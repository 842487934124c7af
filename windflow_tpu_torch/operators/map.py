"""Map, BatchMap and KeyBy — one-to-one transformations.

Counterparts of ``windflow_tpu/operators/map.py`` (reference ``wf/map.hpp``):

- :class:`Map`: per-tuple ``f(t) -> payload`` under ``vmap``, or in place:
  ``f(t) -> None`` writes payload fields of a
  :class:`~windflow_tpu_torch.batch.MutableTupleRef` (``t.v = t.v * 2``), the
  reference's ``void(tuple_t&)``;
- :class:`KeyedMap`: the stateful map ``f(t, state_k) -> (payload,
  new_state_k)`` over a per-key state table, same-key tuples folded in
  stream order;
- :class:`BatchMap`: ``fn(payload_of_[C, ...]) -> payload`` over whole
  tensors — joins through table lookups, projections, casts;
- :class:`KeyBy`: ``key = fn(t) mod num_keys`` rewrites the key control field.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..basic import routing_modes_t, DEFAULT_MAX_KEYS
from ..batch import (Batch, MutableTupleRef, TupleRef, abstract_spec, map_tuples,
                     tree_map, vmap_lanes)
from ..context import RuntimeContext
from ..meta import SignatureError, classify_map
from ..ops.lookup import table_lookup
from ..ops.registry import traced
from ..ops.segment import segment_rank
from .base import Basic_Operator


class Map(Basic_Operator):
    def __init__(self, fn: Callable, *, name: str = "map", parallelism: int = 1,
                 keyed: bool = False, context: Optional[RuntimeContext] = None,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.is_rich = classify_map(fn)
        self.routing = routing_modes_t.KEYBY if keyed else routing_modes_t.FORWARD
        self.context = context or RuntimeContext(parallelism, 0)

    def _call(self, t):
        m = MutableTupleRef(t) if isinstance(t.data, dict) else t
        r = self.fn(m, self.context) if self.is_rich else self.fn(m)
        if r is None:
            if not isinstance(m, MutableTupleRef):
                raise SignatureError(
                    "Map: f returned None (in-place flavour) but the payload is "
                    "not a dict of named fields; return the new payload instead")
            return m._payload()
        return r

    def out_spec(self, payload_spec: Any) -> Any:
        return abstract_spec(lambda dev: map_tuples(self._call,
                                                    Batch.empty(1, payload_spec, dev)))

    def apply(self, state, batch: Batch):
        return state, batch.with_payload(map_tuples(self._call, batch))


class KeyBy(Basic_Operator):
    """Re-key the stream: ``key = fn(t) mod num_keys`` (floored, as in the JAX
    package). ``fn`` takes a TupleRef; the rich variant takes ``(t, ctx)``."""

    def __init__(self, fn: Callable, num_keys: int, *, name: str = "keyby",
                 parallelism: int = 1, context: Optional[RuntimeContext] = None,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.num_keys = int(num_keys)
        self.is_rich = classify_map(fn)
        self.routing = routing_modes_t.KEYBY
        self.context = context or RuntimeContext(parallelism, 0)

    def apply(self, state, batch: Batch):
        one = (lambda t: self.fn(t, self.context)) if self.is_rich else self.fn
        key = map_tuples(one, batch).to(batch.key.dtype)
        return state, batch.replace(key=key % self.num_keys)


class BatchMap(Basic_Operator):
    """Batch-level map: ``fn(payload_pytree_of_[C,...]) -> payload_pytree``."""

    def __init__(self, fn: Callable, *, name: str = "batch_map", parallelism: int = 1,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn

    def out_spec(self, payload_spec: Any) -> Any:
        return abstract_spec(lambda dev: self.fn(Batch.empty(1, payload_spec, dev).payload))

    def apply(self, state, batch: Batch):
        return state, batch.with_payload(self.fn(batch.payload))


class KeyedMap(Basic_Operator):
    """Stateful map with a per-key state table (the reference fork's keyed
    MapGPU, ``wf/map_gpu_node.hpp:216-222``).

    ``f(t, state_k) -> (payload, new_state_k)``; ``init_state_value`` is the
    per-key initial state pytree (Python ints become int32 and floats
    float32, as in the JAX package). Same-key tuples of a batch fold in
    stream order: a batch whose live keys are all distinct takes one
    gather-apply-scatter round; otherwise round r applies the lanes whose
    rank among their key's lanes is r, up to the batch's largest rank. The
    JAX package picks between the two on the device (``lax.cond``,
    ``fori_loop``); eager PyTorch reads that rank on the host once an apply,
    which a CUDA-graph capture cannot hold, so such a KeyedMap raises when
    it is captured (``Pipeline(dispatch=)``, ``device_cursor_step``).

    ``max_key_multiplicity=1`` promises that no batch holds a key twice:
    one round, no host read, capturable. A violation is latched into the
    state (``"bad"``) and ``flush`` raises on it; on the CPU, where reading
    the rank costs no device sync, ``apply`` raises at once (the JAX
    package's early report, an asynchronous debug callback). ``ordered`` is
    kept for API compatibility and does not weaken the in-order fold."""

    routing = routing_modes_t.KEYBY

    def __init__(self, fn: Callable, init_state_value: Any, *,
                 num_keys: int = DEFAULT_MAX_KEYS, name: str = "map_keyed",
                 parallelism: int = 1, ordered: bool = True,
                 max_key_multiplicity: int = None, device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.init_value = init_state_value
        self.num_keys = int(num_keys)
        self.ordered = ordered
        self.max_key_multiplicity = max_key_multiplicity

    def _initial(self):
        """The per-key initial state as tensors on the device (one key's)."""
        def one(v):
            if isinstance(v, bool):
                return torch.tensor(v, device=self.device)
            if isinstance(v, int):
                return torch.tensor(v, dtype=torch.int32, device=self.device)
            if isinstance(v, float):
                return torch.tensor(v, dtype=torch.float32, device=self.device)
            return torch.as_tensor(v, device=self.device)
        return tree_map(one, self.init_value)

    def init_state(self, payload_spec: Any):
        tbl = tree_map(lambda v: v.expand((self.num_keys,) + tuple(v.shape)).clone(),
                       self._initial())
        return {"tbl": tbl, "bad": torch.zeros((), dtype=torch.bool, device=self.device)}

    def out_spec(self, payload_spec: Any) -> Any:
        return abstract_spec(lambda dev: self._round(
            Batch.empty(1, payload_spec, dev),
            tree_map(lambda v: v[None], self._initial()))[0])

    def _round(self, batch: Batch, tbl):
        """``f`` over every lane with its key's current state: (payloads, new states)."""
        st_k = tree_map(lambda t: table_lookup(t, batch.key, traced=True), tbl)
        return vmap_lanes(
            lambda k, i, ts, d, st: self.fn(TupleRef(key=k, id=i, ts=ts, data=d), st),
            batch.key, batch.id, batch.ts, batch.payload, st_k)

    def _scatter(self, tbl, new_st, active: torch.Tensor, key: torch.Tensor):
        """Write the ``active`` lanes' new states into their keys' rows
        (other lanes, and keys outside ``[0, K)``, go to a spill row)."""
        K = self.num_keys
        row = torch.where(active & (key >= 0) & (key < K), key, K).long()

        def put(t, ns):
            ext = torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
            ext[row] = ns.to(t.dtype)
            return ext[:K]
        return tree_map(put, tbl, new_st)

    def apply(self, state, batch: Batch):
        tbl, bad = state["tbl"], state["bad"]
        rank = segment_rank(batch.key, batch.valid)
        max_rank = torch.where(batch.valid, rank, 0).max()
        if self.max_key_multiplicity == 1:
            bad = bad | (max_rank > 0)
            # the CPU's early report (a trace models the card's step: no read)
            if max_rank.device.type == "cpu" and not traced(max_rank) and int(max_rank) > 0:
                raise ValueError(self._violation(
                    f"a batch holds {int(max_rank) + 1} tuples of one key"))
            rounds = 1
        else:
            if batch.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"KeyedMap '{self.name}': apply reads max_rank (the most tuples of "
                    f"one key in the batch) on the host to choose its in-order rounds, "
                    f"and a CUDA-graph capture cannot hold that host read; build it "
                    f"with max_key_multiplicity=1 or run it without dispatch=")
            rounds = int(max_rank) + 1           # the one host read of an apply
        if rounds == 1:
            res, new_st = self._round(batch, tbl)
            tbl = self._scatter(tbl, new_st, batch.valid, batch.key)
            return {"tbl": tbl, "bad": bad}, batch.with_payload(res)
        out = None
        for r in range(rounds):
            active = batch.valid & (rank == r)
            res, new_st = self._round(batch, tbl)
            tbl = self._scatter(tbl, new_st, active, batch.key)
            if out is None:
                out = tree_map(torch.zeros_like, res)
            out = tree_map(lambda o, v: torch.where(
                active.reshape(active.shape + (1,) * (v.ndim - 1)), v, o), out, res)
        return {"tbl": tbl, "bad": bad}, batch.with_payload(out)

    def _violation(self, what: str) -> str:
        return (f"KeyedMap '{self.name}': {what}, violating the max_key_multiplicity=1 "
                f"promise (the single-round path drops state updates); remove "
                f"max_key_multiplicity=1 to get the in-order rounds")

    def flush(self, state):
        """EOS: no residual output; the report point of a violated
        ``max_key_multiplicity=1`` promise latched in the state."""
        if self.max_key_multiplicity == 1 and bool(state["bad"]):
            raise ValueError(self._violation("some batch held same-key duplicates"))
        return state, None

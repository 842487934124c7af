"""Parallel window patterns: Win_Farm, Key_Farm, Key_FFAT, Pane_Farm, Win_MapReduce.

Counterpart of ``windflow_tpu/operators/win_patterns.py``. The reference
implements each pattern as its own thread topology around ``Win_Seq`` workers
(``wf/win_farm.hpp``, ``wf/key_farm.hpp``, ``wf/key_ffat.hpp``,
``wf/pane_farm.hpp``, ``wf/win_mapreduce.hpp``). On one device the batched
window axis plays the worker pool: every fired window is a row of one vmapped
call, so each pattern is a configuration of the vectorized engines.
``shard_axis`` records the axis a multi-device port would shard ("window" or
"key"; ROADMAP Queue 1 item 14).

- **Win_Farm**: windows are already independent rows of the ``[W]`` axis.
- **Key_Farm**: the ``[K]`` state axis is the farm.
- **Key_FFAT**: a Key_Farm whose workers are Win_SeqFFAT.
- **Pane_Farm**: PLQ = a tumbling Win_Seq over panes (``pane_len =
  gcd(win_len, slide)``), WLQ = a Win_Seq over the pane results; both run in
  one apply.
- **Win_MapReduce**: inside the window vmap each window row is split
  round-robin into ``map_parallelism`` partitions, MAP runs vmapped over them
  and REDUCE combines the partials. A MAP of ``it.sum(...)`` is one call of
  kernel K6 over ``[W * M, L / M]`` rows.
- **Nested_Farm**: ``Win_Farm(Pane_Farm(...))``, ``Key_Farm(Win_MapReduce(...))``
  and the like; the inner pattern does the work.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from ..basic import routing_modes_t, role_t, pattern_t, DEFAULT_MAX_KEYS
from ..batch import Batch, CTRL_DTYPE, tree_map
from .base import Basic_Operator
from .window import Iterable, WindowSpec
from .win_seq import Win_Seq
from .win_seqffat import Win_SeqFFAT


def _check_nesting_args(outer: str, args, kw) -> None:
    """The nesting constructors take only parallelism= and name=: the window
    geometry, key capacity and device belong to the inner pattern (the outer
    farm replicates the inner pattern verbatim, ``wf/win_farm.hpp:266-355``).
    Anything else is refused rather than silently ignored."""
    extra = [repr(a) for a in args] + [k for k in kw if k not in ("parallelism", "name")]
    if extra:
        raise TypeError(
            f"{outer}(inner_pattern, ...): nesting accepts only parallelism= and "
            f"name= — the window spec, num_keys and device come from the inner "
            f"pattern; got extra argument(s): {', '.join(extra)}")


class Win_Farm(Win_Seq):
    """Keyless (or keyed) window parallelism. On one device the ``[W]`` axis
    is already the farm; ``parallelism`` is metadata.

    Nesting (``wf/win_farm.hpp:266-355``): a :class:`Pane_Farm` or
    :class:`Win_MapReduce` instance as the first argument replicates that
    whole pattern as the worker — ``Win_Farm(Pane_Farm(...))``."""

    pattern = pattern_t.WF_CPU
    shard_axis = "window"

    def __new__(cls, win_fn=None, *args, **kw):
        if isinstance(win_fn, (Pane_Farm, Win_MapReduce)):
            _check_nesting_args(cls.__name__, args, kw)
            return Nested_Farm(win_fn, shard_axis="window", pattern=pattern_t.WF_CPU,
                               parallelism=kw.get("parallelism", 1),
                               name=kw.get("name", f"win_farm[{win_fn.name}]"))
        return super().__new__(cls)

    def __init__(self, win_fn, spec: WindowSpec, *, parallelism: int = 1,
                 num_keys: int = 1, name: str = "win_farm", **kw):
        super().__init__(win_fn, spec, num_keys=num_keys, name=name,
                         parallelism=parallelism, **kw)
        self.routing = routing_modes_t.COMPLEX


class Key_Farm(Win_Seq):
    """Keyed window parallelism: keys partitioned over replicas, each key's
    windows computed in order (``wf/key_farm.hpp``). The ``[K]`` state axis
    is the farm.

    Nesting (``wf/key_farm.hpp:155-167``): a :class:`Pane_Farm` or
    :class:`Win_MapReduce` instance as the first argument."""

    pattern = pattern_t.KF_CPU
    shard_axis = "key"

    def __new__(cls, win_fn=None, *args, **kw):
        if isinstance(win_fn, (Pane_Farm, Win_MapReduce)):
            _check_nesting_args(cls.__name__, args, kw)
            return Nested_Farm(win_fn, shard_axis="key", pattern=pattern_t.KF_CPU,
                               parallelism=kw.get("parallelism", 1),
                               name=kw.get("name", f"key_farm[{win_fn.name}]"))
        return super().__new__(cls)

    def __init__(self, win_fn, spec: WindowSpec, *, parallelism: int = 1,
                 num_keys: int = DEFAULT_MAX_KEYS, name: str = "key_farm", **kw):
        super().__init__(win_fn, spec, num_keys=num_keys, name=name,
                         parallelism=parallelism, **kw)


class Key_FFAT(Win_SeqFFAT):
    """Key_Farm with FlatFAT-style associative incremental workers
    (``wf/key_ffat.hpp:65-246``): pane-partial sharing over the key axis."""

    pattern = pattern_t.KFF_CPU
    shard_axis = "key"

    def __init__(self, lift, combine, *, spec: WindowSpec, parallelism: int = 1,
                 num_keys: int = DEFAULT_MAX_KEYS, name: str = "key_ffat", **kw):
        super().__init__(lift, combine, spec=spec, num_keys=num_keys, name=name,
                         parallelism=parallelism, **kw)


class Nested_Farm(Basic_Operator):
    """An outer distribution pattern (Win_Farm / Key_Farm) around an inner
    computation pattern (Pane_Farm / Win_MapReduce), the reference's nesting
    constructors (``wf/win_farm.hpp:266-355``, ``wf/key_farm.hpp:155-167``).
    The inner pattern's batched window axis is the worker pool; the outer one
    adds the shard axis and parallelism metadata. It runs on the inner
    pattern's device."""

    def __init__(self, inner, *, shard_axis: str, pattern, parallelism: int = 1,
                 name: str | None = None):
        super().__init__(name or f"nested[{inner.name}]", parallelism, inner.device)
        self.inner = inner
        self.shard_axis = shard_axis
        self.pattern = pattern
        self.routing = inner.routing
        self.spec = inner.spec
        self.num_keys = getattr(inner, "num_keys", None)

    def bind_geometry(self, batch_capacity: int) -> None:
        self.inner.bind_geometry(batch_capacity)

    def out_capacity(self, in_capacity: int) -> int:
        return self.inner.out_capacity(in_capacity)

    def init_state(self, payload_spec: Any):
        return self.inner.init_state(payload_spec)

    def out_spec(self, payload_spec: Any) -> Any:
        return self.inner.out_spec(payload_spec)

    def apply(self, state, batch: Batch):
        return self.inner.apply(state, batch)

    def flush(self, state):
        return self.inner.flush(state)


class Pane_Farm(Basic_Operator):
    """Pane decomposition (Li et al. SIGMOD'05; ``wf/pane_farm.hpp``).

    ``plq_fn(pane_id, iterable) -> pane_result`` runs once per pane;
    ``wlq_fn(wid, iterable_of_pane_results) -> result`` combines the panes of
    each window. Sliding windows only (slide < win_len, as ``:170-173``). The
    state is ``{"plq": WinSeqState, "wlq": WinSeqState}``."""

    routing = routing_modes_t.KEYBY
    pattern = pattern_t.PF_CPU

    def __init__(self, plq_fn: Callable, wlq_fn: Callable, spec: WindowSpec, *,
                 num_keys: int = DEFAULT_MAX_KEYS, name: str = "pane_farm",
                 plq_parallelism: int = 1, wlq_parallelism: int = 1, device=None,
                 **kw):
        super().__init__(name, max(plq_parallelism, wlq_parallelism), device)
        if spec.slide >= spec.win_len:
            raise ValueError("Pane_Farm requires sliding windows (slide < win_len), "
                             "wf/pane_farm.hpp:170-173")
        self.spec = spec
        self.num_keys = num_keys
        self.shard_axis = "key"
        self.pane_len = math.gcd(spec.win_len, spec.slide)
        self.wpanes = spec.win_len // self.pane_len
        self.spanes = spec.slide // self.pane_len
        # PLQ: tumbling windows of one pane, same window type as the outer spec
        plq_spec = WindowSpec(self.pane_len, self.pane_len, spec.wtype, spec.delay)
        self.plq = Win_Seq(plq_fn, plq_spec, num_keys=num_keys, role=role_t.PLQ,
                           name=f"{name}_plq", device=self.device, **kw)
        # WLQ consumes the pane-result stream: CB windows counted in pane
        # results (panes arrive per key in ascending order without gaps); for
        # TB, pane results carry ts = pane end time and WLQ stays time-based
        if spec.is_cb:
            wlq_spec = WindowSpec(self.wpanes, self.spanes)
        else:
            wlq_spec = WindowSpec(spec.win_len, spec.slide, spec.wtype)
        self.wlq = Win_Seq(wlq_fn, wlq_spec, num_keys=num_keys, role=role_t.WLQ,
                           name=f"{name}_wlq", device=self.device)

    def bind_geometry(self, batch_capacity: int) -> None:
        self.plq.bind_geometry(batch_capacity)
        self.wlq.bind_geometry(self.plq.out_capacity(batch_capacity))

    def out_capacity(self, in_capacity: int) -> int:
        return self.wlq.out_capacity(self.plq.out_capacity(in_capacity))

    def init_state(self, payload_spec: Any):
        return {"plq": self.plq.init_state(payload_spec),
                "wlq": self.wlq.init_state(self.plq.out_spec(payload_spec))}

    def out_spec(self, payload_spec: Any) -> Any:
        return self.wlq.out_spec(self.plq.out_spec(payload_spec))

    # Pane results enter WLQ directly: Win_Seq already stamps TB pane results
    # with the pane close time.

    def apply(self, state, batch: Batch):
        st_p, panes = self.plq.apply(state["plq"], batch)
        st_w, out = self.wlq.apply(state["wlq"], panes)
        return {"plq": st_p, "wlq": st_w}, out

    def flush(self, state):
        st_p, panes = self.plq.flush(state["plq"])
        if panes is not None:
            st_w, out = self.wlq.apply(state["wlq"], panes)
            return {"plq": st_p, "wlq": st_w}, out
        st_w, out = self.wlq.flush(state["wlq"])
        return {"plq": st_p, "wlq": st_w}, out


class Win_MapReduce(Basic_Operator):
    """Window partitioning: each window's content is split round-robin over
    ``map_parallelism`` partitions, MAP computes per-partition partials and
    REDUCE combines them (``wf/win_mapreduce.hpp:63-230``, emitters
    ``wf/wm_nodes.hpp``).

    ``map_fn(wid, iterable) -> partial`` per partition;
    ``reduce_fn(wid, iterable_of_partials) -> result`` over the M partials.
    CB and TB windows: partitioning is round-robin by window-row position.
    The engine is a Win_Seq whose window function does the partition-map and
    the reduce inside the window vmap; the state is the engine's."""

    routing = routing_modes_t.KEYBY
    pattern = pattern_t.WMR_CPU

    def __init__(self, map_fn: Callable, reduce_fn: Callable, spec: WindowSpec, *,
                 map_parallelism: int = 2, num_keys: int = DEFAULT_MAX_KEYS,
                 name: str = "win_mapreduce", device=None, **kw):
        super().__init__(name, map_parallelism, device)
        if map_parallelism < 2:
            raise ValueError("Win_MapReduce requires map_parallelism >= 2 "
                             "(wf/win_mapreduce.hpp:160-166)")
        self.spec = spec
        self.M = int(map_parallelism)
        self.map_fn = map_fn
        self.reduce_fn = reduce_fn
        self.num_keys = num_keys
        self.shard_axis = "key"
        self.engine = Win_Seq(self._window_fn, spec, num_keys=num_keys,
                              name=f"{name}_engine", role=role_t.MAP,
                              device=self.device, **kw)

    def _window_fn(self, wid, it: Iterable):
        M = self.M
        L = it.mask.shape[0]                  # row length: win_len (CB) or the ring (TB)
        P = -(-L // M)                        # padded to P * M

        def part(a):
            if P * M != L:
                a = torch.cat([a, a.new_zeros((P * M - L,) + tuple(a.shape[1:]))])
            # round-robin: partition p gets positions p, p+M, p+2M, ...
            # (WinMap_Emitter scatter): [P*M] -> [P, M] -> [M, P]
            return a.reshape((P, M) + tuple(a.shape[1:])).transpose(0, 1)
        map_fn = self.map_fn
        partials = torch.func.vmap(lambda d, i, t, m: map_fn(wid, Iterable(d, i, t, m)))(
            tree_map(part, it.data), part(it.ids), part(it.ts), part(it.mask))
        # REDUCE over the M partials (a CB window of length M in the
        # reference). A partition that received no tuples contributes no
        # partial, so an identity (e.g. 0 of an empty sum) cannot poison a
        # non-sum reduce such as min.
        dev = it.mask.device
        red_it = Iterable(data=partials,
                          ids=torch.arange(M, dtype=CTRL_DTYPE, device=dev),
                          ts=torch.zeros((M,), dtype=CTRL_DTYPE, device=dev),
                          mask=part(it.mask).any(dim=1))
        return self.reduce_fn(wid, red_it)

    def bind_geometry(self, batch_capacity: int) -> None:
        self.engine.bind_geometry(batch_capacity)

    def out_capacity(self, in_capacity: int) -> int:
        return self.engine.out_capacity(in_capacity)

    def init_state(self, payload_spec: Any):
        return self.engine.init_state(payload_spec)

    def out_spec(self, payload_spec: Any) -> Any:
        return self.engine.out_spec(payload_spec)

    def apply(self, state, batch: Batch):
        return self.engine.apply(state, batch)

    def flush(self, state):
        return self.engine.flush(state)

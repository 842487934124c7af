"""Incremental rank operators: per-key top-N and streaming distinct.

Counterpart of ``windflow_tpu/operators/rank.py`` (untiered):

- :class:`TopN` keeps a ``[K, N]`` leaderboard per key and merges each
  batch's candidates with one bitonic sort over ``[K, L]`` rows of composite
  keys ``(-score, id, 0, idx)``, ``L`` the next power of two above
  ``N + C`` (kernel K4 on the card, one call per apply). The unique ``idx``
  lane makes the order total: score descending, then id ascending.
- :class:`Distinct` passes each distinct value once: in-batch duplicates
  fall to a :func:`segment_rank` first-occurrence test, cross-batch ones to
  a probe of a delay-0 JoinTable before the batch's new values upsert
  (kernel K5 twice per apply: the probe, and the upsert's slot probe).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..basic import DEFAULT_MAX_KEYS, routing_modes_t
from ..batch import Batch, map_tuples
from ..ops.bitonic import sort_network
from ..ops.lookup import join_table_init, join_table_probe, join_table_upsert
from ..ops.segment import segment_rank
from .base import Basic_Operator
from .join import refuse_tiered

#: empty-slot score: sorts after every real candidate under the negated key
#: (user scores must be > INT32_MIN + 1)
TOPN_SENTINEL = -(1 << 31) + 1

_I32 = torch.int32


class TopN(Basic_Operator):
    """Incremental per-key top-N by an int32 score.

    ``score_fn(t) -> i32`` (> INT32_MIN + 1). Every apply emits the updated
    leaderboard rows of the keys the batch touched (``K * N`` lanes: key =
    key slot, id = the ranked tuple's id, payload ``{"score", "rank"}``);
    ``flush`` emits the final leaderboard of every key once. Ties break by
    tuple id (earlier wins)."""

    routing = routing_modes_t.KEYBY

    def __init__(self, score_fn: Callable, n: int, *, num_keys: int = DEFAULT_MAX_KEYS,
                 tiered=None, name: str = "topn", parallelism: int = 1, device=None):
        refuse_tiered(name, tiered)
        super().__init__(name, parallelism, device)
        self.score_fn = score_fn
        self.n = int(n)
        self.num_keys = int(num_keys)
        if self.n < 1:
            raise ValueError(f"{name}: n must be >= 1")

    def out_capacity(self, in_capacity: int) -> int:
        return self.num_keys * self.n

    def out_spec(self, payload_spec: Any) -> Any:
        i = torch.empty((), dtype=_I32, device="meta")
        return {"score": i, "rank": i}

    def init_state(self, payload_spec: Any):
        K, N = self.num_keys, self.n
        dev = self.device
        return {"score": torch.full((K, N), TOPN_SENTINEL, dtype=_I32, device=dev),
                "tid": torch.zeros((K, N), dtype=_I32, device=dev),
                "evict": torch.zeros((), dtype=_I32, device=dev),
                "eos": torch.zeros((), dtype=_I32, device=dev)}

    def _merge(self, state, keymat, scores, ids):
        """Merge ``[K, C]`` candidates into the ``[K, N]`` leaderboard through
        one batched bitonic sort over the padded composite key."""
        K, N = self.num_keys, self.n
        dev = scores.device
        cscore = torch.where(keymat, scores[None, :], TOPN_SENTINEL)
        cid = torch.where(keymat, ids[None, :], 0)
        alls = torch.cat([state["score"], cscore], dim=1)
        alli = torch.cat([state["tid"], cid], dim=1)
        L = 1 << max(1, (alls.shape[1] - 1).bit_length())
        pad = L - alls.shape[1]
        alls = torch.cat([alls, torch.full((K, pad), TOPN_SENTINEL, dtype=_I32,
                                           device=dev)], dim=1)
        alli = torch.cat([alli, torch.zeros((K, pad), dtype=_I32, device=dev)], dim=1)
        zero = torch.zeros((K, L), dtype=_I32, device=dev)
        iota = torch.arange(L, dtype=_I32, device=dev).expand(K, L).contiguous()
        neg, sid, _, _ = sort_network((-alls).contiguous(), alli.contiguous(), zero, iota)
        return -neg[:, :N], sid[:, :N].contiguous()

    def apply(self, state, batch: Batch):
        K, N = self.num_keys, self.n
        scores = map_tuples(self.score_fn, batch).to(_I32)
        keymat = ((batch.key[None, :] == torch.arange(K, dtype=_I32,
                                                      device=batch.device)[:, None])
                  & batch.valid[None, :])                              # [K, C]
        filled = (state["score"] != TOPN_SENTINEL).sum(dim=1, dtype=_I32)
        cands = keymat.sum(dim=1, dtype=_I32)
        new_score, new_tid = self._merge(state, keymat, scores, batch.id)
        kept = (new_score != TOPN_SENTINEL).sum(dim=1, dtype=_I32)
        evict = state["evict"] + (filled + cands - kept).sum(dtype=_I32)
        touched = keymat.any(dim=1)
        state = dict(state, score=new_score, tid=new_tid, evict=evict)
        return state, self._rows(state, touched)

    def _rows(self, state, keep_key):
        K, N = self.num_keys, self.n
        dev = state["score"].device
        keyv = torch.arange(K, dtype=_I32, device=dev).repeat_interleave(N)
        rank = torch.arange(N, dtype=_I32, device=dev).repeat(K)
        score = state["score"].reshape(K * N)
        valid = (keep_key[:, None] & (state["score"] != TOPN_SENTINEL)).reshape(K * N)
        return Batch(key=keyv, id=state["tid"].reshape(K * N),
                     ts=torch.zeros((K * N,), dtype=_I32, device=dev),
                     payload={"score": score, "rank": rank}, valid=valid)

    def flush(self, state):
        """Emit the final leaderboard once (guarded by ``eos``); None after."""
        if state is None or int(state["eos"]):
            return state, None
        state = dict(state, eos=torch.ones((), dtype=_I32, device=state["eos"].device))
        return state, self._rows(state, torch.ones((self.num_keys,), dtype=torch.bool,
                                                   device=state["eos"].device))


class Distinct(Basic_Operator):
    """Pass each distinct value through exactly once.

    ``value_fn(t) -> i32`` gives the distinctness key (default: the tuple's
    key; values must be > INT32_MIN). In-batch duplicates keep the first
    occurrence in stream order; cross-batch duplicates are suppressed by
    probing the JoinTable before the batch's new values upsert. ``num_slots``
    bounds the distinct cardinality: values beyond it are dropped from the
    table (counted in ``state["dropped"]``) and would pass again."""

    routing = routing_modes_t.KEYBY

    def __init__(self, value_fn: Optional[Callable] = None, *,
                 num_slots: int = DEFAULT_MAX_KEYS, tiered=None,
                 name: str = "distinct", parallelism: int = 1, device=None):
        refuse_tiered(name, tiered)
        super().__init__(name, parallelism, device)
        self.value_fn = value_fn or (lambda t: t.key)
        self.num_slots = int(num_slots)
        self._pending = None

    def bind_geometry(self, batch_capacity: int) -> None:
        self._pending = int(batch_capacity)

    def init_state(self, payload_spec: Any):
        pending = self._pending or self.num_slots
        vspec = {"one": torch.empty((), dtype=_I32, device="meta")}
        return join_table_init(self.num_slots, pending, vspec, self.device)

    def apply(self, state, batch: Batch):
        dk = map_tuples(self.value_fn, batch).to(_I32)
        firsts = batch.valid & (segment_rank(dk, batch.valid) == 0)
        _, hit = join_table_probe(state, dk, firsts)
        keep = firsts & ~hit
        ones = torch.ones((batch.capacity,), dtype=_I32, device=batch.device)
        state = join_table_upsert(state, dk, {"one": ones}, batch.ts, batch.id, keep,
                                  delay=0)
        return state, batch.mask(keep)


__all__ = ["TOPN_SENTINEL", "TopN", "Distinct"]

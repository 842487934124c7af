"""Incremental rank operators: per-key top-N and streaming distinct.

Counterpart of ``windflow_tpu/operators/rank.py``:

- :class:`TopN` keeps a ``[K, N]`` leaderboard per key and merges each
  batch's candidates with one bitonic sort over ``[K, L]`` rows of composite
  keys ``(-score, id, 0, idx)``, ``L`` the next power of two above
  ``N + C`` (kernel K4 on the card, one call per apply). The unique ``idx``
  lane makes the order total: score descending, then id ascending.
- :class:`Distinct` passes each distinct value once: in-batch duplicates
  fall to a :func:`segment_rank` first-occurrence test, cross-batch ones to
  a probe of a delay-0 JoinTable before the batch's new values upsert
  (kernel K5 twice per apply: the probe, and the upsert's slot probe).

Tiered keyed state (``tiered=``, ``state/tiered.py``): Distinct's table is a
delay-0 JoinTable and takes StreamTableJoin's hooks (a value seen long ago is
readmitted from the cold tier before the duplicate probe). TopN puts a key ->
hot-slot directory in front of its ``[hot_capacity, N]`` leaderboard; cold
leaderboards spill to the host store and readmit on touch, and the EOS flush
emits the hot leaderboards, then drains the store in waves of ``hot_capacity``
keys in ascending key order (``HostStore.pop_keys``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..control import _state as _control
from ..basic import DEFAULT_MAX_KEYS, routing_modes_t
from ..batch import Batch, map_tuples
from ..ops.bitonic import sort_network
from ..ops.lookup import (_isum, _set_drop, count_drops, join_table_init,
                          join_table_probe, join_table_tier_evict, join_table_tier_init,
                          join_table_stats, join_table_tier_resolve,
                          join_table_tier_stats, join_table_tier_touch, join_table_upsert)
from ..ops.segment import segment_rank
from ..state.tiered import (JoinTableTier, SlotTableTier, TierConfig, TieredTable,
                            slot_directory_evict, slot_directory_init,
                            slot_directory_resolve, slot_directory_stats)
from .base import Basic_Operator

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
    tuple id (earlier wins). Tiered, the key is the tuple's true key and the
    EOS drain follows in waves (see the module docstring)."""

    routing = routing_modes_t.KEYBY

    def __init__(self, score_fn: Callable, n: int, *, num_keys: int = DEFAULT_MAX_KEYS,
                 tiered=None, name: str = "topn", parallelism: int = 1, device=None):
        super().__init__(name, parallelism, device)
        self.score_fn = score_fn
        self.n = int(n)
        self.num_keys = int(num_keys)
        if self.n < 1:
            raise ValueError(f"{name}: n must be >= 1")
        self._tier_cfg = TierConfig.resolve(tiered)
        self._tier = None
        self._cap_resolved = None
        self._evict_synced = 0
        self._slots = (int(self._tier_cfg.hot_capacity or num_keys)
                       if self._tier_cfg is not None else self.num_keys)

    def bind_geometry(self, batch_capacity: int) -> None:
        self._cap_resolved = int(batch_capacity)

    def out_capacity(self, in_capacity: int) -> int:
        return self._slots * self.n

    def out_spec(self, payload_spec: Any) -> Any:
        i = torch.empty((), dtype=_I32, device="meta")
        return {"score": i, "rank": i}

    def init_state(self, payload_spec: Any):
        K, N = self._slots, self.n
        dev = self.device
        state = {"score": torch.full((K, N), TOPN_SENTINEL, dtype=_I32, device=dev),
                 "tid": torch.zeros((K, N), dtype=_I32, device=dev),
                 "evict": torch.zeros((), dtype=_I32, device=dev),
                 "eos": torch.zeros((), dtype=_I32, device=dev)}
        if self._tier_cfg is None:
            return state
        cap = self._cap_resolved or DEFAULT_MAX_KEYS
        self._hot_target = max(1, K - min(cap, K - 1))
        outbox = int(self._tier_cfg.outbox or 4 * cap)
        state.update(slot_directory_init(K, outbox, {
            "oscore": lambda S: torch.full((S, N), TOPN_SENTINEL, dtype=_I32, device=dev),
            "otid": lambda S: torch.zeros((S, N), dtype=_I32, device=dev)}, dev))
        state["ovf"] = torch.zeros((), dtype=_I32, device=dev)
        self._tier = SlotTableTier(
            self.name, {"score": (np.int32, (N,)), "tid": (np.int32, (N,))},
            self._tier_cfg, count_key="ocnt", col_keys=["okey", "otick", "oscore", "otid"],
            state_to_store=lambda n, host: (host["okey"], host["otick"],
                                            {"score": host["oscore"], "tid": host["otid"]}),
            wm_key=None, device=dev)
        return state

    def tier_controllers(self):
        return (self._tier.controller,) if self._tier is not None else ()

    def collect_stats(self, state: Any = None) -> None:
        if state is None:
            return
        ev = int(state["evict"])
        if ev > self._evict_synced:
            _control.bump("topn_evictions", ev - self._evict_synced)
            self._evict_synced = ev
        counters = {"topn_evictions": ev}
        if self._tier is not None:
            from .join import tier_counters
            counters.update(tier_counters(state, self._tier))
            counters["overflow_drops"] = int(state["ovf"])
        self._publish_stage_counters(counters)

    def drop_counters(self, state: Any = None) -> dict:
        if state is None or self._tier is None:
            return {}
        return {"overflow_drops": int(state["ovf"])}

    def event_time_stats(self, state: Any = None):
        """Watermark-map section: leaderboard fill and eviction pressure
        (TopN ranks scores, it has no event-time frontier)."""
        if state is None:
            return None
        filled = int((state["score"] != TOPN_SENTINEL).sum())
        slots = self._slots * self.n
        out = {"leaderboard_slots": slots, "leaderboard_filled": filled,
               "occupancy_pct": round(100.0 * filled / slots, 2),
               "topn_evictions": int(state["evict"])}
        if self._tier is not None:
            out["tier"] = {**slot_directory_stats(state), **self._tier.controller.stats()}
            out["overflow_drops"] = int(state["ovf"])
        return out

    def _merge(self, state, keymat, scores, ids):
        """Merge ``[K, C]`` candidates into the ``[K, N]`` leaderboard through
        one batched bitonic sort over the padded composite key."""
        K, N = self._slots, self.n
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
        if self._tier is None:
            return self._apply_core(state, batch)
        K = self._slots
        state, slot, live = slot_directory_resolve(state, batch.key, batch.valid,
                                                   self._tier.lookup, self._admit_write)
        # lanes whose key found no hot slot (the directory saturated): counted
        state = dict(state, ovf=count_drops(state["ovf"], "overflow_drops",
                                            _isum(batch.valid & ~live)))
        b2 = batch.replace(key=torch.where(live, slot, 0), valid=live)
        state, out = self._apply_core(state, b2)
        out = self._true_keys(state, out)
        state = slot_directory_evict(
            state, self._hot_target,
            evictable=torch.ones((K,), dtype=torch.bool, device=batch.device),
            discardable=(state["score"] == TOPN_SENTINEL).all(dim=1),
            pack_write=self._pack_write)
        return state, out

    def _true_keys(self, state, out: Batch) -> Batch:
        """Emitted hot slots remapped to their keys."""
        hk = state["hkey"].index_select(0, out.key.clamp(0, self._slots - 1))
        return out.replace(key=torch.where(out.valid, hk, out.key))

    def _admit_write(self, out, widx, got, in_ob, oidx, host_res):
        """Admitted slots' leaderboard rows: the cold row (the outbox beats
        the host store: it is newer) or a fresh sentinel row."""
        found, h_score, h_tid = host_res
        ob = in_ob[:, None]
        row_s = torch.where(ob, out["oscore"].index_select(0, oidx), h_score)
        row_t = torch.where(ob, out["otid"].index_select(0, oidx), h_tid)
        cold = (in_ob | found)[:, None]
        out["score"] = _set_drop(out["score"], widx, torch.where(cold, row_s, TOPN_SENTINEL))
        out["tid"] = _set_drop(out["tid"], widx, torch.where(cold, row_t, 0))
        return out

    def _pack_write(self, out, opos, perm, spill):
        out["oscore"] = _set_drop(out["oscore"], opos, out["score"].index_select(0, perm))
        out["otid"] = _set_drop(out["otid"], opos, out["tid"].index_select(0, perm))
        return out

    def _apply_core(self, state, batch: Batch):
        K, N = self._slots, self.n
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
        K, N = self._slots, self.n
        dev = state["score"].device
        keyv = torch.arange(K, dtype=_I32, device=dev).repeat_interleave(N)
        rank = torch.arange(N, dtype=_I32, device=dev).repeat(K)
        score = state["score"].reshape(K * N)
        valid = (keep_key[:, None] & (state["score"] != TOPN_SENTINEL)).reshape(K * N)
        return Batch(key=keyv, id=state["tid"].reshape(K * N),
                     ts=torch.zeros((K * N,), dtype=_I32, device=dev),
                     payload={"score": score, "rank": rank}, valid=valid)

    def flush(self, state):
        """Emit the final leaderboards once (guarded by ``eos``); tiered, the
        hot ones first, then one wave of up to ``hot_capacity`` cold keys a
        call until the store is empty; None after."""
        if state is None:
            return state, None
        K, N = self._slots, self.n
        dev = state["eos"].device
        if not int(state["eos"]):
            if self._tier is not None:
                # leaderboards still in the outbox reach the store first
                state = self._tier.controller.settle(state)
            state = dict(state, eos=torch.ones((), dtype=_I32, device=dev))
            if self._tier is None:
                return state, self._rows(state, torch.ones((K,), dtype=torch.bool,
                                                           device=dev))
            # the store may still hold a superseded copy of a key resident
            # hot (readmission does not remove): the waves skip those keys
            hkey, hused = state["hkey"].cpu().numpy(), state["hused"].cpu().numpy()
            self._flush_exclude = set(hkey[hused].tolist())
            return state, self._true_keys(state, self._rows(state, state["hused"]))
        if self._tier is None:
            return state, None
        # EOS drain waves in ascending key order (replay-safe: a restore
        # rewinds the store, so the waves re-derive)
        excl = getattr(self, "_flush_exclude", set())
        TieredTable._quiesce(state)
        while True:
            keys, cols = self._tier.store.pop_keys(K)
            if len(keys) == 0:
                return state, None
            live = np.asarray([int(k) not in excl for k in keys], bool)
            if live.any():
                break
        n = len(keys)
        kv = np.zeros((K,), np.int32)
        kv[:n] = keys.astype(np.int32)
        sc = np.full((K, N), TOPN_SENTINEL, np.int32)
        sc[:n] = np.where(live[:, None], cols["score"], TOPN_SENTINEL)
        td = np.zeros((K, N), np.int32)
        td[:n] = cols["tid"]
        group = np.repeat(np.arange(K) < n, N)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        out = Batch(key=t(np.repeat(kv, N)), id=t(td.reshape(K * N)),
                    ts=torch.zeros((K * N,), dtype=_I32, device=dev),
                    payload={"score": t(sc.reshape(K * N)),
                             "rank": torch.arange(N, dtype=_I32, device=dev).repeat(K)},
                    valid=t(group & (sc.reshape(K * N) != TOPN_SENTINEL)))
        return state, out


class Distinct(Basic_Operator):
    """Pass each distinct value through exactly once.

    ``value_fn(t) -> i32`` gives the distinctness key (default: the tuple's
    key; values must be > INT32_MIN). In-batch duplicates keep the first
    occurrence in stream order; cross-batch duplicates are suppressed by
    probing the JoinTable before the batch's new values upsert. ``num_slots``
    bounds the distinct cardinality: values beyond it are dropped from the
    table (counted in ``state["dropped"]``) and would pass again; tiered, the
    cold values live in a host store instead."""

    routing = routing_modes_t.KEYBY

    def __init__(self, value_fn: Optional[Callable] = None, *,
                 num_slots: int = DEFAULT_MAX_KEYS, tiered=None,
                 name: str = "distinct", parallelism: int = 1, device=None):
        super().__init__(name, parallelism, device)
        self.value_fn = value_fn or (lambda t: t.key)
        self.num_slots = int(num_slots)
        self._pending = None
        self._tier_cfg = TierConfig.resolve(tiered)
        self._tier = None

    def bind_geometry(self, batch_capacity: int) -> None:
        self._pending = int(batch_capacity)

    def init_state(self, payload_spec: Any):
        pending = self._pending or self.num_slots
        vspec = {"one": torch.empty((), dtype=_I32, device="meta")}
        if self._tier_cfg is None:
            return join_table_init(self.num_slots, pending, vspec, self.device)
        hot = int(self._tier_cfg.hot_capacity or self.num_slots)
        _control.set_gauge("hot_capacity", float(hot))
        # a delay-0 table empties its ring every batch: one batch of distinct
        # values is the per-batch admission bound
        self._hot_target = max(1, hot - pending)
        outbox = int(self._tier_cfg.outbox or 4 * pending)
        state = join_table_tier_init(join_table_init(hot, pending, vspec, self.device),
                                     outbox, vspec)
        self._tier = JoinTableTier(self.name, vspec, self._tier_cfg, self.device)
        return state

    def tier_controllers(self):
        return (self._tier.controller,) if self._tier is not None else ()

    def collect_stats(self, state: Any = None) -> None:
        if state is None:
            return
        counters = dict(self.drop_counters(state))
        if self._tier is not None:
            from .join import tier_counters
            counters.update(tier_counters(state, self._tier))
        self._publish_stage_counters(counters)

    def drop_counters(self, state: Any = None) -> dict:
        if state is None:
            return {}
        return {"overflow_drops": int(state["dropped"])}

    def event_time_stats(self, state: Any = None):
        """Watermark-map section: distinct-table occupancy and overflow drops
        (the delay-0 JoinTable underneath)."""
        if state is None:
            return None
        out = join_table_stats(state)
        out["delay"] = 0
        if self._tier is not None:
            out["tier"] = {**join_table_tier_stats(state), **self._tier.controller.stats()}
        return out

    def apply(self, state, batch: Batch):
        dk = map_tuples(self.value_fn, batch).to(_I32)
        firsts = batch.valid & (segment_rank(dk, batch.valid) == 0)
        tier = self._tier
        if tier is not None:
            # a value seen long ago lives in the cold tier: readmit it before
            # the duplicate probe
            state, _fb_vals, fb_ok = join_table_tier_resolve(state, dk, batch.valid,
                                                             tier.lookup)
        _, hit = join_table_probe(state, dk, firsts)
        if tier is not None:
            # a seen value whose row found no free slot still counts as seen
            hit = hit | (fb_ok & firsts)
        keep = firsts & ~hit
        ones = torch.ones((batch.capacity,), dtype=_I32, device=batch.device)
        state = join_table_upsert(state, dk, {"one": ones}, batch.ts, batch.id, keep,
                                  delay=0, divert=tier is not None)
        if tier is not None:
            state = join_table_tier_touch(state, dk, batch.valid)
            state = join_table_tier_evict(state, self._hot_target)
        return state, batch.mask(keep)


__all__ = ["TOPN_SENTINEL", "TopN", "Distinct"]

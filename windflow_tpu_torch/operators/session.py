"""Session windows: data-dependent-gap firing (``WindowSpec.session``).

Counterpart of ``windflow_tpu/operators/session.py::SessionWindow`` (untiered,
event-time monitoring off). A per-key session stays open while consecutive
events arrive within ``gap`` of each other and FIRES when the gap is
exceeded. One apply is a fixed-shape step, as in the JAX package:

1. lanes sort by ``(key, ts, id)``: the JAX package's one stable
   three-key ``lax.sort`` becomes three stable argsorts, least significant
   key first (``ops/lookup.py::_lexsort``), which give the same
   permutation, ties included;
2. in-batch session *fragments* fall out of a gap/boundary scan (``first |
   gap-break`` flags, dense fragment ids by a prefix sum, per-fragment
   aggregates by ``segment_reduce``: kernel K3 on the card for the int32
   sums);
3. each key's first fragment merges with its carried open session where the
   gap chains; every non-final fragment is closed by in-batch evidence;
4. each key's final fragment becomes or extends the carried open session,
   and the triggerer (:meth:`WindowSpec.fired_session`) closes the carried
   sessions the watermark has proven complete, over the whole ``[K]`` table.

Arrival is assumed event-time ordered per key; an intra-key straggler whose
session already closed is OLD, dropped and counted (``state["old"]``).
Output rows carry ``(key, session ordinal, end ts)`` and the payload
``{"agg", "start", "end", "n"}``. Every table read is ``table_lookup(...,
traced=True)`` (kernel K2 on the card), the tables read through one index
together (``table_lookup_many``: four K2 launches an apply, by the batch's
keys, the sorted keys, the fragments' keys and the fragments' close
counts), and nothing in ``apply`` reads a
device value on the host, so a step captures into a CUDA graph. ``flush``
reads ``eos`` on the host and stays eager, as every flush does.

Tiered keyed state (``tiered=``, ``state/tiered.py``): a key -> hot-slot
directory in front of a session table of ``hot_capacity`` slots. Open
sessions are pinned hot (they must fire through the triggerer); only closed
keys' floors and session ordinals spill to the host store, and the
watermark retires floors no admissible arrival can be OLD against (``floor +
gap < wm - delay``, the compaction bound).

Event-time monitoring (``_event_time``, set by the chain): the state carries
an arrival-lateness histogram (``lat_hist``) updated once a batch against the
post-batch watermark. ``collect_stats`` keeps the OLD drops in the
Stats_Record, publishes the stage counters and bumps the process-wide
``sessions_closed`` control counter, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..control import _state as _control
from ..basic import DEFAULT_MAX_KEYS, routing_modes_t
from ..batch import Batch, abstract_spec, map_tuples, tree_leaves, tree_map
from ..observability import event_time as _et
from ..ops.lookup import (_isum, _lexsort, _set_drop, count_drops, table_lookup,
                          table_lookup_many)
from ..ops.segment import segment_reduce
from ..state.tiered import (SlotTableTier, TierConfig, slot_directory_evict,
                            slot_directory_init, slot_directory_resolve,
                            slot_directory_stats)
from .base import Basic_Operator
from .window import WindowSpec

_I32 = torch.int32
_IMIN = -(1 << 31)
_IMAX = (1 << 31) - 1


def _lookup(table, idx):
    return table_lookup(table, idx, traced=True)


def _lookup_many(tables, idx):
    """The tables read through one index: one K2 launch on the card."""
    return table_lookup_many(tables, idx, traced=True)


class SessionWindow(Basic_Operator):
    """Per-key session aggregation under a :meth:`WindowSpec.session` spec.

    ``value_fn(t) -> pytree`` extracts the per-event contribution;
    ``combine`` folds contributions in event-time order (associative;
    default add). One output row per CLOSED session: ``key`` = key slot,
    ``id`` = per-key session ordinal, ``ts`` = session end, payload
    ``{"agg": <folded pytree>, "start", "end", "n"}``."""

    routing = routing_modes_t.KEYBY

    def __init__(self, value_fn: Callable, spec: WindowSpec, *,
                 combine: Callable = None, identity: Any = 0,
                 num_keys: int = DEFAULT_MAX_KEYS, tiered=None,
                 name: str = "session", parallelism: int = 1, device=None):
        super().__init__(name, parallelism, device)
        if not spec.is_session:
            raise ValueError(
                f"{name}: SessionWindow needs a session spec — build it with "
                f"WindowSpec.session(gap, delay), got {spec.wtype}")
        self.value_fn = value_fn
        self.spec = spec
        self.combine = combine
        self.identity = identity
        self.num_keys = int(num_keys)
        self._cap: Optional[int] = None
        self._tier_cfg = TierConfig.resolve(tiered)
        self._tier = None
        self._closed_synced = 0
        self._slots = (int(self._tier_cfg.hot_capacity or num_keys)
                       if self._tier_cfg is not None else self.num_keys)

    # -- geometry / specs -------------------------------------------------------------

    def bind_geometry(self, batch_capacity: int) -> None:
        self._cap = int(batch_capacity)

    def out_capacity(self, in_capacity: int) -> int:
        # in-batch evidence closes (<= 2 row groups of C) + watermark closes
        return 2 * in_capacity + self._slots

    def _val_spec(self, payload_spec):
        return abstract_spec(lambda dev: map_tuples(self.value_fn,
                                                    Batch.empty(1, payload_spec, dev)))

    def out_spec(self, payload_spec: Any) -> Any:
        i = torch.empty((), dtype=_I32, device="meta")
        return {"agg": self._val_spec(payload_spec), "start": i, "end": i, "n": i}

    def init_state(self, payload_spec: Any):
        K, dev = self._slots, self.device
        acc = tree_map(lambda s: torch.zeros((K,) + tuple(s.shape), dtype=s.dtype,
                                             device=dev), self._val_spec(payload_spec))
        z = lambda fill=0: torch.full((K,), fill, dtype=_I32, device=dev)  # noqa: E731
        s = lambda v: torch.tensor(v, dtype=_I32, device=dev)  # noqa: E731
        state = {"open": torch.zeros((K,), dtype=torch.bool, device=dev),
                 "start": z(), "last": z(), "cnt": z(), "sid": z(),
                 "acc": acc, "floor": z(_IMIN),
                 "wm": s(_IMIN), "closed": s(0), "old": s(0), "eos": s(0)}
        if self._event_time:
            # arrival-lateness histogram (event-time monitoring only)
            state["lat_hist"] = _et.lateness_init(device=dev)
        if self._tier_cfg is None:
            return state
        cap = self._cap or DEFAULT_MAX_KEYS
        self._hot_target = max(1, K - min(cap, K - 1))
        outbox = int(self._tier_cfg.outbox or 4 * cap)
        state.update(slot_directory_init(K, outbox, {
            "ofloor": lambda S: torch.full((S,), _IMIN, dtype=_I32, device=dev),
            "osid": lambda S: torch.zeros((S,), dtype=_I32, device=dev)}, dev))
        state["ovf"] = s(0)
        gap, delay = self.spec.gap, self.spec.delay
        self._tier = SlotTableTier(
            self.name, {"floor": (np.int32, ()), "sid": (np.int32, ())}, self._tier_cfg,
            count_key="ocnt", col_keys=["okey", "otick", "ofloor", "osid"],
            state_to_store=lambda n, host: (host["okey"], host["otick"],
                                            {"floor": host["ofloor"], "sid": host["osid"]}),
            # a floor retires once no admissible arrival can be OLD against it
            compact_col="floor", compact_bound=lambda wm: wm - delay - gap,
            wm_key="wm", device=dev)
        return state

    def tier_controllers(self):
        return (self._tier.controller,) if self._tier is not None else ()

    # -- the batched session step -----------------------------------------------------

    def _fold(self, a, b):
        fn = self.combine or torch.add
        return tree_map(fn, a, b)

    def apply(self, state, batch: Batch):
        if self._tier is None:
            return self._apply_core(state, batch)
        K = self._slots
        state, slot, live = slot_directory_resolve(state, batch.key, batch.valid,
                                                   self._tier.lookup, self._admit_write)
        # a lane whose key found no hot slot (the directory full of open
        # sessions) drops, counted
        state = dict(state, ovf=count_drops(state["ovf"], "overflow_drops",
                                            _isum(batch.valid & ~live)))
        state, out = self._apply_core(state, batch.replace(key=torch.where(live, slot, 0),
                                                           valid=live))
        out = self._true_keys(state, out)
        # open sessions stay hot; a floor with nothing to remember frees
        # without outbox space
        state = slot_directory_evict(state, self._hot_target, evictable=~state["open"],
                                     discardable=state["floor"] == _IMIN,
                                     pack_write=self._pack_write)
        return state, out

    def _true_keys(self, state, out: Batch) -> Batch:
        """Emitted hot slots remapped to their keys."""
        hk = state["hkey"].index_select(0, out.key.clamp(0, self._slots - 1))
        return out.replace(key=torch.where(out.valid, hk, out.key))

    def _admit_write(self, out, widx, got, in_ob, oidx, host_res):
        """Admitted keys' carried fields: the cold (floor, session ordinal) pair
        (the outbox beats the host store) or a fresh (INT32_MIN, 0); an
        admitted slot starts closed."""
        found, h_floor, h_sid = host_res
        cold = in_ob | found
        floor = torch.where(in_ob, out["ofloor"].index_select(0, oidx), h_floor)
        sid = torch.where(in_ob, out["osid"].index_select(0, oidx), h_sid)
        out["floor"] = _set_drop(out["floor"], widx, torch.where(cold, floor, _IMIN))
        out["sid"] = _set_drop(out["sid"], widx, torch.where(cold, sid, 0))
        out["open"] = _set_drop(out["open"], widx, torch.zeros_like(got))
        return out

    def _pack_write(self, out, opos, perm, spill):
        out["ofloor"] = _set_drop(out["ofloor"], opos, out["floor"].index_select(0, perm))
        out["osid"] = _set_drop(out["osid"], opos, out["sid"].index_select(0, perm))
        return out

    def _apply_core(self, state, batch: Batch):
        K, C = self._slots, batch.capacity
        gap = self.spec.gap
        dev = batch.device
        vals = map_tuples(self.value_fn, batch)
        # OLD: the event predates (within gap of) the key's last closed end
        floor_k = _lookup(state["floor"], batch.key)
        old = batch.valid & (floor_k > _IMIN) & (batch.ts <= floor_k + gap)
        live = batch.valid & ~old
        # lanes in (key, event-time, id) order, stable
        iota = torch.arange(C, dtype=_I32, device=dev)
        k0 = torch.where(live, batch.key, _IMAX)
        orig = _lexsort([batch.id, batch.ts, k0])
        skeys = k0.index_select(0, orig)
        sts = batch.ts.index_select(0, orig)
        sv = skeys != _IMAX
        sk = torch.where(sv, skeys, 0)
        svals = tree_map(lambda a: a.index_select(0, orig), vals)
        one = torch.ones((1,), dtype=torch.bool, device=dev)
        first = sv & torch.cat([one, skeys[1:] != skeys[:-1]])
        prev_ts = torch.cat([torch.zeros((1,), dtype=sts.dtype, device=dev), sts[:-1]])
        brk = sv & ~first & (sts - prev_ts > gap)
        open_i = state["open"].to(_I32)
        open_k, last_k = _lookup_many((open_i, state["last"]), sk)
        open_k = open_k > 0
        cont = first & open_k & (sts - last_k <= gap)
        # dense fragment ids + per-fragment aggregates (event-time order)
        seg = torch.clamp(torch.cumsum((first | brk).to(_I32), 0, dtype=_I32) - 1, min=0)

        def red(v, comb, ident):
            return segment_reduce(v, seg, sv, C, combine=comb, identity=ident)
        fkey = red(sk, torch.maximum, 0)
        fmin = red(sts, torch.minimum, _IMAX)
        fmax = red(sts, torch.maximum, _IMIN)
        fcnt = red(torch.ones((C,), dtype=_I32, device=dev), None, 0)
        facc = segment_reduce(svals, seg, sv, C, combine=self.combine,
                              identity=self.identity)
        ffirst = red(first.to(_I32), torch.maximum, 0) > 0
        fcont = red(cont.to(_I32), torch.maximum, 0) > 0
        fvalid = fcnt > 0
        # fragment topology per key
        minseg = segment_reduce(seg, sk, sv, K, combine=torch.minimum, identity=_IMAX)
        maxseg = segment_reduce(seg, sk, sv, K, combine=torch.maximum, identity=-1)
        # per fragment key, in one read: the carried open-session fields, the
        # session ordinal and the key's first and last fragment
        acc_leaves = tree_leaves(state["acc"])
        got = _lookup_many([state["start"], state["last"], state["cnt"], *acc_leaves,
                            open_i, state["sid"], minseg, maxseg], fkey)
        c_start, c_last, c_cnt = got[:3]
        got_acc = iter(got[3:3 + len(acc_leaves)])
        c_acc = tree_map(lambda _: next(got_acc), state["acc"])
        c_open, c_sid, f_minseg, f_maxseg = got[3 + len(acc_leaves):]
        c_open = c_open > 0
        m_start = torch.where(fcont, torch.minimum(c_start, fmin), fmin)
        m_last = torch.where(fcont, torch.maximum(c_last, fmax), fmax)
        m_cnt = torch.where(fcont, c_cnt + fcnt, fcnt)
        m_acc = tree_map(
            lambda f, m: torch.where(fcont.reshape(fcont.shape + (1,) * (f.ndim - 1)), m, f),
            facc, self._fold(c_acc, facc))
        frag_rank = iota - f_minseg
        flast = fvalid & (iota == f_maxseg)
        # group 1: carried sessions closed by in-batch evidence (the key's
        # first fragment does NOT chain into the open session)
        g1 = fvalid & ffirst & ~fcont & c_open
        g1_id = c_sid
        # group 2: every non-final fragment is a closed session
        g2 = fvalid & ~flast
        n1 = segment_reduce(g1.to(_I32), fkey, fvalid, K)
        g2_id = c_sid + _lookup(n1, fkey) + frag_rank
        nclosed = segment_reduce(g2.to(_I32), fkey, fvalid, K)
        sid2 = state["sid"] + n1 + nclosed
        # floor: newest closed end per key
        ends1 = segment_reduce(torch.where(g1, c_last, _IMIN), fkey, fvalid, K,
                               combine=torch.maximum, identity=_IMIN)
        ends2 = segment_reduce(torch.where(g2, m_last, _IMIN), fkey, fvalid, K,
                               combine=torch.maximum, identity=_IMIN)
        floor2 = torch.maximum(state["floor"], torch.maximum(ends1, ends2))
        # final fragments become/extend the carried open session
        upd = torch.where(flast, fkey, K)
        open2 = _set_drop(state["open"], upd, torch.ones_like(flast))
        start2 = _set_drop(state["start"], upd, m_start)
        last2 = _set_drop(state["last"], upd, m_last)
        cnt2 = _set_drop(state["cnt"], upd, m_cnt)
        acc2 = tree_map(lambda t, v: _set_drop(t, upd, v), state["acc"], m_acc)
        # group 3: the data-dependent triggerer over the [K] open table
        wm2 = torch.maximum(state["wm"], torch.where(batch.valid, batch.ts, _IMIN).max())
        g3 = open2 & self.spec.fired_session(last2, wm2)
        open3 = open2 & ~g3
        floor3 = torch.where(g3, torch.maximum(floor2, last2), floor2)
        sid3 = sid2 + g3.to(_I32)
        out = self._emit_rows(
            C, K,
            (g1, fkey, g1_id, c_last, c_start, c_cnt, c_acc),
            (g2, fkey, g2_id, m_last, m_start, m_cnt, m_acc),
            (g3, sid2, last2, start2, cnt2, acc2))
        new_state = dict(
            state, open=open3, start=start2, last=last2, cnt=cnt2, sid=sid3, acc=acc2,
            floor=floor3, wm=wm2,
            closed=state["closed"] + _isum(g1) + _isum(g2) + _isum(g3),
            old=count_drops(state["old"], "old_drops", _isum(old)))
        if self._event_time:
            # arrival lateness vs the post-batch watermark (state only)
            new_state["lat_hist"] = _et.lateness_update(state["lat_hist"], wm2, batch.ts,
                                                        batch.valid)
        return new_state, out

    def _emit_rows(self, C, K, g1, g2, g3):
        """The [2C + K] output batch from the three close groups."""
        m1, k1, i1, e1, s1, n1, a1 = g1
        m2, k2, i2, e2, s2, n2, a2 = g2
        m3, i3, e3, s3, n3, a3 = g3
        kk = torch.arange(K, dtype=_I32, device=m1.device)
        cat = lambda a, b, c: torch.cat([a, b, c], 0)  # noqa: E731
        payload = {"agg": tree_map(cat, a1, a2, a3), "start": cat(s1, s2, s3),
                   "end": cat(e1, e2, e3), "n": cat(n1, n2, n3)}
        return Batch(key=cat(k1, k2, kk), id=cat(i1, i2, i3), ts=cat(e1, e2, e3),
                     payload=payload, valid=cat(m1, m2, m3))

    def flush(self, state):
        """EOS fires every open session regardless of the watermark."""
        if state is None or int(state["eos"]):
            return state, None
        K = self._slots
        C = self._cap or K
        dev = state["open"].device
        g3 = state["open"]
        z = torch.zeros((C,), dtype=_I32, device=dev)
        zb = torch.zeros((C,), dtype=torch.bool, device=dev)
        zacc = tree_map(lambda t: torch.zeros((C,) + tuple(t.shape[1:]), dtype=t.dtype,
                                              device=dev), state["acc"])
        out = self._emit_rows(
            C, K, (zb, z, z, z, z, z, zacc), (zb, z, z, z, z, z, zacc),
            (g3, state["sid"], state["last"], state["start"], state["cnt"], state["acc"]))
        if self._tier is not None:
            # open sessions are pinned hot, so the EOS fire covers every live
            # session
            out = self._true_keys(state, out)
        state = dict(state)
        state["closed"] = state["closed"] + _isum(g3)
        state["sid"] = state["sid"] + g3.to(_I32)
        state["open"] = torch.zeros_like(state["open"])
        state["eos"] = torch.ones_like(state["eos"])
        self.collect_stats(state)
        return state, out

    def collect_stats(self, state: Any = None) -> None:
        if state is None:
            return
        old = int(state["old"])
        self._stats[0].tuples_dropped_old = old
        closed = int(state["closed"])
        if closed > self._closed_synced:
            _control.bump("sessions_closed", closed - self._closed_synced)
            self._closed_synced = closed
        counters = {"sessions_closed": closed, "old_drops": old}
        if self._tier is not None:
            from .join import tier_counters
            counters.update(tier_counters(state, self._tier))
            counters["overflow_drops"] = int(state["ovf"])
        self._publish_stage_counters(counters)

    def drop_counters(self, state: Any = None) -> dict:
        if state is None:
            return {}
        out = {"old_drops": int(state["old"])}
        if self._tier is not None:
            out["overflow_drops"] = int(state["ovf"])
        return out

    def event_time_stats(self, state: Any = None):
        """Watermark-map section: open-session pressure (count and the
        oldest open session's age against the watermark), close and drop
        totals, the tier's numbers and the arrival-lateness histogram."""
        if state is None:
            return None
        wm = int(state["wm"])
        open_mask = state["open"].cpu()
        n_open = int(open_mask.sum())
        out = {
            "watermark_ts": wm,
            "gap": self.spec.gap,
            "delay": self.spec.delay,
            "open_sessions": n_open,
            "key_slots": self._slots,
            "occupancy_pct": round(100.0 * n_open / self._slots, 2),
            "sessions_closed": int(state["closed"]),
            "old_drops": int(state["old"]),
        }
        if self._tier is not None:
            out["tier"] = {**slot_directory_stats(state), **self._tier.controller.stats()}
            out["overflow_drops"] = int(state["ovf"])
        if n_open:
            # how much event time the watermark has advanced past the first
            # event of the longest-open session
            out["oldest_open_age"] = max(0, wm - int(state["start"].cpu()[open_mask].min()))
        counts = _et.read_hist(state.get("lat_hist"))
        if counts is not None:
            out["lateness"] = {"in": _et.summarize(counts)}
        return out


__all__ = ["SessionWindow"]

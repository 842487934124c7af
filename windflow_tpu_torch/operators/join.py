"""Streaming joins: stream-table enrichment and the interval join.

Counterpart of ``windflow_tpu/operators/join.py``. Both sides arrive merged
in one stream; ``side_fn`` separates them per tuple.

- :class:`StreamTableJoin`: build-side tuples upsert into the versioned,
  watermark-consistent JoinTable of ``ops/lookup.py`` (last writer by
  ``(ts, id)`` wins per key); probe-side tuples then read the table as of
  the build watermark through ``join_probe`` (kernel K5 on the card). Each
  apply runs K5 twice: once inside the upsert (the ring keys' existing
  slots) and once for the probe.
- :class:`IntervalJoin`: both sides live in bounded ring archives; each
  arriving tuple is matched against the opposite archive (a left tuple also
  against the batch's own right tuples) and every pair is emitted once, when
  its later member arrives. The JAX package computes a ``[C, N]`` compare
  and ``max_matches`` one-hot select-sums over it, outside any Pallas
  kernel; the port computes the match mask once, counts it in column
  blocks, finds each lane's first ``max_matches`` candidate columns with
  two batched ``searchsorted`` calls (the block, then the column in it),
  and gathers from them, row chunk by row chunk (:data:`PROBE_CHUNK_CELLS`),
  in plain PyTorch. A gather gives what the
  select-sum gives: ``jnp.sum``'s dtype, 0 in every field of an unmatched
  pick, and a float ``-0.0`` read as ``+0.0``.

Tiered keyed state (``tiered=``, ``state/tiered.py``): a StreamTableJoin
keeps its hot rows in a table of ``hot_capacity`` slots and the rest in a
host store. Before the upsert, every batch key and every parked pending key
missing from the hot table is resolved from the spill outbox or the cold
tier (``join_table_tier_resolve``; the cold read is the ``cold_probe``
kernel on the card) and readmitted; a winning upsert that finds no free
slot is diverted to the outbox; a probe that still misses reads the outbox,
then the resolved cold value; the coldest rows beyond the hot target are
evicted to the outbox. Results do not depend on tier placement.

An IntervalJoin with ``tiered=`` keeps each side's archive as a ring plus a
cold tier (``state/tiered.py::ArchiveTier``, a multimap host store): a live
row the ring is about to overwrite (an ``arch_drop`` untiered) is packed into
the side's spill outbox first (``_append_spill``); each probe then also sees
the opposite side's outbox rows and up to ``readmit_rows`` cold rows of its
key (``_cold_candidates``; the cold read is the ``cold_fetch`` kernel on the
card), both masked by the same eviction frontier as the ring. The extra
candidates come after the archive and the batch lanes, so the ``max_matches``
truncation order is the JAX package's. Each cold row a batch fetches is
counted once in ``state["readmits"]`` (deduplicated by tuple id).

Event-time monitoring (``_event_time``, set by the chain): a StreamTableJoin
carries a build-side lateness histogram (``lat_hist``) and an IntervalJoin
one a side (``lat_l``, ``lat_r``), each updated once a batch against the
post-batch watermark; ``event_time_stats`` reads them with the table's or
the archives' occupancy for the monitoring snapshot.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .. import control as _control
from ..basic import DEFAULT_MAX_KEYS, routing_modes_t
from ..batch import (Batch, TupleRef, jax_unflatten, map_tuples, spec_of, tree_map,
                     vmap_lanes)
from ..ops.lookup import (JOIN_KEY_SENTINEL, _plus_zero, _set_drop, count_drops,
                          join_table_init, join_table_probe, join_table_tier_evict,
                          join_table_tier_fallback, join_table_tier_init,
                          join_table_stats, join_table_tier_resolve,
                          join_table_tier_stats, join_table_tier_touch, join_table_upsert)
from ..observability import event_time as _et
from ..ops.segment import segment_rank
from ..ops.window_reduce import sum_dtype
from ..state.tiered import ArchiveTier, JoinTableTier, TierConfig
from .base import Basic_Operator

_I32 = torch.int32
_IMIN = -(1 << 31)

#: cells of the ``[rows, candidates]`` match mask an interval-join probe
#: computes at once: rows are taken in chunks of ``PROBE_CHUNK_CELLS //
#: candidates`` (peak about 6 bytes a cell: the int32 time difference and
#: two bool masks)
PROBE_CHUNK_CELLS = 1 << 27
#: candidate columns a block of the probe's two-level prefix count (below
#: 256: a block's count is summed in uint8)
PROBE_BLOCK = 128


class StreamTableJoin(Basic_Operator):
    """Stream-table join over one merged (tagged) stream.

    ``side_fn(t) -> bool`` marks build-side tuples (table upserts); every
    other tuple probes. ``key_fn(t) -> i32`` gives the join key on both sides
    (keys must lie strictly inside the int32 range); ``val_fn(t) -> pytree of
    scalars`` the build side's value columns. ``emit(t, v) -> payload``
    shapes the probe side's output (default: the probe payload merged with
    the value dict). An upsert becomes visible once the build watermark
    passes ``ts + delay``. Misses are masked out (inner join) unless
    ``emit_misses=True`` (left join, zero values). ``tiered=`` (a dict of
    :class:`~windflow_tpu_torch.state.tiered.TierConfig` fields, True, or
    None to consult ``WF_STATE_TIERED``) keeps cold rows in a host store."""

    routing = routing_modes_t.KEYBY

    def __init__(self, side_fn: Callable, key_fn: Callable, val_fn: Callable, *,
                 num_slots: int = DEFAULT_MAX_KEYS, pending: Optional[int] = None,
                 delay: int = 0, emit: Optional[Callable] = None,
                 emit_misses: bool = False, tiered=None,
                 name: str = "stream_table_join", parallelism: int = 1, device=None):
        super().__init__(name, parallelism, device)
        if delay < 0:
            raise ValueError(f"{name}: delay (lateness) must be >= 0")
        self.side_fn = side_fn
        self.key_fn = key_fn
        self.val_fn = val_fn
        self.num_slots = int(num_slots)
        self.pending = None if pending is None else int(pending)
        self.delay = int(delay)
        self.emit_misses = bool(emit_misses)
        self.emit = emit
        self._pending_resolved = pending
        self._tier_cfg = TierConfig.resolve(tiered)
        self._tier = None
        self._cap_resolved = None
        self._version_synced = 0

    def bind_geometry(self, batch_capacity: int) -> None:
        self._cap_resolved = int(batch_capacity)
        # one batch of pure build tuples always fits, with headroom for
        # upserts parked behind a nonzero delay
        self._pending_resolved = (2 * int(batch_capacity) if self.pending is None
                                  else self.pending)

    def _emit(self, t: TupleRef, v):
        if self.emit is not None:
            return self.emit(t, v)
        if isinstance(t.data, dict) and isinstance(v, dict):
            return {**t.data, **v}
        return {"probe": t.data, "join": v}

    def _emit_lanes(self, batch: Batch, vals):
        return vmap_lanes(
            lambda k, i, ts, d, v: self._emit(TupleRef(key=k, id=i, ts=ts, data=d), v),
            batch.key, batch.id, batch.ts, batch.payload, vals)

    def _val_spec(self, payload_spec):
        return spec_of(map_tuples(self.val_fn, Batch.empty(1, payload_spec, self.device)))

    def init_state(self, payload_spec: Any):
        pending = self._pending_resolved or 2 * DEFAULT_MAX_KEYS
        vspec = self._val_spec(payload_spec)
        if self._tier_cfg is None:
            state = join_table_init(self.num_slots, pending, vspec, self.device)
            if self._event_time:
                state["lat_hist"] = _et.lateness_init(device=self.device)
            return state
        hot = int(self._tier_cfg.hot_capacity or self.num_slots)
        # the hot capacity this run was built with (last write wins)
        _control.set_gauge("hot_capacity", float(hot))
        # the per-batch admission bound: the resolve pass may readmit every
        # distinct batch key and every parked pending key, so the hot table
        # keeps that many slots free
        self._reserve = (self._cap_resolved or DEFAULT_MAX_KEYS) + pending
        self._hot_target = max(1, hot - self._reserve)
        outbox = int(self._tier_cfg.outbox or 4 * self._reserve)
        state = join_table_tier_init(join_table_init(hot, pending, vspec, self.device),
                                     outbox, vspec)
        self._tier = JoinTableTier(self.name, vspec, self._tier_cfg, self.device)
        if self._event_time:
            state["lat_hist"] = _et.lateness_init(device=self.device)
        return state

    def tier_controllers(self):
        return (self._tier.controller,) if self._tier is not None else ()

    def out_spec(self, payload_spec: Any) -> Any:
        b = Batch.empty(1, payload_spec, self.device)
        vals = tree_map(lambda s: torch.zeros((1,), dtype=s.dtype, device=self.device),
                        self._val_spec(payload_spec))
        return spec_of(self._emit_lanes(b, vals))

    def apply(self, state, batch: Batch):
        build = map_tuples(self.side_fn, batch).to(torch.bool) & batch.valid
        probe_mask = batch.valid & ~build
        jkey = map_tuples(self.key_fn, batch).to(torch.int32)
        bval = map_tuples(self.val_fn, batch)
        tier = self._tier
        if tier is not None:
            # miss -> readmit before the upsert, for every batch key and every
            # parked pending key (a parked upsert's key stays hot until it
            # applies, so the never-roll-back check sees the applied version)
            state, fb_vals, fb_ok = join_table_tier_resolve(
                state, torch.cat([jkey, state["pkey"]]),
                torch.cat([batch.valid, state["pok"]]), tier.lookup)
        # upsert before probe: a probe sees every build tuple up to and
        # including its own batch (the as-of-watermark read point); a tiered
        # table diverts an upsert that finds no free slot to the outbox
        state = join_table_upsert(state, jkey, bval, batch.ts, batch.id, build,
                                  delay=self.delay, divert=tier is not None)
        if self._event_time:
            # build-side lateness vs the post-upsert watermark (state only)
            state = dict(state, lat_hist=_et.lateness_update(
                state["lat_hist"], state["wm"], batch.ts, build))
        vals, hit = join_table_probe(state, jkey, probe_mask)
        if tier is not None:
            # a probe that still misses reads the newest outbox entry of its
            # key, then the resolve pass's cold value
            C = batch.capacity
            ob_vals, ob_hit = join_table_tier_fallback(state, jkey, probe_mask & ~hit)
            fb = fb_ok[:C] & probe_mask & ~hit & ~ob_hit
            vals = tree_map(lambda v, o, f: torch.where(
                ob_hit, o.to(v.dtype), torch.where(fb, f[:C].to(v.dtype), v)),
                vals, ob_vals, fb_vals)
            hit = hit | ob_hit | fb
            state = join_table_tier_touch(state, jkey, batch.valid)
            state = join_table_tier_evict(state, self._hot_target)
        payload = self._emit_lanes(batch, vals)
        valid = probe_mask & (hit | self.emit_misses)
        return state, batch.replace(payload=payload, valid=valid)

    def collect_stats(self, state: Any = None) -> None:
        if state is None:
            return
        v = int(state["version"])
        if v != self._version_synced:
            self._version_synced = v
            _control.set_gauge("join_table_version", float(v))
        counters = {"join_table_version": v, "overflow_drops": int(state["dropped"])}
        if self._tier is not None:
            counters.update(tier_counters(state, self._tier))
        self._publish_stage_counters(counters)

    def drop_counters(self, state: Any = None) -> dict:
        if state is None:
            return {}
        return {"overflow_drops": int(state["dropped"])}

    def event_time_stats(self, state: Any = None):
        """Watermark-map section: build watermark, applied version, table
        occupancy, pending-ring pressure, the tier's numbers and the
        build-side lateness histogram."""
        if state is None:
            return None
        out = join_table_stats(state)
        out["delay"] = self.delay
        if self._tier is not None:
            out["tier"] = {**join_table_tier_stats(state), **self._tier.controller.stats()}
        counts = _et.read_hist(state.get("lat_hist"))
        if counts is not None:
            out["lateness"] = {"build": _et.summarize(counts)}
        return out


def tier_counters(state, tier) -> dict:
    """Stage counters and gauges of one tiered keyed table: the device
    movement counters and hot and cold occupancy."""
    used_key = "used" if "used" in state else "hused"
    return {"state_spills": int(state["spills"]),
            "state_readmits": int(state["readmits"]),
            "state_compactions": tier.controller.counters()["state_compactions"],
            "tier_hot_used": int(state[used_key].sum()),
            "tier_cold_keys": tier.store.key_count()}


def _default_pair_emit(l: TupleRef, r: TupleRef):
    """Union payload of a matched pair: dict payloads merge under ``l_``/
    ``r_`` prefixes; other pytrees nest under ``{"l": ..., "r": ...}``."""
    if isinstance(l.data, dict) and isinstance(r.data, dict):
        out = {f"l_{k}": v for k, v in l.data.items()}
        out.update({f"r_{k}": v for k, v in r.data.items()})
        return out
    return {"l": l.data, "r": r.data}


def _pick(a: torch.Tensor, flat: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """``a[flat]`` where ``hit``, else 0, as the JAX package's one-hot
    ``jnp.sum(jnp.where(sel, a, 0), axis=1)`` over ``n = len(a)`` candidates
    gives it: in ``jnp.sum``'s dtype, and a float ``-0.0`` as ``+0.0`` (the
    sum starts from ``+0.0``; XLA drops a sum over one element)."""
    n = a.shape[0]
    dt = sum_dtype(a.dtype)
    g = a.index_select(0, flat)
    keep = hit.reshape(hit.shape + (1,) * (g.ndim - 1))
    if dt == torch.uint32 and a.dtype != torch.uint32:
        # torch has no uint16 ``where`` on the card: widen first
        return torch.where(keep, g.to(torch.int64), 0).to(torch.uint32)
    g = g.to(dt)
    g = torch.where(keep, g, torch.zeros((), dtype=dt, device=g.device))
    return _plus_zero(g) if dt.is_floating_point and n >= 2 else g


class IntervalJoin(Basic_Operator):
    """Interval (stream-stream) join over one merged (tagged) stream.

    A pair ``(l, r)`` matches when ``l.key == r.key`` and ``r.ts - l.ts in
    [lower, upper]``. Both archives evict exactly the tuples the watermark
    (as of the start of the batch) proves can no longer match (``l.ts <
    wm - delay - upper``, ``r.ts < wm - delay + lower``). Each arriving tuple
    probes the opposite archive (plus, for the left side, the batch's own
    right tuples), so every pair is emitted once, when its later member
    arrives. Up to ``max_matches`` matches per probing tuple are kept
    (candidate order: archive slot, then batch lane); overflow is counted in
    ``state["match_drops"]``, live archive slots overwritten by the ring in
    ``state["arch_drops"]``. ``ts_l``/``ts_r`` optionally extract per-side
    event time from the payload.

    ``emit(l, r) -> payload`` shapes the output (default: ``l_``/``r_``
    prefixed union). Output rows are ``[left probes C*M ; right probes
    C*M]``, lane-major: key and id are the probing lane's, ts is
    ``max(l.ts, r.ts)``. ``tiered=`` (a dict of
    :class:`~windflow_tpu_torch.state.tiered.TierConfig` fields, True, or None
    to consult ``WF_STATE_TIERED``) spills ring-overwritten live rows to a
    cold tier instead of dropping them (see the module docstring)."""

    routing = routing_modes_t.KEYBY

    def __init__(self, side_fn: Callable, lower: int, upper: int, *,
                 archive: Optional[int] = None, max_matches: int = 4,
                 delay: int = 0, emit: Optional[Callable] = None,
                 ts_l: Optional[Callable] = None, ts_r: Optional[Callable] = None,
                 tiered=None, name: str = "interval_join", parallelism: int = 1,
                 device=None):
        super().__init__(name, parallelism, device)
        self.side_fn = side_fn
        self.lower = int(lower)
        self.upper = int(upper)
        self.archive = None if archive is None else int(archive)
        self.max_matches = int(max_matches)
        self.delay = int(delay)
        self.emit = emit or _default_pair_emit
        self.ts_l = ts_l
        self.ts_r = ts_r
        if self.max_matches < 1:
            raise ValueError(f"{name}: max_matches must be >= 1")
        if self.delay < 0:
            raise ValueError(f"{name}: delay (lateness) must be >= 0")
        self._archive_resolved = archive
        # tiered archives: ring-overwritten live rows spill to per-side
        # multimap host stores and come back as extra match candidates
        self._tier_cfg = TierConfig.resolve(tiered)
        self._tier_l = self._tier_r = None
        self._cap_resolved = None

    def bind_geometry(self, batch_capacity: int) -> None:
        self._cap_resolved = int(batch_capacity)
        a = self.archive if self.archive is not None else 2 * int(batch_capacity)
        if a < batch_capacity:
            raise ValueError(
                f"{self.name}: archive={a} < batch capacity {batch_capacity} — one "
                f"batch's ring writes would collide (size archive >= the batch "
                f"capacity)")
        self._archive_resolved = int(a)

    def out_capacity(self, in_capacity: int) -> int:
        return 2 * in_capacity * self.max_matches

    def _emit_lanes(self, lk, li, lt, ld, rk, ri, rt, rd):
        return vmap_lanes(
            lambda a, b, c, d, e, f, g, h: self.emit(TupleRef(key=a, id=b, ts=c, data=d),
                                                     TupleRef(key=e, id=f, ts=g, data=h)),
            lk, li, lt, ld, rk, ri, rt, rd)

    def out_spec(self, payload_spec: Any) -> Any:
        b = Batch.empty(1, payload_spec, self.device)
        return spec_of(self._emit_lanes(b.key, b.id, b.ts, b.payload,
                                        b.key, b.id, b.ts, b.payload))

    def init_state(self, payload_spec: Any):
        A = self._archive_resolved or 2 * DEFAULT_MAX_KEYS
        dev = self.device

        def side():
            return {"key": torch.full((A,), JOIN_KEY_SENTINEL, dtype=_I32, device=dev),
                    "ts": torch.zeros((A,), dtype=_I32, device=dev),
                    "id": torch.zeros((A,), dtype=_I32, device=dev),
                    "ok": torch.zeros((A,), dtype=torch.bool, device=dev),
                    "pay": tree_map(lambda s: torch.zeros((A,) + tuple(s.shape),
                                                          dtype=s.dtype, device=dev),
                                    payload_spec)}
        s = lambda v: torch.tensor(v, dtype=_I32, device=dev)  # noqa: E731
        state = {"l": side(), "r": side(), "lcur": s(0), "rcur": s(0), "wm": s(_IMIN),
                 "match_drops": s(0), "arch_drops": s(0)}
        if self._tier_cfg is not None:
            S = int(self._tier_cfg.outbox or 4 * (self._cap_resolved or DEFAULT_MAX_KEYS))
            for p in ("l", "r"):
                state[f"{p}okey"] = torch.full((S,), JOIN_KEY_SENTINEL, dtype=_I32,
                                               device=dev)
                state[f"{p}ots"] = torch.zeros((S,), dtype=_I32, device=dev)
                state[f"{p}oid"] = torch.zeros((S,), dtype=_I32, device=dev)
                state[f"{p}opay"] = tree_map(
                    lambda sp: torch.zeros((S,) + tuple(sp.shape), dtype=sp.dtype,
                                           device=dev), payload_spec)
                state[f"{p}ocnt"] = s(0)
            state["spills"] = s(0)
            state["readmits"] = s(0)
            # per-side retention bounds: the arithmetic the ring eviction
            # applies
            self._tier_l = ArchiveTier(self.name, payload_spec, self._tier_cfg, "l",
                                       lambda wm: wm - self.delay - self.upper, dev)
            self._tier_r = ArchiveTier(self.name, payload_spec, self._tier_cfg, "r",
                                       lambda wm: wm - self.delay + self.lower, dev)
        if self._event_time:
            # per-side lateness histograms (event-time monitoring only)
            state["lat_l"] = _et.lateness_init(device=dev)
            state["lat_r"] = _et.lateness_init(device=dev)
        return state

    def tier_controllers(self):
        if self._tier_l is None:
            return ()
        return (self._tier_l.controller, self._tier_r.controller)

    def _event_ts(self, batch, is_l):
        if self.ts_l is None and self.ts_r is None:
            return batch.ts
        tl = map_tuples(self.ts_l, batch) if self.ts_l is not None else batch.ts
        tr = map_tuples(self.ts_r, batch) if self.ts_r is not None else batch.ts
        return torch.where(is_l, tl.to(_I32), tr.to(_I32))

    def _probe(self, pmask, pkey, pts, ck, cts, cok):
        """Each probing lane's first ``max_matches`` candidates with an equal
        key and ``cts - pts`` in ``[0, upper - lower]`` (wrapping int32):
        returns (matched bool[C, M], candidate column int64[C, M], overflow).
        Callers pre-shift ``pts`` and ``cts`` so the window is ``[0, span]``.

        Per row chunk: the mask (two passes: the wrapped difference tested
        unsigned, ``cts - (pts ^ INT_MIN) <= span + INT_MIN`` in signed
        int32, then the key compare), its count in column blocks of
        :data:`PROBE_BLOCK`, and for the (j+1)-th match the block where the
        blocks' prefix count reaches j+1 and the column inside it where the
        block's own prefix count does."""
        M, Bk = self.max_matches, PROBE_BLOCK
        span = self.upper - self.lower
        C, n = pkey.shape[0], ck.shape[0]
        dev = pkey.device
        nb = max(1, -(-n // Bk))
        pad = nb * Bk - n
        # disabled and padding slots get keys no int32 key equals
        cka = torch.where(cok, ck.to(torch.int64), 1 << 40)
        cts_p = cts
        if pad:
            cka = torch.cat([cka, torch.full((pad,), 1 << 40, dtype=torch.int64,
                                             device=dev)])
            cts_p = torch.cat([cts, torch.zeros((pad,), dtype=cts.dtype, device=dev)])
        pk = pkey.to(torch.int64)
        q = pts ^ _IMIN                       # pts - INT_MIN, wrapping
        bound = min(span, (1 << 31) - 1) + _IMIN
        want = torch.arange(1, M + 1, dtype=_I32, device=dev)
        rows = max(1, PROBE_CHUNK_CELLS // (nb * Bk))
        matched, cols, counts = [], [], []
        for r0 in range(0, C, rows):
            r1 = min(C, r0 + rows)
            R = r1 - r0
            if span < 0:                      # an empty window matches nothing
                m = torch.zeros((R, nb * Bk), dtype=torch.bool, device=dev)
            else:
                m = (cts_p[None, :] - q[r0:r1, None]) <= bound
                m &= pk[r0:r1, None] == cka[None, :]
            blocks = m.view(R, nb, Bk)
            # a block counts at most PROBE_BLOCK (< 256) cells: summed as
            # bytes, no int32 copy of the mask is made
            bcs = torch.cumsum(blocks.view(torch.uint8).sum(2, dtype=torch.uint8), 1,
                               dtype=_I32)                                  # [R, nb]
            cnt = torch.where(pmask[r0:r1], bcs[:, -1], 0)
            hit = cnt[:, None] >= want[None, :]
            blk = torch.clamp(torch.searchsorted(bcs, want.expand(R, M).contiguous()),
                              max=nb - 1)                                   # [R, M]
            before = torch.where(blk > 0, bcs.gather(1, torch.clamp(blk - 1, min=0)), 0)
            inner = torch.cumsum(blocks.gather(1, blk[:, :, None].expand(R, M, Bk)), 2,
                                 dtype=_I32)                                # [R, M, Bk]
            off = torch.searchsorted(inner.view(R * M, Bk),
                                     (want[None, :] - before).reshape(R * M, 1))
            del m, blocks, inner
            matched.append(hit)
            cols.append(torch.where(hit, blk * Bk + off.view(R, M), 0))
            counts.append(cnt)
        cnt = torch.cat(counts)
        overflow = torch.clamp(cnt - M, min=0).sum(dtype=_I32)
        return torch.cat(matched), torch.cat(cols), overflow

    def _rows(self, batch, pmask, ets, cand, swap):
        """Output rows of one probe direction: ``cand`` is the candidate
        side's (key, ts, id, ok, pay); ``swap`` True when the PROBING lane is
        the right side (candidates are archived left tuples)."""
        M = self.max_matches
        ck, cts, cid, cok, cpay = cand
        # shift so _probe's [0, upper-lower] window encodes r.ts - l.ts in
        # [lower, upper] for either direction: right probes negate the axis
        pts = ets + self.lower if not swap else -ets + self.lower
        matched, cols, overflow = self._probe(pmask, batch.key, pts, ck,
                                              cts if not swap else -cts, cok)
        flat, hit = cols.reshape(-1), matched.reshape(-1)
        k2, x2, id2 = (_pick(a, flat, hit) for a in (ck, cts, cid))
        pay2 = tree_map(lambda a: _pick(a, flat, hit), cpay)
        rep = lambda a: a.repeat_interleave(M, dim=0)  # noqa: E731
        # the probing side's ref carries the EXTRACTED event time
        probe = (rep(batch.key), rep(batch.id), rep(ets), tree_map(rep, batch.payload))
        cref = (k2, id2, x2, pay2)
        lref, rref = (probe, cref) if not swap else (cref, probe)
        payload = self._emit_lanes(*lref, *rref)
        return hit, probe[0], torch.maximum(lref[2], rref[2]), probe[1], payload, overflow

    def _append(self, side, cur, mask, key, ets, batch):
        """Ring-append the batch's ``mask`` lanes into one side's archive;
        returns (side, cur, live slots overwritten)."""
        A = side["key"].shape[0]
        csum = torch.cumsum(mask.to(_I32), 0, dtype=_I32)
        pos = torch.remainder(cur + csum - 1, A)
        idx = torch.where(mask, pos, A)
        overwrote = (mask & side["ok"].index_select(0, pos.long())).sum(dtype=_I32)
        out = {"key": _set_drop(side["key"], idx, key),
               "ts": _set_drop(side["ts"], idx, ets),
               "id": _set_drop(side["id"], idx, batch.id),
               "ok": _set_drop(side["ok"], idx, torch.ones_like(mask)),
               "pay": tree_map(lambda t, v: _set_drop(t, idx, v), side["pay"],
                               batch.payload)}
        return out, torch.remainder(cur + csum[-1], A), overwrote

    def _append_spill(self, state, p, side, cur, mask, key, ets, batch):
        """Tiered ring-append: a live row the ring is about to overwrite
        (still inside its match window: an untiered ``arch_drop``) is packed
        into the side's spill outbox first; only a full outbox still drops.
        Returns (side, cur, dropped, spilled, outbox updates)."""
        A = side["key"].shape[0]
        csum = torch.cumsum(mask.to(_I32), 0, dtype=_I32)
        pos = torch.remainder(cur + csum - 1, A)
        idx = torch.where(mask, pos, A)
        pl = pos.long()
        ow = mask & side["ok"].index_select(0, pl)
        S = state[f"{p}okey"].shape[0]
        orank = torch.cumsum(ow.to(_I32), 0, dtype=_I32) - 1
        fits = ow & (state[f"{p}ocnt"] + orank < S)
        opos = torch.where(fits, state[f"{p}ocnt"] + orank, S)
        upd = {f"{p}okey": _set_drop(state[f"{p}okey"], opos, side["key"].index_select(0, pl)),
               f"{p}ots": _set_drop(state[f"{p}ots"], opos, side["ts"].index_select(0, pl)),
               f"{p}oid": _set_drop(state[f"{p}oid"], opos, side["id"].index_select(0, pl)),
               f"{p}opay": tree_map(lambda t, a: _set_drop(t, opos, a.index_select(0, pl)),
                                    state[f"{p}opay"], side["pay"]),
               f"{p}ocnt": state[f"{p}ocnt"] + fits.sum(dtype=_I32)}
        out = {"key": _set_drop(side["key"], idx, key),
               "ts": _set_drop(side["ts"], idx, ets),
               "id": _set_drop(side["id"], idx, batch.id),
               "ok": _set_drop(side["ok"], idx, torch.ones_like(mask)),
               "pay": tree_map(lambda t, v: _set_drop(t, idx, v), side["pay"],
                               batch.payload)}
        dropped = (ow & ~fits).sum(dtype=_I32)
        spilled = fits.sum(dtype=_I32)
        return out, torch.remainder(cur + csum[-1], A), dropped, spilled, upd

    def _cold_candidates(self, state, batch, lmask, rmask, horizon):
        """Extra match candidates from the cold tiers: each side's spill
        outbox (unsettled spills stay probeable) and up to ``readmit_rows``
        host-store rows a probing lane (one ``cold_fetch`` a side), both
        masked by the per-side eviction frontier of the rings. Returns (right
        extras for left probes, left extras for right probes, rows fetched).
        ``state_readmits`` counts cold rows served as candidates: the fetch is
        read-only, so a cold row inside the window counts once a probing
        batch."""
        M = int(self._tier_cfg.readmit_rows)
        dev = batch.key.device

        def fetch(tier, want, frontier):
            res = tier.fetch(batch.key, want)
            mask = res[0] & want[:, None] & (res[1] >= frontier)
            # candidates are global (every probing lane sees all of them): a
            # row fetched by N lanes of one key must appear once, so dedup by
            # tuple id (unique a row)
            ids_flat = res[2].reshape(-1)
            mflat = mask.reshape(-1)
            uniq = mflat & (segment_rank(ids_flat, mflat) == 0)
            k2 = torch.where(uniq, batch.key.repeat_interleave(M), JOIN_KEY_SENTINEL)
            pay = jax_unflatten(batch.payload, [r.reshape((-1,) + tuple(r.shape[2:]))
                                                for r in res[3:]])
            return (k2, res[1].reshape(-1), ids_flat, uniq, pay), uniq.sum(dtype=_I32)

        def outbox(p, frontier):
            S = state[f"{p}okey"].shape[0]
            live = ((torch.arange(S, dtype=_I32, device=dev) < state[f"{p}ocnt"])
                    & (state[f"{p}ots"] >= frontier))
            return (state[f"{p}okey"], state[f"{p}ots"], state[f"{p}oid"], live,
                    state[f"{p}opay"])

        r_front = horizon + self.lower
        l_front = horizon - self.upper
        r_fetch, n_r = fetch(self._tier_r, lmask, r_front)
        l_fetch, n_l = fetch(self._tier_l, rmask, l_front)
        return [outbox("r", r_front), r_fetch], [outbox("l", l_front), l_fetch], n_r + n_l

    def apply(self, state, batch: Batch):
        is_l = map_tuples(self.side_fn, batch).to(torch.bool)
        lmask = batch.valid & is_l
        rmask = batch.valid & ~is_l
        ets = self._event_ts(batch, is_l)
        wm = torch.maximum(state["wm"], torch.where(batch.valid, ets, _IMIN).max())
        # evict against the watermark AS OF THE START of the batch: the
        # lateness contract only promises that future arrivals stay at or
        # above (previous wm) - delay
        horizon = state["wm"] - self.delay
        l, r = dict(state["l"]), dict(state["r"])
        l["ok"] = l["ok"] & (l["ts"] >= horizon - self.upper)
        r["ok"] = r["ok"] & (r["ts"] >= horizon + self.lower)
        # left probes see archived rights PLUS the batch's own rights (an
        # in-batch pair counts once, from the left side); tiered, each side's
        # spill outbox and cold rows come after them, so the candidate rank
        # (the max_matches truncation order) is unchanged while the cold
        # tiers are empty
        cat = lambda a, b: torch.cat([a, b], 0)  # noqa: E731
        r_cand = (cat(r["key"], torch.where(rmask, batch.key, JOIN_KEY_SENTINEL)),
                  cat(r["ts"], ets), cat(r["id"], batch.id), cat(r["ok"], rmask),
                  tree_map(cat, r["pay"], batch.payload))
        l_cand = (l["key"], l["ts"], l["id"], l["ok"], l["pay"])
        tier_upd = {}
        if self._tier_l is not None:
            r_extra, l_extra, n_fetched = self._cold_candidates(state, batch, lmask,
                                                                rmask, horizon)

            def join_c(base, extras):
                parts = [base, *extras]
                return tuple(torch.cat([x[f] for x in parts], 0) for f in range(4)) + (
                    tree_map(lambda *xs: torch.cat(xs, 0), *[x[4] for x in parts]),)
            r_cand = join_c(r_cand, r_extra)
            l_cand = join_c(l_cand, l_extra)
            tier_upd["readmits"] = state["readmits"] + n_fetched
        lrows = self._rows(batch, lmask, ets, r_cand, swap=False)
        rrows = self._rows(batch, rmask, ets, l_cand, swap=True)
        out = Batch(key=cat(lrows[1], rrows[1]), id=cat(lrows[3], rrows[3]),
                    ts=cat(lrows[2], rrows[2]), payload=tree_map(cat, lrows[4], rrows[4]),
                    valid=cat(lrows[0], rrows[0]))
        if self._tier_l is not None:
            l, lcur, odl, spl, upd_l = self._append_spill(
                state, "l", l, state["lcur"], lmask, batch.key, ets, batch)
            r, rcur, odr, spr, upd_r = self._append_spill(
                state, "r", r, state["rcur"], rmask, batch.key, ets, batch)
            tier_upd.update(upd_l)
            tier_upd.update(upd_r)
            tier_upd["spills"] = state["spills"] + spl + spr
        else:
            l, lcur, odl = self._append(l, state["lcur"], lmask, batch.key, ets, batch)
            r, rcur, odr = self._append(r, state["rcur"], rmask, batch.key, ets, batch)
        new_state = dict(
            state, l=l, r=r, lcur=lcur, rcur=rcur, wm=wm,
            match_drops=count_drops(state["match_drops"], "match_drops",
                                    lrows[5] + rrows[5]),
            arch_drops=count_drops(state["arch_drops"], "arch_drops", odl + odr))
        new_state.update(tier_upd)
        if self._event_time:
            # per-stream lateness vs the post-batch watermark (state only)
            new_state["lat_l"] = _et.lateness_update(state["lat_l"], wm, ets, lmask)
            new_state["lat_r"] = _et.lateness_update(state["lat_r"], wm, ets, rmask)
        return new_state, out

    def collect_stats(self, state: Any = None) -> None:
        """Publish the drop counters and, tiered, the cold tiers' counters
        (:meth:`stage_counters`)."""
        if state is None:
            return
        counters = dict(self.drop_counters(state))
        if self._tier_l is not None:
            stores = (self._tier_l.store, self._tier_r.store)
            counters.update({
                "state_spills": int(state["spills"]),
                "state_readmits": int(state["readmits"]),
                "state_compactions": sum(st.compacted_rows for st in stores),
                "tier_cold_keys": sum(st.key_count() for st in stores)})
        self._publish_stage_counters(counters)

    def drop_counters(self, state: Any = None) -> dict:
        if state is None:
            return {}
        return {"match_drops": int(state["match_drops"]),
                "arch_drops": int(state["arch_drops"])}

    def event_time_stats(self, state: Any = None):
        """Watermark-map section: each side's archive fill, the eviction
        frontiers, the drops, the tiers' numbers and the per-stream lateness
        histograms."""
        if state is None:
            return None
        A = int(state["l"]["key"].shape[0])
        lfill = int(state["l"]["ok"].sum())
        rfill = int(state["r"]["ok"].sum())
        wm = int(state["wm"])
        horizon = wm - self.delay
        out = {
            "watermark_ts": wm,
            "delay": self.delay,
            "archive_slots": A,
            "l_fill": lfill, "r_fill": rfill,
            "l_fill_pct": round(100.0 * lfill / A, 2),
            "r_fill_pct": round(100.0 * rfill / A, 2),
            "evict_frontier_l_ts": horizon - self.upper,
            "evict_frontier_r_ts": horizon + self.lower,
            "match_drops": int(state["match_drops"]),
            "arch_drops": int(state["arch_drops"]),
        }
        if self._tier_l is not None:
            stores = (self._tier_l.store, self._tier_r.store)
            out["tier"] = {
                "outbox_depth": int(state["locnt"]) + int(state["rocnt"]),
                "state_spills": int(state["spills"]),
                "state_readmits": int(state["readmits"]),
                "l_cold_rows": len(stores[0]), "r_cold_rows": len(stores[1]),
                "state_compactions": sum(st.counters()["state_compactions"]
                                         for st in stores)}
        lat = {}
        for stream, key in (("l", "lat_l"), ("r", "lat_r")):
            counts = _et.read_hist(state.get(key))
            if counts is not None:
                lat[stream] = _et.summarize(counts)
        if lat:
            out["lateness"] = lat
        return out


__all__ = ["IntervalJoin", "StreamTableJoin"]

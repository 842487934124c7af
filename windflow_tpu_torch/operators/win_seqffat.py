"""Win_SeqFFAT — incremental associative window engine with pane-level sharing.

Counterpart of ``windflow_tpu/operators/win_seqffat.py`` (reference
``wf/win_seqffat.hpp`` + ``wf/flatfat.hpp``): every tuple is lifted once and
folded into its ``(key, pane)`` partial in a ``[K, P]`` pane ring; a fired
window combines its ``win_len / pane_len`` pane partials. Two paths:

- **global time** (TB windows, ``global_time``, the default for TB): the
  watermark and the fired-window frontier are scalars. Insert
  (:meth:`_g_insert`): the occupancy counts through
  ``ops/histogram.py::keyed_pane_histogram`` (kernel K1); for a count lift
  (``lift(t) == 1``, the YSB windowed count, with ``torch.add``) those
  counts ARE the partials; any other lift folds through
  ``ops/segment.py::segment_reduce`` (kernel K3 for integer sums). Emit
  (:meth:`_g_emit`): the fired range ``[lo, hi)`` is shared by every key,
  so the output is a ``[K, W]`` grid gathered from the ring with one
  ``index_select``, and fired panes are cleared back to the identity.
- **per key** (CB windows, and TB with ``global_time=False``; ``bench.py``'s
  keyed-CB config): each key has its own count, watermark and frontier.
  Insert (:meth:`_insert`): a CB tuple's pane comes from its key's count
  (``table_lookup``, kernel K2) plus its rank among the batch's lanes of
  that key; a TB tuple behind its key's fired horizon (K2 again) is dropped
  and counted. Partials, occupancy counts and per-key counts fold through
  ``segment_reduce`` (K3 for the counts and integer sums, the fixed-order
  float fold for float sums), the pane ids and watermarks through a max.
  Emit (:meth:`_emit`): the fired windows of every key are packed into W
  output rows by a prefix sum over the keys and a ``searchsorted``, all on
  the device, and each row combines its ``wpanes`` partials.

Any associative ``combine`` with its ``identity`` works; non-add combines
fold partials with ``segment_reduce``'s segmented scan (max and min with a
``scatter_reduce``) and reduce a window's panes with the JAX package's
pairwise tree (``ops/segment.py::tree_reduce``). The port returns new state
tensors (the functional contract); it does not update the state it was given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..basic import routing_modes_t, DEFAULT_MAX_KEYS
from ..batch import (Batch, CTRL_DTYPE, TupleRef, abstract_spec, map_tuples, tree_leaves,
                     tree_map)
from ..observability import event_time as _et
from ..ops.histogram import keyed_pane_histogram
from ..ops.lookup import table_lookup
from ..ops.segment import (as_identity, identity_full, segment_rank, segment_reduce,
                           tree_reduce)
from .base import Basic_Operator
from .window import WindowSpec


@dataclasses.dataclass(frozen=True)
class FFATState:
    """State of the per-key path."""

    panes: Any                 # pytree [K, P, ...] ring of pane partials
    pane_count: torch.Tensor   # i32[K, P] tuples folded into each pane slot
    pane_of: torch.Tensor      # i32[K, P] pane id held by each ring slot (-1 empty)
    count: torch.Tensor        # i32[K] tuples seen per key (CB position source)
    wm: torch.Tensor           # i32[K] per-key max ts
    next_win: torch.Tensor     # i32[K] next window id to fire, per key
    dropped_old: torch.Tensor  # i32[] tuples dropped as OLD (TB stragglers)
    lat_hist: Any = None       # i32[NB] lateness histogram (event time, TB)


@dataclasses.dataclass(frozen=True)
class GFFATState:
    """State of the global-time TB path."""

    panes: Any                 # pytree [K, P, ...] ring of pane partials
    cnt: torch.Tensor          # i32[K, P] tuples per pane slot (emptiness filter)
    wm: torch.Tensor           # i32[] global max ts seen
    next_win: torch.Tensor     # i32[] next window id to fire (global)
    dropped_old: torch.Tensor  # i32[] tuples dropped as OLD (pane < fired horizon)
    lat_hist: Any = None       # i32[NB] lateness histogram (event time)


class Win_SeqFFAT(Basic_Operator):
    routing = routing_modes_t.KEYBY

    def __init__(self, lift: Callable, combine: Callable, *, spec: WindowSpec,
                 identity: Any = 0, num_keys: int = DEFAULT_MAX_KEYS,
                 pane_len: int = None, pane_capacity: int = None,
                 max_wins: int = None, name: str = "win_seqffat",
                 parallelism: int = 1, global_time: bool = None,
                 count_lift: bool = None, device=None):
        super().__init__(name, parallelism, device)
        self.global_time = (not spec.is_cb) if global_time is None else global_time
        if self.global_time and spec.is_cb:
            raise ValueError("global_time applies to TB windows only")
        self.lift = lift
        self.combine = combine
        #: a number, or a tensor (e.g. a 2x2 identity matrix) kept on the device
        self.identity = as_identity(identity, self.device)
        #: lift(t) == 1 for every t (windowed count): the pane update equals
        #: the occupancy histogram. None = detect in init_state.
        self.count_lift = count_lift
        self.spec = spec
        self.num_keys = int(num_keys)
        self.pane_len = pane_len or math.gcd(spec.win_len, spec.slide)
        if spec.win_len % self.pane_len or spec.slide % self.pane_len:
            raise ValueError("pane_len must divide both win_len and slide")
        self.wpanes = spec.win_len // self.pane_len     # panes per window
        self.spanes = spec.slide // self.pane_len       # panes per slide
        self._pane_capacity = pane_capacity
        self.P = None
        self.max_wins = max_wins
        self._w = None
        self.bind_geometry(256)        # provisional; the chain re-binds with real C

    def bind_geometry(self, batch_capacity: int) -> None:
        if self._pane_capacity is not None:
            self.P = _next_pow2(self._pane_capacity)
        elif self.spec.is_cb:
            self.P = _next_pow2(self.wpanes + batch_capacity // self.pane_len + 2)
        else:
            self.P = _next_pow2(self.wpanes
                                + max(64, batch_capacity // self.pane_len) + 2)

    def out_capacity(self, in_capacity: int) -> int:
        if self.global_time:
            return self.num_keys * self._resolve_w(in_capacity)
        return self._resolve_w(in_capacity)

    # ------------------------------------------------------------------ state

    def _lift_spec(self, payload_spec):
        return abstract_spec(lambda dev: map_tuples(self.lift,
                                                    Batch.empty(1, payload_spec, dev)))

    def _ident(self, dtype, shape=None) -> torch.Tensor:
        return identity_full(self.identity, dtype, self.device, shape)

    def init_state(self, payload_spec: Any):
        K, P, dev = self.num_keys, self.P, self.device
        panes = tree_map(lambda s: self._ident(s.dtype, (K, P) + tuple(s.shape)),
                         self._lift_spec(payload_spec))
        # lateness histogram: event-time monitoring on TB specs only (a CB
        # window has no event-time frontier); None is absent from the state
        lat = (_et.lateness_init(device=dev)
               if self._event_time and not self.spec.is_cb else None)
        if not self.global_time:
            keyed = lambda v: torch.full((K,), v, dtype=CTRL_DTYPE, device=dev)  # noqa: E731
            return FFATState(
                panes=panes, pane_count=torch.zeros((K, P), dtype=CTRL_DTYPE, device=dev),
                pane_of=torch.full((K, P), -1, dtype=CTRL_DTYPE, device=dev),
                count=keyed(0), wm=keyed(-1), next_win=keyed(0),
                dropped_old=torch.zeros((), dtype=CTRL_DTYPE, device=dev), lat_hist=lat)
        if self.count_lift is None:
            self.count_lift = _detect_count_lift(self.lift, payload_spec)
        scalar = lambda v: torch.tensor(v, dtype=CTRL_DTYPE, device=dev)  # noqa: E731
        return GFFATState(panes=panes, cnt=torch.zeros((K, P), dtype=CTRL_DTYPE, device=dev),
                          wm=scalar(-1), next_win=scalar(0), dropped_old=scalar(0),
                          lat_hist=lat)

    def out_spec(self, payload_spec: Any) -> Any:
        return self._lift_spec(payload_spec)

    # ---------------------------------------------------- global-time path (TB)

    def _g_insert(self, state: GFFATState, batch: Batch) -> GFFATState:
        """Fold a batch into the ``[K, P]`` pane ring. OLD tuples (pane behind
        the fired horizon) are dropped and counted."""
        K, P = self.num_keys, self.P
        pane = torch.div(batch.ts, self.pane_len, rounding_mode="floor")
        horizon = state.next_win * self.spanes       # first un-fired pane (global)
        valid = batch.valid & (pane >= horizon)
        n_dropped = (batch.valid & ~valid).sum(dtype=CTRL_DTYPE)
        cnt_upd = keyed_pane_histogram(batch.key, pane, valid, K, P)
        add = self.combine is torch.add
        if self.count_lift and add:
            # lift == 1: the value histogram IS the count histogram
            panes = tree_map(lambda t: t + cnt_upd.to(t.dtype), state.panes)
        else:
            seg = torch.where(valid, batch.key * P + torch.remainder(pane, P), K * P)
            upd = segment_reduce(map_tuples(self.lift, batch), seg, valid, K * P,
                                 combine=None if add else self.combine,
                                 identity=self.identity)
            comb = torch.add if add else self.combine
            panes = tree_map(
                lambda t, u: comb(t, u.reshape((K, P) + tuple(u.shape[1:]))),
                state.panes, upd)
        ts_max = torch.where(batch.valid, batch.ts, -1).max()
        wm_new = torch.maximum(state.wm, ts_max)
        lat = state.lat_hist
        if lat is not None:
            # observed lateness vs the post-batch global watermark
            lat = _et.lateness_update(lat, wm_new, batch.ts, batch.valid)
        return dataclasses.replace(
            state, panes=panes, cnt=state.cnt + cnt_upd, wm=wm_new,
            dropped_old=state.dropped_old + n_dropped, lat_hist=lat)

    def _g_emit(self, state: GFFATState, W_n: int, flush: bool):
        """Grid emission of the fired windows ``[lo, hi)``, at most ``W_n``.

        The fired windows' panes form a contiguous cyclic range of the ring
        starting at ``lo * spanes``; the JAX package rolls the ring to column 0
        and takes static indices. Folding the roll into the indices
        (``(lo * spanes + j) mod P``) gives the same columns with one
        ``index_select`` and keeps ``lo`` on the device (``torch.roll`` takes
        a host shift)."""
        K, P = self.num_keys, self.P
        s = self.spec
        dev = state.cnt.device
        lo = state.next_win
        if flush:
            hi = torch.maximum(lo, torch.div(state.wm, s.slide, rounding_mode="floor") + 1)
        else:
            hi = torch.maximum(lo, torch.div(state.wm - s.delay - s.win_len, s.slide,
                                             rounding_mode="floor") + 1)
        hi = torch.minimum(hi, lo + W_n)
        ar = torch.arange(W_n, dtype=CTRL_DTYPE, device=dev)
        wid = lo + ar                                             # [W_n]
        w_valid = ar < (hi - lo)
        static = (ar[:, None] * self.spanes
                  + torch.arange(self.wpanes, dtype=CTRL_DTYPE, device=dev)[None, :])
        cols = torch.remainder(lo * self.spanes + static, P).reshape(-1).long()

        def gat(tbl):                                             # [K, P, ...]
            g = tbl.index_select(1, cols)
            return g.reshape((K, W_n, self.wpanes) + tuple(tbl.shape[2:]))
        cnts = gat(state.cnt)                                     # [K, W_n, wpanes]
        win_cnt = cnts.sum(dim=2, dtype=CTRL_DTYPE)               # [K, W_n]

        def reduce_w(tbl):
            g = gat(tbl)
            if self.combine is not torch.add:
                return tree_reduce(self.combine, g, 2)
            m = (cnts > 0).reshape(cnts.shape + (1,) * (g.ndim - 3))
            return torch.where(m, g, torch.zeros((), dtype=g.dtype, device=dev)
                               ).sum(dim=2, dtype=g.dtype)
        results = tree_map(reduce_w, state.panes)                # [K, W_n, ...]

        valid = (win_cnt > 0) & w_valid[None, :]                  # empty windows not emitted
        res_ts = wid * s.slide + (s.win_len - 1)
        flat = lambda a: a.reshape((K * W_n,) + tuple(a.shape[2:]))  # noqa: E731
        out = Batch(
            key=flat(torch.arange(K, dtype=CTRL_DTYPE, device=dev)[:, None].expand(K, W_n)),
            id=flat(wid[None, :].expand(K, W_n)),
            ts=flat(res_ts[None, :].expand(K, W_n)),
            payload=tree_map(flat, results),
            valid=flat(valid))
        # clear fired panes [lo*spanes, hi*spanes): a cyclic interval of the ring
        first, last = lo * self.spanes, hi * self.spanes
        pos = torch.arange(P, dtype=CTRL_DTYPE, device=dev)
        clear = torch.remainder(pos - torch.remainder(first, P), P) < (last - first)
        panes = tree_map(
            lambda t: torch.where(_b(clear[None, :], t), self._ident(t.dtype), t), state.panes)
        cnt = torch.where(clear[None, :], 0, state.cnt)
        return dataclasses.replace(state, panes=panes, cnt=cnt, next_win=hi), out

    # ------------------------------------------------------------ per-key path

    def _insert(self, state: FFATState, batch: Batch) -> FFATState:
        """Lift each tuple and fold it into its ``(key, pane)`` partial (the
        FlatFAT leaf update and bubble, ``wf/flatfat.hpp:134-240``, as one
        segment reduction a batch). A ring slot whose pane id advanced starts
        again from the identity."""
        K, P = self.num_keys, self.P
        valid = batch.valid
        if self.spec.is_cb:
            rank = segment_rank(batch.key, valid)
            pos = table_lookup(state.count, batch.key, traced=True) + rank
            pane = torch.div(pos, self.pane_len, rounding_mode="floor")
            n_dropped = torch.zeros((), dtype=CTRL_DTYPE, device=valid.device)
        else:
            horizon = table_lookup(state.next_win, batch.key, traced=True) * self.spec.slide
            kept = valid & (batch.ts >= horizon)
            n_dropped = (valid & ~kept).sum(dtype=CTRL_DTYPE)
            valid = kept
            pane = torch.div(batch.ts, self.pane_len, rounding_mode="floor")
        seg = torch.where(valid, batch.key * P + torch.remainder(pane, P), K * P)
        add = self.combine is torch.add
        upd = segment_reduce(map_tuples(self.lift, batch), seg, valid, K * P,
                             combine=None if add else self.combine, identity=self.identity)
        ones = valid.to(CTRL_DTYPE)
        cnt_upd = segment_reduce(ones, seg, valid, K * P).reshape(K, P)
        pane_id_upd = segment_reduce(pane, seg, valid, K * P, combine=torch.maximum,
                                     identity=-1)
        touched = cnt_upd > 0
        new_pane_of = torch.where(touched, pane_id_upd.reshape(K, P), state.pane_of)
        fresh = touched & (new_pane_of != state.pane_of)

        def fold(tbl, u):
            u = u.reshape((K, P) + tuple(u.shape[1:]))
            t = torch.where(_b(fresh, tbl), self._ident(tbl.dtype), tbl)
            return torch.where(_b(touched, tbl), (torch.add if add else self.combine)(t, u), t)

        counts_add = segment_reduce(ones, batch.key, valid, K)
        ts_max = segment_reduce(batch.ts, batch.key, valid, K, combine=torch.maximum,
                                identity=-1)
        wm_new = torch.maximum(state.wm, ts_max)
        lat = state.lat_hist
        if lat is not None:
            # per-key TB path: lateness vs the largest per-key watermark (the
            # cross-key skew measure)
            lat = _et.lateness_update(lat, wm_new.max(), batch.ts, batch.valid)
        return dataclasses.replace(
            state, panes=tree_map(fold, state.panes, upd),
            pane_count=torch.where(fresh, 0, state.pane_count) + cnt_upd,
            pane_of=new_pane_of, count=state.count + counts_add, wm=wm_new,
            dropped_old=state.dropped_old + n_dropped, lat_hist=lat)

    def _emit(self, state: FFATState, W: int, flush: bool):
        """The fired windows of every key, packed into ``W`` output rows: key
        k's windows ``[lo_k, hi_k)`` take rows ``off_k ..`` of a prefix sum
        over the keys, and row r finds its key with a ``searchsorted``. All
        on the device (no host read), so the step can be captured; windows
        beyond ``W`` wait for the next batch."""
        K, P = self.num_keys, self.P
        s = self.spec
        dev = state.count.device
        floor = lambda a, b: torch.div(a, b, rounding_mode="floor")  # noqa: E731
        zero = torch.zeros((), dtype=CTRL_DTYPE, device=dev)
        if s.is_cb:
            hi = (torch.where(state.count > 0, floor(state.count - 1, s.slide) + 1, zero)
                  if flush else torch.clamp(floor(state.count - s.win_len, s.slide) + 1, min=0))
        else:
            hi = (torch.where(state.count > 0, floor(state.wm, s.slide) + 1, zero)
                  if flush else torch.clamp(floor(state.wm - s.delay - s.win_len, s.slide) + 1,
                                            min=0))
        lo = state.next_win
        n_f = torch.maximum(hi, lo) - lo
        csum = torch.cumsum(n_f, dim=0, dtype=CTRL_DTYPE)
        off = csum - n_f
        total = torch.clamp(csum[-1], max=W)
        w_idx = torch.arange(W, dtype=CTRL_DTYPE, device=dev)
        k_of = torch.searchsorted(csum, w_idx, right=True, out_int32=True)
        k_safe = torch.clamp(k_of, max=K - 1)
        kl = k_safe.long()
        wid = lo.index_select(0, kl) + (w_idx - off.index_select(0, kl))
        valid_w = w_idx < total
        emitted_k = torch.minimum(torch.clamp(total - off, min=0), n_f)

        # the wpanes partials of each window, reduced in pane order
        pane_ids = (wid * self.spanes)[:, None] + torch.arange(
            self.wpanes, dtype=CTRL_DTYPE, device=dev)[None, :]       # [W, wpanes]
        gflat = (k_safe[:, None] * P + torch.remainder(pane_ids, P)).reshape(-1).long()
        live = (state.pane_of.reshape(K * P).index_select(0, gflat).reshape(W, -1)
                == pane_ids) & valid_w[:, None]

        def gat_reduce(tbl):
            g = tbl.reshape((K * P,) + tuple(tbl.shape[2:])).index_select(0, gflat)
            g = g.reshape((W, self.wpanes) + tuple(tbl.shape[2:]))
            g = torch.where(_b(live, g), g, self._ident(g.dtype))
            if self.combine is torch.add:
                return g.sum(dim=1, dtype=g.dtype)
            return tree_reduce(self.combine, g, 1)

        res_ts = wid * s.slide + (s.win_len - 1) if not s.is_cb else torch.zeros_like(wid)
        out = Batch(key=k_safe, id=wid, ts=res_ts,
                    payload=tree_map(gat_reduce, state.panes), valid=valid_w)
        return dataclasses.replace(state, next_win=lo + emitted_k), out

    # ------------------------------------------------------------------ operator API

    def _resolve_w(self, capacity):
        if self.max_wins is not None:
            return self.max_wins
        if self.global_time:
            # windows drainable a step, bounded by what the pane ring holds
            return max(4, (self.P - self.wpanes) // self.spanes)
        W = max(16, -(-capacity // self.spec.slide) + 64)
        if W * self.wpanes > (1 << 22):
            # a window combines wpanes partials: the default budget implies a
            # [W, wpanes] gather a batch, so ask for an explicit budget
            raise ValueError(
                f"{self.name}: default fired-window budget W={W} with "
                f"{self.wpanes} panes/window implies a [{W}, {self.wpanes}] "
                f"gather per batch; pass max_wins= to bound it")
        return W

    def apply(self, state, batch: Batch):
        W = self._resolve_w(batch.capacity)
        self._w = W
        if self.global_time:
            state = self._g_insert(state, batch)
            return self._g_emit(state, W, flush=False)
        state = self._insert(state, batch)
        return self._emit(state, W, flush=False)

    def flush(self, state):
        W = self._w or self._resolve_w(256)
        emit = self._g_emit if self.global_time else self._emit
        state, out = emit(state, W, flush=True)
        self.collect_stats(state)
        if not bool(out.valid.any()):
            return state, None
        return state, out

    def collect_stats(self, state=None) -> None:
        """Sync the device-resident OLD-drop counter into the Stats_Record and
        the stage counters."""
        if state is None or not hasattr(state, "dropped_old"):
            return
        old = int(state.dropped_old)
        self._stats[0].tuples_dropped_old = old
        self._publish_stage_counters({"old_drops": old})

    def drop_counters(self, state=None) -> dict:
        if state is None or not hasattr(state, "dropped_old"):
            return {}
        return {"old_drops": int(state.dropped_old)}

    def event_time_stats(self, state=None):
        """Watermark-map section (TB specs): the frontier, the fired-window
        horizon, the arrived-but-unfired lag, OLD drops and the lateness
        histogram, whose ``recommend_delay`` names the smallest ``delay=``
        that would have kept the recorded stragglers."""
        if state is None or self.spec.is_cb:
            return None
        wm = int(state.wm.max())
        frontier = int(state.next_win.max()) * self.spec.slide
        out = {
            "watermark_ts": wm,
            "fire_frontier_ts": frontier,
            "lag": max(wm - frontier + 1, 0) if wm >= 0 else 0,
            "delay": self.spec.delay,
            "old_drops": int(state.dropped_old),
        }
        counts = _et.read_hist(getattr(state, "lat_hist", None))
        if counts is not None:
            out["lateness"] = {"in": _et.summarize(counts)}
        return out


def _detect_count_lift(lift, payload_spec) -> bool:
    """True iff ``lift`` provably returns the constant 1 for every tuple.

    ``torch.func.vmap`` cannot tell: it expands a constant to a batched
    ``[C]`` tensor. So the lift is traced once with ``make_fx`` on zero
    per-tuple probes shaped like ``payload_spec``: its graph output must not
    depend on any input, the graph must hold no random op, and its value
    must be the scalar 1. Data-dependent Python control flow fails the
    trace. Any doubt returns False (the general additive path, which gives
    the same panes)."""
    try:
        from torch.fx.experimental.proxy_tensor import make_fx

        z = torch.zeros((), dtype=CTRL_DTYPE)
        leaves = [torch.zeros(tuple(s.shape), dtype=s.dtype)
                  for s in tree_leaves(payload_spec)]

        def data_of(ls):
            it = iter(ls)
            return tree_map(lambda _: next(it), payload_spec)

        def f(k, i, ts, *ls):
            return lift(TupleRef(key=k, id=i, ts=ts, data=data_of(ls)))

        gm = make_fx(f)(z, z, z, *leaves)
        tainted = set()
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                tainted.add(node)
                continue
            if torch.Tag.nondeterministic_seeded in getattr(node.target, "tags", ()):
                return False
            deps = set()
            torch.fx.node.map_arg((node.args, node.kwargs), deps.add)
            if deps & tainted:
                if node.op == "output":
                    return False
                tainted.add(node)
        out = tree_leaves(f(z, z, z, *leaves))
        return (len(out) == 1 and isinstance(out[0], torch.Tensor)
                and out[0].shape == () and float(out[0]) == 1.0)
    except Exception:  # noqa: BLE001 — any doubt: not a count lift
        return False


def _b(mask, v):
    """``mask`` shaped to broadcast against ``v`` (trailing dims of 1)."""
    return mask.reshape(tuple(mask.shape) + (1,) * (v.ndim - mask.ndim))


def _next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p

"""Win_SeqFFAT — incremental associative window engine with pane-level sharing.

Counterpart of ``windflow_tpu/operators/win_seqffat.py`` (reference
``wf/win_seqffat.hpp`` + ``wf/flatfat.hpp``), global-time path: every tuple is
lifted once and folded into its ``(key, pane)`` partial in a ``[K, P]`` pane
ring; a fired window combines its ``win_len / pane_len`` pane partials. With a
shared event clock (TB windows, ``global_time``) the watermark and the
fired-window frontier are scalars, and each batch is:

- insert (:meth:`_g_insert`): the occupancy counts through
  ``ops/histogram.py::keyed_pane_histogram`` (kernel K1); for a count lift
  (``lift(t) == 1``, the YSB windowed count) those counts ARE the partials;
  any other additive lift folds through ``ops/segment.py::segment_reduce``
  (kernel K3 for integer values);
- emit (:meth:`_g_emit`): the fired range ``[lo, hi)`` is shared by every key,
  so the output is a ``[K, W]`` grid gathered from the ring with one
  ``index_select``, and fired panes are cleared back to the identity.

The port returns new state tensors (the functional contract); it does not
update the state it was given. Only ``torch.add`` is ported as a combine, and
the per-key path (CB windows, ``global_time=False``: ``_insert``/``_emit``)
raises until ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..basic import routing_modes_t, DEFAULT_MAX_KEYS
from ..batch import (Batch, CTRL_DTYPE, TupleRef, map_tuples, spec_of, tree_leaves,
                     tree_map)
from ..ops.histogram import keyed_pane_histogram
from ..ops.segment import segment_reduce
from .base import Basic_Operator
from .window import WindowSpec

_ITEM_9 = "ROADMAP Queue 1 item 9"


@dataclasses.dataclass(frozen=True)
class GFFATState:
    """State of the global-time TB path."""

    panes: Any                 # pytree [K, P, ...] ring of pane partials
    cnt: torch.Tensor          # i32[K, P] tuples per pane slot (emptiness filter)
    wm: torch.Tensor           # i32[] global max ts seen
    next_win: torch.Tensor     # i32[] next window id to fire (global)
    dropped_old: torch.Tensor  # i32[] tuples dropped as OLD (pane < fired horizon)


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
        if combine is not torch.add:
            raise NotImplementedError(
                f"{name}: only the torch.add combine is ported so far; other "
                f"associative combines come with {_ITEM_9}")
        self.lift = lift
        self.combine = combine
        self.identity = identity
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

    def _per_key_unported(self):
        raise NotImplementedError(
            f"{self.name}: the per-key window path (_insert/_emit: CB windows or "
            f"global_time=False) is not ported yet ({_ITEM_9})")

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
        return spec_of(map_tuples(self.lift, Batch.empty(1, payload_spec, self.device)))

    def init_state(self, payload_spec: Any):
        if not self.global_time:
            self._per_key_unported()
        if self.count_lift is None:
            self.count_lift = _detect_count_lift(self.lift, payload_spec)
        K, P, dev = self.num_keys, self.P, self.device
        scalar = lambda v: torch.tensor(v, dtype=CTRL_DTYPE, device=dev)  # noqa: E731
        return GFFATState(
            panes=tree_map(lambda s: torch.full((K, P) + tuple(s.shape), self.identity,
                                                dtype=s.dtype, device=dev),
                           self._lift_spec(payload_spec)),
            cnt=torch.zeros((K, P), dtype=CTRL_DTYPE, device=dev),
            wm=scalar(-1), next_win=scalar(0), dropped_old=scalar(0))

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
        if self.count_lift:
            # lift == 1: the value histogram IS the count histogram
            panes = tree_map(lambda t: t + cnt_upd.to(t.dtype), state.panes)
        else:
            seg = torch.where(valid, batch.key * P + torch.remainder(pane, P), K * P)
            upd = segment_reduce(map_tuples(self.lift, batch), seg, valid, K * P)
            panes = tree_map(lambda t, u: t + u.reshape((K, P) + tuple(u.shape[1:])),
                             state.panes, upd)
        ts_max = torch.where(batch.valid, batch.ts, -1).max()
        return dataclasses.replace(
            state, panes=panes, cnt=state.cnt + cnt_upd,
            wm=torch.maximum(state.wm, ts_max),
            dropped_old=state.dropped_old + n_dropped)

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
            lambda t: torch.where(clear.reshape((1, P) + (1,) * (t.ndim - 2)),
                                  torch.full((), self.identity, dtype=t.dtype, device=dev),
                                  t),
            state.panes)
        cnt = torch.where(clear[None, :], 0, state.cnt)
        return dataclasses.replace(state, panes=panes, cnt=cnt, next_win=hi), out

    # ------------------------------------------------------------------ operator API

    def _resolve_w(self, capacity):
        if self.max_wins is not None:
            return self.max_wins
        if self.global_time:
            return max(4, (self.P - self.wpanes) // self.spanes)
        self._per_key_unported()

    def apply(self, state, batch: Batch):
        if not self.global_time:
            self._per_key_unported()
        W = self._resolve_w(batch.capacity)
        self._w = W
        state = self._g_insert(state, batch)
        return self._g_emit(state, W, flush=False)

    def flush(self, state):
        if not self.global_time:
            self._per_key_unported()
        W = self._w or self._resolve_w(256)
        state, out = self._g_emit(state, W, flush=True)
        self.collect_stats(state)
        if not bool(out.valid.any()):
            return state, None
        return state, out

    def collect_stats(self, state=None) -> None:
        """Sync the device-resident OLD-drop counter into the Stats_Record."""
        if state is None or not hasattr(state, "dropped_old"):
            return
        self._stats[0].tuples_dropped_old = int(state.dropped_old)


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


def _next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p

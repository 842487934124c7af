"""Win_Seq — the sequential window engine, vectorized.

Counterpart of ``windflow_tpu/operators/win_seq.py`` (reference
``wf/win_seq.hpp:56-567`` with ``StreamArchive`` fused in). Per-key archives
live on the device as ring buffers ``[K, A]``; each micro-batch

1. scatters its tuples into the rings (:meth:`Win_Seq._insert`): arrival
   positions from the per-key count (``ops/lookup.py::table_lookup``, kernel
   K2; a TB window reads it with the purge horizon's ``next_win`` in one
   launch, ``table_lookup_many``) plus each lane's rank among its key's
   lanes, the counts added through
   ``segment_reduce`` (kernel K3) and the watermark through its max combine;
2. computes the FIRED window range per key with the batch-level triggerers of
   ``window.py`` and gathers up to ``W`` fired windows as rows ``[W, L]``
   (:meth:`Win_Seq._emit`);
3. applies the user window function across the window axis with
   ``torch.func.vmap``; an ``Iterable.sum`` in it is one call of kernel K6
   (``ops/window_reduce.py``) over all ``W`` rows.

User function flavours (``meta.classify_window_flavour``): non-incremental
``f(wid, iterable)``, and incremental ``f(wid, t, acc) -> acc``, folded by a
Python loop over the row length of one vmapped step (``_fold_windows``; JAX
uses ``lax.scan``).

CB windows index per-key arrival positions; TB windows index timestamps with
per-key watermarks and ``delay`` lateness. Windows beyond the per-batch budget
``W`` defer to the next batch. Emission order is per-key ascending window id.

The archive rings are updated in place (a 2^21-slot ring over 512 keys is
4 GiB a field, too large to copy per batch), so ``apply`` and ``flush``
consume the state they are given, as the JAX bench step's donated state is:
the call marks it, and a second call on it raises, as JAX does for a donated
buffer. Carry on from the state a call returns; a snapshot to come back to
is a copy (``convert.state_to_numpy``). ``count``, ``wm`` and ``next_win``
are new tensors.

Window parallelism across a mesh (``set_window_sharding``, Win_Farm's
distribution): the fired-window ``[W]`` rows, their gathers and the window
function, are computed in blocks of ``W/p`` rows, one block a position along
the mesh axis, and laid end to end (``parallel/sharding.py::ShardedChain``
sets it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..basic import routing_modes_t, role_t, DEFAULT_MAX_KEYS
from ..batch import Batch, CTRL_DTYPE, TupleRef, abstract_spec, tree_map
from ..context import RuntimeContext
from ..meta import (RICH_PARAM_NAMES, classify_window, classify_window_flavour,
                    classify_winupdate)
from ..ops.lookup import table_lookup, table_lookup_many
from ..ops.segment import _bmask, segment_rank, segment_reduce
from .base import Basic_Operator
from .window import Iterable, WindowSpec


@dataclasses.dataclass(frozen=True)
class WinSeqState:
    arch_payload: Any           # pytree [K, A, ...]
    arch_id: torch.Tensor       # i32[K, A] global tuple id of each slot
    arch_ts: torch.Tensor       # i32[K, A]
    arch_pos: torch.Tensor      # i32[K, A] arrival position held by slot (-1 = empty)
    count: torch.Tensor         # i32[K] tuples archived per key
    wm: torch.Tensor            # i32[K] per-key max ts seen
    next_win: torch.Tensor      # i32[K] next window id to fire

    def consume(self, who: str) -> None:
        """Mark this state consumed; raise if an earlier call did (a step
        updates the rings in place, so a consumed state no longer holds the
        archive it names)."""
        if getattr(self, "_consumed", False):
            raise RuntimeError(
                f"{who}: this WinSeqState was consumed by an earlier apply, flush "
                f"or captured step (the archive rings are updated in place); carry "
                f"on from the state that call returned, or restore a copy "
                f"(convert.state_to_numpy / state_from_numpy)")
        object.__setattr__(self, "_consumed", True)


class Win_Seq(Basic_Operator):
    routing = routing_modes_t.KEYBY

    def __init__(self, win_fn: Callable, spec: WindowSpec, *,
                 incremental: Optional[bool] = None, init_acc: Any = None,
                 num_keys: int = DEFAULT_MAX_KEYS, archive_capacity: int = None,
                 max_wins: int = None, tb_capacity: int = None,
                 name: str = "win_seq", parallelism: int = 1,
                 role: role_t = role_t.SEQ, context=None, device=None):
        super().__init__(name, parallelism, device)
        self.win_fn = win_fn
        self.spec = spec
        if incremental is None:
            incremental, self.is_rich = classify_window_flavour(win_fn)
        elif incremental:
            self.is_rich = classify_winupdate(win_fn)
        else:
            self.is_rich = classify_window(win_fn)
        self.incremental = incremental
        self.init_acc = init_acc
        if incremental and init_acc is None:
            raise ValueError(
                f"{name}: incremental window function f(wid, t, acc) -> acc "
                f"requires init_acc. (If this callable is actually a rich "
                f"NON-incremental f(wid, iterable, ctx), name its context "
                f"parameter one of {RICH_PARAM_NAMES} or pass incremental=False "
                f"— 3-positional-arg flavours are separated by the trailing "
                f"parameter's name.)")
        self.context = context or RuntimeContext(parallelism, 0)
        if self.is_rich and incremental:
            self._fn = lambda w, t, a: win_fn(w, t, a, self.context)
        elif self.is_rich:
            self._fn = lambda w, it: win_fn(w, it, self.context)
        else:
            self._fn = win_fn
        self.num_keys = int(num_keys)
        self.role = role
        self._archive_capacity = archive_capacity
        self._tb_capacity = tb_capacity
        self.A = None                  # resolved in bind_geometry
        self.max_wins = max_wins       # resolved at first apply if None
        self._w = None
        #: devices of the positions the fired-window rows split over
        #: (``set_window_sharding``); None computes them as one block
        self._wdevs = None
        #: rows each position computed in the last emission (window sharding)
        self.window_rows = None
        self.bind_geometry(256)        # provisional; the chain re-binds with real C

    def bind_geometry(self, batch_capacity: int) -> None:
        L = self.spec.win_len
        if self._archive_capacity is not None:
            self.A = _next_pow2(self._archive_capacity)
        elif self.spec.is_cb:
            # the ring must survive one whole batch landing on a single key
            # before the fire phase runs, plus the open-window span
            self.A = _next_pow2(L + batch_capacity)
        else:
            self.A = _next_pow2(self._tb_capacity or 2 * batch_capacity)

    @property
    def row_len(self) -> int:
        """L of the ``[W, L]`` window rows: win_len for CB, the ring for TB."""
        return self.spec.win_len if self.spec.is_cb else self.A

    # ------------------------------------------------------------------ state

    def init_state(self, payload_spec: Any):
        K, A, dev = self.num_keys, self.A, self.device

        def mk(s):
            return torch.zeros((K, A) + tuple(s.shape), dtype=s.dtype, device=dev)
        ctrl = lambda shape, v: torch.full(shape, v, dtype=CTRL_DTYPE, device=dev)  # noqa: E731
        return WinSeqState(
            arch_payload=tree_map(mk, payload_spec),
            arch_id=ctrl((K, A), 0), arch_ts=ctrl((K, A), 0), arch_pos=ctrl((K, A), -1),
            count=ctrl((K,), 0), wm=ctrl((K,), -1), next_win=ctrl((K,), 0))

    def out_spec(self, payload_spec: Any) -> Any:
        """The result spec, from the window function run abstractly on one
        probe row (``batch.abstract_spec``; JAX reads it with
        ``jax.eval_shape``): ``Iterable.sum`` takes K6's plain version on
        meta tensors, so building a chain launches nothing."""
        n = 1 if self.incremental else self.row_len   # one fold step: the carry's spec

        def build(dev):
            row = lambda s: torch.zeros((1, n) + tuple(s.shape), dtype=s.dtype,  # noqa: E731
                                        device=dev)
            ctrl = torch.zeros((1, n), dtype=CTRL_DTYPE, device=dev)
            return self._window_results(torch.zeros((1,), dtype=CTRL_DTYPE, device=dev),
                                        tree_map(row, payload_spec), ctrl, ctrl,
                                        torch.zeros((1, n), dtype=torch.bool, device=dev))
        return abstract_spec(build)

    # ------------------------------------------------------------------ insert

    def _insert(self, state: WinSeqState, batch: Batch) -> WinSeqState:
        K, A = self.num_keys, self.A
        valid = batch.valid
        if self.spec.is_cb:
            count_k = table_lookup(state.count, batch.key, traced=True)
        else:
            # both per-key reads in one K2 launch; drop OLD tuples: they
            # precede the purge horizon (already-fired windows)
            next_k, count_k = table_lookup_many((state.next_win, state.count), batch.key)
            valid = valid & (batch.ts >= next_k * self.spec.slide)
        rank = segment_rank(batch.key, valid)
        pos = count_k + rank
        flat = batch.key * A + torch.remainder(pos, A)
        # The JAX form scatters with mode="drop" at an out-of-range index for
        # invalid lanes. Here every lane that writes nothing repeats the first
        # writing lane's write (same slot, same value), so index_put_ needs no
        # host sync to compact the lanes and its result does not depend on
        # the order of the writes: writing lanes hit distinct slots while one
        # key receives at most A lanes a batch, which the default ring sizing
        # guarantees. With no writing lane, every lane rewrites slot 0 with
        # its own content. ``first`` stays a [1] device index: a 0-d tensor
        # index would read it on the host, which a CUDA-graph capture refuses.
        write = valid & (batch.key >= 0) & (batch.key < K)
        first = torch.argmax(write.to(torch.uint8)).view(1)
        any_write = write.index_select(0, first)
        target = torch.where(write, flat,
                             torch.where(any_write, flat.index_select(0, first), 0)).long()

        def scat(tbl, v):
            rows = tbl.view((K * A,) + tuple(tbl.shape[2:]))
            fill = torch.where(_bmask(any_write, v[:1]), v.index_select(0, first), rows[:1])
            rows.index_put_((target,), torch.where(_bmask(write, v), v, fill))
            return tbl

        counts_add = segment_reduce(valid.to(CTRL_DTYPE), batch.key, valid, K)
        ts_max = segment_reduce(batch.ts, batch.key, valid, K,
                                combine=torch.maximum, identity=-1)
        return dataclasses.replace(
            state,
            arch_payload=tree_map(scat, state.arch_payload, batch.payload),
            arch_id=scat(state.arch_id, batch.id),
            arch_ts=scat(state.arch_ts, batch.ts),
            arch_pos=scat(state.arch_pos, pos),
            count=state.count + counts_add,
            wm=torch.maximum(state.wm, ts_max))

    # ------------------------------------------------------------------ fire

    def _resolve_w(self, capacity: int) -> int:
        if self.max_wins is not None:
            return self.max_wins
        W = max(16, -(-capacity // self.spec.slide) + 64)
        L = self.row_len
        if W * L > (1 << 22):
            # an adversarial slide (e.g. slide=1 at a large batch) would imply
            # a [W, L] gather per batch per payload leaf: ask for an explicit
            # budget instead of allocating it silently
            raise ValueError(
                f"{self.name}: default fired-window budget W={W} with window row "
                f"length L={L} implies a [{W}, {L}] gather per batch "
                f"({W * L} elements per payload leaf); pass max_wins= to bound the "
                f"per-batch fired-window budget")
        return W

    def set_window_sharding(self, mesh, axis: str) -> None:
        """Cross-device window parallelism (Win_Farm's distribution,
        ``wf/wf_nodes.hpp:157-204`` / ``wf/win_farm.hpp:165-175``): partition
        the fired-window ``[W]`` axis over mesh axis ``axis``. Each position
        along it gathers and computes its ``W/p`` window rows on its device;
        the archive stays where the state's placement puts it (replicated
        unless a sharded chain splits it by key)."""
        line = mesh.line((0,) * mesh.devices.ndim, axis)
        self._wdevs = [mesh.devices[c] for c in line]

    def _fired_range(self, state: WinSeqState, flush: bool):
        s = self.spec
        if s.is_cb:
            hi = s.flush_hi_cb(state.count) if flush else s.fired_hi_cb(state.count)
        else:
            hi = (s.flush_hi_tb(state.wm, state.count > 0) if flush
                  else s.fired_hi_tb(state.wm))
        return state.next_win, torch.maximum(hi, state.next_win)

    def _window_results(self, wid, data, ids, ts, mask):
        """The window function over every row: ``[W]`` results (a pytree)."""
        if self.incremental:
            return _fold_windows(self._fn, wid, data, ids, ts, mask, self.init_acc)
        fn = self._fn
        out = torch.func.vmap(lambda w, d, i, t, m: fn(w, Iterable(d, i, t, m)))(
            wid, data, ids, ts, mask)
        return tree_map(lambda t: torch.as_tensor(t).to(wid.device), out)

    def _emit(self, state: WinSeqState, W: int, flush: bool):
        """Emit up to W fired windows (per-key ascending wid). Returns (state, Batch)."""
        K, A = self.num_keys, self.A
        s = self.spec
        dev = state.count.device
        lo, hi = self._fired_range(state, flush)
        n_f = hi - lo
        csum = torch.cumsum(n_f, 0, dtype=CTRL_DTYPE)
        off = csum - n_f
        total = csum[-1] if K > 0 else torch.zeros((), dtype=CTRL_DTYPE, device=dev)
        w_idx = torch.arange(W, dtype=CTRL_DTYPE, device=dev)
        k_of = torch.searchsorted(csum, w_idx, right=True).to(CTRL_DTYPE)
        k_safe = torch.clamp(k_of, max=K - 1)
        kl = k_safe.long()
        wid = lo[kl] + (w_idx - off[kl])
        n_emit = torch.clamp(total, max=W)
        valid_w = w_idx < n_emit

        # advance next_win past emitted windows
        new_next = lo + torch.minimum(torch.clamp(n_emit - off, min=0), n_f)

        def rows(r: slice, on: torch.device):
            """Rows ``r`` of the emission: their gathers on the archive's
            device, the window function on ``on``."""
            wid_r, ks, kl_r, ok = wid[r], k_safe[r], kl[r], valid_w[r]
            if s.is_cb:
                L = s.win_len
                p = wid_r[:, None] * s.slide + torch.arange(L, dtype=CTRL_DTYPE,
                                                            device=dev)[None, :]
                gflat = (ks[:, None] * A + torch.remainder(p, A)).long()   # [w, L]

                def gat(tbl):
                    return tbl.reshape((K * A,) + tuple(tbl.shape[2:]))[gflat]
                content_mask = (p < state.count[kl_r][:, None]) & ok[:, None]
                # stale-slot guard: the slot must actually hold position p
                content_mask &= gat(state.arch_pos) == p
                data = tree_map(gat, state.arch_payload)
                ids, tss = gat(state.arch_id), gat(state.arch_ts)
                res_ts = torch.where(content_mask, tss, -1).amax(dim=1)
            else:
                # TB: full-ring rows masked by ts-in-range
                def gat(tbl):
                    return tbl.index_select(0, kl_r)                    # [w, A, ...]
                tss = gat(state.arch_ts)
                poss = gat(state.arch_pos)
                w_start = (wid_r * s.slide)[:, None]
                content_mask = ((poss >= 0) & (tss >= w_start)
                                & (tss < w_start + s.win_len) & ok[:, None])
                # ring-overwrite guard: the slot must hold a live (not yet
                # overwritten) position
                cnt = state.count[kl_r][:, None]
                content_mask &= poss >= torch.clamp(cnt - A, min=0)
                data = tree_map(gat, state.arch_payload)
                ids = gat(state.arch_id)
                res_ts = wid_r * s.slide + (s.win_len - 1)
                # a TB window with no content never fires in the reference
                # (Triggerer_TB only triggers on tuples)
                ok = ok & content_mask.any(dim=1)
            to = lambda t: t.to(on)  # noqa: E731
            res = self._window_results(to(wid_r), tree_map(to, data), to(ids), to(tss),
                                       to(content_mask))
            return res_ts, tree_map(lambda t: t.to(dev), res), ok

        if self._wdevs is None or len(self._wdevs) == 1:
            res_ts, results, valid_w = rows(slice(None), dev)
        else:
            n = len(self._wdevs)
            step = -(-W // n)
            cuts = [(j * step, min(W, (j + 1) * step)) for j in range(n)]
            self.window_rows = [max(0, b - a) for a, b in cuts]
            parts = [rows(slice(a, b), d) for (a, b), d in zip(cuts, self._wdevs) if b > a]
            res_ts = torch.cat([pt[0] for pt in parts])
            results = tree_map(lambda *xs: torch.cat(xs), *[pt[1] for pt in parts])
            valid_w = torch.cat([pt[2] for pt in parts])
        out = Batch(key=k_safe, id=wid, ts=res_ts, payload=results, valid=valid_w)
        return dataclasses.replace(state, next_win=new_next), out

    # ------------------------------------------------------------------ operator API

    def out_capacity(self, in_capacity: int) -> int:
        return self._resolve_w(in_capacity)

    def apply(self, state: WinSeqState, batch: Batch):
        state.consume(self.name)
        W = self._resolve_w(batch.capacity)
        self._w = W
        state = self._insert(state, batch)
        return self._emit(state, W, flush=False)

    def flush(self, state: WinSeqState):
        """EOS: emit every window with content, up to W a call; one device
        read tells whether anything was emitted."""
        state.consume(self.name)
        W = self._w or self._resolve_w(256)
        state, out = self._emit(state, W, flush=True)
        if not bool(out.valid.any()):
            return state, None
        return state, out


def _fold_windows(fn, wids, data, ids, ts, mask, init_acc):
    """Incremental path: the user fold over each row's slots in order, one
    vmapped step per slot (JAX: ``lax.scan`` under ``vmap``). Absent slots
    (mask False) keep the accumulator (``wf/win_seq.hpp:389-397``)."""
    dev = wids.device
    W, L = mask.shape

    def step(acc, wid, d, i, t, m):
        new = fn(wid, TupleRef(key=wid, id=i, ts=t, data=d), acc)
        return tree_map(lambda a, n: torch.where(m, n, a), acc, new)

    vstep = torch.func.vmap(step)
    acc = tree_map(lambda a: torch.as_tensor(a).to(dev).expand(
        (W,) + tuple(torch.as_tensor(a).shape)).clone(), init_acc)
    for l in range(L):
        acc = vstep(acc, wids, tree_map(lambda x: x[:, l], data), ids[:, l], ts[:, l],
                    mask[:, l])
        acc = tree_map(lambda t: torch.as_tensor(t).to(dev), acc)
    return acc


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p

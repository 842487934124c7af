"""Explicit collectives over a mesh axis: the reference's cross-replica
exchanges as functions of sharded tensors.

Counterpart of ``windflow_tpu/parallel/collective.py``, which writes them as
``jax.shard_map`` programs. Here each function takes sharded inputs
(:class:`~.mesh.ShardedTensor`, or a global tensor it places itself) and
returns sharded outputs. It runs its local function once a position of
this process, and exchanges between the positions of each group along the
axis (the positions that differ only in that coordinate) explicitly:

- within this process, a copy between positions;
- across processes (an axis of ``multihost.make_dcn_ici_mesh`` that holds one
  position of each process, in rank order), ``torch.distributed``:
  ``all_reduce``, ``all_gather_into_tensor``, ``all_to_all_single``, and
  ``isend``/``irecv`` for the ring. Under ``gloo`` a CUDA tensor passes
  through the host for the exchange.

- :func:`wmr_map_reduce`: Win_MapReduce with the MAP partition axis split over
  positions and the REDUCE combine as an all-reduce (WinMap_Emitter + REDUCE,
  ``wf/win_mapreduce.hpp:180-230``, ``wf/wm_nodes.hpp:45-181``).
- :func:`ring_pane_windows`: sliding windows over a pane axis split in
  contiguous blocks, the successor panes a block lacks pulled around the ring
  (Pane_Farm's pane sharing, ``wf/pane_farm.hpp:175-213``, across positions).
- :func:`keyed_all_to_all` / :func:`keyed_all_to_all_lossless`: every row to
  the position that owns its key (the KF_Emitter / ``create_sub_batch``
  exchange, ``wf/kf_nodes.hpp:74-90``, ``wf/standard_nodes_gpu.hpp:52-238``).

Static shapes throughout: fixed per-destination capacity and validity masks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..batch import jax_leaves, jax_unflatten, tree_map
from ..ops.segment import segment_rank
from .mesh import Mesh, Placement, ShardedTensor, device_put, from_pieces


def _sharded(x, mesh: Mesh, spec) -> ShardedTensor:
    return x if isinstance(x, ShardedTensor) else device_put(x, Placement(mesh, spec))


# ---------------------------------------------------------- exchanges in a group

class _Group:
    """The positions of one group along an axis (in axis order) and how this
    process exchanges between them."""

    def __init__(self, mesh: Mesh, coords, axis: str):
        self.mesh = mesh
        self.coords = coords
        self.local = [c for c in coords if mesh.is_local(c)]
        procs = [int(mesh.processes[c]) for c in coords]
        self.remote = mesh.process_axis == axis or len(set(procs)) > 1
        if self.remote:
            import torch.distributed as dist
            if not dist.is_initialized() or procs != list(range(dist.get_world_size())):
                raise ValueError(
                    "an axis that spans processes must hold one position of each "
                    "process of the initialized group, in rank order "
                    "(multihost.make_dcn_ici_mesh's outer axis)")
            self.host = dist.get_backend() == "gloo"

    def index(self, c) -> int:
        return self.coords.index(c)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu().contiguous() if self.host else t.contiguous()

    def all_gather(self, pieces: dict) -> dict:
        """For each local position, every member's piece in axis order, on
        that position's device."""
        if not self.remote:
            return {c: [pieces[m].to(self.mesh.devices[c]) for m in self.coords]
                    for c in self.local}
        import torch.distributed as dist
        (c,) = self.local
        t = self._wire(pieces[c])
        out = t.new_empty((len(self.coords),) + tuple(t.shape))
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, t)
        dev = pieces[c].device
        return {c: [x.to(dev) for x in out.unbind(0)]}

    def all_reduce(self, pieces: dict, combine) -> dict:
        """Add, max or min over the members: a fold in axis order within this
        process, ``all_reduce`` across processes."""
        if not self.remote:
            vals = [pieces[m] for m in self.coords]
            acc = vals[0]
            for v in vals[1:]:
                acc = combine(acc, v.to(acc.device))
            return {c: acc.to(self.mesh.devices[c]) for c in self.local}
        import torch.distributed as dist
        op = {torch.add: dist.ReduceOp.SUM, torch.maximum: dist.ReduceOp.MAX,
              torch.minimum: dist.ReduceOp.MIN}[combine]
        (c,) = self.local
        t = self._wire(pieces[c]).clone()
        dist.all_reduce(t, op=op)
        return {c: t.to(pieces[c].device)}

    def all_to_all(self, pieces: dict) -> dict:
        """``pieces[c][d]`` goes to member ``d``; each local position gets
        ``[p, ...]`` with row ``i`` from member ``i``."""
        if not self.remote:
            return {c: torch.stack([pieces[m][self.index(c)].to(self.mesh.devices[c])
                                    for m in self.coords])
                    for c in self.local}
        import torch.distributed as dist
        (c,) = self.local
        t = self._wire(pieces[c])
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return {c: out.to(pieces[c].device)}

    def shift_left(self, pieces: dict) -> dict:
        """Each member gets the piece of the next member around the ring
        (``ppermute`` with ``i -> i - 1``)."""
        n = len(self.coords)
        if not self.remote:
            return {c: pieces[self.coords[(self.index(c) + 1) % n]].to(self.mesh.devices[c])
                    for c in self.local}
        import torch.distributed as dist
        (c,) = self.local
        i = self.index(c)
        t = self._wire(pieces[c])
        out = torch.empty_like(t)
        reqs = [dist.isend(t, (i - 1) % n), dist.irecv(out, (i + 1) % n)]
        for r in reqs:
            r.wait()
        return {c: out.to(pieces[c].device)}


def _groups(mesh: Mesh, axis: str):
    return [_Group(mesh, g, axis) for g in mesh.groups(axis)]


# -- Win_MapReduce over the mesh ------------------------------------------------------

#: the combines an all-reduce carries directly
_REDUCIBLE = (torch.add, torch.maximum, torch.minimum)


def wmr_map_reduce(map_fn: Callable, combine: Callable, mesh: Mesh, *, axis: str = "part"):
    """Build ``f(data, valid) -> result`` where ``data`` is one window's content
    ``[L, ...]`` split over ``axis`` in ``p = mesh.shape[axis]`` partitions.
    Each position runs ``map_fn(partition, valid)`` on its slice (the MAP
    stage), then the partials are combined across the axis (the REDUCE stage):
    ``torch.add``, ``torch.maximum`` and ``torch.minimum`` reduce directly
    (in axis order within a process, so a float sum is the fold
    ``((p0 + p1) + p2) + ...``); any other associative ``combine`` all-gathers
    the partials and folds them pairwise in axis order, ``(0, 1), (2, 3), ..``
    then again, so a non-commuting combine sees them in order.

    ``map_fn``: ``(local_data [L/p, ...], local_valid [L/p]) -> partial`` (a
    pytree of tensors). ``combine``: ``(partial, partial) -> partial``. The
    result is replicated: a pytree of :class:`ShardedTensor` s holding it at
    every position."""
    mesh.axis(axis)

    def f(data, valid):
        d = _sharded(data, mesh, (axis,))
        v = _sharded(valid, mesh, (axis,))
        partial = {c: map_fn(d.piece(c), v.piece(c)) for c in mesh.local_coords()}
        some = next(iter(partial.values()))
        n_leaves = len(jax_leaves(some))
        result = {}
        for g in _groups(mesh, axis):
            if combine in _REDUCIBLE:
                per_leaf = [g.all_reduce({c: jax_leaves(partial[c])[i] for c in g.local},
                                         combine) for i in range(n_leaves)]
                for c in g.local:
                    result[c] = jax_unflatten(some, [pl[c] for pl in per_leaf])
                continue
            per_leaf = [g.all_gather({c: jax_leaves(partial[c])[i] for c in g.local})
                        for i in range(n_leaves)]
            for c in g.local:
                parts = [jax_unflatten(some, [pl[c][m] for pl in per_leaf])
                         for m in range(len(g.coords))]
                while len(parts) > 1:
                    m = len(parts) // 2
                    parts = ([combine(parts[2 * k], parts[2 * k + 1]) for k in range(m)]
                             + parts[2 * m:])
                result[c] = parts[0]
        rep = Placement(mesh, ())
        return jax_unflatten(some, [
            from_pieces(rep, {c: jax_leaves(result[c])[i] for c in result}, shape=leaf.shape)
            for i, leaf in enumerate(jax_leaves(some))])

    return f


# -- ring pane exchange ---------------------------------------------------------------

def ring_pane_windows(combine: Callable, identity, mesh: Mesh, *,
                      win_panes: int, slide_panes: int, axis: str = "win"):
    """Build ``f(panes [Ptot], pane_valid [Ptot]) -> (win_results, win_valid)``
    for sliding windows of ``win_panes`` pane partials sliding by
    ``slide_panes``, the pane axis split in contiguous blocks of ``B`` over
    ``axis``.

    A window starting in block ``d`` can reach ``win_panes - 1`` panes into
    the blocks after it, so the ring shifts each block to its left neighbour
    until the halo is complete: step ``s`` ships the first
    ``min(B, remaining)`` panes of block ``d+s+1`` (the widths never grow), so
    the traffic is O(win_panes), and the pane axis is never gathered. A halo
    that wrapped past the end of the pane axis is masked. Window starts are
    the global multiples of ``slide_panes``, and a window belongs to the
    block that holds its start pane (the WF_Emitter ownership rule), so the
    emitted set is the single-device one whatever ``p`` is. Results and
    validity are split over ``axis``: ``ceil(B / slide_panes)`` slots a
    position, a slot valid when its window is whole."""
    mesh.axis(axis)

    def f(panes, pane_valid):
        pn = _sharded(panes, mesh, (axis,))
        pv = _sharded(pane_valid, mesh, (axis,))
        res_p, ok_p = {}, {}
        for g in _groups(mesh, axis):
            p = len(g.coords)
            ext = {c: pn.piece(c) for c in g.local}
            ext_v = {c: pv.piece(c) for c in g.local}
            B = next(iter(ext.values())).shape[0]
            widths, rem = [], max(win_panes - 1, 0)
            while rem > 0:
                widths.append(min(B, rem))
                rem -= widths[-1]
            buf, buf_v = dict(ext), dict(ext_v)
            for s, w in enumerate(widths):
                buf = g.shift_left({c: buf[c][:w] for c in g.local})
                buf_v = g.shift_left({c: buf_v[c][:w] for c in g.local})
                for c in g.local:
                    wrapped = g.index(c) + s + 1 >= p
                    ext[c] = torch.cat([ext[c], buf[c]])
                    ext_v[c] = torch.cat([ext_v[c], buf_v[c] & (not wrapped)])
            for c in g.local:
                dev = ext[c].device
                base = g.index(c) * B
                off = (-base) % slide_panes
                nwin = -(-B // slide_panes)
                starts = off + torch.arange(nwin, dtype=torch.int64, device=dev) * slide_panes
                # a slice that would run past the end starts earlier, as
                # lax.dynamic_slice clamps it (those windows are masked)
                first = torch.clamp(starts, max=ext[c].shape[0] - win_panes)
                idx = first[:, None] + torch.arange(win_panes, device=dev)[None, :]
                sl, vl = ext[c][idx], ext_v[c][idx]
                masked = torch.where(vl.reshape(vl.shape + (1,) * (sl.ndim - 2)), sl,
                                     torch.as_tensor(identity, dtype=sl.dtype, device=dev))
                acc = masked[:, 0]
                for i in range(1, win_panes):
                    acc = combine(acc, masked[:, i])
                res_p[c] = acc
                ok_p[c] = vl.all(dim=1) & (starts < B)
        spl = Placement(mesh, (axis,))
        return from_pieces(spl, res_p), from_pieces(spl, ok_p)

    return f


# -- keyed all-to-all -----------------------------------------------------------------

def keyed_all_to_all(mesh: Mesh, *, axis: str = "key", capacity: Optional[int] = None,
                     return_residue: bool = False):
    """Build ``f(keys [C], valid [C], payload pytree of [C, ...]) -> (keys,
    valid, payload, n_left_behind)`` sending every live row to the position
    that owns its key, ``owner = key % p`` (floored), over one all-to-all.

    Each (source, destination) pair has a budget of ``capacity`` rows
    (default ``C_local // p``); a source compacts its rows a destination
    into ``[p, cap]`` slots by their rank among that destination's rows in
    stream order (``ops/segment.py::segment_rank``), exchanges, and lays the
    ``p`` received blocks end to end into ``[p * cap]`` rows with a validity
    mask.

    Nothing is lost silently: rows past a budget stay at their source and are
    counted in ``n_left_behind`` (``[1]`` int32 a position, ``[p]`` global;
    all zeros means the exchange was complete). ``return_residue=True`` also
    returns the residue mask (``[C]``, split like the input) so the caller can
    exchange exactly the rows left behind:
    :func:`keyed_all_to_all_lossless` runs those rounds."""
    mesh.axis(axis)
    p = mesh.shape[axis]

    def f(keys, valid, payload):
        ks = _sharded(keys, mesh, (axis,))
        vs = _sharded(valid, mesh, (axis,))
        ps = tree_map(lambda x: _sharded(x, mesh, (axis,)), payload)
        outs = {}
        for g in _groups(mesh, axis):
            sub_k, sub_v, sub_p, left, resid = {}, {}, {}, {}, {}
            for c in g.local:
                k, v = ks.piece(c), vs.piece(c)
                C = k.shape[0]
                cap = capacity if capacity is not None else C // p
                if cap < 1:
                    raise ValueError(
                        f"keyed_all_to_all: per-(src,dst) lane capacity resolved to {cap} "
                        f"(local rows {C}, positions {p}): no row could ever be "
                        f"delivered and the lossless wrapper would loop forever; pass "
                        f"an explicit capacity >= 1")
                dest = torch.where(v, torch.remainder(k, p), p)
                rank = segment_rank(dest, v)
                slot_ok = v & (rank < cap)
                slot = torch.where(slot_ok, dest * cap + rank, p * cap).long()

                def place(a, cap=cap, slot=slot):
                    out = a.new_zeros((p * cap + 1,) + tuple(a.shape[1:]))
                    out.index_copy_(0, slot, a)
                    return out[:p * cap].reshape((p, cap) + tuple(a.shape[1:]))
                sub_k[c], sub_v[c] = place(k), place(slot_ok)
                sub_p[c] = tree_map(lambda x: place(x.piece(c)), ps)  # noqa: B023
                resid[c] = v & ~slot_ok
                left[c] = resid[c].sum(dtype=torch.int32).reshape(1)
            rk, rv = g.all_to_all(sub_k), g.all_to_all(sub_v)
            leaves = [g.all_to_all({c: jax_leaves(sub_p[c])[i] for c in g.local})
                      for i in range(len(jax_leaves(payload)))]
            for c in g.local:
                flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))  # noqa: E731
                outs[c] = (flat(rk[c]), flat(rv[c]),
                           jax_unflatten(payload, [flat(pl[c]) for pl in leaves]),
                           left[c], resid[c])
        spl = Placement(mesh, (axis,))
        col = lambda i: from_pieces(spl, {c: o[i] for c, o in outs.items()})  # noqa: E731
        some = next(iter(outs.values()))
        pay = jax_unflatten(payload, [
            from_pieces(spl, {c: jax_leaves(o[2])[i] for c, o in outs.items()})
            for i in range(len(jax_leaves(some[2])))])
        res = (col(0), col(1), pay, col(3))
        return res + (col(4),) if return_residue else res

    return f


def keyed_all_to_all_lossless(mesh: Mesh, *, axis: str = "key", capacity: Optional[int] = None):
    """Rounds of :func:`keyed_all_to_all` that deliver every live row: rounds
    run until no source reports a row left behind, and each position's
    received rounds are laid end to end. The host loop is the blocking
    backpressure of the reference's bounded queues (``FF_BOUNDED_BUFFER``
    blocks, it never drops). The decision reads the left-behind counts of
    every position, summed across processes, so every process runs the same
    rounds. Returns ``(keys, valid, payload, n_rounds)``, each position's
    block ``n_rounds * p * cap`` rows."""
    ex = keyed_all_to_all(mesh, axis=axis, capacity=capacity, return_residue=True)

    def run(keys, valid, payload):
        spl = (axis,)
        keys = _sharded(keys, mesh, spl)
        payload = tree_map(lambda x: _sharded(x, mesh, spl), payload)
        v = _sharded(valid, mesh, spl)
        rounds = []
        while True:
            rk, rv, rp, n_left, resid = ex(keys, v, payload)
            rounds.append((rk, rv, rp))
            left = sum(t.sum(dtype=torch.int64).cpu() for t in n_left.pieces.values())
            if mesh.process_axis is not None:
                import torch.distributed as dist
                wire = left if dist.get_backend() == "gloo" else left.to(
                    next(iter(n_left.pieces.values())).device)
                dist.all_reduce(wire)
                left = wire
            if int(left) == 0:
                break
            v = resid
        cat = lambda *xs: from_pieces(  # noqa: E731
            xs[0].placement, {c: torch.cat([x.pieces[c] for x in xs]) for c in xs[0].pieces})
        ks = cat(*[r[0] for r in rounds])
        vs = cat(*[r[1] for r in rounds])
        ps = tree_map(cat, *[r[2] for r in rounds])
        return ks, vs, ps, len(rounds)

    return run


__all__ = ["wmr_map_reduce", "ring_pane_windows", "keyed_all_to_all",
           "keyed_all_to_all_lossless"]

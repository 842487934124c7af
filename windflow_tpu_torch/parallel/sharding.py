"""Sharded execution over a mesh, and key ownership for shard-local supervision.

Counterpart of ``windflow_tpu/parallel/sharding.py``, in two halves.

**The mesh half** (``ShardedChain``, ``batch_sharding``, ``shard_batch`` and
the state placement rules of ``_state_sharding``). The JAX package places a
compiled chain's states and batches with sharding annotations and lets
XLA/GSPMD partition the jitted step. The port partitions explicitly, with
the same placements (``mesh.py``) and the same rows:

- *dp blocks.* A batch splits into ``p`` contiguous lane blocks on the
  positions of the batch axis. Stateless operators run block by block;
  before the first stateful operator the blocks are laid end to end in lane
  order (the all-gather XLA inserts), which keeps stream order for ranks
  and first matches.
- *Key blocks.* A window engine whose ``[K]`` tables split over the key
  axis runs once a key block: position ``i`` runs a copy of the engine built
  at ``num_keys = K/p`` over the whole batch, its lanes' keys rebased by
  ``-i*K/p`` and the other blocks' lanes given the out-of-range key ``K/p``
  (kernel K1 and the keyed paths drop it from key-indexed state), and the
  emitted keys get ``+i*K/p`` back. ``Win_SeqFFAT``'s global-time path keeps
  every lane valid, so its replicated leaves (the watermark, the fired
  frontier, the OLD-drop count) see every lane on every position, and its
  ``[K, W]`` grid is the blocks' grids end to end. The per-key emitters
  (``Win_Seq`` and its farms, ``Win_SeqFFAT``'s per-key path, and
  ``Pane_Farm``'s two stages) pack the fired windows of all keys into one
  ``[W]`` budget, so there the other blocks' lanes are masked off, each
  block's fired count is exchanged, a block keeps the windows the global
  budget leaves it (its ``next_win`` put back for the rest), and its rows
  land at their global offsets; the per-key path's OLD-drop count is the sum
  of the blocks' (an all-reduce of their increments). Any other stateful
  operator, and a per-key Win_SeqFFAT with event-time lateness histograms,
  runs whole on the gathered state, which is split again after: sharded at
  rest, computed in one place.
- *Window rows.* A Win_Farm's fired-window rows split over the window axis
  (``Win_Seq.set_window_sharding``).

An in-process mesh runs on the chain's device: its positions may repeat the
device (``make_mesh(4, devices=[torch.device("cuda", 0)] * 4)``), and a mesh
naming another device is refused (one process a device: ``multihost.py``).

**Key ownership for shard-local supervision** (``ShardAssignment``,
``ReshardPlan``, ``make_splitter``, ``affected_shards``, ``resolve_shards``).
The sharded supervisors (``runtime/supervisor.py``) run N shards of one
chain on one device: each shard owns the keys ``owner_of(key) == s`` and
pushes a sub-batch whose ``valid`` is the batch's masked by that ownership,
so the live lanes of the N sub-batches are the batch's, each in exactly one
of them.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from ..batch import (Batch, CTRL_DTYPE, concat_batches, jax_leaves, jax_unflatten, map_tuples,
                     split_batch, tree_map)
from .mesh import Mesh, Placement, ShardedTensor, device_put, global_tree


@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    """Deterministic key -> shard map: ``owner(key) = key % num_shards``
    (floored, as ``jnp``'s ``%``), overridden by ``moves``, a small tuple of
    ``(key, shard)`` pairs (a re-sharding plan's targeted moves). Doubling the
    shard count splits every shard in two (``key % 2N`` is congruent to ``key
    % N`` mod N). Pure data: ``to_meta``/``from_meta`` carry it in checkpoints,
    so a supervised replay re-derives the same ownership."""

    num_shards: int
    moves: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if int(self.num_shards) < 1:
            raise ValueError(f"ShardAssignment: num_shards must be >= 1, "
                             f"got {self.num_shards}")
        norm = tuple(sorted((int(k), int(s)) for k, s in self.moves))
        if len({k for k, _s in norm}) != len(norm):
            dupes = sorted({k for k, _s in norm
                            if sum(1 for kk, _ in norm if kk == k) > 1})
            raise ValueError(
                f"ShardAssignment: key slot(s) {dupes} appear in more than one move — "
                f"each key has exactly one owner")
        for k, s in norm:
            if not (0 <= s < self.num_shards):
                raise ValueError(
                    f"ShardAssignment: move {k} -> shard {s} references a nonexistent "
                    f"shard (have {self.num_shards})")
        object.__setattr__(self, "num_shards", int(self.num_shards))
        object.__setattr__(self, "moves", norm)

    def owner_of(self, keys: torch.Tensor) -> torch.Tensor:
        """Owning shard of each key (a tensor in, a tensor out)."""
        own = torch.remainder(keys, self.num_shards)
        for k, s in self.moves:
            own = torch.where(keys == k, torch.full_like(own, s), own)
        return own

    def owner(self, key_slot: int) -> int:
        """The owner of one key, on the host."""
        for k, s in self.moves:
            if k == int(key_slot):
                return s
        return int(key_slot) % self.num_shards

    def split(self, batch: Batch):
        """``[sub_batch_0, ..., sub_batch_{N-1}]`` of one batch."""
        if self.num_shards == 1:
            return [batch]
        return list(make_splitter(self)(batch))

    def to_meta(self) -> dict:
        return {"num_shards": self.num_shards, "moves": [[k, s] for k, s in self.moves]}

    @classmethod
    def from_meta(cls, meta: dict) -> "ShardAssignment":
        return cls(int(meta["num_shards"]),
                   tuple((int(k), int(s)) for k, s in meta.get("moves", ())))


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """A live re-sharding request, applied by the sharded supervisors at the
    first checkpoint barrier at or after ``at_pos`` (so replay re-derives the
    same layout). ``new_shards``: the target count (None keeps it); ``moves``:
    targeted ``(key, shard)`` overrides on top. ``WF_RESHARD`` takes ``"8"``
    or the JSON ``{"at_pos": 64, "new_shards": 8, "moves": [[3, 1]]}``."""

    new_shards: Optional[int] = None
    moves: Tuple[Tuple[int, int], ...] = ()
    at_pos: int = 0

    def __post_init__(self):
        object.__setattr__(self, "moves", tuple((int(k), int(s)) for k, s in self.moves))
        if self.new_shards is not None:
            object.__setattr__(self, "new_shards", int(self.new_shards))
        object.__setattr__(self, "at_pos", int(self.at_pos))

    def apply_to(self, cur: ShardAssignment) -> ShardAssignment:
        """The new layout (its moves validated by ShardAssignment). A count
        change re-bases every key to ``key % N``, so the old moves carry over
        only when the count stays."""
        n = self.new_shards if self.new_shards is not None else cur.num_shards
        merged = dict(cur.moves if n == cur.num_shards else ())
        merged.update(dict(self.moves))
        return ShardAssignment(n, tuple(merged.items()))

    @classmethod
    def resolve(cls, arg):
        """A driver's ``reshard=``: None consults ``WF_RESHARD``; False is off;
        ``"auto"`` passes through as the governor's sentinel (the caller
        decides); a plan, dict, int or JSON string parses."""
        if arg is False:
            return None
        if isinstance(arg, cls):
            return arg
        if arg is None:
            raw = os.environ.get("WF_RESHARD", "").strip()
            if not raw:
                return None
            arg = raw
        if isinstance(arg, str):
            if arg == "auto":
                return "auto"
            arg = json.loads(arg) if arg[:1] in "[{" else int(arg)
        if isinstance(arg, int):
            return cls(new_shards=arg)
        if isinstance(arg, dict):
            return cls(new_shards=arg.get("new_shards"),
                       moves=tuple((int(k), int(s)) for k, s in arg.get("moves", ())),
                       at_pos=arg.get("at_pos", 0))
        raise TypeError(f"reshard= accepts a ReshardPlan, dict, int, JSON string, "
                        f"'auto', or None/False — got {type(arg)}")


def make_splitter(assignment: ShardAssignment, key_fn=None):
    """``batch -> (sub_batch_0, ..., sub_batch_{N-1})``: every lane kept, each
    sub-batch's ``valid`` the batch's masked by ownership. ``key_fn``
    (``TupleRef -> int``, the KeyBy convention) overrides ``batch.key`` as the
    ownership key, which must follow the key the state tables group on (a
    KeyBy downstream, or an operator ``key_fn`` over another field)."""
    n = assignment.num_shards

    def split(batch: Batch):
        keys = batch.key if key_fn is None else map_tuples(key_fn, batch).to(batch.key.dtype)
        own = assignment.owner_of(keys)
        return tuple(batch.replace(valid=batch.valid & (own == s)) for s in range(n))
    return split


def affected_shards(old: ShardAssignment, new: ShardAssignment) -> set:
    """The new layout's shards whose key set changes: every shard on a count
    change, else the donors and recipients of the moves."""
    if old.num_shards != new.num_shards:
        return set(range(new.num_shards))
    out = set()
    for k in ({k for k, _ in old.moves} | {k for k, _ in new.moves}):
        a, b = old.owner(k), new.owner(k)
        if a != b:
            out.add(a)
            out.add(b)
    return out


def resolve_shards(arg) -> int:
    """A driver's ``shards=``: None consults ``WF_SHARDS`` (unset, empty, 0
    or 1 all mean off: one supervision domain); 0 means off; negative raises."""
    if arg is None:
        raw = os.environ.get("WF_SHARDS", "").strip()
        arg = int(raw) if raw else 1
    n = int(arg)
    if n == 0:
        return 1
    if n < 0:
        raise ValueError(f"shards= must be >= 0, got {n}")
    return n


# ------------------------------------------------------------- mesh placement

def _state_sharding(op, mesh: Mesh, axis: str, window_key_axis: Optional[str] = None):
    """The placement rule of one operator's state leaves, ``leaf ->
    Placement`` (the JAX package's ``_state_sharding``), dispatched on the
    op's declared ``shard_axis``:

    - ``"key"`` (the default; Key_Farm, Key_FFAT, Pane_Farm, Win_MapReduce):
      a leaf whose leading dimension is the op's ``num_keys``, when the axis
      divides it, splits that dimension over ``axis`` (KF_Emitter whole-key
      routing as a placement rule); every other leaf is replicated.
    - ``"window"`` (Win_Farm): the archive is replicated (the WF_Emitter
      multicast, ``wf/wf_nodes.hpp:182-204``), unless ``window_key_axis`` is
      given (2-D key x win layouts): then a keyed farm's ``[K, ...]`` leaves
      split over it, as the reference distributes a keyed Win_Farm's tuples
      by ``hash(key) % pardegree`` before the window round-robin
      (``wf/wf_nodes.hpp:157-204``)."""
    shard_axis = getattr(op, "shard_axis", "key")
    num_keys = getattr(op, "num_keys", None)

    def keyed(leaf, ax) -> bool:
        return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 1 and num_keys is not None
                and leaf.shape[0] == num_keys and num_keys % mesh.shape.get(ax, mesh.size) == 0)

    if shard_axis == "window":
        ax = window_key_axis

        def place(leaf):
            if ax is not None and num_keys is not None and num_keys > 1 and keyed(leaf, ax):
                return Placement(mesh, (ax,))
            return Placement(mesh, ())
        return place

    def place(leaf):
        if shard_axis == "key" and keyed(leaf, axis):
            return Placement(mesh, (axis,))
        return Placement(mesh, ())
    return place


def batch_sharding(mesh: Mesh, axis: str = "dp") -> Placement:
    return Placement(mesh, (axis,))


def shard_batch(batch: Batch, mesh: Mesh, axis: str = "dp") -> Batch:
    """A batch whose fields are :class:`ShardedTensor` s split in contiguous
    lane blocks over ``axis``."""
    s = batch_sharding(mesh, axis)
    put = lambda a: device_put(a, s)  # noqa: E731
    return Batch(key=put(batch.key), id=put(batch.id), ts=put(batch.ts),
                 payload=tree_map(put, batch.payload), valid=put(batch.valid))


def _put_views(x, placement: Placement) -> ShardedTensor:
    """``x`` placed without a copy: each position's block is a view of it
    (the positions of a chain share its device)."""
    return ShardedTensor(placement, x.shape, x.dtype,
                         {c: x[placement.slices(c, x.shape)]
                          for c in placement.mesh.local_coords()})


def _window_engine(op):
    """What the key split runs for ``op``: ``("engine", e)`` for a window
    engine (Win_Seq and its farms, Win_SeqFFAT and Key_FFAT, a
    Win_MapReduce's engine, through any Nested_Farm), ``("pane", op)`` for a
    Pane_Farm, None for an operator it does not cover."""
    from ..operators.win_patterns import Nested_Farm, Pane_Farm, Win_MapReduce
    from ..operators.win_seq import Win_Seq
    from ..operators.win_seqffat import Win_SeqFFAT
    while isinstance(op, Nested_Farm):
        op = op.inner
    if isinstance(op, Win_MapReduce):
        return "engine", op.engine
    if isinstance(op, Pane_Farm):
        return "pane", op
    if isinstance(op, (Win_Seq, Win_SeqFFAT)):
        return "engine", op
    return None


def _grid_engine(eng) -> bool:
    """Win_SeqFFAT's global-time path: a ``[K, W]`` grid output and
    replicated control leaves."""
    return getattr(eng, "global_time", False)


class _KeySplit:
    """One window operator run as ``p`` key blocks over ``key_axis`` (see the
    module docstring): engine copies at ``num_keys = K/p``, block states read
    from and written to the positions of each block."""

    def __init__(self, op, kind, target, mesh: Mesh, key_axis: str, win_axis: Optional[str]):
        self.mesh = mesh
        self.p = mesh.shape[key_axis]
        self.kb = op.num_keys // self.p
        self.kind = kind
        self.target = target
        d = mesh.axis(key_axis)
        zero = (0,) * mesh.devices.ndim
        #: the position that computes key block b, and every position holding it
        self.rep = [zero[:d] + (b,) + zero[d + 1:] for b in range(self.p)]
        self.members = [[c for c in mesh.coords() if c[d] == b] for b in range(self.p)]
        engines = [target.plq, target.wlq] if kind == "pane" else [target]
        self.blocks = {id(e): [self._block(e, b, win_axis) for b in range(self.p)]
                       for e in engines}

    def _block(self, eng, b: int, win_axis):
        blk = copy.copy(eng)
        blk.num_keys = self.kb
        if getattr(eng, "_wdevs", None) is not None:
            blk._wdevs = [self.mesh.devices[c] for c in self.mesh.line(self.rep[b], win_axis)]
        return blk

    # -- states --------------------------------------------------------------

    def read(self, state):
        """Block b's state, from the pieces of its first position."""
        leaves = jax_leaves(state)
        return [jax_unflatten(state, [x.piece(self.rep[b]) if isinstance(x, ShardedTensor)
                                      else x for x in leaves])
                for b in range(self.p)]

    def write(self, state, blocks):
        """The placed state holding each block's new leaves at every position
        of that block (a replicated leaf keeps each block's own value)."""
        old = jax_leaves(state)
        new = [jax_leaves(st) for st in blocks]
        out = []
        for i, x in enumerate(old):
            if not isinstance(x, ShardedTensor):
                out.append(new[0][i])
                continue
            pieces = {c: new[b][i] for b in range(self.p) for c in self.members[b]}
            out.append(ShardedTensor(x.placement, x.shape, x.dtype, pieces))
        return jax_unflatten(state, out)

    # -- one engine over the key blocks --------------------------------------

    def _rebase(self, batch: Batch, b: int, mask: bool) -> Batch:
        lo = b * self.kb
        mine = (batch.key >= lo) & (batch.key < lo + self.kb)
        key = torch.where(mine, batch.key - lo, self.kb).to(CTRL_DTYPE)
        return batch.replace(key=key, valid=batch.valid & mine if mask else batch.valid)

    def step(self, eng, states, batch, flush: bool):
        blks = self.blocks[id(eng)]
        grid = _grid_engine(eng)
        pre = list(states)
        new, outs = [], []
        for b, (blk, st) in enumerate(zip(blks, states)):
            if flush:
                st, o = blk.flush(st)
            else:
                st, o = blk.apply(st, self._rebase(batch, b, mask=not grid))
            new.append(st)
            outs.append(o)
        if grid:
            return new, self._grid(outs)
        if hasattr(pre[0], "dropped_old"):
            # the per-key path counts a block's own keys' drops: all-reduce
            # the increments so every position holds the global count
            inc = sum(n.dropped_old - o.dropped_old for n, o in zip(new, pre))
            new = [dataclasses.replace(n, dropped_old=o.dropped_old + inc)
                   for n, o in zip(new, pre)]
        return self._packed(blks[0], pre, new, outs, flush)

    def _filled(self, outs):
        """Each block's output, an all-invalid copy of another's where a
        flush returned None; None when every block did."""
        tpl = next((o for o in outs if o is not None), None)
        if tpl is None:
            return None
        zero = Batch(key=torch.zeros_like(tpl.key), id=torch.zeros_like(tpl.id),
                     ts=torch.zeros_like(tpl.ts), payload=tree_map(torch.zeros_like, tpl.payload),
                     valid=torch.zeros_like(tpl.valid))
        return [zero if o is None else o for o in outs]

    def _grid(self, outs):
        """Global-time Key_FFAT: block b's ``[K/p, W]`` grid is rows
        ``b*K/p*W ..`` of the ``[K, W]`` grid."""
        outs = self._filled(outs)
        if outs is None:
            return None
        return concat_batches(*[o.replace(key=o.key + b * self.kb) for b, o in enumerate(outs)])

    def _packed(self, blk, pre, new, outs, flush: bool):
        """The per-key emitters' global ``[W]`` budget over the blocks: the
        blocks' fired counts are exchanged, block b keeps the windows from
        its offset up to ``W`` (its ``next_win`` put back past the rest) and
        its rows land at that offset."""
        W = blk._w or blk._resolve_w(256)
        emitted = [n.next_win - o.next_win for n, o in zip(new, pre)]          # [K/p] each
        n = torch.stack([e.sum(dtype=CTRL_DTYPE) for e in emitted])           # [p]
        base = torch.cumsum(n, 0, dtype=CTRL_DTYPE) - n
        allowed = torch.minimum(torch.clamp(W - base, min=0), n)
        kept = []
        for b, (st, e) in enumerate(zip(new, emitted)):
            off = torch.cumsum(e, 0, dtype=CTRL_DTYPE) - e
            keep = torch.minimum(torch.clamp(allowed[b] - off, min=0), e)
            kept.append(dataclasses.replace(st, next_win=pre[b].next_win + keep))
        outs = self._filled(outs)
        if outs is None:
            return kept, None
        # global row w comes from block b = searchsorted(ends, w), its row w - start_b
        ends = torch.cumsum(allowed, 0, dtype=CTRL_DTYPE)
        w = torch.arange(W, dtype=CTRL_DTYPE, device=ends.device)
        b = torch.clamp(torch.searchsorted(ends, w, right=True), max=self.p - 1)
        src = (b * W + w - (ends - allowed)[b]).long()
        ok = w < ends[-1]
        cat = concat_batches(*[o.replace(key=o.key + i * self.kb) for i, o in enumerate(outs)])
        out = cat.take(src, valid=cat.valid.index_select(0, src) & ok)
        if flush and not bool(out.valid.any()):
            return kept, None
        return kept, out

    # -- the operator --------------------------------------------------------

    def run(self, states, batch, flush: bool):
        if self.kind == "engine":
            return self.step(self.target, states, batch, flush)
        pf = self.target
        plq = [st["plq"] for st in states]
        wlq = [st["wlq"] for st in states]
        plq, panes = self.step(pf.plq, plq, batch, flush)
        if not flush or panes is not None:
            wlq, out = self.step(pf.wlq, wlq, panes, False)
        else:
            wlq, out = self.step(pf.wlq, wlq, None, True)
        return [{"plq": a, "wlq": b} for a, b in zip(plq, wlq)], out


class ShardedChain:
    """Wraps a :class:`CompiledChain`, placing its states on the mesh and
    running every ``push``/``flush`` over the positions (module docstring).

    On a 1-D mesh, ``axis`` carries both the batch capacity axis and the state
    shard axis. On a 2-D mesh (``make_mesh_2d``), pass ``key_axis`` (and/or
    ``win_axis``) to place key tables / fired-window rows on a different mesh
    axis than the batch: batch over ``dp`` (operator replication), key state
    over ``key`` (KF whole-key routing), window rows over ``win`` (WF window
    ownership).

    A KEYED window farm on a ``key x win`` mesh gets BOTH: its ``[K, ...]``
    archive splits over ``key_axis`` (explicit ``key_axis`` only; on a 1-D
    mesh the archive stays replicated, the WF-multicast rule) while its
    fired-window rows split over ``win_axis``. A push returns one ``Batch``
    on the chain's device, the rows the unsharded chain gives; ``push`` runs
    eagerly (no CUDA graph)."""

    def __init__(self, chain, mesh: Mesh, axis: str = "dp",
                 win_axis: Optional[str] = None, key_axis: Optional[str] = None):
        # validate axis names up front: a typo would otherwise surface as a
        # bare KeyError from deep inside the placement
        for name, val in (("axis", axis), ("win_axis", win_axis), ("key_axis", key_axis)):
            if val is not None and val not in mesh.axis_names:
                raise ValueError(
                    f"ShardedChain: {name}={val!r} is not an axis of the mesh "
                    f"(axes: {tuple(mesh.axis_names)})")
        foreign = sorted({str(mesh.devices[c]) for c in mesh.coords()
                          if mesh.devices[c] != chain.device or not mesh.is_local(c)})
        if foreign:
            raise ValueError(
                f"ShardedChain: the chain runs on {chain.device} and the mesh names "
                f"{foreign} (or positions of other processes); an in-process mesh "
                f"repeats the chain's device, and other devices take a process each "
                f"(parallel/multihost.py)")
        if chain._tier_ops:
            raise ValueError("ShardedChain: a chain with tiered keyed state cannot be "
                             "sharded over a mesh")
        self.chain = chain
        self.mesh = mesh
        self.axis = axis
        for op in chain.ops:
            if (getattr(op, "shard_axis", None) == "window"
                    and hasattr(op, "set_window_sharding")):
                op.set_window_sharding(mesh, win_axis or axis)
        chain.graphs = {}        # drop graphs captured over the unplaced states
        self._splits = []
        states = []
        for op, st in zip(chain.ops, chain.states):
            if st is None:
                self._splits.append(None)
                states.append(None)
                continue
            win = getattr(op, "shard_axis", "key") == "window"
            kax = key_axis if win else (key_axis or axis)
            place = _state_sharding(op, mesh, key_axis or axis, window_key_axis=key_axis)
            states.append(jax_unflatten(st, [
                device_put(x, place(x)) if isinstance(x, torch.Tensor) else x
                for x in jax_leaves(st)]))
            self._splits.append(self._key_split(op, st, kax, win_axis or axis))
        chain.states = states

    def _key_split(self, op, state, key_axis, win_axis):
        """The key split of ``op`` when it applies (module docstring), else None."""
        found = _window_engine(op)
        K = getattr(op, "num_keys", None)
        if found is None or key_axis is None or not K or K <= 1:
            return None
        p = self.mesh.shape[key_axis]
        if p == 1 or K % p:
            return None
        kind, target = found
        if (kind == "engine" and not _grid_engine(target)
                and getattr(state, "lat_hist", None) is not None):
            return None           # the per-key lateness histogram reads the global max
        return _KeySplit(op, kind, target, self.mesh, key_axis, win_axis)

    # -- running -------------------------------------------------------------

    def _blocks(self, batch: Batch):
        """The batch's lane blocks over the batch axis (views, or the pieces
        of a ``shard_batch``)."""
        if isinstance(batch.key, ShardedTensor):
            line = self.mesh.line((0,) * self.mesh.devices.ndim, self.axis)
            return [Batch(key=batch.key.piece(c), id=batch.id.piece(c), ts=batch.ts.piece(c),
                          payload=tree_map(lambda x: x.piece(c), batch.payload),  # noqa: B023
                          valid=batch.valid.piece(c))
                    for c in line]
        p = self.mesh.shape[self.axis]
        if batch.capacity % p:
            raise ValueError(f"ShardedChain: batch capacity {batch.capacity} does not split "
                             f"over axis {self.axis!r} of size {p}")
        return split_batch(batch, batch.capacity // p)

    def _apply(self, j: int, batch: Optional[Batch], flush: bool):
        op, st, split = self.chain.ops[j], self.chain.states[j], self._splits[j]
        if split is not None:
            blocks, out = split.run(split.read(st), batch, flush)
            self.chain.states[j] = split.write(st, blocks)
            return out
        whole = global_tree(st)
        new, out = op.flush(whole) if flush else op.apply(whole, batch)
        self.chain.states[j] = jax_unflatten(new, [
            _put_views(x, old.placement) if isinstance(old, ShardedTensor) else x
            for x, old in zip(jax_leaves(new), jax_leaves(st))])
        return out

    def _run(self, batch: Batch, start: int) -> Batch:
        ops = self.chain.ops
        blocks = self._blocks(batch) if start == 0 else None
        whole = None if blocks is not None else batch
        for j in range(start, len(ops)):
            op, st = ops[j], self.chain.states[j]
            if blocks is not None:
                cap = blocks[0].capacity
                if st is None and op.out_capacity(cap) * len(blocks) == op.out_capacity(
                        cap * len(blocks)):
                    blocks = [op.apply(None, b)[1] for b in blocks]
                    continue
                whole, blocks = concat_batches(*blocks), None
            if st is None:
                whole = op.apply(None, whole)[1]
            else:
                whole = self._apply(j, whole, flush=False)
        return concat_batches(*blocks) if blocks is not None else whole

    def push(self, batch: Batch) -> Batch:
        return self._run(batch, 0)

    def flush(self):
        """EOS: drain every operator in order, cascading the flushed batches
        through the rest of the chain (``CompiledChain.flush``)."""
        outs = []
        ops = self.chain.ops
        for i, op in enumerate(ops):
            while True:
                if self.chain.states[i] is None:
                    fb = op.flush(None)[1]
                else:
                    fb = self._apply(i, None, flush=True)
                if fb is None:
                    break
                outs.append(self._run(fb, i + 1) if i + 1 < len(ops) else fb)
        return outs

    def result(self) -> dict:
        """Results of the ReduceSink terminal ops, gathered."""
        return self.chain.result()


__all__ = ["ShardAssignment", "ReshardPlan", "ShardedChain", "affected_shards",
           "batch_sharding", "make_splitter", "resolve_shards", "shard_batch"]

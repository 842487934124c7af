"""Device meshes, placements and sharded tensors: the scale-out substrate.

Counterpart of ``windflow_tpu/parallel/mesh.py``. The JAX package is
single-controller SPMD: a ``jax.sharding.Mesh`` over its devices, arrays
placed with a ``NamedSharding`` and XLA inserting the collectives. PyTorch has
no partitioner, so the port makes the partitioning explicit: a :class:`Mesh`
is an array of *positions* with named axes, a :class:`Placement` (the
counterpart of ``NamedSharding``) says which tensor dimension splits over
which axis, and a :class:`ShardedTensor` holds one tensor a position. The
operators that run on the pieces (``sharding.py::ShardedChain``,
``collective.py``) run their local function once a position and exchange
between positions explicitly: a copy between positions of this process, and
``torch.distributed`` between processes (``multihost.py``).

Axis vocabulary (as in the JAX package):

- ``"dp"``   data parallelism: the batch capacity axis;
- ``"key"``  key partitioning: the ``[K]`` state-table axis (KF_Emitter
  whole-key routing, ``wf/kf_nodes.hpp:74-90``);
- ``"win"``  window parallelism: the ``[W]`` fired-window axis (WF_Emitter
  window ownership, ``wf/wf_nodes.hpp:182-204``);
- ``"part"`` intra-window partitioning (Win_MapReduce's MAP stage).

A position names a ``torch.device``, and positions may repeat one:
``make_mesh(4, devices=[torch.device("cuda", 0)] * 4)`` is a 4-position mesh
on one card, ``devices=["cpu"] * 8`` the CPU tests' counterpart of the JAX
suite's 8 virtual devices. By default a mesh covers every visible CUDA device;
without a card and without ``devices=`` it raises (it never falls back to the
CPU). Positions on one device that hold the same piece of a tensor share it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _process_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def visible_cuda_devices() -> list:
    """Every visible CUDA device; raises without one (a mesh never falls back
    to the CPU: pass ``devices=["cpu"] * n`` for that)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "a mesh covers the visible CUDA devices by default, and "
            "torch.cuda.is_available() is False; pass devices= (e.g. "
            "devices=['cpu'] * 8) to build one on other devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


class Mesh:
    """An ndarray of positions with named axes. ``devices[c]`` is the
    ``torch.device`` of the position at coordinates ``c``; ``processes[c]``
    the rank of the process that holds it (all this process's unless the
    mesh spans processes, ``multihost.make_dcn_ici_mesh``). ``shape`` maps
    each axis to its size, in order."""

    def __init__(self, devices, axis_names: Sequence[str], processes=None,
                 process_axis: Optional[str] = None):
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for c in np.ndindex(given.shape):
            arr[c] = _as_device(given[c])
        if arr.ndim != len(axis_names):
            raise ValueError(f"Mesh: {arr.ndim}-D devices with axis names {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: repeated axis name in {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        rank = _process_rank()
        self.processes = (np.full(arr.shape, rank, dtype=np.int64) if processes is None
                          else np.asarray(processes, dtype=np.int64).reshape(arr.shape))
        #: the rank of this process (0 without torch.distributed)
        self.process_index = rank
        #: the axis whose exchanges go through torch.distributed (the outer
        #: axis of ``multihost.make_dcn_ici_mesh`` once the group is up),
        #: even at world size 1; None: every exchange is a copy in-process
        self.process_axis = process_axis

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every position's coordinates, in row-major (``devices.flat``) order."""
        return list(np.ndindex(self.devices.shape))

    def is_local(self, c) -> bool:
        return int(self.processes[c]) == self.process_index

    def local_coords(self):
        return [c for c in self.coords() if self.is_local(c)]

    def axis(self, name: str) -> int:
        """The dimension of axis ``name``."""
        if name not in self.axis_names:
            raise ValueError(f"{name!r} is not an axis of the mesh (axes: {self.axis_names})")
        return self.axis_names.index(name)

    def line(self, c, name: str):
        """The coordinates along axis ``name`` through position ``c``, in axis
        order: the members of ``c``'s group for a collective over that axis."""
        d = self.axis(name)
        return [tuple(c[:d]) + (i,) + tuple(c[d + 1:]) for i in range(self.devices.shape[d])]

    def groups(self, name: str):
        """Every group of positions that differ only along ``name`` (each in
        axis order), in row-major order of the other coordinates."""
        d = self.axis(name)
        seen = []
        for c in self.coords():
            if c[d] == 0:
                seen.append(self.line(c, name))
        return seen

    def __repr__(self):
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices: Sequence = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    visible CUDA device)."""
    devs = list(devices if devices is not None else visible_cuda_devices())
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"make_mesh: {n_devices} positions asked, {len(devs)} devices given")
        devs = devs[:n_devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = [_as_device(d) for d in devs]
    return Mesh(arr, (axis,))


def make_mesh_2d(shape, axes=("dp", "key"), devices: Sequence = None) -> Mesh:
    """2-D mesh of ``shape`` over the first ``shape[0] * shape[1]`` devices."""
    devs = list(devices if devices is not None else visible_cuda_devices())
    n = shape[0] * shape[1]
    if n > len(devs):
        raise ValueError(f"make_mesh_2d: {n} positions asked, {len(devs)} devices given")
    arr = np.empty(n, dtype=object)
    arr[:] = [_as_device(d) for d in devs[:n]]
    return Mesh(arr.reshape(tuple(shape)), tuple(axes))


# ------------------------------------------------------------------ placements

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor's pieces live (``NamedSharding``): ``spec[i]`` names the
    mesh axis that tensor dimension ``i`` splits over in contiguous blocks,
    or None; dimensions past ``spec`` and axes it does not name replicate."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def block_of(self, c) -> tuple:
        """The block index of each split dimension at position ``c``."""
        return tuple(0 if a is None else c[self.mesh.axis(a)] for a in self.spec)

    def slices(self, c, shape) -> tuple:
        """The index of position ``c``'s piece in the global tensor."""
        out = []
        for dim, a in enumerate(self.spec):
            if a is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[a]
            if shape[dim] % n:
                raise ValueError(f"dimension {dim} of size {shape[dim]} does not split "
                                 f"over axis {a!r} of size {n}")
            b = shape[dim] // n
            out.append(slice(c[self.mesh.axis(a)] * b, (c[self.mesh.axis(a)] + 1) * b))
        return tuple(out)


def leading_axis_sharding(mesh: Mesh, axis: str) -> Placement:
    """Split the leading tensor dimension over mesh axis ``axis``."""
    mesh.axis(axis)
    return Placement(mesh, (axis,))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


@dataclasses.dataclass(frozen=True)
class Shard:
    """One position's piece (``jax.Shard``): ``index`` is its place in the
    global tensor."""

    data: torch.Tensor
    device: torch.device
    index: tuple


class ShardedTensor:
    """A global tensor held as one piece a position of this process.
    ``pieces`` maps coordinates to tensors; positions of other processes are
    absent. A replicated placement holds a whole copy a position (the copies
    of one device may be one tensor)."""

    def __init__(self, placement: Placement, shape, dtype, pieces: dict):
        self.placement = placement
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.pieces = pieces

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def addressable_shards(self) -> list:
        return [Shard(t, t.device, self.placement.slices(c, self.shape))
                for c, t in self.pieces.items()]

    def piece(self, c) -> torch.Tensor:
        return self.pieces[tuple(c)]

    def full(self, name: str = "ShardedTensor") -> torch.Tensor:
        """The global tensor assembled on the first position's device, from
        the first position holding each block: a new tensor. Needs every
        block in this process; otherwise raises a ``ValueError`` naming
        ``name`` and the positions whose blocks live in other processes (as
        ``np.asarray`` refuses a JAX array that is not fully addressable)."""
        first = {}
        for c, t in self.pieces.items():
            first.setdefault(self.placement.block_of(c), (c, t))
        mesh = self.placement.mesh
        missing = [c for c in mesh.coords() if self.placement.block_of(c) not in first]
        if missing:
            raise ValueError(
                f"{name}: the blocks at mesh positions {missing} (processes "
                f"{sorted({int(mesh.processes[c]) for c in missing})}) are not held by "
                f"this process (rank {mesh.process_index}); gather them first "
                f"(parallel/collective.py)")
        dev = next(iter(self.pieces.values())).device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for c, t in first.values():
            out[self.placement.slices(c, self.shape)] = t.to(dev)
        return out

    def clone(self) -> "ShardedTensor":
        """A copy with memory of its own; positions that shared a piece
        share its copy."""
        made = {}
        for t in self.pieces.values():
            if id(t) not in made:
                made[id(t)] = t.clone()
        return ShardedTensor(self.placement, self.shape, self.dtype,
                             {c: made[id(t)] for c, t in self.pieces.items()})

    def __repr__(self):
        return f"ShardedTensor(shape={tuple(self.shape)}, spec={self.placement.spec})"


def device_put(x: torch.Tensor, placement: Placement) -> ShardedTensor:
    """Place a global tensor (``jax.device_put``): every position of this
    process gets its block, a copy with memory of its own; positions of one
    device that hold the same block share that copy."""
    made = {}
    pieces = {}
    for c in placement.mesh.local_coords():
        dev = placement.mesh.devices[c]
        key = (placement.block_of(c), str(dev))
        if key not in made:
            made[key] = x[placement.slices(c, x.shape)].to(dev).clone()
        pieces[c] = made[key]
    return ShardedTensor(placement, x.shape, x.dtype, pieces)


def global_tree(tree):
    """``tree`` (a state) with every placed leaf as its global value, for
    reading: a replicated leaf's first copy, a split leaf's blocks laid end
    to end (the all-gather). A sharded chain's state reads as the unsharded
    chain's; ``tree`` itself when nothing in it is placed."""
    from ..batch import jax_leaves, jax_unflatten
    flat = jax_leaves(tree)
    if not any(isinstance(x, ShardedTensor) for x in flat):
        return tree

    def value(x):
        if not isinstance(x, ShardedTensor):
            return x
        if not any(a is not None for a in x.placement.spec):
            return next(iter(x.pieces.values()))
        return x.full()
    return jax_unflatten(tree, [value(x) for x in flat])


def host_copy(leaf, name: str = "leaf"):
    """A leaf as one tensor on the host, always a copy: a tensor copied
    (synchronous on the card, so an asynchronous CUDA error surfaces here),
    a :class:`ShardedTensor` assembled (:meth:`ShardedTensor.full`, which
    raises naming ``name`` where blocks live in other processes); any other
    leaf as is. The one way the host paths (checkpoints, supervisor
    snapshots, ``convert``) take a state leaf, so a sharded chain's state
    is written and snapshotted as the unsharded chain's would be."""
    if isinstance(leaf, ShardedTensor):
        return leaf.full(name).to("cpu")       # full() is a new tensor already
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


def from_pieces(placement: Placement, pieces: dict, shape=None) -> ShardedTensor:
    """A ShardedTensor over tensors already placed a position; ``shape``
    defaults to the pieces' blocks laid side by side."""
    t = next(iter(pieces.values()))
    if shape is None:
        shape = list(t.shape)
        for dim, a in enumerate(placement.spec):
            if a is not None:
                shape[dim] *= placement.mesh.shape[a]
    return ShardedTensor(placement, shape, t.dtype, dict(pieces))


__all__ = ["Mesh", "Placement", "Shard", "ShardedTensor", "device_put", "from_pieces",
           "global_tree", "host_copy", "leading_axis_sharding", "make_mesh",
           "make_mesh_2d", "replicated", "visible_cuda_devices"]

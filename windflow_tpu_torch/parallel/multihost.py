"""Multi-process scale-out: ``torch.distributed`` initialization and the
two-level (process x local positions) mesh.

Counterpart of ``windflow_tpu/parallel/multihost.py``. The reference runs in
one shared-memory process (no MPI, NCCL or sockets in ``wf/``). The JAX
package runs one process a host over ``jax.distributed``; the port runs one
process a card (or a host) over ``torch.distributed``, with a mesh whose
OUTER axis spans the processes and whose INNER axes span each process's
local positions. The axis taxonomy (``mesh.py``) maps on as:

- ``dp`` (batch capacity) is safe across processes: each process's source
  ingests its own share of the stream (:func:`process_local_batch_range`);
- ``key`` may span processes: ``collective.keyed_all_to_all`` then exchanges
  through ``torch.distributed``;
- ``win``/``part`` stay inside a process: their per-step halo and all-reduce
  latency is the window emission latency.

Usage (one process a card, the standard launcher environment)::

    from windflow_tpu_torch.parallel import multihost
    multihost.initialize()                  # no-op in a single process
    mesh = multihost.make_dcn_ici_mesh(dcn_axis="key", ici_axes=("dp",))

In a single process every helper degrades to the local mesh, so the same
program text runs from a test to several cards. The backend is ``nccl`` for
CUDA positions and ``gloo`` for CPU positions; NCCL refuses two ranks on one
card, so processes sharing a card pass ``backend="gloo"`` and their
exchanges pass through the host.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, _as_device, visible_cuda_devices


def _world() -> Tuple[int, int]:
    """(number of processes, this process's rank): (1, 0) without an
    initialized group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> bool:
    """Start ``torch.distributed``; returns True when it did. A no-op (False)
    when the group is already up, or when nothing asks for one: no argument
    and no ``MASTER_ADDR`` in the environment (a single process).

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to the launcher's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. ``backend`` defaults to ``nccl`` when CUDA is
    available and ``gloo`` otherwise."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None and num_processes is None and "MASTER_ADDR" not in env:
        return False
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return True


def make_dcn_ici_mesh(dcn_axis: str = "dp", ici_axes: Sequence[str] = ("key",),
                      ici_shape: Optional[Tuple[int, ...]] = None,
                      devices: Sequence = None) -> Mesh:
    """Two-level mesh: ``dcn_axis`` spans the processes (row ``i`` holds
    process ``i``'s local positions), ``ici_axes`` span each process's
    positions: ``devices`` (default: every visible CUDA device), in each
    process alike. In a single process the outer axis has size 1, so the
    program text is the same."""
    n_proc, _rank = _world()
    local = [_as_device(d) for d in (devices if devices is not None
                                     else visible_cuda_devices())]
    if ici_shape is None:
        ici_shape = _factor(len(local), len(ici_axes))
    ici_shape = tuple(ici_shape)
    n = int(np.prod(ici_shape))
    if n > len(local):
        raise ValueError(f"make_dcn_ici_mesh: {ici_shape} local positions, "
                         f"{len(local)} devices given")
    row = np.empty(n, dtype=object)
    row[:] = local[:n]
    devs = np.empty((n_proc, n), dtype=object)
    for i in range(n_proc):
        devs[i] = row
    procs = np.repeat(np.arange(n_proc), n).reshape((n_proc,) + ici_shape)
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    return Mesh(devs.reshape((n_proc,) + ici_shape), (dcn_axis,) + tuple(ici_axes),
                processes=procs, process_axis=dcn_axis if up else None)


def _factor(n: int, k: int) -> Tuple[int, ...]:
    """Split n into k near-balanced power-of-two-ish factors (largest first)."""
    if k == 1:
        return (n,)
    f = 1
    target = round(n ** (1 / k))
    for c in range(target, 0, -1):
        if n % c == 0:
            f = c
            break
    return (n // f,) + _factor(f, k - 1) if k == 2 else (f,) + _factor(n // f, k - 1)


def process_shard_slice(num_shards: int) -> Tuple[int, int]:
    """Contiguous shard-index range ``[lo, hi)`` supervised by THIS process:
    process ``i`` of ``P`` owns shards ``[i*ceil(N/P), ...)``, so each process
    runs its own per-shard recovery domains over its own key ranges (pass it
    as ``SupervisedPipeline(shards=N, shard_range=...)``). ``(0, num_shards)``
    in a single process."""
    p, i = _world()
    per = -(-int(num_shards) // p)
    lo = min(i * per, int(num_shards))
    hi = min(lo + per, int(num_shards))
    return lo, hi


def process_local_batch_range(total: int, batch_size: int) -> Tuple[int, int]:
    """This process's contiguous share of a global stream of ``total``
    tuples (the reference's Source replicas split the stream the same way,
    ``wf/source.hpp:284-296``), its start rounded down to a whole batch so
    every process steps in lockstep."""
    p, i = _world()
    per = -(-total // p)
    lo = min(i * per, total)
    hi = min(lo + per, total)
    lo -= lo % batch_size
    return lo, hi


__all__ = ["initialize", "make_dcn_ici_mesh", "process_local_batch_range",
           "process_shard_slice"]

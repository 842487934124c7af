"""Stream compaction: pack live lanes to the front of a fixed-capacity buffer.

Counterpart of ``windflow_tpu/ops/compaction.py`` (reference prefix-scan suite,
``wf/gpu_utils.hpp:323-417``, behind the GPU emitter's per-destination
sub-batches, ``wf/standard_nodes_gpu.hpp:52-238``): ``cumsum`` plus scatter
or gather, and a stable sort for the partition by destination. No TPU kernel
is behind these functions; they are plain PyTorch on both devices. Index
outputs are int32, as the JAX package's are with 32-bit defaults.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..batch import tree_map


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum (the reference's ``prescan``)."""
    return torch.cumsum(x, 0, dtype=x.dtype) - x


def compact_indices(valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gather_idx, out_valid): taking ``gather_idx`` packs the live lanes to
    the front in stable order; ``out_valid[i] = i < count``."""
    order = torch.argsort((~valid).to(torch.int8), stable=True).to(torch.int32)
    count = valid.sum(dtype=torch.int32)
    out_valid = torch.arange(valid.shape[0], dtype=torch.int32, device=valid.device) < count
    return order, out_valid


def scatter_compact(values: Any, valid: torch.Tensor,
                    capacity: int = None) -> Tuple[Any, torch.Tensor]:
    """Scatter compaction: live lane i goes to ``exclusive_scan(valid)[i]``.
    Returns (packed pytree, out_valid); ``capacity`` defaults to the input's."""
    cap = capacity or valid.shape[0]
    pos = exclusive_scan(valid.to(torch.int32))
    # dead lanes (and live ones past the capacity) land in a spare slot that
    # is sliced off: the JAX package's out-of-bounds scatter drop
    tgt = torch.where(valid & (pos < cap), pos, cap).to(torch.int64)

    def one(v):
        out = torch.zeros((cap + 1,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        out[tgt] = v
        return out[:cap]
    count = valid.sum(dtype=torch.int32)
    out_valid = torch.arange(cap, dtype=torch.int32, device=valid.device) < count
    return tree_map(one, values), out_valid


def _counts(key: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each of ``0..n-1`` in ``key`` (int32 ``[n]``), without
    the host read ``bincount`` makes on the card."""
    out = torch.zeros((n,), dtype=torch.int32, device=key.device)
    return out.index_add_(0, key.to(torch.int64), torch.ones_like(key, dtype=torch.int32))


def partition_by_destination(dest: torch.Tensor, valid: torch.Tensor, n_dest: int,
                             capacity_per_dest: int, return_counts: bool = False):
    """Group lanes by destination: (gather_idx ``[n_dest, cap]``, out_valid
    ``[n_dest, cap]``). A destination with more than ``capacity_per_dest``
    live lanes overflows: the lanes past its budget are not in the gather
    table; ``return_counts=True`` adds the unclamped live counts ``[n_dest]``
    so the caller can re-route them. Out-of-range destinations (negative ones
    included) go to a discarded extra bucket."""
    c = dest.shape[0]
    key = torch.where(valid & (dest >= 0) & (dest < n_dest), dest,
                      torch.full_like(dest, n_dest)).to(torch.int32)
    order = torch.argsort(key, stable=True).to(torch.int32)    # grouped by destination
    counts = _counts(key, n_dest + 1)[:n_dest]
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    lane = torch.arange(capacity_per_dest, dtype=torch.int32, device=dest.device)
    gather_idx = (offsets[:, None] + lane[None, :]).clamp(0, c - 1)
    out_valid = lane[None, :] < counts[:, None]
    idx = order[gather_idx.to(torch.int64)]
    return (idx, out_valid, counts) if return_counts else (idx, out_valid)


def partition_by_destination_onehot(dest: torch.Tensor, valid: torch.Tensor,
                                    n_dest: int, capacity_per_dest: int,
                                    return_counts: bool = False):
    """Sort-free form of :func:`partition_by_destination` for small fan-out:
    each lane's rank within its destination from a one-hot cumsum, then one
    scatter builds the gather table. Same contract."""
    c = dest.shape[0]
    cap = capacity_per_dest
    dev = dest.device
    valid = valid & (dest >= 0) & (dest < n_dest)
    oh = (dest[:, None] == torch.arange(n_dest, dtype=dest.dtype, device=dev)[None, :]) \
        & valid[:, None]
    ranks = torch.cumsum(oh.to(torch.int32), 0, dtype=torch.int32)     # [C, D] inclusive
    dclip = dest.clamp(0, n_dest - 1).to(torch.int64)
    rank = ranks.gather(1, dclip[:, None])[:, 0] - 1
    counts = ranks[-1] if c else torch.zeros((n_dest,), dtype=torch.int32, device=dev)
    tgt = torch.where(valid & (rank < cap), dclip * cap + rank, n_dest * cap)
    table = torch.zeros((n_dest * cap + 1,), dtype=torch.int32, device=dev)
    table[tgt.to(torch.int64)] = torch.arange(c, dtype=torch.int32, device=dev)
    gather_idx = table[:n_dest * cap].reshape(n_dest, cap)
    lane = torch.arange(cap, dtype=torch.int32, device=dev)
    out_valid = lane[None, :] < counts.clamp(max=cap)[:, None]
    return (gather_idx, out_valid, counts) if return_counts else (gather_idx, out_valid)

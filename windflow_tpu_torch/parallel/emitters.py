"""Emitters — batch-level routing between pipeline segments.

Counterpart of ``windflow_tpu/parallel/emitters.py`` (reference L2). The
reference's emitters scatter tuples to replica queues; here they route whole
micro-batches, or partition one batch into per-destination sub-batches, with
the partitioning done on the device (``ops/compaction.py``):

- :class:`Standard_Emitter`: FORWARD (whole batches round-robin) or KEYBY
  (``routing_func(key, n)`` per lane, lossless: lanes past a destination's
  ``capacity_per_dest`` are re-partitioned in further passes, the blocking
  bounded queue of the reference, ``wf/standard_emitter.hpp:42-132``);
- :class:`Broadcast_Emitter`: every destination gets the batch;
- :class:`Splitting_Emitter`: a user split function per tuple (an int
  branch, or a ``[n]`` bool multicast mask), ``wf/splitting_emitter.hpp``;
- :class:`Tree_Emitter`: a root emitter, then one child emitter per root
  destination, ``wf/tree_emitter.hpp``.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import torch

from ..basic import routing_modes_t
from ..batch import Batch, concat_batches, map_tuples, tree_map
from ..ops.compaction import partition_by_destination, partition_by_destination_onehot


def _pad_batch_pow2(b: Batch) -> Batch:
    """Pad a batch's capacity up to the next power of two with invalid lanes."""
    C = b.capacity
    P = 1
    while P < C:
        P *= 2
    if P == C:
        return b
    pz = lambda a: torch.cat([a, a.new_zeros((P - C,) + tuple(a.shape[1:]))])  # noqa: E731
    return Batch(key=pz(b.key), id=pz(b.id), ts=pz(b.ts),
                 payload=tree_map(pz, b.payload), valid=pz(b.valid))


def split_masks(sel: torch.Tensor, n: int) -> List[torch.Tensor]:
    """The keep mask of each of ``n`` branches from a split function's
    output: an int branch per lane (compared with ``== i`` as int32, like
    ``jax.vmap``'s traced int), or a ``[C, n]`` multicast mask."""
    if sel.ndim == 2:
        return [sel[:, i].to(torch.bool) for i in range(n)]
    sel = sel.to(torch.int32)
    return [sel == i for i in range(n)]


class Basic_Emitter:
    """Pluggable routing node (``wf/basic_emitter.hpp:40-57``): one input
    batch to a list of per-destination batches."""

    def __init__(self, n_dest: int):
        self.n_dest = int(n_dest)

    def getNDestinations(self) -> int:
        return self.n_dest

    def clone(self) -> "Basic_Emitter":
        return copy.copy(self)

    def route(self, batch: Batch) -> List[Optional[Batch]]:
        raise NotImplementedError


class Standard_Emitter(Basic_Emitter):
    """FORWARD / KEYBY routing; KEYBY is lossless (``overflow_rounds`` counts
    the extra passes; the one-pass path reads nothing back to the host)."""

    def __init__(self, n_dest: int, mode: routing_modes_t = routing_modes_t.FORWARD,
                 routing_func: Callable = None, capacity_per_dest: int = None,
                 partition: str = "sort"):
        super().__init__(n_dest)
        self.mode = mode
        self.routing_func = routing_func or (lambda h, n: h % n)
        self.capacity_per_dest = capacity_per_dest
        if partition not in ("sort", "onehot"):
            raise ValueError(f"Standard_Emitter: partition must be 'sort' or "
                             f"'onehot', got {partition!r}")
        self.partition = partition
        self._rr = 0
        self.overflow_rounds = 0

    def _dest(self, batch: Batch) -> torch.Tensor:
        return self.routing_func(batch.key, self.n_dest).to(torch.int32)

    def _partition(self, batch: Batch, cap: int) -> List[Batch]:
        part = (partition_by_destination_onehot if self.partition == "onehot"
                else partition_by_destination)
        idx, ov = part(self._dest(batch), batch.valid, self.n_dest, cap)
        return [batch.select(idx[d], ov[d]) for d in range(self.n_dest)]

    def _partition_resid(self, batch: Batch, cap: int):
        """Partition plus residue: the lanes ranked past the budget stay valid
        in the returned mask for the next pass."""
        from ..ops.segment import segment_rank
        subs = self._partition(batch, cap)
        dest = self._dest(batch)
        in_range = (dest >= 0) & (dest < self.n_dest)
        rank = segment_rank(torch.where(batch.valid & in_range, dest,
                                        torch.full_like(dest, self.n_dest)), batch.valid)
        resid = batch.valid & in_range & (rank >= cap)
        return subs, resid, resid.sum(dtype=torch.int32)

    def route(self, batch: Batch) -> List[Optional[Batch]]:
        if self.mode == routing_modes_t.KEYBY:
            cap = self.capacity_per_dest or batch.capacity
            if cap >= batch.capacity:      # overflow impossible: one pass
                return self._partition(batch, cap)
            outs, cur = None, batch
            while True:
                subs, resid, n_resid = self._partition_resid(cur, cap)
                outs = (subs if outs is None else
                        [concat_batches(a, b) for a, b in zip(outs, subs)])
                if int(n_resid) == 0:
                    if outs and outs[0].capacity > cap:     # several rounds
                        outs = [_pad_batch_pow2(b) for b in outs]
                    return outs
                self.overflow_rounds += 1
                cur = cur.replace(valid=resid)
        # FORWARD: whole batches round-robin
        out: List[Optional[Batch]] = [None] * self.n_dest
        out[self._rr % self.n_dest] = batch
        self._rr += 1
        return out


class Broadcast_Emitter(Basic_Emitter):
    def route(self, batch: Batch) -> List[Batch]:
        return [batch] * self.n_dest


class Splitting_Emitter(Basic_Emitter):
    def __init__(self, split_fn: Callable, n_dest: int):
        super().__init__(n_dest)
        self.split_fn = split_fn

    def route(self, batch: Batch) -> List[Batch]:
        sel = map_tuples(self.split_fn, batch)
        return [batch.mask(keep) for keep in split_masks(sel, self.n_dest)]


class Tree_Emitter(Basic_Emitter):
    """Root emitter fans out to child emitters; destination j of child i is
    global destination ``sum(n_dest of children < i) + j``."""

    def __init__(self, root: Basic_Emitter, children: Sequence[Basic_Emitter]):
        if root.getNDestinations() != len(children):
            raise ValueError("root destinations must equal number of children")
        super().__init__(sum(c.getNDestinations() for c in children))
        self.root = root
        self.children = [c.clone() for c in children]

    def route(self, batch: Batch) -> List[Optional[Batch]]:
        out: List[Optional[Batch]] = []
        for child, b in zip(self.children, self.root.route(batch)):
            if b is None:
                out.extend([None] * child.getNDestinations())
            else:
                out.extend(child.route(b))
        return out

"""Asynchronous device-to-host result shipping — the latency path of a sink.

Counterpart of ``windflow_tpu/runtime/async_sink.py``. A synchronous fetch
makes the host wait for the card once a batch. :class:`AsyncResultShipper`
instead starts a ``non_blocking`` device-to-host copy into pinned host memory
the moment a result is shipped and records a CUDA event behind it; a result
is harvested (handed back as numpy) only after its event has completed, in
ship order, so result transfers overlap the card's next steps (the reference
GPU operators' ``cudaMemcpyAsync`` discipline, ``wf/win_seq_gpu.hpp:243-260``).
On the CPU the copy is synchronous.

Usage::

    shipper = AsyncResultShipper(depth=4)
    for i, batch in enumerate(stream):
        shipper.ship(step(batch), tag=i)        # starts the copy, never blocks
        for rec in shipper.harvest():           # older results, in order
            sink(rec.value)
    for rec in shipper.drain():                 # EOS
        sink(rec.value)
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Optional

import torch

from ..batch import tree_leaves, tree_map


@dataclasses.dataclass
class ShippedResult:
    tag: Any              # the caller's identifier (e.g. the step index)
    value: Any            # pytree of numpy arrays on the host
    ship_time: float      # perf_counter at ship()
    receipt_time: float   # perf_counter when the host copy was handed back


def _start_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned and ``non_blocking`` from the card,
    synchronous from the CPU."""
    if t.device.type == "cuda":
        host = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)
    return t.detach().clone()


class AsyncResultShipper:
    """Overlapped device-to-host shipping of result pytrees. ``depth``:
    ``harvest()`` leaves this many newest results in flight."""

    def __init__(self, depth: int = 4):
        self.depth = int(depth)
        self._inflight: deque = deque()

    def ship(self, arrays: Any, tag: Any = None) -> None:
        """Start the copy of ``arrays`` (a pytree of tensors) and return."""
        host = tree_map(_start_copy, arrays)
        event = None
        cuda = [t for t in tree_leaves(arrays) if t.device.type == "cuda"]
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cuda[0].device))
        self._inflight.append((time.perf_counter(), tag, host, event))

    def harvest(self, keep_inflight: Optional[int] = None) -> List[ShippedResult]:
        """The results older than the in-flight window, in ship order, each
        after its copy's event has completed."""
        keep = self.depth if keep_inflight is None else keep_inflight
        out: List[ShippedResult] = []
        while len(self._inflight) > keep:
            ship_t, tag, host, event = self._inflight.popleft()
            if event is not None:
                event.synchronize()
            out.append(ShippedResult(tag=tag, value=tree_map(lambda t: t.numpy(), host),
                                     ship_time=ship_t, receipt_time=time.perf_counter()))
        return out

    def drain(self) -> List[ShippedResult]:
        """EOS: everything still in flight."""
        return self.harvest(keep_inflight=0)

    def __len__(self) -> int:
        return len(self._inflight)

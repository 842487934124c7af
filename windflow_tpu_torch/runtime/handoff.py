"""The hand-off of a batch from one CUDA stream to another.

Every stage thread of the threaded drivers (``runtime/threaded.py``,
``PipeGraph.run(threaded=True)``) and the prefetch worker of the host sources
(``operators/source.py::prefetch_to_device``) launches its work on a CUDA
stream of its own. A batch made on stage A's stream and read on stage B's
needs two things, and this module is the one place that does them:

- B's stream waits on an event that A recorded after the kernels that wrote
  the batch (:func:`send` records it, :func:`receive` waits on it). The host
  does not wait.
- Every tensor of the batch (key, id, ts, valid and each payload leaf) is
  ``record_stream``-ed to B's stream, so that the caching allocator does not
  hand the memory out again once A drops its reference while B's kernels
  have yet to read it.

A batch on the CPU carries no event and needs neither: both calls are then
pass-throughs. End-of-stream markers are sent bare, without an event.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..batch import Batch, tree_leaves


def batch_tensors(batch: Batch):
    """Every tensor of ``batch``: the control fields, then the payload leaves."""
    return [batch.key, batch.id, batch.ts, batch.valid, *tree_leaves(batch.payload)]


def send(batch: Batch) -> Tuple[Batch, Optional[torch.cuda.Event]]:
    """``(batch, event)`` for the consumer: on the card, an event recorded on
    the current stream behind the work that made ``batch``; None on the CPU."""
    if batch.device.type != "cuda":
        return batch, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(batch.device))
    return batch, event


def receive(item: Tuple[Batch, Optional[torch.cuda.Event]]) -> Batch:
    """The batch of a :func:`send`, ready for the current stream: it waits on
    the producer's event and every tensor is recorded to it."""
    batch, event = item
    if event is not None:
        stream = torch.cuda.current_stream(batch.device)
        stream.wait_event(event)
        for t in batch_tensors(batch):
            t.record_stream(stream)
    return batch


__all__ = ["batch_tensors", "receive", "send"]

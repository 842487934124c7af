"""Sink — stream absorption.

Counterpart of ``windflow_tpu/operators/sink.py`` (reference ``wf/sink.hpp``):

- :class:`Sink`: host callback invoked once per batch with the live tuples as
  numpy arrays, ``{"key", "id", "ts", "payload"}`` — the same keys as the JAX
  package's view — and with ``None`` at EOS (the empty-optional convention).
  ``async_depth > 0`` ships each batch through an
  :class:`~windflow_tpu_torch.runtime.async_sink.AsyncResultShipper`: its
  copy to the host starts at once, and the callback receives it, in batch
  order, once ``async_depth`` newer batches are shipped and its copy has
  completed (EOS drains them all first);
- :class:`ReduceSink`: an in-graph reduction kept on the device and read once
  at the end (``chain.result()``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..basic import routing_modes_t
from ..batch import Batch, map_tuples, spec_of, tree_leaves, tree_map
from ..context import RuntimeContext
from ..meta import classify_sink
from .base import Basic_Operator


class Sink(Basic_Operator):
    def __init__(self, fn: Callable, *, name: str = "sink", parallelism: int = 1,
                 keyed: bool = False, async_depth: int = 0,
                 context: Optional[RuntimeContext] = None, device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.is_rich = classify_sink(fn)
        self.routing = routing_modes_t.KEYBY if keyed else routing_modes_t.FORWARD
        self.async_depth = int(async_depth)
        self._shipper = None
        self.context = context or RuntimeContext(parallelism, 0)

    def _deliver(self, view):
        if self.is_rich:
            self.fn(view, self.context)
        else:
            self.fn(view)

    def _deliver_host(self, host: dict):
        """Deliver the live lanes of a host batch (numpy fields)."""
        v = host["valid"]
        rec = self._stats[0]
        rec.bytes_copied_dh += sum(a.nbytes for a in tree_leaves(host))
        n_live = int(v.sum())
        rec.record_input(n_live)
        if n_live:
            self._deliver({"key": host["key"][v], "id": host["id"][v],
                           "ts": host["ts"][v],
                           "payload": tree_map(lambda a: a[v], host["payload"])})

    def consume(self, batch: Optional[Batch]):
        """Host side: deliver one batch (or None at EOS) to the user callback."""
        if self.async_depth:
            if self._shipper is None:
                from ..runtime.async_sink import AsyncResultShipper
                self._shipper = AsyncResultShipper(depth=self.async_depth)
            if batch is None:
                for rec in self._shipper.drain():
                    self._deliver_host(rec.value)
                self._deliver(None)
                return
            self._shipper.ship(_fields(batch))
            for rec in self._shipper.harvest():
                self._deliver_host(rec.value)
            return
        if batch is None:
            self._deliver(None)
            return
        self._deliver_host(batch.to_host())


def _fields(batch: Batch) -> dict:
    return {"key": batch.key, "id": batch.id, "ts": batch.ts, "payload": batch.payload,
            "valid": batch.valid}


_REDUCERS = {torch.add: lambda v: v.sum(dim=0, dtype=v.dtype),
             torch.maximum: lambda v: v.amax(dim=0),
             torch.minimum: lambda v: v.amin(dim=0)}


class ReduceSink(Basic_Operator):
    """In-graph reduction sink: ``value_fn(t) -> pytree`` per tuple, combined
    over the whole stream with ``combine`` (``torch.add`` by default;
    ``torch.maximum`` and ``torch.minimum`` also ported) into a device-resident
    accumulator."""

    def __init__(self, value_fn: Callable, *, combine: Callable = None, identity=0,
                 name: str = "reduce_sink", parallelism: int = 1, device=None):
        super().__init__(name, parallelism, device)
        self.value_fn = value_fn
        self.combine = combine or torch.add
        if self.combine not in _REDUCERS:
            raise NotImplementedError(
                f"{name}: ReduceSink combines torch.add/maximum/minimum so far; "
                f"general associative combines come with ROADMAP Queue 1 item 9")
        self.identity = identity

    def init_state(self, payload_spec: Any):
        val = spec_of(map_tuples(self.value_fn, Batch.empty(1, payload_spec, self.device)))
        return tree_map(lambda s: torch.full(tuple(s.shape), self.identity,
                                             dtype=s.dtype, device=self.device), val)

    def apply(self, state, batch: Batch):
        vals = map_tuples(self.value_fn, batch)
        reduce = _REDUCERS[self.combine]

        def red(acc, v):
            m = batch.valid.reshape(batch.valid.shape + (1,) * (v.ndim - 1))
            v = torch.where(m, v, torch.full((), self.identity, dtype=v.dtype,
                                             device=v.device))
            return self.combine(acc, reduce(v)).to(acc.dtype)
        return tree_map(red, state, vals), batch

    def result(self, state):
        return state

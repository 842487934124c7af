"""Sink — stream absorption.

Counterpart of ``windflow_tpu/operators/sink.py`` (reference ``wf/sink.hpp``):

- :class:`Sink`: host callback invoked once per batch with the live tuples as
  numpy arrays, ``{"key", "id", "ts", "payload"}`` — the same keys as the JAX
  package's view — and with ``None`` at EOS (the empty-optional convention);
- :class:`ReduceSink`: an in-graph reduction kept on the device and read once
  at the end (``chain.result()``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..basic import routing_modes_t
from ..batch import Batch, host_view, map_tuples, spec_of, tree_map
from ..context import RuntimeContext
from ..meta import classify_sink
from .base import Basic_Operator


class Sink(Basic_Operator):
    def __init__(self, fn: Callable, *, name: str = "sink", parallelism: int = 1,
                 keyed: bool = False, context: Optional[RuntimeContext] = None,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.is_rich = classify_sink(fn)
        self.routing = routing_modes_t.KEYBY if keyed else routing_modes_t.FORWARD
        self.context = context or RuntimeContext(parallelism, 0)

    def _deliver(self, view):
        if self.is_rich:
            self.fn(view, self.context)
        else:
            self.fn(view)

    def consume(self, batch: Optional[Batch]):
        """Host side: deliver one batch (or None at EOS) to the user callback."""
        if batch is None:
            self._deliver(None)
            return
        view = host_view(batch)
        rec = self._stats[0]
        rec.bytes_copied_dh += sum(
            t.numel() * t.element_size()
            for t in (batch.key, batch.id, batch.ts, batch.valid))
        n_live = len(view["key"])
        rec.record_input(n_live)
        if n_live:
            self._deliver(view)


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

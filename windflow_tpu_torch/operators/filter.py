"""Filter — drop-by-predicate.

Counterpart of ``windflow_tpu/operators/filter.py::Filter`` (reference
``wf/filter.hpp``): the predicate ``f(t) -> bool`` runs under ``vmap`` and
intersects the validity mask, with no data movement. The transforming flavour
``f(t) -> (payload, keep)`` (the reference's ``optional<result>`` signature)
replaces the payload and masks in one step; :class:`FilterMap` names it.
:class:`Compact` packs the live lanes to the front. Rich variants append a
context parameter.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..basic import routing_modes_t
from ..batch import Batch, abstract_spec, map_tuples
from ..context import RuntimeContext
from ..meta import SignatureError, classify_filter
from .base import Basic_Operator


class Filter(Basic_Operator):
    def __init__(self, fn: Callable, *, name: str = "filter", parallelism: int = 1,
                 keyed: bool = False, context: Optional[RuntimeContext] = None,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.is_rich = classify_filter(fn)
        self.routing = routing_modes_t.KEYBY if keyed else routing_modes_t.FORWARD
        self.context = context or RuntimeContext(parallelism, 0)

    def _call(self, t):
        r = self.fn(t, self.context) if self.is_rich else self.fn(t)
        if isinstance(r, tuple) and len(r) != 2:
            raise SignatureError(
                "Filter: accepted signatures are\n"
                "  f(t[, ctx]) -> bool                (predicate)\n"
                "  f(t[, ctx]) -> (payload, keep)     (optional/transforming)\n"
                f"got a {len(r)}-tuple")
        return r

    def out_spec(self, payload_spec: Any) -> Any:
        out = abstract_spec(lambda dev: map_tuples(self._call,
                                                   Batch.empty(1, payload_spec, dev)))
        return out[0] if isinstance(out, tuple) else payload_spec

    def apply(self, state, batch: Batch):
        out = map_tuples(self._call, batch)
        if isinstance(out, tuple):
            payload, keep = out
            return state, batch.with_payload(payload).mask(keep.to(torch.bool))
        return state, batch.mask(out.to(torch.bool))


class FilterMap(Filter):
    """The transforming Filter flavour under its own name: ``f(t) -> (payload,
    keep)``, the reference's ``optional<result>(const tuple&)`` signature.
    :class:`Filter` deduces the same flavour from the return value; this
    class only fixes the default name."""

    def __init__(self, fn: Callable, *, name: str = "filtermap", parallelism: int = 1,
                 context: Optional[RuntimeContext] = None, device=None):
        super().__init__(fn, name=name, parallelism=parallelism, context=context,
                         device=device)


class Compact(Basic_Operator):
    """Pack live lanes to the front (stable): opt-in densification after a
    selective filter, the reference GPU emitter's compaction pass."""

    def __init__(self, *, name: str = "compact", device=None):
        super().__init__(name, 1, device)

    def apply(self, state, batch: Batch):
        return state, batch.compact()

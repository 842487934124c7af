"""Map, BatchMap and KeyBy — one-to-one transformations.

Counterparts of ``windflow_tpu/operators/map.py`` (reference ``wf/map.hpp``):

- :class:`Map`: per-tuple ``f(t) -> payload`` under ``vmap``, or in place:
  ``f(t) -> None`` writes payload fields of a
  :class:`~windflow_tpu_torch.batch.MutableTupleRef` (``t.v = t.v * 2``), the
  reference's ``void(tuple_t&)``. ``KeyedMap`` is not ported (ROADMAP Queue 1
  item 9);
- :class:`BatchMap`: ``fn(payload_of_[C, ...]) -> payload`` over whole
  tensors — joins through table lookups, projections, casts;
- :class:`KeyBy`: ``key = fn(t) mod num_keys`` rewrites the key control field.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..basic import routing_modes_t
from ..batch import Batch, MutableTupleRef, map_tuples, spec_of
from ..context import RuntimeContext
from ..meta import SignatureError, classify_map
from .base import Basic_Operator


class Map(Basic_Operator):
    def __init__(self, fn: Callable, *, name: str = "map", parallelism: int = 1,
                 keyed: bool = False, context: Optional[RuntimeContext] = None,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.is_rich = classify_map(fn)
        self.routing = routing_modes_t.KEYBY if keyed else routing_modes_t.FORWARD
        self.context = context or RuntimeContext(parallelism, 0)

    def _call(self, t):
        m = MutableTupleRef(t) if isinstance(t.data, dict) else t
        r = self.fn(m, self.context) if self.is_rich else self.fn(m)
        if r is None:
            if not isinstance(m, MutableTupleRef):
                raise SignatureError(
                    "Map: f returned None (in-place flavour) but the payload is "
                    "not a dict of named fields; return the new payload instead")
            return m._payload()
        return r

    def out_spec(self, payload_spec: Any) -> Any:
        return spec_of(map_tuples(self._call, Batch.empty(1, payload_spec, self.device)))

    def apply(self, state, batch: Batch):
        return state, batch.with_payload(map_tuples(self._call, batch))


class KeyBy(Basic_Operator):
    """Re-key the stream: ``key = fn(t) mod num_keys`` (floored, as in the JAX
    package). ``fn`` takes a TupleRef; the rich variant takes ``(t, ctx)``."""

    def __init__(self, fn: Callable, num_keys: int, *, name: str = "keyby",
                 parallelism: int = 1, context: Optional[RuntimeContext] = None,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.num_keys = int(num_keys)
        self.is_rich = classify_map(fn)
        self.routing = routing_modes_t.KEYBY
        self.context = context or RuntimeContext(parallelism, 0)

    def apply(self, state, batch: Batch):
        one = (lambda t: self.fn(t, self.context)) if self.is_rich else self.fn
        key = map_tuples(one, batch).to(batch.key.dtype)
        return state, batch.replace(key=key % self.num_keys)


class BatchMap(Basic_Operator):
    """Batch-level map: ``fn(payload_pytree_of_[C,...]) -> payload_pytree``."""

    def __init__(self, fn: Callable, *, name: str = "batch_map", parallelism: int = 1,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn

    def out_spec(self, payload_spec: Any) -> Any:
        return spec_of(self.fn(Batch.empty(1, payload_spec, self.device).payload))

    def apply(self, state, batch: Batch):
        return state, batch.with_payload(self.fn(batch.payload))

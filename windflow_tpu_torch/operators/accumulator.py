"""Accumulator — per-key rolling reduce.

Counterpart of ``windflow_tpu/operators/accumulator.py`` (reference
``wf/accumulator.hpp``, class at ``:61``, per-key state map ``:103-104``):
each tuple is folded into its key's accumulator (seeded with ``init_value``)
and the tuple's output is the updated accumulator. Routing is always KEYBY.

The per-key table lives on the device (``[K, ...]``). A batch runs a
segmented inclusive prefix scan in stream order with the table carried in
(``ops/segment.py::segment_prefix_scan``), then folds each key's batch total
into the table: ``segment_reduce`` for ``torch.add`` (kernel K3 for integer
values, the fixed-order float fold for floats), the combine over the keys the
batch touched otherwise.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..basic import routing_modes_t, DEFAULT_MAX_KEYS
from ..batch import Batch, abstract_spec, map_tuples, tree_map
from ..ops.segment import as_identity, identity_full, segment_prefix_scan, segment_reduce
from .base import Basic_Operator


class Accumulator(Basic_Operator):
    """Associative rolling reduce. ``value_fn(t) -> pytree`` is the value
    folded; ``combine(a, b)`` the associative fold (default ``torch.add``)
    with ``identity``; ``init_value`` seeds every key. Emits per input tuple
    the accumulator after its fold."""

    routing = routing_modes_t.KEYBY

    def __init__(self, value_fn: Callable, *, init_value: Any = 0.0,
                 combine: Callable = None, identity: Any = 0,
                 num_keys: int = DEFAULT_MAX_KEYS, name: str = "accumulator",
                 parallelism: int = 1, device=None):
        super().__init__(name, parallelism, device)
        self.value_fn = value_fn
        self.combine = combine or torch.add
        self.identity = as_identity(identity, self.device)
        self.init_value = as_identity(init_value, self.device)
        self.num_keys = int(num_keys)

    def out_spec(self, payload_spec: Any) -> Any:
        return abstract_spec(lambda dev: map_tuples(self.value_fn,
                                                    Batch.empty(1, payload_spec, dev)))

    def init_state(self, payload_spec: Any):
        return tree_map(lambda s: identity_full(self.init_value, s.dtype, self.device,
                                                (self.num_keys,) + tuple(s.shape)),
                        self.out_spec(payload_spec))

    def apply(self, state, batch: Batch):
        vals = map_tuples(self.value_fn, batch)
        add = self.combine is torch.add
        prefix = segment_prefix_scan(vals, batch.key, batch.valid, self.combine,
                                     self.identity, carry_in=state)
        batch_red = segment_reduce(vals, batch.key, batch.valid, self.num_keys,
                                   combine=None if add else self.combine,
                                   identity=self.identity)
        if add:
            state = tree_map(torch.add, state, batch_red)
        else:
            touched = segment_reduce(torch.ones_like(batch.key), batch.key, batch.valid,
                                     self.num_keys) > 0
            state = tree_map(
                lambda t, r: torch.where(touched.reshape(touched.shape + (1,) * (r.ndim - 1)),
                                         self.combine(t, r), t),
                state, batch_red)
        return state, batch.with_payload(prefix)

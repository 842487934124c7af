"""Source — stream generation on the device.

Counterpart of ``windflow_tpu/operators/source.py::DeviceSource`` in its itemized
flavour (reference ``wf/source.hpp``, ``bool(tuple_t&)``): ``f(i) -> payload``
runs under ``torch.func.vmap`` over the global tuple index tensor, so a batch is
generated on the device with no host-to-device traffic. ``key_fn(i)`` and
``ts_fn(i)`` set the control fields (``setControlFields``). The loop flavour
(``f(i, shipper)``), ``GeneratorSource`` and ``RecordSource`` come in later
slices.

The index is ``int32`` (:data:`CTRL_DTYPE`), exactly as in the JAX package:
index arithmetic in user functions (YSB's ``(i * 7919) % N_ADS``) wraps at
2^31 the same way, so the two packages generate the same stream.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import torch

from ..basic import routing_modes_t, DEFAULT_BATCH_SIZE
from ..batch import Batch, CTRL_DTYPE, spec_of, vmap_lanes
from ..context import RuntimeContext
from ..meta import classify_source_flavour
from .base import Basic_Operator

_I32_MAX = torch.iinfo(CTRL_DTYPE).max


class SourceBase(Basic_Operator):
    routing = routing_modes_t.NONE

    def batches(self, batch_size: int) -> Iterator[Batch]:
        raise NotImplementedError

    def out_capacity(self, batch_size: int) -> int:
        return batch_size

    def payload_spec(self) -> Any:
        raise NotImplementedError


class DeviceSource(SourceBase):
    """Synthetic on-device source: ``payload = vmap(f)(global_index)``."""

    def __init__(self, fn: Callable, total: int, *, name: str = "source",
                 parallelism: int = 1, key_fn: Callable = None, ts_fn: Callable = None,
                 num_keys: int = 1, context: Optional[RuntimeContext] = None,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.is_loop, self.is_rich = classify_source_flavour(fn)
        if self.is_loop:
            raise NotImplementedError(
                f"{name}: the loop Source flavour f(i, shipper) is not ported "
                f"yet (ROADMAP Queue 1 item 3); use the itemized f(i) -> payload")
        self.total = int(total)
        self.key_fn = key_fn
        self.ts_fn = ts_fn
        self.num_keys = num_keys
        self.context = context or RuntimeContext(parallelism, 0)

    def _payload_fn(self):
        return (lambda x: self.fn(x, self.context)) if self.is_rich else self.fn

    def make_batch(self, start, batch_size: int) -> Batch:
        """The batch of global indices ``[start, start + batch_size)``;
        ``start`` is an int or an int32 device scalar (the device cursor)."""
        start = torch.as_tensor(start, dtype=CTRL_DTYPE, device=self.device)
        i = start + torch.arange(batch_size, dtype=CTRL_DTYPE, device=self.device)
        if self.key_fn is not None:
            key = vmap_lanes(self.key_fn, i).to(CTRL_DTYPE)
        elif self.num_keys > 1:
            key = i % self.num_keys
        else:
            key = torch.zeros_like(i)
        ts = vmap_lanes(self.ts_fn, i).to(CTRL_DTYPE) if self.ts_fn else i
        payload = vmap_lanes(self._payload_fn(), i)
        return Batch(key=key, id=i, ts=ts, payload=payload, valid=i < self.total)

    def payload_spec(self):
        i = torch.zeros((1,), dtype=CTRL_DTYPE, device=self.device)
        return spec_of(vmap_lanes(self._payload_fn(), i))

    def batches(self, batch_size: int = DEFAULT_BATCH_SIZE):
        """The stream as device batches. The cursor is a device scalar advanced
        on the device: no host-to-device copy per batch."""
        if self.total > _I32_MAX:
            raise ValueError(
                f"DeviceSource total={self.total} exceeds the i32 control dtype "
                f"({_I32_MAX}); chunk the stream into multiple sources/runs")
        cur = torch.zeros((), dtype=CTRL_DTYPE, device=self.device)
        for _ in range(0, self.total, batch_size):
            b = self.make_batch(cur, batch_size)
            cur = cur + batch_size
            yield b


# reference-style alias
Source = DeviceSource

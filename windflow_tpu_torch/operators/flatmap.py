"""FlatMap — one-to-many transformation.

Counterpart of ``windflow_tpu/operators/flatmap.py`` (reference
``wf/flatmap.hpp``, class at ``:61``): the user function ``f(t, shipper)``
(rich: ``f(t, shipper, ctx)``) calls ``shipper.push(payload, when=...,
key=..., ts=...)`` up to ``max_fanout`` times. It runs once under
``torch.func.vmap``: the pushes are recorded and stacked into ``max_fanout``
slots a tuple, so a batch of capacity C becomes one of capacity
``C * max_fanout`` with a validity mask (``when`` makes the number of tuples
an input emits data-dependent at a fixed shape).

Output control fields: a push keeps the input's ``key`` and ``ts`` unless it
gives its own; output ``id`` is ``id * max_fanout + j`` for push j (windowed
consumers renumber, the reference's emit counter).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..basic import routing_modes_t
from ..batch import Batch, CTRL_DTYPE, TupleRef, abstract_spec, tree_map, vmap_lanes
from ..context import RuntimeContext
from ..meta import classify_flatmap
from ..shipper import Shipper
from .base import Basic_Operator


class FlatMap(Basic_Operator):
    routing = routing_modes_t.FORWARD

    def __init__(self, fn: Callable, *, max_fanout: int, name: str = "flatmap",
                 parallelism: int = 1, context: Optional[RuntimeContext] = None,
                 device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.is_rich = classify_flatmap(fn)
        self.max_fanout = int(max_fanout)
        self.context = context or RuntimeContext(parallelism, 0)

    def out_capacity(self, in_capacity: int) -> int:
        return in_capacity * self.max_fanout

    @staticmethod
    def _on_device(x, dtype, device) -> torch.Tensor:
        """A pushed control value or ``when`` on the lanes' device. A host
        constant (a Python value, or the 0-d CPU tensor ``Shipper`` makes of
        one) becomes a ``torch.full``: a copy from the host would be refused
        by a CUDA-graph capture."""
        if isinstance(x, torch.Tensor) and x.device == device:
            return x.to(dtype)
        if isinstance(x, torch.Tensor):
            x = x.item()
        return torch.full((), x, dtype=dtype, device=device)

    def _per_tuple(self, key, id_, ts, data):
        """One tuple's pushes stacked: (payload ``[F, ...]``, when, key and ts
        ``[F]``); slots past the last push repeat the first, masked off."""
        t = TupleRef(key=key, id=id_, ts=ts, data=data)
        sh = Shipper(self.max_fanout)
        if self.is_rich:
            self.fn(t, sh, self.context)
        else:
            self.fn(t, sh)
        payloads, whens, keys, tss = sh._recorded()
        n = len(payloads)
        if n == 0:
            raise ValueError("FlatMap function pushed nothing (need >=1 push; use "
                             "when=False for a conditional no-emit)")
        pad = self.max_fanout - n
        dev = key.device
        whn = [self._on_device(w, torch.bool, dev) for w in whens + [False] * pad]
        ks = [self._on_device(key if k is None else k, CTRL_DTYPE, dev)
              for k in keys + [None] * pad]
        xs = [self._on_device(ts if x is None else x, CTRL_DTYPE, dev)
              for x in tss + [None] * pad]
        return (tree_map(lambda *ls: torch.stack(ls), *(payloads + [payloads[0]] * pad)),
                torch.stack(whn), torch.stack(ks), torch.stack(xs))

    def _pushes(self, batch: Batch):
        return vmap_lanes(self._per_tuple, batch.key, batch.id, batch.ts, batch.payload)

    def out_spec(self, payload_spec: Any) -> Any:
        return abstract_spec(lambda dev: tree_map(                # drop the fan-out axis
            lambda a: a[:, 0], self._pushes(Batch.empty(1, payload_spec, dev))[0]))

    def apply(self, state, batch: Batch):
        C, F = batch.capacity, self.max_fanout
        pay, when, key, ts = self._pushes(batch)
        flat = lambda a: a.reshape((C * F,) + tuple(a.shape[2:]))  # noqa: E731
        fan = torch.arange(F, dtype=CTRL_DTYPE, device=batch.device)
        return state, Batch(key=flat(key), id=flat(batch.id[:, None] * F + fan[None, :]),
                            ts=flat(ts), payload=tree_map(flat, pay),
                            valid=flat(when & batch.valid[:, None]))

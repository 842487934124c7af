"""Shipper — the push-style output handle of loop-flavour Source user code.

Counterpart of ``windflow_tpu/shipper.py`` (reference ``wf/shipper.hpp:50-104``).
The reference Shipper allocates and sends one tuple per ``push``; here the
pushes are recorded while the user function runs under ``torch.func.vmap``
and stacked into fixed fan-out slots: an index batch of capacity C with
``max_fanout`` F becomes a batch of capacity C * F with a validity mask.

``push(payload, when=..., key=..., ts=...)``: ``when`` masks a push per
tuple, the batched counterpart of calling ``shipper.push`` conditionally.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch


class Shipper:
    def __init__(self, max_fanout: int):
        self.max_fanout = int(max_fanout)
        self._payloads: List[Any] = []
        self._whens: List[Any] = []
        self._keys: List[Optional[Any]] = []
        self._ts: List[Optional[Any]] = []
        self.delivered = 0  # pushes recorded (the reference counts delivered tuples)

    def push(self, payload: Any, *, when=True, key=None, ts=None):
        if len(self._payloads) >= self.max_fanout:
            raise ValueError(
                f"Shipper: more than max_fanout={self.max_fanout} pushes; raise "
                f"max_fanout on the FlatMap/Source builder")
        self._payloads.append(payload)
        self._whens.append(torch.as_tensor(when).to(torch.bool))
        self._keys.append(key)
        self._ts.append(ts)
        self.delivered += 1

    def _recorded(self):
        return self._payloads, self._whens, self._keys, self._ts

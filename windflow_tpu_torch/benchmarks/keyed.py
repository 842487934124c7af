"""``bench.py``'s keyed-state configurations in the port.

- :func:`make_keyed_cb` is ``bench.py::bench_keyed_cb`` ("Config 3",
  ``bench.py:604-623``) as written: ``v = i % 97`` as float32 over 512 keys
  (key ``i % 512``) into ``Key_FFAT(lambda t: t.v, torch.add,
  spec=WindowSpec(1024, 512), num_keys=512)``, the per-key count-based
  FlatFAT path. At batch 2^20 its pane ring is ``[512, 4096]`` (P = 4096)
  and its fired-window budget W = 2112; an apply launches K2 once (the
  per-key count), K3 twice (occupancy counts at S = 2^21, per-key counts at
  S = 512) and the fixed-order float fold once (the pane sums at S = 2^21).
- :func:`make_keyed_stateful` is ``bench.py::bench_keyed_stateful``
  (``bench.py:808-834``, the MapGPU-stateful analogue swept over K = 1, 500
  and 10,000): ``v = i % 1000`` over ``num_keys`` keys into an
  ``Accumulator`` of ``max(K, 8)`` keys (the per-key running sum, one output
  a tuple) and a ``ReduceSink`` of its outputs. ``dtype=torch.int32`` gives
  the same stream with integer payloads, whose sums are exact.

The numpy oracles compute the same results from the stream's definition.
"""

from __future__ import annotations

import numpy as np
import torch

from ..operators.accumulator import Accumulator
from ..operators.sink import ReduceSink
from ..operators.source import DeviceSource
from ..operators.win_patterns import Key_FFAT
from ..operators.window import WindowSpec

KEYED_CB_KEYS = 512
KEYED_CB_WIN, KEYED_CB_SLIDE = 1024, 512


def make_keyed_cb(total: int, device=None):
    """``(source, [Key_FFAT])`` of ``bench_keyed_cb`` over ``total`` tuples."""
    src = DeviceSource(lambda i: {"v": (i % 97).float()}, total=total,
                       num_keys=KEYED_CB_KEYS, name="keyed_cb_source", device=device)
    op = Key_FFAT(lambda t: t.v, torch.add, spec=WindowSpec(KEYED_CB_WIN, KEYED_CB_SLIDE),
                  num_keys=KEYED_CB_KEYS, name="keyed_cb", device=device)
    return src, [op]


def keyed_cb_oracle(total: int) -> dict:
    """``{(key, window): sum}`` of :func:`make_keyed_cb` over ``total``
    tuples (a multiple of 512) and the flush: key k's arrival position p
    holds tuple ``p * 512 + k`` of value ``(p * 512 + k) % 97``; window w
    covers positions ``[512 w, 512 w + 1024)``."""
    K, L, S = KEYED_CB_KEYS, KEYED_CB_WIN, KEYED_CB_SLIDE
    n = total // K
    p = np.arange(n, dtype=np.int64)
    vals = (p[None, :] * K + np.arange(K)[:, None]) % 97
    csum = np.concatenate([np.zeros((K, 1), np.int64), np.cumsum(vals, 1)], 1)
    out = {}
    for w in range((n - 1) // S + 1):
        lo, hi = w * S, min(w * S + L, n)
        for k, v in enumerate((csum[:, hi] - csum[:, lo]).tolist()):
            out[(k, w)] = v
    return out


def make_keyed_stateful(num_keys: int, total: int, dtype=torch.float32, device=None):
    """``(source, [Accumulator, ReduceSink])`` of ``bench_keyed_stateful`` at
    ``num_keys`` keys over ``total`` tuples (``dtype``: the payload's)."""
    src = DeviceSource(lambda i: {"v": (i % 1000).to(dtype)}, total=total,
                       num_keys=num_keys, name="keyed_stateful_source", device=device)
    acc = Accumulator(lambda t: t.data["v"], init_value=0, num_keys=max(num_keys, 8),
                      name="keyed_stateful", device=device)
    return src, [acc, ReduceSink(lambda t: t.data, name="keyed_stateful_total",
                                 device=device)]


def keyed_stateful_oracle(num_keys: int, total: int) -> np.ndarray:
    """float64 ``[total]``: tuple i's output of :func:`make_keyed_stateful`,
    its key's running sum of ``v = i % 1000`` up to and including i (exact
    in float64)."""
    i = np.arange(total, dtype=np.int64)
    v = (i % 1000).astype(np.float64)
    if num_keys <= 1:
        return np.cumsum(v)
    order = np.argsort(i % num_keys, kind="stable")
    cs = np.cumsum(v[order])
    key_sorted = (i % num_keys)[order]
    starts = np.searchsorted(key_sorted, key_sorted)
    base = np.where(starts > 0, cs[np.maximum(starts - 1, 0)], 0.0)
    out = np.empty(total, np.float64)
    out[order] = cs - base
    return out

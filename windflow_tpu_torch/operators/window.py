"""Window descriptors, the batch-level triggerers, and the Iterable view.

Counterpart of ``windflow_tpu/operators/window.py`` (reference ``wf/window.hpp``,
``wf/iterable.hpp``). :class:`WindowSpec` is ``(win_len, slide, type,
delay)``, the builder-visible window definition. The reference triggers one
window event per tuple; here the same arithmetic is batch-level:

- a CB window ``w`` covers per-key arrival positions
  ``[w*slide, w*slide + win_len)``; a key with ``count`` archived tuples has
  every window with ``w*slide + win_len <= count`` FIRED;
- a TB window ``w`` covers timestamps ``[w*slide, w*slide + win_len)``; under
  the per-key watermark ``wm`` (max ts seen) and lateness ``delay`` every
  window with ``w*slide + win_len <= wm - delay + 1`` is FIRED.

:class:`Iterable` is the mask-aware view of one fired window's content handed
to non-incremental window functions. Win_Seq builds it inside the function it
vmaps over the fired windows, from plain ``(data, ids, ts, mask)`` arguments
(as ``batch.map_tuples`` builds a TupleRef), so it is no pytree node. Its
``sum`` and ``mean`` go through a one-row
``ops/window_reduce.py::masked_window_reduce`` (kernel K6 on the card) for
every 1-D leaf.

The session triggerer (``WindowSpec.session``) comes with SessionWindow
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..basic import win_type_t
from ..batch import TupleRef, tree_map
from ..ops.window_reduce import masked_sum, masked_window_reduce


def _floordiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    win_len: int
    slide: int
    wtype: win_type_t = win_type_t.CB
    delay: int = 0            # TB lateness (triggering_delay, wf/window.hpp:83-121)

    def __post_init__(self):
        if self.win_len <= 0 or self.slide <= 0:
            raise ValueError("win_len and slide must be positive")
        if self.delay < 0:
            raise ValueError("delay (lateness) must be >= 0")

    @property
    def is_cb(self):
        return self.wtype == win_type_t.CB

    # batch-level triggerer arithmetic (int32 in, int32 out) ---------------------

    def fired_hi_cb(self, count):
        """Exclusive upper bound of FIRED window ids for a key with ``count`` tuples."""
        return torch.clamp(_floordiv(count - self.win_len, self.slide) + 1, min=0)

    def fired_hi_tb(self, watermark):
        """Exclusive upper bound of FIRED window ids under per-key watermark (max ts)."""
        return torch.clamp(
            _floordiv(watermark - self.delay - self.win_len, self.slide) + 1, min=0)

    def flush_hi_cb(self, count):
        """At EOS every window with any content fires (partial allowed)."""
        return torch.where(count > 0, _floordiv(count - 1, self.slide) + 1, 0)

    def flush_hi_tb(self, max_ts, has_any):
        return torch.where(has_any, _floordiv(max_ts, self.slide) + 1, 0)


def _fill_max(dtype):
    return (torch.finfo(dtype).max if dtype.is_floating_point
            else torch.iinfo(dtype).max)


def _fill_min(dtype):
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


@dataclasses.dataclass(frozen=True)
class Iterable:
    """View over one fired window's content (under vmap: one row).

    ``data``: payload pytree ``[L, ...]``; ``ids``/``ts``: ``[L]``; ``mask``:
    ``[L]`` (False = absent slot: TB windows and EOS-flushed partial CB
    windows). Mirrors ``wf/iterable.hpp`` (begin/end/at/size) in mask-aware
    form, with the JAX package's fills and result dtypes: ``sum`` widens bool,
    int8 and int16 to int32 and keeps every other dtype (an int32 sum wraps);
    ``size`` is int32."""

    data: Any
    ids: torch.Tensor
    ts: torch.Tensor
    mask: torch.Tensor

    def __getattr__(self, name):
        data = object.__getattribute__(self, "data")
        if isinstance(data, dict) and name in data:
            return data[name]
        raise AttributeError(name)

    def size(self):
        return self.mask.to(torch.int32).sum(dtype=torch.int32)

    def at(self, i):
        """The i-th LIVE tuple of the window in order (reference ``at``/
        ``operator[]``): a one-hot select over the row. Out-of-range ``i``
        gives zeros (pair with ``size()``)."""
        pos = torch.cumsum(self.mask.to(torch.int32), 0, dtype=torch.int32) - 1
        onehot = self.mask & (pos == i)

        def pick(x):
            return masked_sum(x, onehot.reshape(onehot.shape + (1,) * (x.ndim - 1)), 0)
        return TupleRef(key=None, id=pick(self.ids), ts=pick(self.ts),
                        data=tree_map(pick, self.data))

    __getitem__ = at

    def first(self):
        """First live tuple (reference begin())."""
        return self.at(0)

    def last(self):
        """Last live tuple (reference end()-1)."""
        return self.at(self.size() - 1)

    # mask-aware reductions (the common window aggregations)
    def _extreme(self, x, is_max: bool):
        """Masked amax/amin with the JAX package's fills. uint16 and uint32
        go through int64 (torch has no ``where`` for them on the card) and
        come back in their own dtype."""
        fill = _fill_min(x.dtype) if is_max else _fill_max(x.dtype)
        w = x.to(torch.int64) if x.dtype in (torch.uint16, torch.uint32) else x
        m = self.mask.reshape(self.mask.shape + (1,) * (x.ndim - 1))
        w = torch.where(m, w, torch.full((), fill, dtype=w.dtype, device=w.device))
        return (w.amax(dim=0) if is_max else w.amin(dim=0)).to(x.dtype)

    def _field(self, field):
        return self.data[field] if field else self.data

    def sum(self, field=None):
        def red(x):
            if x.ndim == 1:
                return masked_window_reduce(x[None], self.mask[None])[0]
            return masked_sum(x, self.mask.reshape(self.mask.shape + (1,) * (x.ndim - 1)),
                              0)
        return tree_map(red, self._field(field))

    def max(self, field=None):
        return tree_map(lambda x: self._extreme(x, True), self._field(field))

    def min(self, field=None):
        return tree_map(lambda x: self._extreme(x, False), self._field(field))

    def mean(self, field=None):
        s = self.sum(field)
        n = torch.clamp(self.size(), min=1)
        def div(x):
            if not x.dtype.is_floating_point:     # an integer sum divides as float32
                x = x.to(torch.float32)
            return x / n.to(x.dtype)
        return tree_map(div, s)

"""Window descriptors.

Counterpart of ``windflow_tpu/operators/window.py::WindowSpec`` (reference
``wf/window.hpp``): ``(win_len, slide, type, delay)``, the builder-visible
window definition. A CB window ``w`` covers per-key arrival positions
``[w*slide, w*slide + win_len)``; a TB window ``w`` covers timestamps
``[w*slide, w*slide + win_len)`` and fires once the watermark passes its end
plus the lateness ``delay``.
"""

from __future__ import annotations

import dataclasses

from ..basic import win_type_t


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

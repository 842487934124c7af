"""The control plane's process-wide counters and gauges.

Counterpart of ``windflow_tpu/control/_state.py``: a flat dict behind a lock,
bumped from the actuation points (shed decisions, throttle waits, capacity
switches, remediation) and from the operators that count their own
(``sessions_closed``, ``topn_evictions``), and set where the JAX package
sets them (``chosen_capacity``, ``dispatch_k``, ``hot_capacity``,
``join_table_version``, ...); the metrics snapshot renders it as the
``control`` section. Kept in its own module so the rest of ``control/`` and
the operators import it without the package ``__init__``.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..observability.names import CONTROL_COUNTERS

_counters: Dict[str, float] = {k: 0 for k in CONTROL_COUNTERS}
_gauges: Dict[str, float] = {}
_lock = threading.Lock()


def bump(name: str, n: float = 1) -> None:
    """Add ``n`` to a process-wide control counter."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def set_gauge(name: str, value: float) -> None:
    """Publish a control gauge (last write wins)."""
    with _lock:
        _gauges[name] = value


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def gauges() -> Dict[str, float]:
    with _lock:
        return dict(_gauges)


def reset() -> None:
    """Zero every counter and drop every gauge (test isolation)."""
    with _lock:
        for k in list(_counters):
            _counters[k] = 0
        _gauges.clear()

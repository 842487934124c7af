"""Backpressure governor — per-edge high/low watermarks over SPSC ring depths.

Counterpart of ``windflow_tpu/control/governor.py``. It reads the depth of
the port's native rings (``native.SPSCQueue.size``) and never the card.

The threaded drivers' SPSC rings already provide *implicit* backpressure (a
full ring blocks the producer inside ``push``), but blocking there is
invisible: the producer wedges mid-push with no signal, no counter, and the
ring sits pegged at capacity. The governor makes backpressure *explicit and
observable*: the source loop calls :meth:`throttle` before each push; when any
watched edge's depth reaches its high watermark the source pauses — setting
``pause_event`` so a prefetch worker (``SourceBase.
batches_prefetched``) stops starting new host-to-device copies too — until every edge
drains to its low watermark. Every throttle episode is counted
(``windflow_control_throttle_*``) and journaled.

Watermarks are fractions of each edge's ring capacity (defaults 0.75 / 0.25),
so per-edge capacities (the ``queue_capacity`` dict/callable on the threaded
drivers) automatically scale their thresholds.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

from ..observability import journal as _journal
from ..observability import tracing as _tracing
from . import _state


class BackpressureGovernor:
    """Throttles a source loop on downstream ring depth."""

    def __init__(self, high_watermark: float = 0.75,
                 low_watermark: float = 0.25, poll_s: float = 0.001,
                 clock=time.monotonic):
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.poll_s = float(poll_s)
        self.clock = clock
        # actuator setpoints: the watermark fractions this governor
        # throttles on, observable beside the remediation ledger so a
        # before/after delta is visible in the snapshot + Prometheus
        _state.set_gauge("governor_high_watermark", self.high_watermark)
        _state.set_gauge("governor_low_watermark", self.low_watermark)
        #: set while the governor is actively throttling — the prefetch
        #: pause hook (pass it as ``pause_event=`` to ``batches_prefetched``)
        self.pause_event = threading.Event()
        self.throttles = 0                    # episodes (per-governor, tests)
        # watch() registers every edge on the driver BEFORE the source/stage
        # threads start throttling; throttle() only iterates
        self._edges: List[Tuple[str, Callable[[], int], int, int]] = []  # wf-lint: single-writer[driver]
        self._stop = threading.Event()

    def watch(self, edge: str, size_fn: Callable[[], int],
              capacity: int) -> None:
        """Register one ring: ``size_fn`` probes its live depth."""
        hi = max(1, int(capacity * self.high_watermark))
        lo = min(max(0, int(capacity * self.low_watermark)), hi - 1)
        self._edges.append((edge, size_fn, hi, lo))

    def _over_high(self) -> Optional[Tuple[str, int, int]]:
        for edge, size_fn, hi, _lo in self._edges:
            try:
                d = int(size_fn())
            except Exception:                 # noqa: BLE001 — ring freed at EOS
                continue
            if d >= hi:
                return edge, d, hi
        return None

    def _all_low(self) -> bool:
        for _edge, size_fn, _hi, lo in self._edges:
            try:
                if int(size_fn()) > lo:
                    return False
            except Exception:                 # noqa: BLE001
                continue
        return True

    def throttle(self, heartbeat=None) -> float:
        """Called by the source loop before each push. Returns seconds spent
        throttled (0.0 on the fast path: one depth probe per edge).
        ``heartbeat`` (optional zero-arg callable) is invoked every poll so a
        stage watchdog can tell an intentional throttle wait from a hang."""
        over = self._over_high()
        if over is None or self._stop.is_set():
            return 0.0
        edge, depth, hi = over
        self.throttles += 1
        _state.bump("throttle_events")
        _journal.record("throttle", edge=edge, depth=depth, high=hi)
        # throttle episodes also land in the flight recorder (a span on the
        # "governor" pseudo-stage) so the Perfetto view shows exactly which
        # batches sat behind a throttled source — one None check when off
        stall = _tracing.stall(f"governor:{edge}")
        self.pause_event.set()
        t0 = self.clock()
        try:
            while not self._stop.is_set() and not self._all_low():
                if heartbeat is not None:
                    heartbeat()
                time.sleep(self.poll_s)
        finally:
            self.pause_event.clear()
            if stall is not None:
                stall.done()
        dt = self.clock() - t0
        _state.bump("throttle_seconds", dt)
        _journal.record("throttle_end", edge=edge, waited_s=round(dt, 6))
        return dt

    def stop(self) -> None:
        """Release any in-flight throttle wait (failure/teardown path: a dead
        consumer must not leave the source wedged in the governor)."""
        self._stop.set()
        self.pause_event.clear()


def governor_from_config(cfg, clock=time.monotonic,
                         ) -> Optional[BackpressureGovernor]:
    if cfg is None or not cfg.backpressure:
        return None
    return BackpressureGovernor(cfg.high_watermark, cfg.low_watermark,
                                cfg.throttle_poll_s, clock=clock)


def recommend_reshard(loads, assignment, *, hot_fraction: float = 0.6,
                      max_shards: int = 64, min_load: float = 1.0):
    """The governor's re-sharding planner — a PURE function from per-shard
    load signals to a :class:`~windflow_tpu.parallel.sharding.ReshardPlan`
    (or None).

    ``loads``: per-shard load, e.g. the sharded supervisor's committed
    ``interval_tuples`` (a pure function of stream position, so
    supervised replay re-derives the identical plan), or live queue depths
    for an external operator. ``assignment``: the current
    ``ShardAssignment`` (or a bare shard count). Doubling is recommended
    when the hottest shard carries more than ``hot_fraction`` of the TOTAL
    load — a scale-free signal (a max/mean ratio would grow with the shard
    count even on a perfectly balanced layout whenever active keys are
    fewer than shards): ``key % 2N`` splits every shard (the hot one
    included) in two without shuffling keys between survivors.
    Deterministic; never wall-clock."""
    vals = [float(v) for v in
            (loads.values() if isinstance(loads, dict) else loads)]
    if not vals:
        return None
    total = sum(vals)
    if total / len(vals) < float(min_load):
        return None                       # nothing measured yet
    if max(vals) < float(hot_fraction) * total:
        return None
    n = getattr(assignment, "num_shards", None)
    n = int(assignment) if n is None else int(n)
    if n * 2 > int(max_shards):
        return None
    from ..parallel.sharding import ReshardPlan
    return ReshardPlan(new_shards=n * 2)

"""Periodic reporter thread — the reference's MONITORING-mode per-second dump.

Upstream WindFlow's ``MONITORING`` build runs a reporter that aggregates every
replica's ``Stats_Record`` into a JSON dump once per second (SURVEY §5). Here a
single daemon thread snapshots the :class:`~.metrics.MetricsRegistry` every
``interval_s`` and writes:

- ``snapshot.json``   — the latest graph-level snapshot (atomic replace);
- ``snapshots.jsonl`` — one line per tick (time series for later analysis);
- ``metrics.prom``    — Prometheus text exposition (point a file-based scraper
  or ``node_exporter`` textfile collector at it).

Off by default; started/stopped by the Monitor. ``stop()`` joins the thread and
emits one final snapshot, so no thread outlives the run (tested).

Counterpart of ``windflow_tpu/observability/reporter.py``, a copy: each tick
also runs the SLO engine (``slo.py``) before the files land and offers the
written snapshot to the fleet telemetry agent (``fleet.py``) after."""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Optional

from .metrics import MetricsRegistry


def _atomic_write(path: str, data: str) -> None:
    """Write-then-rename (the checkpoint.py convention): a reader — the
    stdlib CLIs wf_state/wf_trace/wf_health poll these files while the run
    is live — can NEVER observe a torn snapshot.json / metrics.prom: either
    the old complete file or the new complete file.  The tmp name carries
    pid + thread id so a reporter tick racing a final ``stop()`` emit (two
    writers, one path) cannot truncate each other's in-flight tmp; flush +
    fsync before the rename so the replace publishes complete bytes, not an
    empty inode, even across a crash."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):            # failed mid-write: no debris
            try:
                os.unlink(tmp)
            except OSError:
                pass


class Reporter:
    def __init__(self, registry: MetricsRegistry, out_dir: str,
                 interval_s: float = 1.0, prometheus: bool = True,
                 slo_engine=None, snapshot_keep: Optional[int] = None,
                 telemetry_agent=None):
        self.registry = registry
        self.out_dir = out_dir
        self.interval_s = max(0.05, float(interval_s))
        self.prometheus = prometheus
        #: fleet telemetry agent (observability/fleet.py TelemetryAgent,
        #: None = plane off): its stats are stamped into every snapshot
        #: BEFORE the files land (so the artifacts carry the
        #: windflow_telemetry_* gauges) and the written snapshot is OFFERED
        #: after — a bounded deque append, never a socket wait, so the tick
        #: cadence is independent of the aggregator's health by construction
        self.telemetry = telemetry_agent
        #: SLO engine (observability/slo.py) evaluated INSIDE every tick,
        #: right after the registry snapshot and before the files land —
        #: the written snapshot.json/snapshots.jsonl carry its "slo"
        #: section, and PAGE transitions capture incident bundles on this
        #: thread (the engine is single-writer for the same reason ticks
        #: is: the final stop() emit runs only after join())
        self.slo = slo_engine
        #: keep-last-N-lines retention for snapshots.jsonl (None/0 =
        #: unlimited, today's behavior): a long-running service's time
        #: series must not grow without bound.  Rotation is an amortized
        #: atomic rewrite on THIS thread (trim to N once the file reaches
        #: 2N lines, so steady state appends instead of rewriting every
        #: tick) — a reader polling the file sees either the pre- or
        #: post-trim file, never a truncated line
        self.snapshot_keep = int(snapshot_keep) if snapshot_keep else None
        # bumped by emit(): reporter ticks while running; the driver's final
        # stop() emit runs only after join() — never two writers at once
        self.ticks = 0                      # wf-lint: single-writer[reporter]
        # SLO-engine observe() failures (same single-writer discipline): a
        # broken signal extractor must not kill the tick, but the engine
        # whose whole job is alerting dying silently would be worse — the
        # count lands in every snapshot and the first failure warns once
        self.slo_errors = 0                 # wf-lint: single-writer[reporter]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(out_dir, exist_ok=True)
        self._jsonl_path = os.path.join(out_dir, "snapshots.jsonl")
        # resume-aware line count (same single-writer discipline as ticks)
        self._jsonl_lines = 0               # wf-lint: single-writer[reporter]
        if self.snapshot_keep and os.path.exists(self._jsonl_path):
            with open(self._jsonl_path) as f:
                self._jsonl_lines = sum(1 for _ in f)

    # -- lifecycle --------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(  # wf-lint: thread-role[reporter]
            target=self._run, name="wf-reporter", daemon=True)
        self._thread.start()

    def stop(self, final: bool = True) -> None:
        """Signal, join, and (by default) write one last snapshot so short
        runs that never crossed an interval still leave artifacts."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        if final:
            self.emit()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- emission ---------------------------------------------------------------------

    def emit(self) -> dict:
        snap = self.registry.snapshot()
        if self.telemetry is not None:
            snap["telemetry"] = self.telemetry.stats()
        if self.slo is not None:
            try:
                self.slo.observe(snap)
            except Exception as e:  # noqa: BLE001 — a bad SLO tick must not
                # kill the reporter (the snapshot still lands), but it must
                # not die SILENTLY either: the snapshot records the error +
                # count, and the first failure warns on stderr — otherwise a
                # broken extractor reads as "all SLOs OK" for the whole run
                self.slo_errors += 1
                snap["slo_error"] = {"error": f"{type(e).__name__}: {e}",
                                     "count": self.slo_errors}
                if self.slo_errors == 1:
                    print(f"wf reporter: SLO engine failed on tick "
                          f"{self.ticks + 1} ({type(e).__name__}: {e}) — "
                          f"burn-rate alerting is degraded; see "
                          f"snapshot['slo_error']", file=sys.stderr)
        _atomic_write(os.path.join(self.out_dir, "snapshot.json"),
                      json.dumps(snap, indent=1, sort_keys=True))
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(snap) + "\n")
        self._jsonl_lines += 1
        if self.snapshot_keep and self._jsonl_lines >= 2 * self.snapshot_keep:
            # amortized: trim back to keep-N only once the file doubles —
            # trimming on every tick past N would re-read and rewrite the
            # whole series each second for the lifetime of a long-running
            # service (the exact deployment retention targets).  Readers
            # tolerate either side of the rewrite; the file is bounded at
            # 2N-1 lines and always ends with the newest ticks
            with open(self._jsonl_path) as f:
                lines = f.readlines()
            kept = lines[-self.snapshot_keep:]
            _atomic_write(self._jsonl_path, "".join(kept))
            self._jsonl_lines = len(kept)
        if self.prometheus:
            _atomic_write(os.path.join(self.out_dir, "metrics.prom"),
                          self.registry.to_prometheus(snap))
        if self.telemetry is not None:
            try:
                self.telemetry.offer(snap)
            except Exception:  # noqa: BLE001 — the telemetry plane is
                pass           # best-effort; it must never cost a tick
        self.ticks += 1
        return snap

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.emit()
            except Exception:       # noqa: BLE001 — a bad tick must not kill
                pass                # the reporter (snapshot retries next tick)

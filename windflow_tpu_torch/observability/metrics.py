"""Metrics primitives: log-bucket latency histograms and the graph-level registry.

Counterpart of ``windflow_tpu/observability/metrics.py``, a copy of its host
code: :class:`MetricsRegistry` walks a live ``PipeGraph`` / ``Pipeline`` /
``CompiledChain``, sums the replicas' ``Stats_Record`` counters, derives
rates from successive snapshots, reads watermark gauges and (event-time
monitoring) each operator's event-time section out of its state, and renders
a JSON snapshot and a Prometheus text exposition with the JAX package's
names and label sets. The ``health`` section reads ``device_health.py``.

The ``slo``, ``telemetry`` and ``serving`` sections and their
``windflow_slo_*``/``windflow_telemetry_*``/``windflow_serving_*``/
``windflow_tenant_*`` gauges render only when the SLO engine, the telemetry
agent or a serving runtime is attached (``attach_serving``; per-tenant
latency histograms through ``record_tenant_e2e``), as in the JAX package.

:class:`LogHistogram` is re-exported from ``stats.py`` (the port keeps one
copy, with the trace-id exemplars).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..parallel.mesh import global_tree
from ..stats import LogHistogram
from .device_health import SNAPSHOT_SCHEMA as _SNAPSHOT_SCHEMA

#: counter fields summed across replicas and exposed per operator
_COUNTERS = ("inputs_received", "outputs_sent", "bytes_received", "bytes_sent",
             "batches_received", "batches_sent", "num_kernels",
             "bytes_copied_hd", "bytes_copied_dh", "tuples_dropped_old")

#: HELP text per event-time gauge — checked against the central registry at
#: import so the exposition can never drift from names.py (the WF240/241
#: one-source-of-truth discipline)
_EVENT_TIME_HELP = {
    "watermark": "operator event-time frontier (max event ts seen)",
    "lag": "arrived-but-unfired event-time span",
    "occupancy_pct": "state-table occupancy percent",
    "pending_depth": "join-table upserts parked behind the watermark",
    "open_sessions": "open sessions in the session table",
    "oldest_open_age": "event-time age of the longest-open session",
    "archive_fill_pct": "interval-join archive fill percent (max of both "
                        "sides)",
    "lateness_p50": "observed lateness p50 (ticks; bucket upper bound)",
    "lateness_p99": "observed lateness p99 (ticks; bucket upper bound)",
    "min_watermark": "graph-level min-watermark frontier",
    "skew": "per-edge watermark skew (producer - consumer, ticks)",
}

#: snapshot section key -> registered event-time gauge name
_EVENT_TIME_KEY_MAP = {"watermark_ts": "watermark", "lag": "lag",
                       "occupancy_pct": "occupancy_pct",
                       "pending_depth": "pending_depth",
                       "open_sessions": "open_sessions",
                       "oldest_open_age": "oldest_open_age"}


def _check_event_time_names() -> None:
    from .names import EVENT_TIME_GAUGES
    if set(_EVENT_TIME_HELP) != set(EVENT_TIME_GAUGES):
        raise RuntimeError(
            f"metrics.py event-time exposition drifted from "
            f"names.py::EVENT_TIME_GAUGES: "
            f"{set(_EVENT_TIME_HELP) ^ set(EVENT_TIME_GAUGES)}")


_check_event_time_names()

#: HELP text per runtime-health gauge — checked against
#: ``names.py::HEALTH_GAUGES`` at import (the event-time lockstep
#: discipline): only registered names can render.  The ``hbm_*`` family
#: renders as ``windflow_hbm_<name>`` per device; the rest as
#: ``windflow_health_<name>``.
_HEALTH_HELP = {
    "hbm_headroom_bytes": "device memory limit minus bytes in use — the "
                          "tiered-state eviction signal",
    "hbm_bytes_in_use": "device memory bytes in use",
    "hbm_bytes_limit": "device memory limit (allocatable bytes)",
    "live_buffer_bytes": "live CUDA caching-allocator block bytes",
    "live_buffer_count": "live CUDA caching-allocator blocks",
    "state_bytes": "operator state-pytree footprint (bytes)",
    "compiles": "chain program traces observed (compile ledger)",
    "retraces": "re-traces under a NEW shape/dtype signature "
                "(capacity switch, weak-type drift)",
    "retraces_unexpected": "re-traces of a warm executable under an "
                           "already-traced signature",
    "compile_seconds": "total seconds spent in journaled compiles",
    "device_ms": "sampled device execution time per stage (ms)",
    "dispatch_ms": "sampled host dispatch overhead per stage (ms)",
    "dispatch_ratio": "host dispatch / device time per stage — >= 0.5 "
                      "names a fusion candidate",
}


def _check_health_names() -> None:
    from .names import HEALTH_GAUGES
    if set(_HEALTH_HELP) != set(HEALTH_GAUGES):
        raise RuntimeError(
            f"metrics.py health exposition drifted from "
            f"names.py::HEALTH_GAUGES: "
            f"{set(_HEALTH_HELP) ^ set(HEALTH_GAUGES)}")


_check_health_names()

#: HELP text per SLO gauge — checked against ``names.py::SLO_GAUGES`` at
#: import (the event-time/health lockstep discipline).  Rendered as
#: ``windflow_slo_<name>{graph,slo="..."}`` from the snapshot's ``slo``
#: section (written by the SLO engine inside the Reporter tick).
_SLO_HELP = {
    "state": "SLO health state (0 ok, 1 warn, 2 page)",
    "burn_fast": "error-budget burn rate over the fast window",
    "burn_slow": "error-budget burn rate over the slow window",
    "signal": "latest observed value of the SLO's signal",
    "target": "the SLO's target threshold",
    "pages": "PAGE transitions this run",
}


def _check_slo_names() -> None:
    from .names import SLO_GAUGES
    if set(_SLO_HELP) != set(SLO_GAUGES):
        raise RuntimeError(
            f"metrics.py SLO exposition drifted from "
            f"names.py::SLO_GAUGES: {set(_SLO_HELP) ^ set(SLO_GAUGES)}")


_check_slo_names()

#: HELP text per telemetry-agent gauge — checked against
#: ``names.py::TELEMETRY_GAUGES`` at import (the SLO lockstep discipline).
#: Rendered as ``windflow_telemetry_<name>{graph}`` from the snapshot's
#: ``telemetry`` section (the TelemetryAgent stats the Reporter stamps in
#: when ``MonitoringConfig.telemetry`` is on — absent otherwise, so the
#: off path's artifacts are byte-identical).
_TELEMETRY_HELP = {
    "frames_sent": "telemetry frames delivered to the aggregator socket",
    "frames_dropped": "telemetry frames evicted by the bounded drop-oldest "
                      "outbox (a slow/dead aggregator costs frames, never "
                      "Reporter cadence)",
    "reconnects": "successful reconnects after a lost aggregator",
    "outbox_depth": "telemetry frames queued right now",
    "connected": "1 = live aggregator connection, 0 = not",
}


def _check_telemetry_names() -> None:
    from .names import TELEMETRY_GAUGES
    if set(_TELEMETRY_HELP) != set(TELEMETRY_GAUGES):
        raise RuntimeError(
            f"metrics.py telemetry exposition drifted from "
            f"names.py::TELEMETRY_GAUGES: "
            f"{set(_TELEMETRY_HELP) ^ set(TELEMETRY_GAUGES)}")


_check_telemetry_names()

#: HELP text per serving-plane gauge — checked against
#: ``names.py::SERVING_GAUGES`` at import (the telemetry lockstep
#: discipline).  Rendered as ``windflow_serving_<name>{graph}`` from the
#: snapshot's ``serving`` section (``ServingRuntime.serving_section`` via
#: ``attach_serving`` — absent when no serving runtime is attached, so the
#: off path's artifacts are byte-identical).
_SERVING_HELP = {
    "swaps_applied": "zero-downtime graph_swap cutovers completed",
    "swaps_rejected": "wire swap frames naming an unregistered graph",
    "frames_decoded": "intact WFS1 record frames ingested",
    "frames_torn": "ingest bytes resync'd past (torn client / garbage)",
    "frames_dup": "reconnect-overlap frames deduped by tenant seq",
    "clients_seen": "ingest connections accepted since serving start",
    "unknown_offered": "batches from tenant ids nobody declared",
}

#: HELP text per tenant gauge — checked against ``names.py::TENANT_GAUGES``
#: at import.  Rendered as ``windflow_tenant_<name>{graph,tenant="..."}``
#: from the ``serving.tenants`` rows (the per-label SHARD_GAUGES shape).
_TENANT_HELP = {
    "offered": "batches this tenant offered to its admission bucket",
    "admitted": "batches this tenant's controller admitted",
    "shed": "batches this tenant's controller shed",
    "shed_tuples": "tuple capacity this tenant's shed batches carried",
    "rate": "the tenant bucket's live refill rate",
    "e2e_p50_ms": "tenant e2e latency p50 (ms, cumulative)",
    "e2e_p95_ms": "tenant e2e latency p95 (ms, cumulative)",
    "e2e_p99_ms": "tenant e2e latency p99 (ms, cumulative)",
    "e2e_p99_tick_ms": "tenant e2e latency p99 over the last reporter tick "
                       "(ms; the tenant_e2e_p99_ms SLO signal)",
    "e2e_samples": "tenant e2e latency samples recorded",
    "e2e_samples_tick": "tenant e2e latency samples in the last tick",
    "e2e_p99_exemplar": "trace id of a batch observed in the tenant's p99 "
                        "latency bucket",
}


def _check_serving_names() -> None:
    from .names import SERVING_GAUGES, TENANT_GAUGES
    if set(_SERVING_HELP) != set(SERVING_GAUGES):
        raise RuntimeError(
            f"metrics.py serving exposition drifted from "
            f"names.py::SERVING_GAUGES: "
            f"{set(_SERVING_HELP) ^ set(SERVING_GAUGES)}")
    if set(_TENANT_HELP) != set(TENANT_GAUGES):
        raise RuntimeError(
            f"metrics.py tenant exposition drifted from "
            f"names.py::TENANT_GAUGES: "
            f"{set(_TENANT_HELP) ^ set(TENANT_GAUGES)}")


_check_serving_names()


def _recovery_counters() -> Dict[str, float]:
    """Process-wide supervision counters (lazy import: runtime.faults imports
    observability.journal, so the reverse edge must not exist at import time)."""
    from ..runtime import faults as _faults
    return _faults.counters()


def _control_section() -> Dict[str, Dict[str, float]]:
    """Process-wide control-plane counters (shed/throttle/switch totals) and
    gauges (chosen capacity) — lazy import for the same no-reverse-edge
    reason as the recovery counters."""
    from ..control import _state as _control
    return {"counters": _control.counters(), "gauges": _control.gauges()}


class MetricsRegistry:
    """Aggregates every ``Stats_Record`` of a running graph into one snapshot.

    Sources of truth are registered once and walked live at snapshot time (so
    lazily-compiled chains and late-built Ordering_Nodes are picked up):

    - ``register_graph(graph)``: a PipeGraph — walks ``_all_pipes()`` for
      sources, chains (ops + states), sinks, Ordering_Nodes, and (threaded
      driver) SPSC edge queues.
    - ``register_pipeline(pipeline)``: a linear Pipeline (source/chain/sink).
    - ``register_chain(label, chain)`` / ``register_operator(op)``: raw pieces
      (bench harnesses).

    ``snapshot()`` additionally derives per-operator input/output rates from
    the delta against the previous snapshot and pulls watermark-lag gauges out
    of TB window states (a tiny D2H read — monitoring-path only).
    """

    def __init__(self, name: str = "pipegraph", event_time: bool = False,
                 health_ledger=None, health: Optional[bool] = None):
        self.name = name
        #: runtime-health observability (MonitoringConfig.health): snapshots
        #: grow a graph-level ``health`` section — per-device memory gauges
        #: + headroom, per-operator state-pytree footprints, the compile/
        #: retrace ledger, sampled device-time attribution with the
        #: dispatch-bound classifier — and the Prometheus exposition the
        #: ``windflow_hbm_*``/``windflow_health_*`` gauges.  Host-side
        #: metadata reads only (shapes, memory_stats) — never a device sync.
        self._health_ledger = health_ledger
        self.health = bool(health_ledger is not None if health is None
                           else health)
        #: event-time observability (MonitoringConfig.event_time): snapshot
        #: rows grow per-operator ``event_time`` sections (watermarks, state
        #: occupancy, lateness histograms), the snapshot a graph-level
        #: ``event_time`` section (min-watermark frontier + per-edge skew),
        #: and the Prometheus exposition the ``windflow_event_time_*``
        #: gauges.  Snapshot-time D2H reads only — the monitoring path.
        self.event_time = bool(event_time)
        self.created = time.monotonic()
        self.e2e_hist = LogHistogram()       # source framing -> sink host receipt
        # registration happens on the driver while the graph is being built,
        # BEFORE the Monitor starts the reporter thread (happens-before via
        # Thread.start); the reporter tick only iterates — checked by the
        # WF260 concurrency lint, these annotations are its rationale
        self._graphs: List[Any] = []          # wf-lint: single-writer[driver]
        self._pipelines: List[Any] = []       # wf-lint: single-writer[driver]
        # (label, CompiledChain)
        self._chains: List[tuple] = []        # wf-lint: single-writer[driver]
        self._operators: List[Any] = []       # wf-lint: single-writer[driver]
        self._gauges: Dict[str, Callable[[], Any]] = {}  # wf-lint: single-writer[driver]
        self._queue_gauges: Dict[str, Callable[[], int]] = {}  # wf-lint: single-writer[driver]
        self._queue_capacities: Dict[str, int] = {}  # wf-lint: single-writer[driver]
        # id(op) -> (t, inputs, outputs)  # wf-lint: guarded-by[_lock]
        self._prev: Dict[int, tuple] = {}
        # written only inside snapshot(): reporter ticks are one thread, and
        # a driver-side snapshot (Reporter.stop final emit) runs only after
        # the tick thread is joined
        self._et_names: Dict[int, str] = {}   # wf-lint: single-writer[reporter]
        # previous tick's e2e bucket counts (same single-writer discipline):
        # the delta gives the PER-TICK p99 the SLO latency signal needs —
        # the cumulative histogram could never recover below a target once
        # a stall pushed its whole-run p99 over it
        self._e2e_prev_counts: Optional[List[int]] = None  # wf-lint: single-writer[reporter]
        self._lock = threading.Lock()
        # per-tenant e2e latency histograms (serving drive loop records,
        # reporter tick reads): the DICT itself is guarded — first sample
        # of a new tenant inserts while the reporter iterates — while each
        # histogram is internally locked like e2e_hist
        self._tenant_e2e: Dict[str, LogHistogram] = {}  # wf-lint: guarded-by[_lock]
        # previous tick's per-tenant bucket counts (reporter-only, the
        # _e2e_prev_counts windowed-p99 discipline per tenant)
        self._tenant_prev_counts: Dict[str, List[int]] = {}  # wf-lint: single-writer[reporter]
        self._lock = threading.Lock()

    # -- registration -----------------------------------------------------------------

    def register_graph(self, graph) -> None:
        self._graphs.append(graph)

    def register_pipeline(self, pipeline) -> None:
        self._pipelines.append(pipeline)

    def register_chain(self, label: str, chain) -> None:
        self._chains.append((label, chain))

    def register_operator(self, op) -> None:
        self._operators.append(op)

    def attach_gauge(self, name: str, fn: Callable[[], Any]) -> None:
        self._gauges[name] = fn

    def attach_shards(self, provider: Callable[[], dict]) -> None:
        """Register the sharded supervisor's per-shard health provider
        (``shard_report()``: {shard idx -> names.py::SHARD_GAUGES row}) —
        rendered as the snapshot's ``shards`` section and folded
        HOST-TAGGED (never summed) by ``device_health.merge_snapshots``,
        so the fleet view names WHICH shard is hot."""
        self._shards_provider = provider

    def attach_serving(self, provider: Callable[[], dict]) -> None:
        """Register a serving runtime's section provider
        (``ServingRuntime.serving_section``: graph/swap/frame counters +
        the per-tenant ``names.py::TENANT_GAUGES`` rows) — rendered as the
        snapshot's ``serving`` section and folded counters-summed,
        per-tenant-summed by ``device_health.merge_snapshots``."""
        self._serving_provider = provider

    def attach_queue_gauge(self, edge: str, fn: Callable[[], int],
                           capacity: Optional[int] = None) -> None:
        """SPSC ring depth probe for one dataflow edge (threaded driver):
        depth/capacity is the backpressure signal — a persistently full ring
        means the consumer pipe is the bottleneck. ``capacity`` (when known)
        is exposed alongside the depth, so watermark fractions are computable
        from the snapshot alone."""
        self._queue_gauges[edge] = fn
        if capacity is not None:
            self._queue_capacities[edge] = int(capacity)

    def record_e2e(self, seconds: float, exemplar=None) -> None:
        self.e2e_hist.record(seconds, exemplar=exemplar)

    def record_tenant_e2e(self, tenant: str, seconds: float,
                          exemplar=None) -> None:
        """One sampled wire-to-sink latency observation for ``tenant``
        (serving drive loop, same sampling cadence as ``record_e2e``) —
        feeds the per-tenant p50/p95/p99 rows of ``serving.tenants`` and
        the ``tenant_e2e_p99_ms`` SLO signal."""
        with self._lock:
            h = self._tenant_e2e.get(tenant)
            if h is None:
                h = self._tenant_e2e[tenant] = LogHistogram()
        h.record(seconds, exemplar=exemplar)

    def _tenant_latency_rows(self) -> Dict[str, dict]:
        """Per-tenant latency keys (names.py::TENANT_GAUGES e2e_* family)
        merged into the ``serving.tenants`` rows at snapshot time.  Reporter
        thread only (the _e2e_prev_counts discipline); tenants with zero
        samples yield nothing, so latency-off snapshots stay byte-identical."""
        with self._lock:
            hists = list(self._tenant_e2e.items())
        out: Dict[str, dict] = {}
        for tenant, h in hists:
            counts, count, _sum, _mn, mx, exemplars = h._snap()
            if not count:
                continue
            pct = lambda q: LogHistogram._pct_value(counts, count, mx, q)
            row = {
                "e2e_p50_ms": round(pct(50) * 1e3, 3),
                "e2e_p95_ms": round(pct(95) * 1e3, 3),
                "e2e_p99_ms": round(pct(99) * 1e3, 3),
                "e2e_samples": count,
            }
            i99 = LogHistogram._bucket_of(counts, count, 99)
            ex = None if i99 is None else exemplars.get(i99)
            if ex is not None:
                row["e2e_p99_exemplar"] = ex
            prev = self._tenant_prev_counts.get(tenant)
            if prev is not None:
                delta = [max(c - p, 0) for c, p in zip(counts, prev)]
                dn = sum(delta)
                row["e2e_samples_tick"] = dn
                row["e2e_p99_tick_ms"] = round(
                    LogHistogram._pct_value(delta, dn, mx, 99) * 1e3, 3)
            self._tenant_prev_counts[tenant] = counts
            out[tenant] = row
        return out

    # -- collection -------------------------------------------------------------------

    def _op_units(self):
        """Yield (op, state_or_None) for every operator currently visible."""
        seen = set()

        def emit(op, state=None):
            if op is None or id(op) in seen:
                return
            seen.add(id(op))
            # a ShardedChain's chain (register_chain) reads as the unsharded one
            yield op, global_tree(state)

        for g in self._graphs:
            for mp in g._all_pipes():
                if mp.source is not None:
                    yield from emit(mp.source)
                ch = mp._chain
                if ch is not None:
                    for op, st in zip(ch.ops, ch.states):
                        yield from emit(op, st)
                else:
                    for op in mp.ops:
                        yield from emit(op)
                if mp.sink is not None:
                    yield from emit(mp.sink)
        for p in self._pipelines:
            yield from emit(p.source)
            for op, st in zip(p.chain.ops, p.chain.states):
                yield from emit(op, st)
            if p.sink is not None:
                yield from emit(p.sink)
        for _, ch in self._chains:
            for op, st in zip(ch.ops, ch.states):
                yield from emit(op, st)
        for op in self._operators:
            yield from emit(op)

    @staticmethod
    def _watermark_gauge(op, state) -> Optional[dict]:
        """TB window frontier gauge from a window operator's carried state:
        ``wm`` (max event ts seen) vs the firing frontier ``next_win * slide``.
        ``lag`` is the span of arrived-but-unfired event time — the
        watermark-lag of the stage."""
        spec = getattr(op, "spec", None)
        if (spec is None or getattr(spec, "is_cb", True)
                or state is None
                or not hasattr(state, "wm") or not hasattr(state, "next_win")):
            return None
        try:
            wm = int(state.wm.max())
            nxt = int(state.next_win.max())
        except RuntimeError:
            # a live window state read mid-run: a Win_Seq state the driver
            # consumed in place raises RuntimeError ("consumed"); anything
            # else is a bug that should surface, not be swallowed
            return None
        frontier = nxt * spec.slide
        return {"watermark_ts": wm, "fire_frontier_ts": frontier,
                "lag_ts": max(wm - frontier + 1, 0) if wm >= 0 else 0}

    def snapshot(self) -> dict:
        """One graph-level snapshot: per-operator aggregated counters + rates +
        latency percentiles, watermark gauges, queue depths, e2e latency."""
        from ..runtime.graphs import CAPTURE_LOCK
        now = time.monotonic()
        ops_out = []
        et_secs: Dict[int, dict] = {}    # id(op) -> event_time section
        totals = {k: 0 for k in _COUNTERS}
        # the state reads below synchronize the device: never inside another
        # thread's CUDA-graph capture
        with self._lock, CAPTURE_LOCK:
            for op, state in self._op_units():
                # sync device-resident counters (e.g. Win_SeqFFAT.dropped_old)
                # into the host Stats_Record before reading it
                try:
                    op.collect_stats(state)
                except Exception:   # noqa: BLE001 — never kill a snapshot
                    pass
                recs = op.get_StatsRecords()
                row = {"name": op.getName(),
                       "replicas": len(recs),
                       "routing": op.getRoutingMode().name}
                for k in _COUNTERS:
                    v = sum(getattr(r, k, 0) for r in recs)
                    row[k] = v
                    totals[k] += v
                # service-time distribution: merged across replicas — each
                # replica read through its locked _snap() (stage threads
                # record concurrently; raw-field reads here were the torn-
                # count/mutating-dict race the WF260 lint surfaced)
                merged = LogHistogram()
                for r in recs:
                    h = getattr(r, "service_hist", None)
                    if h is None:
                        continue
                    counts, count, total, mn, mx, exemplars = h._snap()
                    if not count:
                        continue
                    for i, c in enumerate(counts):
                        merged.counts[i] += c
                    merged.count += count
                    merged.sum += total
                    merged.max = max(merged.max, mx)
                    merged.min = min(merged.min, mn)
                    merged.exemplars.update(exemplars)
                row["service_time_us"] = merged.summary_us()
                # rates vs the previous snapshot. Mid-chain operators count
                # batches/bytes, not tuples (per-tuple counts would need a
                # device sync per push), so batch + byte rates are the
                # universally-populated signals; tuple rates are live at the
                # host boundaries (sources count launches, sinks tuples).
                prev = self._prev.get(id(op))
                if prev is not None and now > prev[0]:
                    dt = now - prev[0]
                    row["rate_in_tps"] = round(
                        (row["inputs_received"] - prev[1]) / dt, 1)
                    row["rate_out_tps"] = round(
                        (row["outputs_sent"] - prev[2]) / dt, 1)
                    row["rate_batches_in_per_s"] = round(
                        (row["batches_received"] - prev[3]) / dt, 2)
                    row["rate_bytes_in_per_s"] = round(
                        (row["bytes_received"] - prev[4]) / dt, 1)
                else:
                    up = max(now - self.created, 1e-9)
                    row["rate_in_tps"] = round(row["inputs_received"] / up, 1)
                    row["rate_out_tps"] = round(row["outputs_sent"] / up, 1)
                    row["rate_batches_in_per_s"] = round(
                        row["batches_received"] / up, 2)
                    row["rate_bytes_in_per_s"] = round(
                        row["bytes_received"] / up, 1)
                self._prev[id(op)] = (now, row["inputs_received"],
                                      row["outputs_sent"],
                                      row["batches_received"],
                                      row["bytes_received"])
                wmg = self._watermark_gauge(op, state)
                if wmg is not None:
                    row["watermark"] = wmg
                # per-stage counters published by collect_stats (PR 8
                # operator counters on a uniform per-operator surface)
                sc = op.stage_counters() if hasattr(op, "stage_counters") \
                    else {}
                if sc:
                    row["counters"] = sc
                if self.event_time:
                    try:
                        sec = op.event_time_stats(state)
                    except RuntimeError:
                        # the live-state read hazard of _watermark_gauge
                        sec = None
                    if sec is not None:
                        row["event_time"] = sec
                        et_secs[id(op)] = sec
                        self._et_names[id(op)] = op.getName()
                    elif wmg is not None:
                        # TB window ops without a richer section still carry
                        # a frontier — include them in the watermark map
                        et_secs[id(op)] = {"watermark_ts":
                                           wmg["watermark_ts"]}
                        self._et_names[id(op)] = op.getName()
                ops_out.append(row)
        queues = {}
        for edge, fn in list(self._queue_gauges.items()):
            try:
                queues[edge] = int(fn())
            except Exception:       # noqa: BLE001 — queue freed after EOS
                queues[edge] = 0
        gauges = {}
        for gname, fn in list(self._gauges.items()):
            try:
                gauges[gname] = fn()
            except Exception:       # noqa: BLE001
                pass
        orderings = []
        for g in self._graphs:
            for i, mp in enumerate(g._all_pipes()):
                o = mp._ordering
                if o is not None:
                    orderings.append({
                        "pipe": i,
                        "pending_capacity": (0 if o._pending is None
                                             else int(o._pending.capacity)),
                        # the RAW settled value (o._last_release_count), not
                        # the settling property: the reporter thread must
                        # neither force a device sync on the driver's async
                        # counts readback nor race its deferred pool trim —
                        # settle() is restricted to the node's owning
                        # thread by its `wf-lint: thread-role[driver,
                        # stage]` annotation (parallel/ordering.py; WF261
                        # fails the gate if the reporter ever reaches it) —
                        # telemetry may lag the in-flight push by one
                        "last_release_count": int(o._last_release_count),
                        "mode": o.mode.name,
                    })
        e2e = self.e2e_hist.summary_us()
        # per-tick e2e latency: percentile over ONLY the samples recorded
        # since the previous snapshot (bucket-count delta) — the windowed
        # signal the SLO engine's "e2e_p99_ms" reads, so a recovered stream
        # can flip PAGE back to OK while the cumulative p50/p95/p99 above
        # still carry the incident
        counts, _cnt, _sum, _mn, mx, _ex = self.e2e_hist._snap()
        if self._e2e_prev_counts is not None:
            delta = [max(c - p, 0) for c, p in
                     zip(counts, self._e2e_prev_counts)]
            dn = sum(delta)
            e2e["samples_tick"] = dn
            e2e["p99_tick"] = round(
                LogHistogram._pct_value(delta, dn, mx, 99) * 1e6, 3)
        self._e2e_prev_counts = counts
        snap = {
            "graph": self.name,
            # snapshot schema version (device_health.SNAPSHOT_SCHEMA):
            # merge_snapshots refuses to SILENTLY fold hosts that disagree
            # (a heterogeneous fleet mid-upgrade must be detectable)
            "schema": _SNAPSHOT_SCHEMA,
            "wall_time": time.time(),
            "uptime_s": round(now - self.created, 3),
            "operators": ops_out,
            "totals": totals,
            "e2e_latency_us": e2e,
            "queues": queues,
            "ordering": orderings,
            # process-wide recovery/chaos counters (restarts, backoff sleeps,
            # dead-lettered poison batches, checkpoint validation outcomes,
            # watchdog timeouts, injected faults) — runtime/faults.py
            "recovery": _recovery_counters(),
            # control-plane counters/gauges (shed/throttle/capacity-switch
            # totals, chosen capacity) — windflow_tpu/control
            "control": _control_section(),
        }
        if self._queue_capacities:
            snap["queue_capacity"] = dict(self._queue_capacities)
        if gauges:
            snap["gauges"] = gauges
        shards_fn = getattr(self, "_shards_provider", None)
        if shards_fn is not None:
            try:
                rows = shards_fn()
            except Exception:       # noqa: BLE001 — never kill a snapshot
                rows = None
            if rows:
                # string keys: the section round-trips through JSON
                snap["shards"] = {str(k): dict(v) for k, v in rows.items()}
        serving_fn = getattr(self, "_serving_provider", None)
        if serving_fn is not None:
            try:
                sec = serving_fn()
            except Exception:       # noqa: BLE001 — never kill a snapshot
                sec = None
            if sec:
                # join per-tenant latency into the tenant rows (tenants the
                # registry declared but latency never sampled keep their
                # exact shape — the off path stays byte-identical)
                lat = self._tenant_latency_rows()
                if lat:
                    tenants = sec.setdefault("tenants", {})
                    for tid, extra in lat.items():
                        tenants.setdefault(tid, {}).update(extra)
                snap["serving"] = sec
        if self.event_time:
            et = self._event_time_section(et_secs)
            if et:
                snap["event_time"] = et
        if self.health:
            with CAPTURE_LOCK:
                snap["health"] = self._health_section()
        return snap

    def _iter_health_chains(self):
        """Every live CompiledChain visible to this registry (deduped) —
        the state-footprint walk of the health section."""
        seen = set()
        chains = []
        for g in self._graphs:
            for mp in g._all_pipes():
                chains.append(mp._chain)
        for p in self._pipelines:
            chains.append(getattr(p, "chain", None))
        for _, ch in self._chains:
            chains.append(ch)
        for ch in chains:
            if ch is not None and id(ch) not in seen:
                seen.add(id(ch))
                yield ch

    def _health_section(self) -> dict:
        """The runtime-health ledger, snapshot-shaped: HBM devices +
        headroom, live-buffer totals, per-operator state footprints (static
        shape metadata — no device sync), and — when a ledger is active —
        the compile/retrace counters, executable footprints, and the
        sampled device-time attribution with its dispatch-bound
        classifier."""
        from . import device_health as _dh
        sec: dict = {"devices": _dh.device_memory()}
        sec.update(_dh.live_buffer_stats())
        state_bytes: Dict[str, int] = {}
        for ch in self._iter_health_chains():
            try:
                fp = ch.state_footprints()
            except Exception:   # noqa: BLE001 — never kill a snapshot
                continue
            for op_name, nbytes in fp.items():
                state_bytes[op_name] = state_bytes.get(op_name, 0) + nbytes
        if state_bytes:
            sec["state_bytes"] = state_bytes
        led = self._health_ledger or _dh.get_active()
        if led is not None:
            sec.update(led.snapshot_section())
        risky = _dh.headroom_risks(sec["devices"])
        if risky:
            sec["headroom_risk"] = risky
        return sec

    def _event_time_section(self, et_secs: Dict[int, dict]) -> dict:
        """Graph-level watermark propagation map: the min-watermark frontier
        (the operator holding the whole graph's event time back) and the
        per-edge watermark *skew* — producer-pipe watermark minus consumer-
        pipe watermark over the SAME ``_iter_edges`` enumeration the
        threaded driver builds its rings from (edge labels match queue
        gauges and the topology export, which annotates its edges from this
        section)."""
        out: dict = {}
        wms = []
        for g in self._graphs:
            for mp in g._all_pipes():
                for op in mp.ops:
                    sec = et_secs.get(id(op))
                    if sec and "watermark_ts" in sec:
                        wms.append((sec["watermark_ts"], op.getName()))
        if not wms:
            # linear pipelines / raw chains: no pipe structure — frontier
            # from every section (the loop stored the owning op's name)
            for oid, sec in et_secs.items():
                if "watermark_ts" in sec:
                    wms.append((sec["watermark_ts"],
                                self._et_names.get(oid)))
        if wms:
            mn = min(wms, key=lambda t: t[0])
            out["min_watermark_ts"] = mn[0]
            if mn[1]:
                out["frontier_operator"] = mn[1]
        edges = {}
        for g in self._graphs:
            wm_of_pipe = {}
            for mp in g._all_pipes():
                pw = [et_secs[id(op)]["watermark_ts"] for op in mp.ops
                      if id(op) in et_secs
                      and "watermark_ts" in et_secs[id(op)]]
                if pw:
                    wm_of_pipe[id(mp)] = max(pw)
            try:
                edge_iter = list(g._iter_edges())
            except Exception:       # noqa: BLE001 — half-built graph
                continue
            for prod, cons, label, _idx in edge_iter:
                if prod is None:
                    continue
                a = wm_of_pipe.get(id(prod))
                b = wm_of_pipe.get(id(cons))
                if a is not None and b is not None:
                    edges[label] = a - b
        if edges:
            out["edge_skew_ts"] = edges
        return out

    # -- Prometheus text exposition ----------------------------------------------------

    @staticmethod
    def _prometheus_health(snap: dict, lines: List[str], esc) -> None:
        """``windflow_hbm_*`` (per device) + ``windflow_health_*`` gauges
        from the snapshot's health section.  Only the names registered in
        ``names.py::HEALTH_GAUGES`` render (the import-time lockstep check
        above); absent values (e.g. ``memory_stats`` on a CPU backend)
        simply do not render."""
        sec = snap.get("health")
        if not sec:
            return
        g = snap["graph"]
        typed = set()

        def head(metric, name):
            if metric not in typed:
                typed.add(metric)
                lines.append(f"# HELP {metric} {_HEALTH_HELP[name]}")
                lines.append(f"# TYPE {metric} gauge")

        for d in sec.get("devices", []):
            lab = f'graph="{esc(g)}",device="{esc(d.get("device", "?"))}"'
            for name in ("hbm_bytes_in_use", "hbm_bytes_limit",
                         "hbm_headroom_bytes"):
                v = d.get(name[4:])      # row keys drop the hbm_ prefix
                if v is not None:
                    head(f"windflow_{name}", name)
                    lines.append(f'windflow_{name}{{{lab}}} {v}')
        glab = f'graph="{esc(g)}"'
        for name in ("live_buffer_bytes", "live_buffer_count"):
            if sec.get(name) is not None:
                head(f"windflow_health_{name}", name)
                lines.append(f'windflow_health_{name}{{{glab}}} {sec[name]}')
        for op_name, nbytes in sorted((sec.get("state_bytes") or {}).items()):
            head("windflow_health_state_bytes", "state_bytes")
            lines.append(f'windflow_health_state_bytes{{{glab},'
                         f'operator="{esc(op_name)}"}} {nbytes}')
        comp = sec.get("compile") or {}
        for name, key in (("compiles", "compiles"), ("retraces", "retraces"),
                          ("retraces_unexpected", "retraces_unexpected"),
                          ("compile_seconds", "compile_s_total")):
            if comp.get(key) is not None:
                head(f"windflow_health_{name}", name)
                lines.append(f'windflow_health_{name}{{{glab}}} {comp[key]}')
        for label, row in sorted((sec.get("device_time") or {}).items()):
            slab = f'{glab},stage="{esc(label)}"'
            for name, key in (("device_ms", "device_ms"),
                              ("dispatch_ms", "dispatch_ms"),
                              ("dispatch_ratio", "dispatch_ratio")):
                if row.get(key) is not None:
                    head(f"windflow_health_{name}", name)
                    lines.append(f'windflow_health_{name}{{{slab}}} '
                                 f'{row[key]}')

    @staticmethod
    def _prometheus_slo(snap: dict, lines: List[str], esc) -> None:
        """``windflow_slo_*`` gauges from the snapshot's ``slo`` section
        (one label set per SLO).  Only the names registered in
        ``names.py::SLO_GAUGES`` render (the import-time lockstep check
        above); ``state`` renders its numeric code."""
        sec = snap.get("slo")
        if not sec:
            return
        g = snap["graph"]
        typed = set()

        def head(name):
            if name not in typed:
                typed.add(name)
                lines.append(f"# HELP windflow_slo_{name} {_SLO_HELP[name]}")
                lines.append(f"# TYPE windflow_slo_{name} gauge")

        for slo_name, row in sorted(sec.items()):
            lab = f'graph="{esc(g)}",slo="{esc(slo_name)}"'
            for name in ("burn_fast", "burn_slow", "signal", "target",
                         "pages"):
                v = row.get(name)
                if v is not None:
                    head(name)
                    lines.append(f'windflow_slo_{name}{{{lab}}} {v}')
            if row.get("code") is not None:
                head("state")
                lines.append(f'windflow_slo_state{{{lab}}} {row["code"]}')

    @staticmethod
    def _prometheus_telemetry(snap: dict, lines: List[str], esc) -> None:
        """``windflow_telemetry_*`` gauges from the snapshot's ``telemetry``
        section (the TelemetryAgent stats — present only when the fleet
        telemetry plane is on).  Only the names registered in
        ``names.py::TELEMETRY_GAUGES`` render (the import-time lockstep
        check above)."""
        sec = snap.get("telemetry")
        if not sec:
            return
        g = snap["graph"]
        for name in sorted(_TELEMETRY_HELP):
            v = sec.get(name)
            if v is None:
                continue
            lines.append(f"# HELP windflow_telemetry_{name} "
                         f"{_TELEMETRY_HELP[name]}")
            lines.append(f"# TYPE windflow_telemetry_{name} gauge")
            lines.append(f'windflow_telemetry_{name}{{graph="{esc(g)}"}} '
                         f'{v}')

    @staticmethod
    def _prometheus_serving(snap: dict, lines: List[str], esc) -> None:
        """``windflow_serving_*`` run-level gauges + ``windflow_tenant_*``
        per-tenant gauges from the snapshot's ``serving`` section.  Only
        names registered in ``names.py::SERVING_GAUGES``/``TENANT_GAUGES``
        render (the import-time lockstep check above)."""
        sec = snap.get("serving")
        if not sec:
            return
        g = snap["graph"]
        for name in sorted(_SERVING_HELP):
            v = sec.get(name)
            if v is None:
                continue
            lines.append(f"# HELP windflow_serving_{name} "
                         f"{_SERVING_HELP[name]}")
            lines.append(f"# TYPE windflow_serving_{name} gauge")
            lines.append(f'windflow_serving_{name}{{graph="{esc(g)}"}} {v}')
        tenants = sec.get("tenants") or {}
        typed = set()

        def head(name):
            if name not in typed:
                typed.add(name)
                lines.append(f"# HELP windflow_tenant_{name} "
                             f"{_TENANT_HELP[name]}")
                lines.append(f"# TYPE windflow_tenant_{name} gauge")

        for tid, row in sorted(tenants.items()):
            lab = f'graph="{esc(g)}",tenant="{esc(tid)}"'
            for name in sorted(_TENANT_HELP):
                v = row.get(name)
                if v is not None:
                    head(name)
                    lines.append(f'windflow_tenant_{name}{{{lab}}} {v}')

    @staticmethod
    def _prometheus_event_time(snap: dict, lines: List[str], esc) -> None:
        """``windflow_event_time_*`` gauges (HELP/TYPE'd) from the snapshot's
        event-time sections: per-operator watermark/lag/occupancy/pressure,
        per-(operator, stream) lateness quantiles, and the graph-level
        min-watermark frontier + per-edge skew.  Only the names registered
        in ``names.py::EVENT_TIME_GAUGES`` render (the module-level check
        below keeps the local maps and the registry in lockstep)."""
        g = snap["graph"]
        help_of = _EVENT_TIME_HELP
        key_map = _EVENT_TIME_KEY_MAP
        typed = set()

        def head(name):
            if name not in typed:
                typed.add(name)
                lines.append(f"# HELP windflow_event_time_{name} "
                             f"{help_of[name]}")
                lines.append(f"# TYPE windflow_event_time_{name} gauge")

        for row in snap["operators"]:
            sec = row.get("event_time")
            if not sec:
                continue
            lab = f'graph="{esc(g)}",operator="{esc(row["name"])}"'
            for key, gname in key_map.items():
                if key in sec:
                    head(gname)
                    lines.append(
                        f'windflow_event_time_{gname}{{{lab}}} {sec[key]}')
            fills = [v for k, v in sec.items() if k.endswith("_fill_pct")]
            if fills:
                head("archive_fill_pct")
                lines.append(f'windflow_event_time_archive_fill_pct{{{lab}}} '
                             f'{max(fills)}')
            for stream, summ in (sec.get("lateness") or {}).items():
                if not summ.get("total"):
                    continue
                slab = f'{lab},stream="{esc(stream)}"'
                for q in ("p50", "p99"):
                    head(f"lateness_{q}")
                    lines.append(f'windflow_event_time_lateness_{q}'
                                 f'{{{slab}}} {summ[q]}')
        et = snap.get("event_time") or {}
        if "min_watermark_ts" in et:
            head("min_watermark")
            lines.append(f'windflow_event_time_min_watermark'
                         f'{{graph="{esc(g)}"}} {et["min_watermark_ts"]}')
        for edge, skew in sorted((et.get("edge_skew_ts") or {}).items()):
            head("skew")
            lines.append(f'windflow_event_time_skew{{graph="{esc(g)}",'
                         f'edge="{esc(edge)}"}} {skew}')

    def to_prometheus(self, snap: Optional[dict] = None) -> str:
        """Render the snapshot in the Prometheus text format (one scrape body).
        Metric names: ``windflow_<counter>_total`` per-operator counters,
        ``windflow_service_time_seconds`` / ``windflow_e2e_latency_seconds``
        histograms, ``windflow_queue_depth`` / ``windflow_watermark_lag``
        gauges."""
        snap = snap or self.snapshot()
        g = snap["graph"]
        lines = []

        def esc(s):
            return str(s).replace("\\", "\\\\").replace('"', '\\"')

        for c in _COUNTERS:
            lines.append(f"# TYPE windflow_{c}_total counter")
            for row in snap["operators"]:
                lines.append(
                    f'windflow_{c}_total{{graph="{esc(g)}",'
                    f'operator="{esc(row["name"])}"}} {row[c]}')
        lines.append("# TYPE windflow_rate_in_tps gauge")
        for row in snap["operators"]:
            lines.append(f'windflow_rate_in_tps{{graph="{esc(g)}",'
                         f'operator="{esc(row["name"])}"}} {row["rate_in_tps"]}')
        lines.append("# TYPE windflow_watermark_lag gauge")
        for row in snap["operators"]:
            if "watermark" in row:
                lines.append(
                    f'windflow_watermark_lag{{graph="{esc(g)}",'
                    f'operator="{esc(row["name"])}"}} '
                    f'{row["watermark"]["lag_ts"]}')
        # per-stage operator counters/gauges (names.py::STAGE_COUNTERS /
        # STAGE_GAUGES — only registered names render, the WF240/241
        # discipline), with HELP lines: these are the PR 8 operator counters
        # promoted to a uniform per-operator exposition
        from .names import STAGE_COUNTERS, STAGE_GAUGES
        stage_help = {
            "sessions_closed": "sessions closed by the session triggerer",
            "topn_evictions": "leaderboard candidates evicted by the top-N "
                              "rank merge",
            "match_drops": "interval-join matches dropped past max_matches",
            "arch_drops": "live interval-join archive slots overwritten",
            "overflow_drops": "join-table pending-ring/table overflow drops",
            "old_drops": "tuples dropped as OLD behind the event-time "
                         "frontier",
            "join_table_version": "applied upsert count of the operator's "
                                  "join table",
        }
        for c in STAGE_COUNTERS + STAGE_GAUGES:
            rows = [r for r in snap["operators"]
                    if c in (r.get("counters") or {})]
            if not rows:
                continue
            kind = "gauge" if c in STAGE_GAUGES else "counter"
            suffix = "" if kind == "gauge" else "_total"
            lines.append(f"# HELP windflow_stage_{c}{suffix} "
                         f"{stage_help.get(c, c)}")
            lines.append(f"# TYPE windflow_stage_{c}{suffix} {kind}")
            for row in rows:
                lines.append(
                    f'windflow_stage_{c}{suffix}{{graph="{esc(g)}",'
                    f'operator="{esc(row["name"])}"}} {row["counters"][c]}')
        self._prometheus_event_time(snap, lines, esc)
        self._prometheus_health(snap, lines, esc)
        self._prometheus_slo(snap, lines, esc)
        self._prometheus_telemetry(snap, lines, esc)
        self._prometheus_serving(snap, lines, esc)
        lines.append("# TYPE windflow_queue_depth gauge")
        for edge, depth in snap["queues"].items():
            lines.append(f'windflow_queue_depth{{graph="{esc(g)}",'
                         f'edge="{esc(edge)}"}} {depth}')
        qcaps = snap.get("queue_capacity") or {}
        if qcaps:
            lines.append("# TYPE windflow_queue_capacity gauge")
            for edge, cap in qcaps.items():
                lines.append(f'windflow_queue_capacity{{graph="{esc(g)}",'
                             f'edge="{esc(edge)}"}} {cap}')
        # service-time histograms, straight from the live LogHistograms
        lines.append("# TYPE windflow_service_time_seconds histogram")
        with self._lock:
            for op, _state in self._op_units():
                for r in op.get_StatsRecords():
                    h = getattr(r, "service_hist", None)
                    if h is None or not h.count:
                        continue
                    lab = (f'graph="{esc(g)}",operator="{esc(op.getName())}",'
                           f'replica="{r.replica_id}"')
                    for le, acc in h.prometheus_buckets():
                        le_s = "+Inf" if le == float("inf") else f"{le:.9g}"
                        lines.append(
                            f'windflow_service_time_seconds_bucket'
                            f'{{{lab},le="{le_s}"}} {acc}')
                    lines.append(
                        f'windflow_service_time_seconds_sum{{{lab}}} {h.sum:.9g}')
                    lines.append(
                        f'windflow_service_time_seconds_count{{{lab}}} {h.count}')
        h = self.e2e_hist
        if h.count:
            lines.append("# TYPE windflow_e2e_latency_seconds histogram")
            lab = f'graph="{esc(g)}"'
            for le, acc in h.prometheus_buckets():
                le_s = "+Inf" if le == float("inf") else f"{le:.9g}"
                lines.append(f'windflow_e2e_latency_seconds_bucket'
                             f'{{{lab},le="{le_s}"}} {acc}')
            lines.append(f'windflow_e2e_latency_seconds_sum{{{lab}}} {h.sum:.9g}')
            lines.append(f'windflow_e2e_latency_seconds_count{{{lab}}} {h.count}')
        recovery = snap.get("recovery") or _recovery_counters()
        for k, v in sorted(recovery.items()):
            lines.append(f"# TYPE windflow_recovery_{k}_total counter")
            lines.append(f'windflow_recovery_{k}_total{{graph="{esc(g)}"}} '
                         f'{round(v, 6)}')
        control = snap.get("control") or _control_section()
        for k, v in sorted((control.get("counters") or {}).items()):
            lines.append(f"# TYPE windflow_control_{k}_total counter")
            lines.append(f'windflow_control_{k}_total{{graph="{esc(g)}"}} '
                         f'{round(v, 6)}')
        for k, v in sorted((control.get("gauges") or {}).items()):
            lines.append(f"# TYPE windflow_control_{k} gauge")
            lines.append(f'windflow_control_{k}{{graph="{esc(g)}"}} {v}')
        lines.append(f'windflow_uptime_seconds{{graph="{esc(g)}"}} '
                     f'{snap["uptime_s"]}')
        return "\n".join(lines) + "\n"

"""Runtime health ledger: device memory, captures and recaptures, device time.

Counterpart of ``windflow_tpu/observability/device_health.py`` on CUDA:

- **Memory ledger** (:func:`device_memory`, :func:`live_buffer_stats`): the
  caching allocator's and the driver's numbers under the JAX package's
  names, per-operator state footprints (``CompiledChain.state_footprints``),
  folded into the snapshot's ``health`` section and the
  ``windflow_hbm_headroom_bytes`` gauge.
- **Capture ledger** (:class:`HealthLedger`): each first run of a chain's
  step at a shape and each CUDA-graph capture is journaled as a ``compile``
  record (cause, cache key, duration), with an unexpected-recapture
  detector; each first resolution of a kernel registry key
  (``ops/registry.py``) as a ``kernel_resolve`` record.
- **Device-time attribution**: at the sampled service points of
  ``CompiledChain.push``/``push_many`` the host time of the push call
  (dispatch) and the device time between two CUDA events around it; the
  per-stage ratio is the dispatch-bound classifier.

Off by default (``MonitoringConfig.health``, ``WF_MONITORING_HEALTH``); off,
a call site costs a module attribute load and a ``None`` check, and nothing
is synchronized.

The snapshot loaders and the fleet merge (:func:`merge_snapshots`,
:func:`merge_monitoring_dirs`) are copies of the JAX module's: the fleet
aggregator (``fleet.py``) folds its hosts' snapshots with them.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from . import journal as _journal

#: snapshot schema version, stamped by ``MetricsRegistry.snapshot()`` as
#: the top-level ``"schema"`` field.  Seed-era snapshots carry no field and
#: read as version 0.  ``merge_snapshots`` never SILENTLY folds hosts that
#: disagree — a heterogeneous fleet mid-upgrade gets a ``schema_mismatch``
#: section that the loaders/CLIs surface.  Bump when a section's meaning
#: (not mere presence — sections are already optional) changes.
SNAPSHOT_SCHEMA = 1

#: dispatch-bound classifier threshold: a stage whose host-dispatch overhead
#: is at least this fraction of its device time is a fusion candidate (the
#: host loop, not the chip, is its ceiling)
DISPATCH_BOUND_RATIO = 0.5

#: headroom below this fraction of the device limit flags [HEADROOM-RISK]
#: (the wf_state.py OVERFLOW-RISK convention, applied to device memory)
HEADROOM_RISK_FRACTION = 0.2

#: the cost columns of the JAX package's ``compile`` records (XLA's AOT
#: cost and memory analysis): null in the port's records
COST_FIELDS = ("flops", "bytes_accessed", "argument_bytes", "output_bytes",
               "temp_bytes", "code_bytes")

#: compile-record history kept in memory per ledger (the journal holds the
#: full sequence; this bound only caps the snapshot section)
_COMPILE_LOG_CAP = 256


def _fnv1a32(s: str) -> int:
    h = 2166136261
    for ch in s.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


# -------------------------------------------------------------- the ledger


class HealthLedger:
    """Per-run capture/recapture + device-time ledger.

    The Monitor activates one ledger for its run (:func:`set_active`);
    ``CompiledChain`` reaches it through the module-level helpers below (one
    ``None`` check when off). Thread-safe: the threaded drivers' stage
    threads record concurrently; notes ride a thread-local pending list
    because a step is built on its calling thread.

    What the JAX package's ledger calls a trace is here the first run of a
    chain's program for one ``(stage, from_op, kind, signature)``: the first
    eager step at a shape (``kind="step"``, which builds the kernels it
    launches for the first time) or the capture of a K-step CUDA graph
    (``kind="scan"``, ``runtime/graphs.py``). Its ``compile`` record keeps
    the JAX record's cause, cache key and duration; a second capture under a
    signature already captured is an unexpected recapture
    (``retrace_unexpected``). XLA's cost analysis has no counterpart: the
    records' cost columns are null and ``executables`` stays empty."""

    def __init__(self, sample_every: int = 1):
        #: record device-time attribution on every Nth *sampled* service
        #: point (the sampled pushes already wait for the stream; this only
        #: subsamples the split's bookkeeping)
        self.sample_every = max(1, int(sample_every))
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.traces = 0                  # every note_trace (compile events)
        self.retraces = 0                # re-trace of a known (stage, kind)
        #                                  under a NEW shape/dtype signature
        #                                  (capacity switch, weak-type drift)
        self.retraces_unexpected = 0     # re-trace under an ALREADY-TRACED
        #                                  signature: a warm executable was
        #                                  silently recompiled
        self.compile_s_total = 0.0
        self.kernel_resolves = 0
        # (label, from_op, kind) -> {sig: traces seen}
        self._sigs: Dict[Tuple[str, int, str], Dict[str, int]] = {}
        self._compile_log: List[dict] = []
        # stage label -> [device_s, dispatch_s, samples]
        self._service: Dict[str, List[float]] = {}
        self._svc_seen = 0

    # -- cause tracking ----------------------------------------------------

    def set_cause(self, cause: str) -> None:
        """The cause of the notes made on this thread from now on (``push``,
        ``push_many``, ``warm``, ``warm_scan``); a :func:`cause` context
        (``autotune_prewarm``) wins."""
        self._tls.cause = cause

    def _current_cause(self) -> str:
        override = getattr(_CAUSE_TLS, "override", None)
        return override or getattr(self._tls, "cause", "push")

    # -- capture notes (the first run of a program at a signature) ---------

    def suppressed(self) -> bool:
        """Whether notes on this thread are suppressed (:meth:`_suppress`):
        a program run again to be inspected is no new capture, and the
        kernels it resolves are no new resolutions."""
        return bool(getattr(self._tls, "suppress", 0))

    def _suppress(self, on: bool) -> None:
        self._tls.suppress = getattr(self._tls, "suppress", 0) + (1 if on else -1)

    def note_trace(self, label: str, from_op: int, kind: str, sig: str,
                   capacity: Optional[int] = None,
                   k: Optional[int] = None) -> None:
        """One first run (eager step) or capture (K-step graph) of a chain
        program observed. Classifies it (fresh, a new signature of a known
        program, or an unexpected recapture under a signature already
        seen), journals the detector event, and parks a pending record for
        the caller to finish with its duration once the call returns
        (``commit_pending``)."""
        if self.suppressed():
            return
        key = (label, int(from_op), kind)
        cache_key = f"{_fnv1a32('/'.join((label, str(from_op), kind, sig))):08x}"
        with self._lock:
            self.traces += 1
            seen = self._sigs.setdefault(key, {})
            unexpected = sig in seen
            retrace = bool(seen) and not unexpected
            seen[sig] = seen.get(sig, 0) + 1
            if unexpected:
                self.retraces_unexpected += 1
            elif retrace:
                self.retraces += 1
        rec = {"label": label, "from_op": int(from_op), "kind": kind,
               "cache_key": cache_key, "cause": self._current_cause(),
               "retrace": retrace, "unexpected": unexpected}
        if capacity is not None:
            rec["capacity"] = int(capacity)
        if k is not None and int(k) > 1:
            rec["k"] = int(k)
        if unexpected:
            # the detector event fires immediately (the compile record
            # follows once the call returns with its duration): a warm
            # program captured again under an identical signature (a chain
            # built anew, or its graphs dropped), never a shape change
            _journal.record("retrace_unexpected", **rec)
        pending = getattr(self._tls, "pending", None)
        if pending is None:
            pending = self._tls.pending = []
        pending.append(rec)

    def has_pending(self) -> bool:
        """Whether THIS invocation traced/compiled (pending notes parked on
        the calling thread) — the device-time sampler consults it so a
        first build's or capture's time is never charged to ``dispatch_ms`` (which
        would permanently mis-flag the stage as dispatch-bound; the sums
        never decay)."""
        return bool(getattr(self._tls, "pending", None))

    def take_pending(self) -> List[dict]:
        out = getattr(self._tls, "pending", None)
        if not out:
            return []
        self._tls.pending = []
        return out

    def clear_pending(self) -> None:
        """Drop pending trace notes on this thread — the supervised restore
        path calls this so a step that faulted mid-compile cannot charge its
        abandoned trace's duration to the next successful push."""
        self._tls.pending = []

    def commit_pending(self, duration_s: float, op: str = "") -> None:
        """Finish the pending notes of this thread: journal one ``compile``
        event per note with its cause, cache key and duration, and the JAX
        record's cost columns null (XLA's cost analysis has no
        counterpart)."""
        notes = self.take_pending()
        if not notes:
            return
        dur = float(duration_s) / len(notes)
        for rec in notes:
            rec = dict(rec)
            rec["compile_s"] = round(dur, 6)
            if op:
                rec["op"] = op
            rec.update(dict.fromkeys(COST_FIELDS))
            with self._lock:
                self.compile_s_total += dur
                self._compile_log.append(rec)
                if len(self._compile_log) > _COMPILE_LOG_CAP:
                    del self._compile_log[0]
            _journal.record("compile", **rec)

    # -- device-time attribution -------------------------------------------

    def service_sample(self) -> bool:
        """Whether THIS sampled service point should also record the
        host-dispatch vs device-time split (every Nth, ``sample_every``)."""
        with self._lock:
            self._svc_seen += 1
            return (self._svc_seen % self.sample_every) == 0

    def note_service(self, label: str, dispatch_s: float,
                     device_s: float) -> None:
        with self._lock:
            acc = self._service.setdefault(label, [0.0, 0.0, 0])
            acc[0] += float(device_s)
            acc[1] += float(dispatch_s)
            acc[2] += 1

    def note_kernel_resolve(self, kernel: str, spec_key: str, impl: str,
                            device: str = "") -> None:
        if self.suppressed():
            return
        with self._lock:
            self.kernel_resolves += 1
        _journal.record("kernel_resolve", kernel=kernel, spec_key=spec_key,
                        impl=impl, device=device)

    # -- snapshot ----------------------------------------------------------

    def device_time_section(self) -> Dict[str, dict]:
        out = {}
        with self._lock:
            items = [(lb, list(acc)) for lb, acc in self._service.items()]
        for label, (dev, disp, n) in items:
            row = {"device_ms": round(dev * 1e3, 3),
                   "dispatch_ms": round(disp * 1e3, 3), "samples": n}
            if dev > 0:
                row["dispatch_ratio"] = round(disp / dev, 4)
            out[label] = row
        return out

    def snapshot_section(self) -> dict:
        dt = self.device_time_section()
        bound = {label: row["dispatch_ratio"] for label, row in dt.items()
                 if row.get("dispatch_ratio", 0.0) >= DISPATCH_BOUND_RATIO}
        with self._lock:
            sec = {
                "compile": {
                    "compiles": self.traces,
                    "retraces": self.retraces,
                    "retraces_unexpected": self.retraces_unexpected,
                    "compile_s_total": round(self.compile_s_total, 6),
                    "kernel_resolves": self.kernel_resolves,
                },
                "compile_log": list(self._compile_log[-32:]),
                # the JAX section's executable footprints: no XLA
                # memory analysis here
                "executables": {},
            }
        if dt:
            sec["device_time"] = dt
        if bound:
            sec["dispatch_bound"] = bound
        return sec


# ------------------------------------------------- process-global active hook

_active: Optional[HealthLedger] = None


def set_active(ledger: Optional[HealthLedger]) -> None:
    global _active
    _active = ledger


def get_active() -> Optional[HealthLedger]:
    return _active


_CAUSE_TLS = threading.local()


@contextlib.contextmanager
def cause(name: str):
    """Attribute the notes made on this thread inside the block to ``name``
    (``autotune_prewarm`` around the capacity and K ladders' warm loops),
    over the chain methods' own causes."""
    prev = getattr(_CAUSE_TLS, "override", None)
    _CAUSE_TLS.override = name
    try:
        yield
    finally:
        _CAUSE_TLS.override = prev


def note_kernel_resolve(kernel: str, spec_key: str, impl: str,
                        device: str = "") -> None:
    led = _active
    if led is not None:
        led.note_kernel_resolve(kernel, spec_key, impl, device)


def clear_pending() -> None:
    led = _active
    if led is not None:
        led.clear_pending()


# ------------------------------------------------------------ device memory


def device_memory() -> List[dict]:
    """Per-device memory gauges, in the JAX package's row names. On a CUDA
    device, from the caching allocator (``torch.cuda.memory_stats``) and the
    driver (``torch.cuda.mem_get_info``):

    - ``bytes_in_use``: bytes of live tensors (``allocated_bytes.all.current``);
    - ``bytes_limit``: what this process could hold, its allocator's
      reservation plus the device's free bytes;
    - ``headroom_bytes = bytes_limit - bytes_in_use``;
    - ``peak_bytes_in_use``: ``allocated_bytes.all.peak``.

    Without CUDA, one identity row for the CPU (``cpu:0``, as JAX lists its
    CPU device), without memory numbers."""
    import torch
    if not torch.cuda.is_available():
        return [{"device": "cpu:0", "kind": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        row = {"device": f"cuda:{i}", "kind": torch.cuda.get_device_name(i)}
        ms = torch.cuda.memory_stats(i)
        free, _total = torch.cuda.mem_get_info(i)
        in_use = int(ms.get("allocated_bytes.all.current", 0))
        limit = int(free) + int(ms.get("reserved_bytes.all.current", 0))
        row["bytes_in_use"] = in_use
        row["bytes_limit"] = limit
        row["headroom_bytes"] = limit - in_use
        row["peak_bytes_in_use"] = int(ms.get("allocated_bytes.all.peak", 0))
        out.append(row)
    return out


def live_buffer_stats() -> dict:
    """Live allocator blocks and their bytes, summed over the CUDA devices
    (``active.all.current``, ``active_bytes.all.current``): the counterpart
    of the JAX package's ``jax.live_arrays()`` walk, which has none here. A
    block may back several tensors (views), so the count is of blocks, not
    tensors. Empty without CUDA."""
    import torch
    if not torch.cuda.is_available():
        return {}
    count = total = 0
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        count += int(ms.get("active.all.current", 0))
        total += int(ms.get("active_bytes.all.current", 0))
    return {"live_buffer_count": count, "live_buffer_bytes": total}


def headroom_risks(devices: Sequence[dict]) -> List[str]:
    """Device labels whose headroom sits below ``HEADROOM_RISK_FRACTION`` of
    the limit — the promotion/eviction signal tiered state (ROADMAP 3)
    consumes."""
    out = []
    for row in devices or []:
        head, limit = row.get("headroom_bytes"), row.get("bytes_limit")
        if head is not None and limit:
            if head < HEADROOM_RISK_FRACTION * limit:
                out.append(row.get("device", "?"))
    return out


# ------------------------------------------------- shared snapshot loading
#
# THE one snapshot/journal loader for wf_state.py / wf_trace.py /
# wf_health.py (each previously grew its own copy).  Torn-tolerant: a
# snapshots.jsonl line cut mid-write (host crash between append and flush)
# is skipped, never a crash — and snapshot.json itself is written via
# tmp+os.replace by the Reporter, so a reader can never observe it torn.


def load_snapshots(mon_dir: str):
    """(latest snapshot, full time series) from a monitoring directory.
    Raises FileNotFoundError when neither artifact exists."""
    series = []
    jl = os.path.join(mon_dir, "snapshots.jsonl")
    if os.path.exists(jl):
        with open(jl) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    series.append(json.loads(line))
                except ValueError:
                    # torn tail of an append in progress — drop the line,
                    # keep the parsed prefix (the Reporter's snapshot.json
                    # replace is atomic; the jsonl append is not)
                    continue
    latest = None
    sj = os.path.join(mon_dir, "snapshot.json")
    if os.path.exists(sj):
        try:
            with open(sj) as f:
                latest = json.load(f)
        except ValueError:
            latest = None
    if latest is None and series:
        latest = series[-1]
    if latest is None:
        raise FileNotFoundError(
            f"no snapshot.json / snapshots.jsonl under {mon_dir!r}")
    return latest, series


def load_journal(mon_dir: str) -> List[dict]:
    path = os.path.join(mon_dir, "events.jsonl")
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue               # torn tail, same policy as above
    return out


# --------------------------------------------------------- fleet federation


def _sum_into(dst: dict, src: dict) -> None:
    for k, v in (src or {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            dst[k] = dst.get(k, 0) + v


def _max_into(dst: dict, src: dict) -> None:
    for k, v in (src or {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            dst[k] = max(dst.get(k, v), v)


#: event-time section keys merged by MAX across hosts (pressure gauges: the
#: fleet view must show the worst host) — everything else numeric in the
#: per-op section is summed (counters) except the watermark family, which
#: takes MIN (the frontier is held by the slowest host)
_ET_MAX_KEYS = ("occupancy_pct", "pending_depth", "l_fill_pct", "r_fill_pct",
                "open_sessions", "oldest_open_age", "lag")
_ET_MIN_KEYS = ("watermark_ts", "fire_frontier_ts")

#: tiered-state sub-section ("tier" in the event-time rows): occupancy /
#: size gauges take MAX (the fleet view shows the worst host), the
#: spill/readmit/compaction movement counters SUM
_TIER_MAX_KEYS = ("hot_pct", "hot_used", "hot_slots", "outbox_slots",
                  "outbox_depth", "cold_keys", "cold_rows",
                  "l_cold_rows", "r_cold_rows")


def _merge_tier_section(dst: dict, src: dict) -> None:
    for k, v in (src or {}).items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k in _TIER_MAX_KEYS:
            dst[k] = max(dst.get(k, v), v)
        else:                       # state_spills/readmits/compactions
            dst[k] = dst.get(k, 0) + v


def _merge_et_section(dst: dict, src: dict) -> None:
    for k, v in (src or {}).items():
        if k == "tier" and isinstance(v, dict):
            _merge_tier_section(dst.setdefault("tier", {}), v)
            continue
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k in _ET_MAX_KEYS:
            dst[k] = max(dst.get(k, v), v)
        elif k in _ET_MIN_KEYS:
            dst[k] = min(dst.get(k, v), v)
        else:
            dst[k] = dst.get(k, 0) + v


def merge_snapshots(snaps: Sequence[dict],
                    hosts: Optional[Sequence[str]] = None) -> dict:
    """Fold N per-host snapshots into ONE fleet snapshot: counters summed,
    the watermark frontier min'd, occupancy/pressure gauges max'd, queue
    depths max'd, HBM/health ledgers concatenated/summed, per-host
    provenance kept under ``hosts``.  Latency percentiles cannot be merged
    from summaries — the fleet row keeps the MAX percentile (worst host)
    and the summed sample count, which is the honest conservative read."""
    snaps = [s for s in snaps if s]
    if not snaps:
        raise ValueError("merge_snapshots: no snapshots to merge")
    hosts = list(hosts) if hosts else []
    if len(hosts) < len(snaps):               # pad, never silently truncate
        hosts += [f"host{i}" for i in range(len(hosts), len(snaps))]
    # duplicate host tags (two --merge dirs with the same basename) are
    # disambiguated with a #N suffix, never silently folded into one host's
    # rows — host-tagged sections (shards, pages_by_host, devices) would
    # otherwise collide and drop data
    seen_tags: Dict[str, int] = {}
    for i, h in enumerate(hosts):
        n = seen_tags.get(h, 0) + 1
        seen_tags[h] = n
        if n > 1:
            hosts[i] = f"{h}#{n}"
    out: dict = {
        "graph": "+".join(dict.fromkeys(s.get("graph", "?") for s in snaps)),
        "merged_from": len(snaps),
        "hosts": [{"host": h, "graph": s.get("graph"),
                   "wall_time": s.get("wall_time"),
                   "uptime_s": s.get("uptime_s")}
                  for h, s in zip(hosts, snaps)],
    }
    # schema provenance: the merged view carries the NEWEST schema seen;
    # hosts that disagree (a fleet mid-upgrade) are flagged per host under
    # ``schema_mismatch`` — the fold still runs (the sections are all
    # individually optional), but the disagreement is never silent, and the
    # loaders/CLIs surface it (seed-era snapshots read as version 0)
    schemas = {h: int(s.get("schema", 0) or 0)
               for h, s in zip(hosts, snaps)}
    out["schema"] = max(schemas.values())
    if len(set(schemas.values())) > 1:
        out["schema_mismatch"] = schemas
    # operators joined by name: counters summed, percentiles max'd
    ops: Dict[str, dict] = {}
    order: List[str] = []
    for host, s in zip(hosts, snaps):
        for row in s.get("operators") or []:
            if not isinstance(row, dict):
                continue                      # torn/partial host section
            name = row.get("name", "?")
            dst = ops.get(name)
            if dst is None:
                dst = ops[name] = {"name": name, "hosts": []}
                order.append(name)
            dst["hosts"].append(host)
            _sum_into(dst, {k: v for k, v in row.items()
                            if k not in ("service_time_us", "event_time",
                                         "counters", "watermark")})
            if row.get("counters"):
                dst.setdefault("counters", {})
                _sum_into(dst["counters"], row["counters"])
            if row.get("service_time_us"):
                st = dst.setdefault("service_time_us", {})
                samples = st.get("samples", 0) + \
                    row["service_time_us"].get("samples", 0)
                _max_into(st, row["service_time_us"])
                st["samples"] = samples
            if row.get("event_time"):
                dst.setdefault("event_time", {})
                _merge_et_section(dst["event_time"], row["event_time"])
    out["operators"] = [ops[n] for n in order]
    totals: dict = {}
    for s in snaps:
        _sum_into(totals, s.get("totals") or {})
    out["totals"] = totals
    queues: dict = {}
    for s in snaps:
        _max_into(queues, s.get("queues") or {})
    if queues:
        out["queues"] = queues
    recovery: dict = {}
    control_counters: dict = {}
    for s in snaps:
        _sum_into(recovery, s.get("recovery") or {})
        _sum_into(control_counters, (s.get("control") or {}).get("counters")
                  or {})
    out["recovery"] = recovery
    out["control"] = {"counters": control_counters}
    # e2e latency: worst-host percentiles + fleet sample count
    e2e: dict = {}
    for s in snaps:
        row = s.get("e2e_latency_us") or {}
        samples = e2e.get("samples", 0) + row.get("samples", 0)
        _max_into(e2e, row)
        e2e["samples"] = samples
    if e2e:
        out["e2e_latency_us"] = e2e
    # graph-level event time: the fleet frontier is the MIN across hosts
    ets = [(h, s.get("event_time")) for h, s in zip(hosts, snaps)
           if isinstance(s.get("event_time"), dict)]
    if ets:
        sec: dict = {}
        wm = [(e["min_watermark_ts"], h, e) for h, e in ets
              if "min_watermark_ts" in e]
        if wm:
            mn = min(wm, key=lambda t: t[0])
            sec["min_watermark_ts"] = mn[0]
            sec["frontier_host"] = mn[1]
            if mn[2].get("frontier_operator"):
                sec["frontier_operator"] = mn[2]["frontier_operator"]
        skews: dict = {}
        for _h, e in ets:
            _max_into(skews, e.get("edge_skew_ts") or {})
        if skews:
            sec["edge_skew_ts"] = skews
        out["event_time"] = sec
    # shard-local supervision: per-shard rows are folded HOST-TAGGED
    # (``host/shard``), never summed — a fleet view that summed shard
    # gauges could not name WHICH shard is hot, which is the whole point
    # of the per-shard health surface (names.py::SHARD_GAUGES)
    shard_secs = [(h, s.get("shards")) for h, s in zip(hosts, snaps)
                  if isinstance(s.get("shards"), dict)]
    if shard_secs:
        ssec: dict = {}
        for host, rows in shard_secs:
            for k, row in rows.items():
                ssec[f"{host}/{k}"] = dict(row)
        out["shards"] = ssec
    # SLO sections joined by SLO name: worst state wins (code MAX, the
    # host holding it named), burn rates MAX (the fleet view must show the
    # worst burn), pages summed AND host-tagged — an un-tagged page total
    # could not say WHICH host was paging.  The latest signal VALUE comes
    # from the worst (code, burn_fast) host, never a blanket MAX: for a
    # min-sense signal like hbm_headroom_pct, MAX would report the
    # HEALTHIEST host's headroom on a row whose state says another host
    # is paging
    slo_secs = [(h, s.get("slo")) for h, s in zip(hosts, snaps)
                if isinstance(s.get("slo"), dict)]
    if slo_secs:
        ssec: Dict[str, dict] = {}
        worst_key: Dict[str, tuple] = {}
        for host, rows in slo_secs:
            for name, row in rows.items():
                if not isinstance(row, dict):
                    continue                  # torn/partial host section
                dst = ssec.setdefault(name, {"state": "ok", "code": 0,
                                             "pages": 0,
                                             "pages_by_host": {}})
                code = int(row.get("code", 0))
                bf = row.get("burn_fast")
                key = (code, bf if isinstance(bf, (int, float)) else 0.0)
                if name not in worst_key or key > worst_key[name]:
                    worst_key[name] = key
                    dst["code"] = code
                    dst["state"] = row.get("state", dst["state"])
                    dst["worst_host"] = host
                    if row.get("signal") is not None:
                        dst["signal"] = row["signal"]
                    else:
                        dst.pop("signal", None)
                for k in ("burn_fast", "burn_slow"):
                    v = row.get(k)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        dst[k] = max(dst.get(k, v), v)
                if row.get("target") is not None and "target" not in dst:
                    dst["target"] = row["target"]
                pages = int(row.get("pages", 0))
                dst["pages"] += pages
                if pages:
                    dst["pages_by_host"][host] = pages
        out["slo"] = ssec
    # serving sections: run-level counters SUMMED (frames_torn across the
    # fleet is one total, like the telemetry fold), tenant rows joined by
    # tenant id and SUMMED per id (one tenant's fleet-wide shed pressure is
    # ONE series — the label is the tenant, not the host; the rate gauge
    # takes MIN, the tightest remediated bucket across hosts), graph labels
    # concatenated when hosts disagree mid-swap
    serv_secs = [(h, s.get("serving")) for h, s in zip(hosts, snaps)
                 if isinstance(s.get("serving"), dict)]
    if serv_secs:
        vsec: dict = {}
        tenants: Dict[str, dict] = {}
        graphs: List[str] = []
        for host, sec in serv_secs:
            g = sec.get("graph")
            if g and g not in graphs:
                graphs.append(g)
            _sum_into(vsec, {k: v for k, v in sec.items()
                             if isinstance(v, (int, float))
                             and not isinstance(v, bool)})
            for tid, row in (sec.get("tenants") or {}).items():
                if not isinstance(row, dict):
                    continue                  # torn/partial host section
                dst = tenants.setdefault(str(tid), {})
                rate = row.get("rate")
                # latency percentiles fold like SLO burn rates — MAX
                # across hosts (percentiles never sum), the exemplar
                # follows the worst host's p99; only the sample counters
                # ride the sum below
                pct_keys = ("e2e_p50_ms", "e2e_p95_ms", "e2e_p99_ms",
                            "e2e_p99_tick_ms")
                for k in pct_keys:
                    v = row.get(k)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        dst[k] = max(dst.get(k, v), v)
                p99 = row.get("e2e_p99_ms")
                if row.get("e2e_p99_exemplar") is not None \
                        and isinstance(p99, (int, float)) \
                        and p99 >= dst.get("e2e_p99_ms", p99):
                    dst["e2e_p99_exemplar"] = row["e2e_p99_exemplar"]
                _sum_into(dst, {k: v for k, v in row.items()
                                if k != "rate" and k not in pct_keys
                                and k != "e2e_p99_exemplar"})
                if isinstance(rate, (int, float)):
                    dst["rate"] = min(dst.get("rate", rate), rate)
        if graphs:
            vsec["graph"] = "+".join(graphs)
        if tenants:
            vsec["tenants"] = tenants
        out["serving"] = vsec
    # health ledgers: devices concatenated (host-tagged), footprints and
    # compile counters summed, device-time summed with the dispatch-bound
    # classifier recomputed over the fleet totals
    healths = [(h, s.get("health")) for h, s in zip(hosts, snaps)
               if isinstance(s.get("health"), dict)]
    if healths:
        hsec: dict = {"devices": []}
        state_bytes: dict = {}
        compile_tot: dict = {}
        dt: Dict[str, dict] = {}
        for host, hs in healths:
            for d in hs.get("devices", []):
                hsec["devices"].append(
                    dict(d, device=f"{host}/{d.get('device', '?')}"))
            _sum_into(state_bytes, hs.get("state_bytes") or {})
            _sum_into(compile_tot, hs.get("compile") or {})
            for label, row in (hs.get("device_time") or {}).items():
                acc = dt.setdefault(label, {"device_ms": 0.0,
                                            "dispatch_ms": 0.0, "samples": 0})
                _sum_into(acc, {k: row.get(k, 0) for k in
                                ("device_ms", "dispatch_ms", "samples")})
        if state_bytes:
            hsec["state_bytes"] = state_bytes
        if compile_tot:
            hsec["compile"] = compile_tot
        if dt:
            for row in dt.values():
                if row["device_ms"] > 0:
                    row["dispatch_ratio"] = round(
                        row["dispatch_ms"] / row["device_ms"], 4)
            hsec["device_time"] = dt
            bound = {lb: r["dispatch_ratio"] for lb, r in dt.items()
                     if r.get("dispatch_ratio", 0.0) >= DISPATCH_BOUND_RATIO}
            if bound:
                hsec["dispatch_bound"] = bound
        out["health"] = hsec
    return out


def merge_monitoring_dirs(paths: Sequence[str]):
    """(merged latest snapshot, merged index-aligned series, concatenated
    journal) over N per-host monitoring directories OR snapshots.jsonl
    files — the ``--merge`` entry point of wf_health.py / wf_state.py."""
    latests, serieses, journal, hosts = [], [], [], []
    for p in paths:
        mon_dir = os.path.dirname(p) if p.endswith(".jsonl") else p
        hosts.append(os.path.basename(os.path.normpath(mon_dir)) or mon_dir)
        latest, series = load_snapshots(mon_dir)
        latests.append(latest)
        serieses.append(series or [latest])
        journal.extend(load_journal(mon_dir))
    merged = merge_snapshots(latests, hosts=hosts)
    n_ticks = min(len(s) for s in serieses)
    merged_series = [merge_snapshots([s[i] for s in serieses], hosts=hosts)
                     for i in range(n_ticks)]
    journal.sort(key=lambda e: e.get("wall", 0.0))
    return merged, merged_series, journal

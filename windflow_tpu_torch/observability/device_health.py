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
  detector; each first build of a hand kernel (``ops/cuda.py``) as a
  ``kernel_resolve`` record.
- **Device-time attribution**: at the sampled service points of
  ``CompiledChain.push``/``push_many`` the host time of the push call
  (dispatch) and the device time between two CUDA events around it; the
  per-stage ratio is the dispatch-bound classifier.

Off by default (``MonitoringConfig.health``, ``WF_MONITORING_HEALTH``); off,
a call site costs a module attribute load and a ``None`` check, and nothing
is synchronized. The JAX module's fleet merge (``merge_snapshots``) is
ROADMAP Queue 1 item 16b; its snapshot loaders serve its scripts, which
read the port's artifacts as they are.
"""

from __future__ import annotations

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
        ``push_many``, ``warm``, ``warm_scan``)."""
        self._tls.cause = cause

    # -- capture notes (the first run of a program at a signature) ---------

    def note_trace(self, label: str, from_op: int, kind: str, sig: str,
                   capacity: Optional[int] = None,
                   k: Optional[int] = None) -> None:
        """One first run (eager step) or capture (K-step graph) of a chain
        program observed. Classifies it (fresh, a new signature of a known
        program, or an unexpected recapture under a signature already
        seen), journals the detector event, and parks a pending record for
        the caller to finish with its duration once the call returns
        (``commit_pending``)."""
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
               "cache_key": cache_key, "cause": getattr(self._tls, "cause", "push"),
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

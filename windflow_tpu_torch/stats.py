"""Per-replica statistics — ``Stats_Record``.

Counterpart of ``windflow_tpu/stats.py`` (reference ``wf/stats_record.hpp:50-156``):
host-side counters of tuples, batches and bytes, the launches of the
operator's step with the host<->device bytes, and a log-bucket histogram of
the sampled service times (``CompiledChain`` times every
``SERVICE_SAMPLE_EVERY``-th push to completion). ``dump_to_file`` writes one
JSON file a replica, as the reference's ``dump_toFile`` does
(``wf/stats_record.hpp:109-155``); ``PipeGraph.dump_stats`` calls it.

:func:`xprof_trace` is the counterpart of the JAX package's profiler capture:
one ``torch.profiler`` session a process, written as a Chrome trace.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

#: histogram geometry: bounds[i] = BASE_S * GROWTH**i, spanning 1 us .. ~90 s
_BASE_S = 1e-6
_GROWTH = 2.0 ** 0.5
_N_BUCKETS = 54


class LogHistogram:
    """Log-spaced latency histogram (seconds): a reported percentile is the
    upper bound of its bucket, at most a factor sqrt(2) above the sample.
    Thread-safe for concurrent ``record`` (the reporter thread reads while
    driver threads write). Counterpart of
    ``windflow_tpu/observability/metrics.py::LogHistogram``."""

    #: shared, immutable upper bounds (seconds); the last bucket is +inf
    BOUNDS: List[float] = [_BASE_S * _GROWTH ** i for i in range(_N_BUCKETS)]

    def __init__(self):
        self.counts = [0] * (_N_BUCKETS + 1)      # +1 = overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        #: latency exemplars: bucket index -> the LAST trace id that landed
        #: there (observability/tracing.py) — links a percentile line in the
        #: snapshot to a concrete traced batch.  Populated only when callers
        #: pass ``exemplar=`` (tracing on), so the plain path pays one None
        #: check.
        self.exemplars: Dict[int, int] = {}
        self._lock = threading.Lock()

    def record(self, seconds: float, exemplar=None) -> None:
        s = float(seconds)
        if s < 0.0:
            s = 0.0
        i = bisect.bisect_left(self.BOUNDS, s)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += s
            if s < self.min:
                self.min = s
            if s > self.max:
                self.max = s
            if exemplar is not None:
                self.exemplars[i] = exemplar

    def _snap(self) -> tuple:
        """One consistent ``(counts, count, sum, min, max, exemplars)``
        read — the reporter thread summarizes while driver/stage threads
        record, so every read-side path (incl. the registry's cross-replica
        merge) works off a locked snapshot instead of walking the live
        fields (a torn counts/count pair would misplace a percentile, and
        iterating the live exemplars dict while record() inserts raises;
        surfaced by the WF260 concurrency lint)."""
        with self._lock:
            return (list(self.counts), self.count, self.sum, self.min,
                    self.max, dict(self.exemplars))

    @staticmethod
    def _bucket_of(counts: List[int], count: int, q: float) -> Optional[int]:
        """Index of the bucket holding the q-th sample; None when empty."""
        if not count:
            return None
        target = max(1, int(q / 100.0 * count + 0.5))
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                return i
        return len(counts) - 1

    @classmethod
    def _pct_value(cls, counts: List[int], count: int, mx: float,
                   q: float) -> float:
        """q-th percentile from one snapshot: the upper bound of the bucket
        holding the q-th sample (overflow bucket -> observed max) — an
        overestimate by at most one bucket width (factor sqrt(2)).  THE one
        bucket-to-value rule; percentile() and summary_us() both use it."""
        i = cls._bucket_of(counts, count, q)
        if i is None:
            return 0.0
        if i >= _N_BUCKETS:                      # overflow bucket
            return mx
        return min(cls.BOUNDS[i], mx)

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100])."""
        counts, count, _sum, _mn, mx, _ex = self._snap()
        return self._pct_value(counts, count, mx, q)

    def exemplar(self, q: float) -> Optional[int]:
        """Trace id of the last sample that landed in the q-th percentile's
        bucket (None when empty or never traced) — THE link from a histogram
        line to a concrete batch in the flight recorder."""
        counts, count, _sum, _mn, _mx, exemplars = self._snap()
        i = self._bucket_of(counts, count, q)
        return None if i is None else exemplars.get(i)

    @property
    def mean(self) -> float:
        _counts, count, total, _mn, _mx, _ex = self._snap()
        return total / count if count else 0.0

    def summary_us(self) -> Dict[str, float]:
        """p50/p95/p99 + mean in microseconds (the snapshot's unit), all
        computed from ONE consistent snapshot.  When tracing supplied
        exemplars, ``p99_exemplar`` names the trace id of the last batch
        that landed in the p99 bucket."""
        counts, count, total, _mn, mx, exemplars = self._snap()
        pct = lambda q: self._pct_value(counts, count, mx, q)
        out = {
            "p50": round(pct(50) * 1e6, 3),
            "p95": round(pct(95) * 1e6, 3),
            "p99": round(pct(99) * 1e6, 3),
            "mean": round((total / count if count else 0.0) * 1e6, 3),
            "max": round(mx * 1e6, 3) if count else 0.0,
            "samples": count,
        }
        i99 = self._bucket_of(counts, count, 99)
        ex = None if i99 is None else exemplars.get(i99)
        if ex is not None:
            out["p99_exemplar"] = ex
        return out

    def prometheus_buckets(self):
        """Cumulative (le_seconds, count) pairs, Prometheus histogram form."""
        counts, count, _sum, _mn, _mx, _ex = self._snap()
        out, acc = [], 0
        for i, c in enumerate(counts[:_N_BUCKETS]):
            acc += c
            out.append((self.BOUNDS[i], acc))
        out.append((float("inf"), count))
        return out


class Stats_Record:  # wf-lint: single-writer[driver, stage]
    def __init__(self, op_name: str, replica_id: int = 0):
        self.op_name = op_name
        self.replica_id = replica_id
        self.start_time = time.monotonic()
        self.inputs_received = 0
        self.bytes_received = 0
        self.outputs_sent = 0
        self.bytes_sent = 0
        self.batches_received = 0
        self.batches_sent = 0
        self.num_kernels = 0          # step launches attributed to this operator
        self.bytes_copied_hd = 0      # host -> device
        self.bytes_copied_dh = 0      # device -> host
        self.tuples_dropped_old = 0   # TB window stragglers behind the fired horizon
        self._service_time_sum = 0.0
        self._service_samples = 0
        #: distribution of the sampled service times
        self.service_hist = LogHistogram()

    def record_input(self, n_tuples: int, n_bytes: int = 0):
        self.inputs_received += int(n_tuples)
        self.bytes_received += int(n_bytes)
        self.batches_received += 1

    def record_output(self, n_tuples: int, n_bytes: int = 0):
        self.outputs_sent += int(n_tuples)
        self.bytes_sent += int(n_bytes)
        self.batches_sent += 1

    def record_launch(self, service_time_s: Optional[float] = None, hd_bytes: int = 0,
                      dh_bytes: int = 0, exemplar=None):
        """One step launch; ``service_time_s`` is a measured launch-to-
        completion sample (None on unsampled launches), ``exemplar`` the
        trace id of the sampled batch (tracing on)."""
        self.num_kernels += 1
        self.bytes_copied_hd += int(hd_bytes)
        self.bytes_copied_dh += int(dh_bytes)
        if service_time_s is not None:
            self._service_time_sum += float(service_time_s)
            self._service_samples += 1
            self.service_hist.record(service_time_s, exemplar=exemplar)

    @property
    def avg_service_time_us(self) -> float:
        if not self._service_samples:
            return 0.0
        return 1e6 * self._service_time_sum / self._service_samples

    def as_dict(self) -> dict:
        return {
            "operator": self.op_name,
            "replica": self.replica_id,
            "inputs_received": self.inputs_received,
            "outputs_sent": self.outputs_sent,
            "bytes_received": self.bytes_received,
            "bytes_sent": self.bytes_sent,
            "batches_received": self.batches_received,
            "batches_sent": self.batches_sent,
            "num_kernels": self.num_kernels,
            "bytes_copied_hd": self.bytes_copied_hd,
            "bytes_copied_dh": self.bytes_copied_dh,
            "tuples_dropped_old": self.tuples_dropped_old,
            "avg_service_time_us": self.avg_service_time_us,
            "service_time_us": self.service_hist.summary_us(),
            "uptime_s": time.monotonic() - self.start_time,
        }

    def dump_to_file(self, log_dir: str = "log") -> str:
        """Write :meth:`as_dict` to ``<log_dir>/<pid>_<op>_<replica>.json``."""
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{os.getpid()}_{self.op_name}_{self.replica_id}.json")
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)
        return path


#: the one profiler session of the process: who (if anyone) holds it. Guarded
#: so a nested or concurrent ``xprof_trace`` fails with a clear message
#: instead of the profiler's own error surfacing out of user code.
_xprof_lock = threading.Lock()
_xprof_logdir = None
#: the thread that opened the process's first session with CUDA activity
#: (:func:`profiler_init`), None before it
_profiler_thread = None


def profiler_activities() -> list:
    """The ``torch.profiler`` activities a capture records: the CPU, and the
    card's kernels (CUPTI) when CUDA is present and the profiler supports
    them."""
    import torch
    from torch.profiler import ProfilerActivity, supported_activities
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and ProfilerActivity.CUDA in supported_activities():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def _quiet_card():
    """The card quiet for a profiler start or stop (F30): no other thread
    in a launching step (``runtime/graphs.py::LAUNCH_GATE``, held alone),
    no CUDA-graph capture (``CAPTURE_LOCK``: the synchronize must not
    happen inside one), and the card's queued work finished."""
    import torch
    from .runtime.graphs import CAPTURE_LOCK, LAUNCH_GATE
    with LAUNCH_GATE.exclusive(), CAPTURE_LOCK:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        yield


def _first_session(activities: list) -> None:
    """Open and close one short ``torch.profiler`` session with
    ``activities`` on this thread, around one small operation on the card."""
    import torch
    with torch.profiler.profile(activities=activities):
        torch.ones((1,), device="cuda").add_(1)
        torch.cuda.synchronize()


def _init_locked(activities: list) -> bool:
    """:func:`profiler_init` under ``_xprof_lock``; the session runs with
    the card quiet (:func:`_quiet_card`)."""
    global _profiler_thread
    from torch.profiler import ProfilerActivity
    if _profiler_thread is not None or ProfilerActivity.CUDA not in activities:
        return False
    with _quiet_card():
        _first_session(activities)
    _profiler_thread = threading.get_ident()
    return True


def profiler_init() -> bool:
    """Open the process's first ``torch.profiler`` session with CUDA
    activity on this thread, once: Kineto sets up its CUPTI client on the
    thread of the first session and refuses another thread (a first session
    opened elsewhere traces no CUDA kernel, or the process crashes later).
    Call it on the main thread before any capture runs on another thread
    (``Monitor.start`` does when profile-on-page is on). It does nothing
    without CUDA activity (:func:`profiler_activities`), after an earlier
    init, or off the main thread, where the first session is the fault
    itself: a later capture there is refused with the reason. Only this
    init counts: a session opened another way (a ``torch.profiler.profile``
    of the caller's own) does not lift the refusal. Returns whether it
    opened the session."""
    if threading.current_thread() is not threading.main_thread():
        return False
    with _xprof_lock:
        if _xprof_logdir is not None:
            return False
        return _init_locked(profiler_activities())


@contextlib.contextmanager
def xprof_trace(logdir: str):
    """``torch.profiler`` capture around a run, written as a Chrome trace
    (``<logdir>/trace.json``, loadable in Perfetto or ``chrome://tracing``)::

        with wt.xprof_trace("/tmp/trace"):
            graph.run()

    It records the CPU, and on the card every kernel of the process through
    CUPTI (whichever thread launched it). Pairs with the host-side flight
    recorder (``trace=``).

    One session at a time: the profiler is process-global, and a nested
    start raises an opaque error from deep inside it. This wrapper detects
    the active session first and raises a ``RuntimeError`` that names the
    holder and the fix. Starting and stopping wait for a quiet card
    (F30): ``runtime/graphs.py::LAUNCH_GATE`` held alone, so no chain step
    of another thread launches meanwhile, and ``CAPTURE_LOCK``, so neither
    interleaves with a CUDA-graph capture; the card is synchronized first.
    A loop of one's own that launches on the card from another thread
    during a capture holds ``LAUNCH_GATE.shared()`` around each step.

    The process's first session with CUDA activity must open on the main
    thread (:func:`profiler_init`): on the main thread this wrapper runs the
    init itself; on another thread, before any init, it raises a
    ``RuntimeError`` that names the cause and the fix."""
    global _xprof_logdir
    import torch
    with _xprof_lock:
        if _xprof_logdir is not None:
            raise RuntimeError(
                f"xprof_trace({logdir!r}): a profiler session is already "
                f"active, capturing to {_xprof_logdir!r} — torch.profiler "
                f"supports one trace per process; nest this region inside "
                f"the existing capture (one file is enough: the trace "
                f"carries every device event between start and stop) or "
                f"close it first")
        acts = profiler_activities()
        if _profiler_thread is None and torch.profiler.ProfilerActivity.CUDA in acts:
            th = threading.current_thread()
            if th is not threading.main_thread():
                raise RuntimeError(
                    f"xprof_trace({logdir!r}): this would be the process's first "
                    f"torch.profiler session with CUDA activity, on thread "
                    f"{th.name!r}: Kineto sets up its CUPTI client on the thread "
                    f"of the first session and refuses another thread (the "
                    f"session traces no CUDA kernel, or the process crashes "
                    f"later); call windflow_tpu_torch.stats.profiler_init() on "
                    f"the main thread first (Monitor.start() does when "
                    f"profile-on-page is on); a session opened another way, "
                    f"such as a torch.profiler.profile of your own, does not "
                    f"count")
            _init_locked(acts)
        prof = torch.profiler.profile(activities=acts)
        try:
            if torch.autograd._profiler_enabled():
                raise RuntimeError("the autograd profiler is already enabled")
            with _quiet_card():
                prof.start()
        except RuntimeError as e:
            # a session started outside this wrapper (a direct
            # torch.profiler.profile elsewhere in this process): same root
            # cause, same guidance, original error chained
            raise RuntimeError(
                f"xprof_trace({logdir!r}): torch.profiler start failed — "
                f"most likely another profiler session (a direct "
                f"torch.profiler.profile elsewhere in this process) is "
                f"already active; stop it before opening a new capture") from e
        _xprof_logdir = logdir
    try:
        os.makedirs(logdir, exist_ok=True)
        yield logdir
    finally:
        # stop BEFORE releasing the guard: clearing first would open a
        # window where a concurrent xprof_trace passes the guard and hits
        # the still-active profiler with its raw error
        try:
            with _quiet_card():
                prof.stop()
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        finally:
            with _xprof_lock:
                _xprof_logdir = None

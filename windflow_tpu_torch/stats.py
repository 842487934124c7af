"""Per-replica statistics — ``Stats_Record``.

Counterpart of ``windflow_tpu/stats.py`` (reference ``wf/stats_record.hpp:50-156``):
host-side counters of tuples, batches and bytes, the launches of the
operator's step with the host<->device bytes, and a log-bucket histogram of
the sampled service times (``CompiledChain`` times every
``SERVICE_SAMPLE_EVERY``-th push to completion). ``dump_to_file`` writes one
JSON file a replica, as the reference's ``dump_toFile`` does
(``wf/stats_record.hpp:109-155``); ``PipeGraph.dump_stats`` calls it.
"""

from __future__ import annotations

import bisect
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
    Counterpart of ``windflow_tpu/observability/metrics.py::LogHistogram``."""

    BOUNDS: List[float] = [_BASE_S * _GROWTH ** i for i in range(_N_BUCKETS)]

    def __init__(self):
        self.counts = [0] * (_N_BUCKETS + 1)      # +1 = overflow bucket
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        i = bisect.bisect_left(self.BOUNDS, s)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += s
            self.max = max(self.max, s)

    def _snap(self) -> tuple:
        with self._lock:
            return list(self.counts), self.count, self.sum, self.max

    @classmethod
    def _pct_value(cls, counts: List[int], count: int, mx: float, q: float) -> float:
        """The upper bound of the bucket holding the q-th sample (the observed
        max for the overflow bucket); 0 when empty."""
        if not count:
            return 0.0
        target = max(1, int(q / 100.0 * count + 0.5))
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                return mx if i >= _N_BUCKETS else min(cls.BOUNDS[i], mx)
        return mx

    def percentile(self, q: float) -> float:
        counts, count, _sum, mx = self._snap()
        return self._pct_value(counts, count, mx, q)

    def summary_us(self) -> Dict[str, float]:
        """p50/p95/p99, mean and max in microseconds, from one snapshot."""
        counts, count, total, mx = self._snap()
        pct = lambda q: self._pct_value(counts, count, mx, q)  # noqa: E731
        return {"p50": round(pct(50) * 1e6, 3), "p95": round(pct(95) * 1e6, 3),
                "p99": round(pct(99) * 1e6, 3),
                "mean": round((total / count if count else 0.0) * 1e6, 3),
                "max": round(mx * 1e6, 3) if count else 0.0, "samples": count}


class Stats_Record:
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

    def record_launch(self, service_time_s: Optional[float] = None, hd_bytes: int = 0,
                      dh_bytes: int = 0):
        """One step launch; ``service_time_s`` is a measured launch-to-
        completion sample (None on unsampled launches)."""
        self.num_kernels += 1
        self.bytes_copied_hd += int(hd_bytes)
        self.bytes_copied_dh += int(dh_bytes)
        if service_time_s is not None:
            self._service_time_sum += float(service_time_s)
            self._service_samples += 1
            self.service_hist.record(service_time_s)

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

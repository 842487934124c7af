"""Per-replica statistics — a minimal ``Stats_Record``.

Counterpart of ``windflow_tpu/stats.py`` (reference ``wf/stats_record.hpp:50-156``)
without its service-time histogram, which lives in the JAX package's
observability layer and is not ported in this slice: host-side counters of
tuples, batches and bytes, plus the launches of the operator's step.
"""

from __future__ import annotations

import time


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

    def record_input(self, n_tuples: int, n_bytes: int = 0):
        self.inputs_received += int(n_tuples)
        self.bytes_received += int(n_bytes)
        self.batches_received += 1

    def record_launch(self, hd_bytes: int = 0, dh_bytes: int = 0):
        self.num_kernels += 1
        self.bytes_copied_hd += int(hd_bytes)
        self.bytes_copied_dh += int(dh_bytes)

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
            "uptime_s": time.monotonic() - self.start_time,
        }

"""Multi-host helpers: not ported (ROADMAP Queue 1 item 14, the mesh half).

Counterpart of ``windflow_tpu/parallel/multihost.py``. Shard-local
supervision on one card runs without it: pass the slice a process
supervises as an explicit ``SupervisedPipeline(shard_range=(lo, hi))``.
"""

from __future__ import annotations


def process_shard_slice(num_shards: int):
    """This process's ``[lo, hi)`` slice of ``num_shards`` shards: refused by
    name, as the port runs no multi-process mesh yet."""
    raise NotImplementedError(
        "multihost.process_shard_slice is not ported yet (ROADMAP Queue 1 item 14): "
        "pass shard_range=(lo, hi) to SupervisedPipeline explicitly")


__all__ = ["process_shard_slice"]

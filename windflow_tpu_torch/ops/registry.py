"""The port's kernel registry: one entry per hand-written kernel family.

Counterpart of ``windflow_tpu/ops/registry.py``, reduced to what the port
needs now: each family's CUDA source, the TPU kernel it replaces, and an
integer launch counter that the kernel's wrapper bumps exactly where it
launches the kernel (and nowhere else), so a run can show that its main path
went through the kernel. A CUDA-graph replay calls no wrapper: the launches
a capture counted are taken back and added once per replay
(:func:`add_launches`, ``runtime/graphs.py``). The JAX registry's impl selection (``WF_KERNEL_IMPL``,
tuning-cache winners) is not ported: a CUDA tensor always goes to the kernel.

The counts are safe under threads: every update takes one lock, and a
capture collects only the launches its own thread makes while it captures
(:func:`collect`), so another stage thread's launches during a capture are
neither put into the graph's per-replay counts nor taken off the totals.

An entry whose ``replaces`` is None is a helper kernel that replaces no TPU
kernel (``segment_fold_float``: the fixed-order float fold; ``cold_probe``:
the tiered state's cold-tier read through mapped host memory, where the JAX
package calls back into Python; ``cold_fetch``: the interval join's archive
tier read, the multimap counterpart). It is counted the same way;
:func:`tpu_kernels` leaves it out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, Optional


@dataclasses.dataclass
class Kernel:
    name: str          # family name (the JAX registry's kernel name)
    source: str        # CUDA source, relative to the repository root
    replaces: Optional[str]  # the Pallas function it replaces (file:line of
    #                          its def); None for a helper
    launches: int = 0


KERNELS = {
    k.name: k for k in (
        Kernel("histogram", "windflow_tpu_torch/ops/csrc/histogram.cu",
               "windflow_tpu/ops/histogram.py:195"),
        Kernel("lookup", "windflow_tpu_torch/ops/csrc/lookup.cu",
               "windflow_tpu/ops/lookup.py:113"),
        Kernel("segment_fold", "windflow_tpu_torch/ops/csrc/segment.cu",
               "windflow_tpu/ops/segment.py:90"),
        Kernel("ordering_merge", "windflow_tpu_torch/ops/csrc/bitonic.cu",
               "windflow_tpu/ops/bitonic.py:131"),
        Kernel("join_probe", "windflow_tpu_torch/ops/csrc/join_probe.cu",
               "windflow_tpu/ops/lookup.py:209"),
        Kernel("masked_window_reduce", "windflow_tpu_torch/ops/csrc/masked_sum.cu",
               "windflow_tpu/ops/pallas_kernels.py:57"),
        Kernel("segment_fold_float", "windflow_tpu_torch/ops/csrc/segment.cu", None),
        Kernel("cold_probe", "windflow_tpu_torch/ops/csrc/cold_probe.cu", None),
        Kernel("cold_fetch", "windflow_tpu_torch/ops/csrc/cold_probe.cu", None),
    )
}


def tpu_kernels() -> dict:
    """The entries that replace a TPU kernel (helpers left out)."""
    return {n: k for n, k in KERNELS.items() if k.replaces is not None}


_lock = threading.Lock()
_local = threading.local()      # .collector: the capture's counts, or None


def count_launch(name: str) -> None:
    add_launches({name: 1})


def add_launches(counts: dict) -> None:
    """Add ``{name: n}`` to the counts: the launches of one CUDA-graph replay,
    recorded at capture (a replay calls no wrapper). Inside :func:`collect`
    on this thread they go to the collector instead."""
    sink = getattr(_local, "collector", None)
    if sink is not None:
        for name, n in counts.items():
            sink[name] = sink.get(name, 0) + n
        return
    with _lock:
        for name, n in counts.items():
            KERNELS[name].launches += n


@contextlib.contextmanager
def collect() -> Iterator[Dict[str, int]]:
    """The launches this thread makes inside the block, as ``{name: n}``,
    kept out of the global counts (a capture's launches run at each replay,
    not now). Other threads count as usual meanwhile."""
    prev = getattr(_local, "collector", None)
    _local.collector = counts = {}
    try:
        yield counts
    finally:
        _local.collector = prev


def reset_launches() -> None:
    with _lock:
        for k in KERNELS.values():
            k.launches = 0


def launch_counts() -> dict:
    with _lock:
        return {name: k.launches for name, k in KERNELS.items()}

"""The port's kernel registry: one entry per hand-written kernel family.

Counterpart of ``windflow_tpu/ops/registry.py``, reduced to what the port
needs now: each family's CUDA source, the TPU kernel it replaces, and an
integer launch counter that the kernel's wrapper bumps exactly where it
launches the kernel (and nowhere else), so a run can show that its main path
went through the kernel. The JAX registry's impl selection (``WF_KERNEL_IMPL``,
tuning-cache winners) is not ported: a CUDA tensor always goes to the kernel.

An entry whose ``replaces`` is None is a helper kernel that replaces no TPU
kernel (``segment_fold_float``: the fixed-order float fold). It is counted
the same way; :func:`tpu_kernels` leaves it out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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
        Kernel("segment_fold_float", "windflow_tpu_torch/ops/csrc/segment.cu", None),
    )
}


def tpu_kernels() -> dict:
    """The entries that replace a TPU kernel (helpers left out)."""
    return {n: k for n, k in KERNELS.items() if k.replaces is not None}


def count_launch(name: str) -> None:
    KERNELS[name].launches += 1


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}

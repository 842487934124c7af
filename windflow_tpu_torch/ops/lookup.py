"""Table lookups: ``table[idx]`` for the campaign join and per-key table reads.

Counterpart of ``windflow_tpu/ops/lookup.py::table_lookup``. On the TPU a gather
is serial, so the JAX package picks a one-hot formulation by table size: a
select-reduce for small tables and a factored one-hot matmul (the Pallas
kernel ``_pallas_factored_lookup``) for 128 < K <= 65536. Both give
``table[idx]`` with 0 for an index outside ``[0, K)``; on a CUDA tensor that
function is the hand-written gather ``csrc/lookup.cu`` (kernel K2), on a CPU
tensor the plain version beside it.

Routing follows the JAX package's rule for a concrete table (the port runs
eagerly, so every table is concrete):

- K <= 2048: select or factored branch — both ``table[idx]``, 0 out of range;
- 2048 < K <= 65536: factored branch when the table is f32-exact (floats all
  finite, ints of <= 16 bits, or int values below 2^24 in magnitude — read
  from the table, one device sync), else the ``take`` branch;
- K > 65536: the ``take`` branch.

The ``take`` branch was never a kernel: it keeps ``jnp.take``'s semantics in
plain PyTorch (a negative index wraps once; out of range gives the dtype's
fill: NaN, the signed minimum, the unsigned maximum, or True).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda
from .registry import count_launch

#: C signature of the kernel's entry point (pointers and the stream as void*)
_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

#: tables up to this size take the JAX select or factored branch whatever
#: their values
SELECT_MAX_ROWS_2D = 2048
#: the factored path handles tables up to this many rows
FACTORED_MAX_ROWS = 1 << 16


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with the JAX package's out-of-range semantics for the
    table's size. ``table``: 1-D ``[K]``; ``idx``: i32 ``[C]``."""
    if table.ndim != 1:
        raise NotImplementedError(
            "table_lookup: only 1-D tables are ported so far (2-D state "
            "tables come with the per-key window paths, ROADMAP Queue 1 item 9)")
    K = table.shape[0]
    if K <= SELECT_MAX_ROWS_2D or (K <= FACTORED_MAX_ROWS and _factored_ok(table)):
        return gather_or_zero(table, idx)
    return take(table, idx)


def _factored_ok(table: torch.Tensor) -> bool:
    """The JAX package's exactness test for the factored path (lookup.py:72-84)."""
    if table.dtype.is_floating_point:
        return bool(torch.isfinite(table).all())
    if table.is_complex():
        return False
    if table.dtype == torch.bool or torch.iinfo(table.dtype).bits <= 16:
        return True
    return bool(table.abs().max() < (1 << 24))


def gather_or_zero(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, 0 where ``idx`` is outside ``[0, K)``: K2 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if table.device.type == "cuda":
        return lookup_cuda(table, idx)
    if table.device.type == "cpu":
        return lookup_plain(table, idx)
    raise ValueError(f"table_lookup: unsupported device {table.device}")


def lookup_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    if table.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=table.dtype, device=table.device)
    ok = (idx >= 0) & (idx < table.shape[0])
    g = table.index_select(0, torch.where(ok, idx, 0).long())
    return torch.where(ok, g, torch.zeros((), dtype=table.dtype, device=table.device))


def lookup_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K2 on ``table``'s card. Raises on anything the kernel does not take."""
    K = table.shape[0]
    if idx.ndim != 1 or idx.dtype != torch.int32 or idx.device != table.device \
            or not idx.is_contiguous():
        raise ValueError(f"lookup_cuda: idx must be a contiguous int32 [C] tensor "
                         f"on {table.device}, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    if not table.is_contiguous() or table.element_size() not in (1, 2, 4, 8) \
            or K >= 2 ** 31 or table.is_complex():
        raise ValueError(f"lookup_cuda: table must be a contiguous 1-D tensor of "
                         f"1/2/4/8-byte real elements, got {table.dtype} [{K}]")
    n = idx.shape[0]
    out = torch.empty((n,), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    fn = cuda.function("lookup", "wf_table_lookup", _ARGTYPES)
    count_launch("lookup")
    cuda.check(fn(cuda.ptr(table), cuda.ptr(idx), cuda.ptr(out), n, K,
                  table.element_size(), cuda.stream_ptr(table.device)),
               "lookup_cuda")
    return out


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` in plain PyTorch (the JAX package's
    ``take`` branch, never a kernel there either)."""
    K = table.shape[0]
    j = torch.where(idx < 0, idx + K, idx)
    ok = (j >= 0) & (j < K)
    g = table.index_select(0, torch.where(ok, j, 0).long())
    dt = table.dtype
    if dt == torch.bool:
        fill = True
    elif dt.is_floating_point or dt.is_complex:
        fill = float("nan")
    elif torch.iinfo(dt).min < 0:
        fill = torch.iinfo(dt).min
    else:
        fill = torch.iinfo(dt).max
    return torch.where(ok, g, torch.full((), fill, dtype=dt, device=table.device))

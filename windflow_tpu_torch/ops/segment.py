"""Segmented (per-key) reductions over micro-batches.

Counterpart of the part of ``windflow_tpu/ops/segment.py`` this slice runs:
:func:`segment_fold` (the masked 1-D segment sum behind Win_SeqFFAT's additive
lifts) and the default-combine branch of :func:`segment_reduce`.

:func:`segment_fold` on integer values of at most 4 bytes is the hand-written
CUDA kernel ``csrc/segment.cu`` (kernel K3) on a CUDA tensor and the plain
PyTorch version beside it on a CPU tensor. Both sum in wrapping int32
arithmetic, so they equal XLA's integer ``segment_sum`` bit for bit, overflow
included, and a narrower input dtype is cast back at the end. The JAX kernel
served S <= 4096 only (``FOLD_MAX_SEGMENTS``, XLA above); the port's serves
any S, since the result is the same.

Float values are not a kernel's job (the JAX package leaves them to XLA's
``segment_sum``): here they go through ``index_add_`` in plain PyTorch. On
the card ``index_add_`` uses float atomics, which sum in no fixed order, so a
float fold may differ from run to run in the last bits.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable

import torch

from . import cuda
from ..batch import tree_map
from .registry import count_launch

#: C signature of the kernel's entry point (pointers and the stream as void*)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

#: integer dtypes K3 takes, with the code its C entry point expects
_FOLD_DTYPES = {torch.int32: 0, torch.int16: 1, torch.int8: 2, torch.uint8: 3}


def segment_fold(values: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Masked 1-D segment sum ``out[s] = sum(values[i] : seg[i]==s, valid[i])``.
    Invalid lanes contribute 0; segment ids outside ``[0, S)`` are dropped.
    Returns ``[S]`` in ``values``' dtype."""
    S = int(num_segments)
    if values.dtype in _FOLD_DTYPES:
        if values.device.type == "cuda":
            return segment_fold_cuda(values, seg, valid, S)
        if values.device.type == "cpu":
            return segment_fold_plain(values, seg, valid, S)
        raise ValueError(f"segment_fold: unsupported device {values.device}")
    return _index_add_fold(values, seg, valid, S)


def segment_fold_plain(values, seg, valid, S: int) -> torch.Tensor:
    """Plain PyTorch version of K3: an exact int64 sum, wrapped to int32."""
    ok = valid & (seg >= 0) & (seg < S)
    acc = torch.zeros(S + 1, dtype=torch.int64, device=values.device)
    acc.index_add_(0, torch.where(ok, seg, S).long(),
                   torch.where(ok, values.to(torch.int64), 0))
    wrapped = torch.remainder(acc[:S] + 2 ** 31, 2 ** 32) - 2 ** 31
    return wrapped.to(torch.int32).to(values.dtype)


def segment_fold_cuda(values, seg, valid, S: int) -> torch.Tensor:
    """Launch K3 on ``values``' card. Raises on anything the kernel does not take."""
    n = values.shape[0]
    dev = values.device
    for name, t, ok_dtype in (("values", values, values.dtype in _FOLD_DTYPES),
                              ("seg", seg, seg.dtype == torch.int32),
                              ("valid", valid, valid.dtype == torch.bool)):
        if t.device != dev or not ok_dtype or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(
                f"segment_fold_cuda: {name} must be a contiguous [{n}] tensor "
                f"on {dev} (values int32/int16/int8/uint8, seg int32, valid "
                f"bool), got {t.dtype} {tuple(t.shape)} on {t.device}")
    if S < 0 or S >= 2 ** 31:
        raise ValueError(f"segment_fold_cuda: bad segment count {S}")
    out = torch.zeros((S,), dtype=torch.int32, device=dev)
    if n == 0 or S == 0:
        return out.to(values.dtype)
    fn = cuda.function("segment", "wf_segment_fold", _ARGTYPES)
    count_launch("segment_fold")
    cuda.check(fn(cuda.ptr(values), _FOLD_DTYPES[values.dtype], cuda.ptr(seg),
                  cuda.ptr(valid), cuda.ptr(out), n, S, cuda.stream_ptr(dev)),
               "segment_fold_cuda")
    return out if values.dtype == torch.int32 else out.to(values.dtype)


def _index_add_fold(values, seg, valid, S: int) -> torch.Tensor:
    """Segment sum outside K3's domain (floats, int64, trailing dims): plain
    ``index_add_`` into a spill row that collects dropped lanes."""
    ok = valid & (seg >= 0) & (seg < S)
    m = ok.reshape(ok.shape + (1,) * (values.ndim - 1))
    out = torch.zeros((S + 1,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, torch.where(ok, seg, S).long(),
                   torch.where(m, values, torch.zeros((), dtype=values.dtype,
                                                      device=values.device)))
    return out[:S]


def segment_reduce(values: Any, keys: torch.Tensor, valid: torch.Tensor,
                   num_keys: int, combine: Callable = None, identity=0) -> Any:
    """Per-key reduction of a batch: a pytree of ``[num_keys, ...]`` tensors.
    Only the default combine (addition) is ported in this slice."""
    if combine is not None:
        raise NotImplementedError(
            "segment_reduce: only the default additive combine is ported so far; "
            "max/min and general associative combines come with the windowed-"
            "operator matrix (ROADMAP Queue 1 item 9)")

    def red(v):
        if v.ndim == 1:
            return segment_fold(v, keys, valid, num_keys)
        return _index_add_fold(v, keys, valid, num_keys)
    return tree_map(red, values)

"""Segmented (per-key) reductions over micro-batches.

Counterpart of the part of ``windflow_tpu/ops/segment.py`` the port runs:
:func:`segment_fold` (the masked 1-D segment sum behind Win_SeqFFAT's additive
lifts), the default-combine branch of :func:`segment_reduce`, and
:func:`segment_rank` (Distinct's first-occurrence test).

:func:`segment_fold` on integer values of at most 4 bytes is the hand-written
CUDA kernel ``csrc/segment.cu`` (kernel K3) on a CUDA tensor and the plain
PyTorch version beside it on a CPU tensor. Both sum in wrapping int32
arithmetic, so they equal XLA's integer ``segment_sum`` bit for bit, overflow
included, and a narrower input dtype is cast back at the end. The JAX kernel
served S <= 4096 only (``FOLD_MAX_SEGMENTS``, XLA above); the port's serves
any S, since the result is the same.

Float values are not a TPU kernel's job (the JAX package leaves them to
XLA's ``segment_sum``, which sums each segment from +0.0 in stream order). On
a CPU tensor ``index_add_`` gives those bits. On the card ``index_add_``
would use float atomics, which sum in no fixed order, so a CUDA float fold
goes through a small helper instead (``csrc/segment.cu``,
``wf_segment_fold_ordered``, registry name ``segment_fold_float``): a stable
sort of the lanes by segment, then one thread per segment summing its run in
stream order. Its bits equal the CPU's on every run.
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

#: C signature of the ordered float fold (pointers and the stream as void*)
_ORDERED_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

#: float dtypes the ordered fold takes, with the code its C entry point expects
_ORDERED_DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
                   torch.bfloat16: 3}


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
    ``index_add_`` into a spill row that collects dropped lanes; on a CUDA
    float tensor, the ordered fold (fixed bits, equal to the CPU's)."""
    if values.device.type == "cuda" and values.dtype.is_floating_point:
        return segment_fold_float_cuda(values, seg, valid, S)
    ok = valid & (seg >= 0) & (seg < S)
    m = ok.reshape(ok.shape + (1,) * (values.ndim - 1))
    out = torch.zeros((S + 1,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, torch.where(ok, seg, S).long(),
                   torch.where(m, values, torch.zeros((), dtype=values.dtype,
                                                      device=values.device)))
    return out[:S]


def segment_fold_float_cuda(values, seg, valid, S: int) -> torch.Tensor:
    """Float segment sum on the card in stream order per segment: a stable
    sort of the lanes by segment, each segment's run found by
    ``searchsorted``, then ``wf_segment_fold_ordered`` sums every run in
    order. Raises on anything the helper does not take."""
    dev = values.device
    C = values.shape[0]
    if values.dtype not in _ORDERED_DTYPES or seg.shape != (C,) or valid.shape != (C,) \
            or seg.device != dev or valid.device != dev:
        raise ValueError(f"segment_fold_float_cuda: float32/64/16/bf16 values "
                         f"[{C}, ...] with seg and valid [{C}] on {dev}, got "
                         f"{values.dtype} {tuple(values.shape)}, {tuple(seg.shape)} "
                         f"on {seg.device}")
    if S < 0 or S >= 2 ** 31:
        raise ValueError(f"segment_fold_float_cuda: bad segment count {S}")
    D = 1
    for n in values.shape[1:]:
        D *= int(n)
    out = torch.empty((S,) + tuple(values.shape[1:]), dtype=values.dtype, device=dev)
    if S == 0 or D == 0:
        return out.zero_()
    ok = valid & (seg >= 0) & (seg < S)
    sorted_seg, perm = torch.sort(torch.where(ok, seg.to(torch.int32), S), stable=True)
    rows = values.reshape(C, D).index_select(0, perm).contiguous()
    starts = torch.searchsorted(sorted_seg, torch.arange(S + 1, dtype=torch.int32,
                                                         device=dev))
    fn = cuda.function("segment", "wf_segment_fold_ordered", _ORDERED_ARGTYPES)
    count_launch("segment_fold_float")
    cuda.check(fn(cuda.ptr(rows), cuda.ptr(starts), cuda.ptr(out), S, D,
                  _ORDERED_DTYPES[values.dtype], cuda.stream_ptr(dev)),
               "segment_fold_float_cuda")
    return out


def _sort_by_key(keys: torch.Tensor, valid: torch.Tensor):
    """Stable sort of the lanes by ``(invalid, key)``: returns the sorted key
    (the dtype's maximum for invalid lanes) and each sorted lane's original
    index. Counterpart of the JAX package's ``_sort_by_key`` without
    companion arrays."""
    big = torch.iinfo(keys.dtype).max
    sorted_keys, orig = torch.sort(torch.where(valid, keys, big), stable=True)
    return sorted_keys, orig


def segment_rank(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rank of each live lane among the live lanes with the same key
    (0-based, in stream order): int32 ``[C]``. One stable sort, segment
    starts from the sorted boundaries, their index carried forward by
    ``cummax``, and one scatter back to stream order."""
    c = keys.shape[0]
    dev = keys.device
    if c == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    sorted_keys, orig = _sort_by_key(keys, valid)
    iota = torch.arange(c, dtype=torch.int32, device=dev)
    starts = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                        sorted_keys[1:] != sorted_keys[:-1]])
    seg_start = torch.cummax(torch.where(starts, iota, 0), dim=0).values
    out = torch.zeros((c,), dtype=torch.int32, device=dev)
    out[orig] = iota - seg_start
    return out


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

"""Per-window masked sums — the aggregation of Win_Seq's sum windows.

Counterpart of ``windflow_tpu/ops/pallas_kernels.py``: given fired-window
contents ``vals [W, L]`` and their occupancy ``mask [W, L]``,
:func:`masked_window_reduce` returns ``out[w] = sum_l where(mask, vals, 0)``.
The JAX package wrote it as the Pallas kernel ``_pallas_masked_sum`` and kept
XLA's form on its data path after an A/B on a TPU. In the port it is on the
data path: :class:`~windflow_tpu_torch.operators.window.Iterable`'s ``sum``
and ``mean`` call it for every 1-D payload leaf, so a window function vmapped
over the fired windows reaches it once per leaf per apply, with all windows
as the rows of one call.

On a CUDA tensor it is the hand-written kernel ``csrc/masked_sum.cu`` (K6),
one launch a call, on a CPU tensor the plain version beside it. Both give
``jnp.sum``'s dtype (:func:`sum_dtype`): bool, int8 and int16 widen to int32
(on the card in registers, read as stored); uint8 and uint16 sum into
uint32; float16 and bfloat16 accumulate in float32 and round once to their
own dtype; float32, float64, int32 and uint32 keep theirs. Integer sums
wrap, as XLA's do. Float sums are taken in the kernel's own fixed order,
which depends on the row length and the dtype alone (not on W), so they
equal the plain version exactly where every partial sum is exact, and within
rounding elsewhere. Any other dtype raises on the card.

:func:`reduce_plan` picks the kernel's regime and geometry for a call (narrow
rows a thread each, long rows a warp each, or few long rows split over
several warps of a block) and is what the wrapper passes to the C entry.

It is a ``torch.library`` custom op with fake (meta) and vmap rules. The vmap
rule folds every leading batch dimension into rows and expands an unbatched
mask, so a one-row call ``masked_window_reduce(x[None], mask[None])[0]``,
vmapped over windows (and again over Win_MapReduce's partitions inside each
window), arrives here as one ``[outer * inner, L]`` call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import cuda
from .registry import count_launch, on_card

#: C signature of K6's entry point (pointers and the stream as void*):
#: vals, dtype code, mask, out, W, L, regime, threads, C, blocks, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p]

#: dtypes K6 takes, with the code its C entry point expects
_DTYPES = {torch.float32: 0, torch.int32: 1, torch.uint8: 2, torch.uint16: 3,
           torch.float16: 4, torch.bfloat16: 5, torch.float64: 6, torch.uint32: 7,
           torch.bool: 8, torch.int8: 9, torch.int16: 10}

#: the kernel's constants (``csrc/masked_sum.cu``, mirrored): rows of up to
#: NARROW_LEN values and NARROW_BYTES value bytes are summed a thread each;
#: longer rows are cut into chunks of CHUNK elements (a warp's step) from
#: the flat index at or below the row's start that is a multiple of LINE;
#: both bases are ALIGN-byte aligned
NARROW_BYTES = 256
NARROW_LEN = 64
CHUNK = 512
LINE = 16
ALIGN = 16

#: geometry, from the measured split (``chip_smoke.py::k6_split``): threads
#: a block of the narrow regime (a row each); warps a block of the warp
#: regime, and at least that many of the split regime; the warps at which a
#: call fills the card: while W * C is below it and every row has chunks for
#: 2C warps, C doubles (up to 16)
NARROW_THREADS = 128
WARP_BLOCK_WARPS = 4
SPLIT_BLOCK_WARPS = 8
FILL_WARPS = 132 * 16
MAX_SPLIT = 16

_REGIMES = {"narrow": 0, "warp": 1, "split": 2}


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """K6's launch for ``[W, L]`` rows of ``itemsize``-byte values: the
    regime, the threads of a block, ``C`` warps a row (split; 1 otherwise),
    the rows a block and the blocks."""
    regime: str
    threads: int
    C: int
    rows_per_block: int
    blocks: int

    def rows(self, W: int) -> np.ndarray:
        """The row each thread (narrow) or warp (warp, split) of the grid
        sums, ``-1`` where it has none, as ``[blocks, slots]``: the kernel's
        own mapping. A split row appears C times, once a warp of it."""
        b = np.arange(self.blocks, dtype=np.int64)[:, None]
        slots = self.threads if self.regime == "narrow" else self.threads // 32
        s = np.arange(slots, dtype=np.int64)[None, :]
        row = b * self.rows_per_block + s // self.C
        return np.where(row < W, row, -1)

    def chunks(self, L: int, q: int = 0, row: int = 0) -> list:
        """The ``(start, end)`` element ranges, relative to the row, that warp
        ``q`` of row ``row`` sums, in its order (chunks q, q + C, ...); the
        narrow regime sums the whole row. Chunk k of row [s, s + L) is the
        part of [c0 + CHUNK k, c0 + CHUNK (k + 1)) inside it, c0 the
        multiple of LINE at or below s."""
        if self.regime == "narrow":
            return [(0, L)] if q == 0 else []
        s = row * L
        c0 = s - s % LINE
        out = []
        for k in range(q, -(-(s + L - c0) // CHUNK), self.C):
            lo = c0 + CHUNK * k
            out.append((max(lo, s) - s, min(lo + CHUNK, s + L) - s))
        return out


@functools.lru_cache(maxsize=256)
def reduce_plan(W: int, L: int, itemsize: int) -> ReducePlan:
    """K6's regime and geometry for ``[W, L]`` rows of ``itemsize`` bytes
    (W, L >= 1): narrow rows (``L <= NARROW_LEN`` and ``L * itemsize <=
    NARROW_BYTES``) a thread each; otherwise a warp a row, or, while the
    rows are too few to fill the card (``W * C < FILL_WARPS``) and every
    row holds chunks for 2C warps, C warps a row (split). The summation
    order does not depend on the plan."""
    if W < 1 or L < 1:
        raise ValueError(f"reduce_plan: W and L must be >= 1, got {W}, {L}")
    if L <= NARROW_LEN and L * itemsize <= NARROW_BYTES:
        return ReducePlan("narrow", NARROW_THREADS, 1, NARROW_THREADS, -(-W // NARROW_THREADS))
    nch = -(-L // CHUNK)                     # the fewest chunks a row of L has
    C = 1
    while 2 * C <= min(MAX_SPLIT, nch) and W * C < FILL_WARPS:
        C *= 2
    warps = WARP_BLOCK_WARPS if C == 1 else max(C, SPLIT_BLOCK_WARPS)
    rpb = warps // C
    return ReducePlan("warp" if C == 1 else "split", 32 * warps, C, rpb, -(-W // rpb))


#: dtypes whose sum widens to int32 (``jnp.sum`` with 32-bit defaults)
_WIDEN = (torch.bool, torch.int8, torch.int16)

#: dtypes whose sum is uint32 (``jnp.sum`` with 32-bit defaults)
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)

#: a dtype of the same width with full operator support, for uint32
_SAME_WIDTH = {torch.uint32: torch.int32}

#: half types: ``jnp.sum`` accumulates them in float32 and rounds once
_HALF = (torch.float16, torch.bfloat16)


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of ``jnp.sum`` over ``dtype`` (32-bit defaults): bool, int8
    and int16 widen to int32, uint8 and uint16 to uint32; every other dtype
    is kept."""
    if dtype in _WIDEN:
        return torch.int32
    if dtype in _UNSIGNED:
        return torch.uint32
    return dtype


def masked_sum(x: torch.Tensor, keep: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.sum(jnp.where(keep, x, 0), axis=dim)`` in torch: :func:`sum_dtype`'s
    dtype; unsigned sums wrap modulo 2^32 (taken in int64, whose low 32 bits
    they are: torch has no uint32 ``sum`` on the CPU and no uint16 ``where``
    on the card, so they widen before the mask); half types accumulate in
    float32."""
    if x.dtype in _UNSIGNED:
        s = torch.where(keep, x.to(torch.int64), 0).sum(dim=dim)
        return (s & 0xFFFFFFFF).to(torch.uint32)
    x = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    if x.dtype in _HALF:
        return x.sum(dim=dim, dtype=torch.float32).to(x.dtype)
    return x.sum(dim=dim, dtype=sum_dtype(x.dtype))


def masked_window_reduce_plain(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6 (the JAX package's ``_xla_masked_sum``)."""
    return masked_sum(vals, mask, 1)


def masked_window_reduce_cuda(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch K6 on ``vals``' card, one launch (no fill: the kernel writes
    every row). A view whose base is off ``ALIGN`` bytes is cloned first
    (the kernel reads whole aligned lines; no path sends one). Raises on
    anything the kernel does not take."""
    if vals.dtype not in _DTYPES:
        raise NotImplementedError(
            f"masked_window_reduce_cuda: K6 sums {sorted(map(str, _DTYPES))} "
            f"(bool, int8 and int16 into int32); {vals.dtype} is not a dtype "
            f"the JAX package sums with 32-bit defaults")
    if vals.ndim != 2 or mask.shape != vals.shape or mask.dtype != torch.bool \
            or mask.device != vals.device:
        raise ValueError(
            f"masked_window_reduce_cuda: vals [W, L] and a bool mask of the same "
            f"shape on {vals.device}, got {tuple(vals.shape)} and {mask.dtype} "
            f"{tuple(mask.shape)} on {mask.device}")
    W, L = vals.shape
    if L >= 2 ** 31:
        raise ValueError(f"masked_window_reduce_cuda: row length {L} too large")
    odt = sum_dtype(vals.dtype)
    # the output's width, viewed as its dtype (uint32 has few ops)
    wide = _SAME_WIDTH.get(odt, odt)
    if W == 0 or L == 0:
        return torch.zeros((W,), dtype=wide, device=vals.device).view(odt)
    out = torch.empty((W,), dtype=wide, device=vals.device).view(odt)
    vals, mask = (t if t.is_contiguous() and t.data_ptr() % ALIGN == 0
                  else t.clone(memory_format=torch.contiguous_format) for t in (vals, mask))
    plan = reduce_plan(W, L, vals.element_size())
    fn = cuda.function("masked_sum", "wf_masked_window_reduce", _ARGTYPES)
    count_launch("masked_window_reduce")
    cuda.check(fn(cuda.ptr(vals), _DTYPES[vals.dtype], cuda.ptr(mask), cuda.ptr(out), W, L,
                  _REGIMES[plan.regime], plan.threads, plan.C, plan.blocks,
                  cuda.stream_ptr(vals.device)), "masked_window_reduce_cuda")
    return out


@torch.library.custom_op("windflow_tpu_torch::masked_window_reduce", mutates_args=())
def masked_window_reduce(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-window masked sum of ``vals [W, L]`` under ``mask [W, L]`` ->
    ``[W]`` (of :func:`sum_dtype`): K6 on a CUDA tensor, the plain version
    on a CPU tensor."""
    if on_card("masked_window_reduce", vals):
        return masked_window_reduce_cuda(vals, mask)
    if vals.device.type in ("cpu", "cuda"):
        return masked_window_reduce_plain(vals, mask)
    raise ValueError(f"masked_window_reduce: unsupported device {vals.device}")


@masked_window_reduce.register_fake
def _(vals, mask):
    return vals.new_empty((vals.shape[0],), dtype=sum_dtype(vals.dtype))


def _batch_first(info, in_dims, *ts):
    """Each tensor with its vmap dimension moved to the front; an unbatched
    one expanded to the batch size."""
    return [t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape)
            for t, d in zip(ts, in_dims)]


def _vmap_rows(info, in_dims, vals, mask):
    vals, mask = _batch_first(info, in_dims, vals, mask)
    B, W, L = vals.shape
    out = masked_window_reduce(vals.reshape(B * W, L), mask.reshape(B * W, L))
    return out.reshape(B, W), 0


masked_window_reduce.register_vmap(_vmap_rows)


"""Keyed-pane histograms — the Key_FFAT insert hot path.

Counterpart of ``windflow_tpu/ops/histogram.py``. The JAX package computes the
``[K, P]`` count as one-hot matmuls (XLA einsum or the Pallas kernel
``_pallas_fast``) under a chunk-locality precondition, with a ``lax.cond``
falling back to an exact scatter-add. All of its branches give the same
counts, so the port has one function: a CUDA tensor goes to the hand-written
histogram (``csrc/histogram.cu``, kernel K1: a shared-memory window of
``[K, Lw]`` counts per tile of the stream, or one global atomic a lane where
a tile spans more panes than the window holds), a CPU tensor to the plain
PyTorch version beside it. ``chunk=`` and ``locality=`` stay in the signature for parity;
the result does not depend on them. :func:`histogram_plan` reports the
launch K1 makes.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda
from .registry import count_launch

#: C signature of the kernel's entry point (pointers and the stream as void*)
_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
#: C signature of the plan query (n, K, P and four int out-pointers)
_PLAN_ARGTYPES = ([ctypes.c_longlong] + [ctypes.c_int] * 2
                  + [ctypes.POINTER(ctypes.c_int)] * 4)
#: the counters a launch adds to ``stats=`` (``partials.cuh``'s WF_ST_*)
STATS = ("direct_or_window_tiles", "global_tiles", "empty_tiles")

#: default lanes per chunk-local histogram row (JAX parity; unused here)
DEFAULT_CHUNK = 1024
#: default pane-locality bound per chunk (JAX parity; unused here)
DEFAULT_L = 8


def keyed_pane_histogram(key: torch.Tensor, pane: torch.Tensor,
                         valid: torch.Tensor, num_keys: int, ring: int, *,
                         chunk: int = DEFAULT_CHUNK,
                         locality: int = DEFAULT_L) -> torch.Tensor:
    """Count histogram ``out[k, pane mod ring] = #{valid lanes: key==k, pane}``.

    ``key``/``pane``: i32[C]; ``valid``: bool[C]. Keys outside
    ``[0, num_keys)`` and invalid lanes are dropped; the slot is the floored
    ``pane mod ring``, so negative panes land where the JAX package puts
    them. Returns i32[num_keys, ring]."""
    del chunk, locality
    K, P = int(num_keys), int(ring)
    if key.device.type == "cuda":
        return histogram_cuda(key, pane, valid, K, P)
    if key.device.type == "cpu":
        return histogram_plain(key, pane, valid, K, P)
    raise ValueError(f"keyed_pane_histogram: unsupported device {key.device}")


def histogram_plain(key, pane, valid, K: int, P: int) -> torch.Tensor:
    """Plain PyTorch version of K1 (the JAX package's ``_scatter_hist``)."""
    ok = valid & (key >= 0) & (key < K)
    seg = torch.where(ok, key.long() * P + torch.remainder(pane, P).long(), K * P)
    out = torch.zeros(K * P + 1, dtype=torch.int32, device=key.device)
    out.index_add_(0, seg, ok.to(torch.int32))
    return out[:K * P].view(K, P)


def histogram_plan(n: int, K: int, P: int) -> dict:
    """K1's launch for ``n`` lanes, ``K`` keys and a ring of ``P`` panes on
    the current card: ``{"grid": CTAs, "smem": dynamic shared bytes a CTA,
    "tile": lanes a tile, "lw_max": the window's most columns, "path":
    "window" (each tile takes the window when its panes fit, else goes
    global) or "global" (every tile: K is too large for a window),
    "zero": "memset", "flush": "atomic"}``."""
    out = [ctypes.c_int(0) for _ in range(4)]
    fn = cuda.function("histogram", "wf_histogram_plan", _PLAN_ARGTYPES)
    cuda.check(fn(n, K, P, *(ctypes.byref(o) for o in out)), "histogram_plan")
    grid, smem, lw_max, tile = (o.value for o in out)
    return {"grid": grid, "smem": smem, "tile": tile, "lw_max": lw_max,
            "path": "window" if lw_max else "global",
            "zero": "memset", "flush": "atomic"}


def histogram_cuda(key, pane, valid, K: int, P: int, *, stats=None) -> torch.Tensor:
    """Launch K1 on ``key``'s card. Raises on anything the kernel does not take.
    ``stats``: None, or an int32 ``[3]`` tensor on the card to which the
    launch adds the counts named by :data:`STATS`: tiles that took the
    window, tiles that went global (each lane adds straight to the output)
    and tiles with no counted lane."""
    n = key.shape[0]
    for name, t, dt in (("key", key, torch.int32), ("pane", pane, torch.int32),
                        ("valid", valid, torch.bool)):
        if t.device != key.device or t.dtype != dt or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(
                f"histogram_cuda: {name} must be a contiguous {dt} [{n}] tensor "
                f"on {key.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if K < 0 or P <= 0 or K * P >= 2 ** 31:
        raise ValueError(f"histogram_cuda: bad geometry K={K}, P={P}")
    if n == 0 or K == 0:
        return torch.zeros((K, P), dtype=torch.int32, device=key.device)
    if stats is not None and (stats.device != key.device or stats.dtype != torch.int32
                              or stats.shape != (len(STATS),)):
        raise ValueError("histogram_cuda: stats must be an int32 [3] tensor on the card")
    out = torch.empty((K, P), dtype=torch.int32, device=key.device)
    fn = cuda.function("histogram", "wf_keyed_pane_histogram", _ARGTYPES)
    count_launch("histogram")
    cuda.check(fn(cuda.ptr(key), cuda.ptr(pane), cuda.ptr(valid), cuda.ptr(out),
                  None if stats is None else cuda.ptr(stats), n, K, P,
                  cuda.stream_ptr(key.device)), "histogram_cuda")
    return out

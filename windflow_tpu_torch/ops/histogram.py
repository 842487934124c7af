"""Keyed-pane histograms — the Key_FFAT insert hot path.

Counterpart of ``windflow_tpu/ops/histogram.py``. The JAX package computes the
``[K, P]`` count as one-hot matmuls (XLA einsum or the Pallas kernel
``_pallas_fast``) under a chunk-locality precondition, with a ``lax.cond``
falling back to an exact scatter-add. All of its branches give the same
counts, so the port has one function: a CUDA tensor goes to the hand-written
atomic histogram (``csrc/histogram.cu``, kernel K1), a CPU tensor to the
plain PyTorch version beside it. ``chunk=`` and ``locality=`` stay in the
signature for parity; the result does not depend on them.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda
from .registry import count_launch

#: C signature of the kernel's entry point (pointers and the stream as void*)
_ARGTYPES = ([ctypes.c_void_p] * 4
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

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


def histogram_cuda(key, pane, valid, K: int, P: int) -> torch.Tensor:
    """Launch K1 on ``key``'s card. Raises on anything the kernel does not take."""
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
    out = torch.zeros((K, P), dtype=torch.int32, device=key.device)
    if n == 0 or K == 0:
        return out
    fn = cuda.function("histogram", "wf_keyed_pane_histogram", _ARGTYPES)
    count_launch("histogram")
    cuda.check(fn(cuda.ptr(key), cuda.ptr(pane), cuda.ptr(valid), cuda.ptr(out),
                  n, K, P, cuda.stream_ptr(key.device)), "histogram_cuda")
    return out

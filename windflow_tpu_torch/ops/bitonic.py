"""Bitonic compare-exchange networks: TopN's merge, and Ordering_Node's later.

Counterpart of ``windflow_tpu/ops/bitonic.py``. A network orders a 4-tuple
composite key ``(prim, sec, chan, idx)`` of int32 lanes lexicographically;
because ``idx`` is unique in every caller, the order is total and the output
equals the stable lexsort. :func:`sort_network` is the full sort (stages
``k = 2, 4, .., n``), :func:`merge_network` the merge of a bitonic sequence
(the last stage alone). Both take ``[n]`` or ``[R, n]`` lanes, ``n`` a power
of two: a batch dimension written out where the JAX package vmaps the
network (TopN sorts ``[K, L]`` candidate rows once per batch).

The kernel registry (family ``ordering_merge``) picks kernel K4
(``csrc/bitonic.cu``, ``cuda``: the default on a CUDA tensor) or the plain
version beside it (``torch``: the default on the CPU), which runs
the JAX package's butterfly stages in torch. The TPU kernel took n <= 2^15;
the port's takes any power of two n >= 2.

K4's mechanism: each lane is packed into one 128-bit key, a CTA of 512
threads holds 4096 lanes (8 a thread in registers, 64 KB of shared memory),
every compare-exchange runs in registers, and the lanes change their
assignment to registers (through shared memory) only when a stride leaves
the current three register bits. Its regimes, by row length:

- ``n <= 4096``: one CTA per 4096 lanes (several rows a CTA);
- ``4096 < n <= 4096 * 8``: a row lives in one thread block cluster of
  ``n / 4096`` CTAs, which exchange lanes through distributed shared memory
  for the strides across CTAs, and the whole network is one launch
  (TopN's ``[16, 2^15]``: 128 CTAs);
- larger ``n``: strides of a cluster's span or more run as global-memory
  passes, the rest of every stage in one cluster launch.

:func:`network_plan` reports the cluster size and the launches of a call.
Its bound on the H100 is bytes: each lane's 16 bytes read and written once.

Exactness: every step is a compare and a select on int32, so the kernel and
the plain version agree bit for bit on any input, ties included.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import cuda
from .registry import count_launch, register_kernel, resolve_impl

#: C signature of K4's entry point (pointers and the stream as void*)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p]
#: C signature of K4's plan query (n, sort, and three int out-pointers)
_PLAN_ARGTYPES = [ctypes.c_longlong, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3

Lanes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _lex_lt(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Strict lexicographic ``a < b`` over equal-length tuples of int32 tensors."""
    out = eq = None
    for x, y in zip(a, b):
        term = (x < y) if eq is None else (eq & (x < y))
        out = term if out is None else (out | term)
        eq = (x == y) if eq is None else (eq & (x == y))
    return out


def _butterfly(arrs, d: int, ascending=None):
    """One stride-``d`` butterfly over ``[R, n]`` lanes: pair ``i`` with
    ``i + d`` through the ``[R, n/(2d), 2, d]`` reshape. ``ascending``: None
    (every pair ascending) or a ``[n/(2d), 1]`` bool direction mask."""
    R, n = arrs[0].shape
    rs = [a.reshape(R, n // (2 * d), 2, d) for a in arrs]
    lt = _lex_lt([r[:, :, 0] for r in rs], [r[:, :, 1] for r in rs])
    lo_takes_0 = lt if ascending is None else torch.where(ascending, lt, ~lt)

    def sel(r):
        lo = torch.where(lo_takes_0, r[:, :, 0], r[:, :, 1])
        hi = torch.where(lo_takes_0, r[:, :, 1], r[:, :, 0])
        return torch.stack([lo, hi], dim=2).reshape(R, n)
    return [sel(r) for r in rs]


def _merge_stages(arrs):
    n = arrs[0].shape[1]
    d = n // 2
    while d >= 1:
        arrs = _butterfly(arrs, d)
        d //= 2
    return arrs


def _sort_stages(arrs):
    n = arrs[0].shape[1]
    dev = arrs[0].device
    k = 2
    while k <= n:
        d = k // 2
        while d >= 1:
            # ascending iff bit k of the pair's lane is 0; that bit lies in the
            # block index of the [n/(2d), 2, d] pairing
            blk = torch.arange(n // (2 * d), dtype=torch.int32, device=dev)[:, None]
            arrs = _butterfly(arrs, d, ((blk * (2 * d)) & k) == 0)
            d //= 2
        k *= 2
    return arrs


def _as_rows(lanes: Lanes, what: str):
    """``[n]`` or ``[R, n]`` int32 lanes of one shape, as ``[R, n]``, and
    whether they were 1-D."""
    shape = lanes[0].shape
    for t in lanes:
        if t.shape != shape or t.dtype != torch.int32 or t.device != lanes[0].device:
            raise ValueError(f"{what}: four int32 tensors of one shape on one device, "
                             f"got {[(t.dtype, tuple(t.shape), str(t.device)) for t in lanes]}")
    if len(shape) not in (1, 2):
        raise ValueError(f"{what}: lanes must be [n] or [R, n], got {tuple(shape)}")
    flat = len(shape) == 1
    return [t.reshape(1, -1) if flat else t for t in lanes], flat


def network_plain(prim, sec, chan, idx, *, sort: bool) -> Lanes:
    """Plain PyTorch version of K4: the JAX package's butterfly stages."""
    rows, flat = _as_rows((prim, sec, chan, idx), "network_plain")
    out = (_sort_stages if sort else _merge_stages)(rows)
    return tuple(o.reshape(-1) if flat else o for o in out)


def network_plan(n: int, *, sort: bool) -> dict:
    """K4's plan for rows of ``n`` lanes on the current card:
    ``{"cluster": CTAs of one cluster, "active_clusters": clusters of that
    size the card holds at once, "launches": CUDA launches of one call}``
    (one launch while a row fits in one cluster)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    fn = cuda.function("bitonic", "wf_bitonic_plan", _PLAN_ARGTYPES)
    cuda.check(fn(n, int(sort), *(ctypes.byref(o) for o in out)), "network_plan")
    return dict(zip(("cluster", "active_clusters", "launches"), (o.value for o in out)))


def network_cuda(prim, sec, chan, idx, *, sort: bool) -> Lanes:
    """Launch K4 on the lanes' card (all launches of one network; counted
    once). Raises on anything the kernel does not take, and on a refused
    launch or shared-memory size."""
    rows, flat = _as_rows((prim, sec, chan, idx), "network_cuda")
    R, n = rows[0].shape
    if n < 2 or n & (n - 1) or n > (1 << 30):
        raise ValueError(f"network_cuda: n must be a power of two in [2, 2^30], got {n}")
    rows = [t.contiguous() for t in rows]
    outs = [torch.empty_like(t) for t in rows]
    if R == 0:
        return tuple(o.reshape(-1) if flat else o for o in outs)
    fn = cuda.function("bitonic", "wf_bitonic_network", _ARGTYPES)
    count_launch("ordering_merge")
    cuda.check(fn(*(cuda.ptr(t) for t in rows), *(cuda.ptr(o) for o in outs), R, n,
                  int(sort), cuda.stream_ptr(rows[0].device)), "network_cuda")
    return tuple(o.reshape(-1) if flat else o for o in outs)


def _network(prim, sec, chan, idx, sort: bool, impl: str = None) -> Lanes:
    if impl is None:
        impl = resolve_impl("ordering_merge", device=prim.device, record=False)
    if impl == "cuda":
        return network_cuda(prim, sec, chan, idx, sort=sort)
    return network_plain(prim, sec, chan, idx, sort=sort)


def sort_network(prim, sec, chan, idx, *, impl: str = None) -> Lanes:
    """Full bitonic sort of the composite key, per row: equal to the stable
    ``lexsort((chan, sec, prim))`` of each row applied to all four lanes
    when ``idx`` is unique. ``impl``: ``"cuda"`` (K4) or ``"torch"`` (None:
    the registry's choice for the lanes' device, unrecorded)."""
    return _network(prim, sec, chan, idx, True, impl)


def merge_network(prim, sec, chan, idx, *, impl: str = None) -> Lanes:
    """Merge a bitonic (ascending then descending) composite-key sequence,
    per row, into ascending order (``impl`` as :func:`sort_network`'s)."""
    return _network(prim, sec, chan, idx, False, impl)


register_kernel("ordering_merge", "torch", network_plain, reference=True)
register_kernel("ordering_merge", "cuda", network_cuda, devices=("cuda",))


__all__ = ["sort_network", "merge_network", "network_plain", "network_cuda",
           "network_plan"]

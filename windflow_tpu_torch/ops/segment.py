"""Segmented (per-key) reductions over micro-batches.

Counterpart of the part of ``windflow_tpu/ops/segment.py`` the port runs:
:func:`segment_fold` (the masked 1-D segment sum behind Win_SeqFFAT's additive
lifts and Win_Seq's counts), :func:`segment_reduce` with the additive,
max/min and general associative combines, :func:`segment_rank`
(Distinct's first-occurrence test, Win_Seq's and Key_FFAT's arrival
positions) and :func:`segment_prefix_scan` (the Accumulator's per-key
rolling fold). :func:`tree_reduce` is the JAX package's pairwise fold of an
axis with any associative combine (Win_SeqFFAT's ``_tree_reduce``).

An ``identity`` is a Python number, or a tensor (a 2x2 identity matrix for
a matrix-product combine) that the operators move to their device once, at
construction: a number becomes a ``torch.full`` (a kernel argument, which a
CUDA-graph capture takes), a tensor on the device is used as it is.

:func:`segment_fold` on integer values of at most 4 bytes is the hand-written
CUDA kernel ``csrc/segment.cu`` (kernel K3: block-private partials in shared
memory, a direct ``[S]`` array where S is small, flushed through a
workspace and one grid barrier up to S = 512; one global atomic a lane
otherwise; :func:`segment_fold_plan` reports the launch) or the plain PyTorch
version beside it, as the kernel registry picks (family ``segment_fold``:
``cuda`` by default on a CUDA tensor, ``torch`` on the CPU). Both sum in wrapping int32
arithmetic, so they equal XLA's integer ``segment_sum`` bit for bit, overflow
included, and a narrower input dtype is cast back at the end. The JAX kernel
served S <= 4096 only (``FOLD_MAX_SEGMENTS``, XLA above); the port's serves
any S, since the result is the same.

Float values are not a TPU kernel's job (the JAX package leaves them to
XLA's ``segment_sum``, which sums each segment from +0.0 in stream order,
rounding after every add). On a CPU tensor ``index_add_`` gives those bits
(see :func:`_index_add_fold` for float16 and bfloat16 rows). On the card ``index_add_``
would use float atomics, which sum in no fixed order, so a CUDA float fold
goes through a helper kernel instead (``csrc/segment.cu``,
``wf_segment_fold_ordered``, registry name ``segment_fold_float``): a stable
sort of the lanes by segment, then each run summed in stream order: a short
run by one thread, a long one streamed by a block through shared memory
(rows of several columns: a thread a column of a segment). Its bits equal
the CPU's on every run (NaN payloads aside).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Callable

import torch

from . import cuda
from ..batch import dtype_name, tree_map
from .registry import count_launch, on_card, register_kernel, resolve_impl

#: C signature of the kernel's entry point (pointers and the stream as void*)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
#: C signature of the plan query (n, S, dtype, six out-pointers)
_PLAN_ARGTYPES = ([ctypes.c_longlong] + [ctypes.c_int] * 2
                  + [ctypes.POINTER(ctypes.c_int)] * 5 + [ctypes.POINTER(ctypes.c_longlong)])

#: K3's paths and flushes, by the codes its C plan reports
FOLD_PATHS = ("direct", "global")
FOLD_FLUSHES = ("workspace_reduce", "atomic")

#: integer dtypes K3 takes, with the code its C entry point expects
_FOLD_DTYPES = {torch.int32: 0, torch.int16: 1, torch.int8: 2, torch.uint8: 3}

#: C signature of the ordered float fold (rows, keys, segment starts or
#: null, out, work list; C, S, D, dtype; the stream)
_ORDERED_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
#: lanes from which the ordered fold streams a one-column run by a block (its
#: ``WF_RUN_LONG``): its work list holds at most C // FOLD_RUN_LONG runs
FOLD_RUN_LONG = 256
#: rows of padding after the gathered rows: the streaming block reads whole
#: 16-byte spans
_ROW_PAD = 16

#: float dtypes the ordered fold takes, with the code its C entry point expects
_ORDERED_DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
                   torch.bfloat16: 3}


def segment_fold(values: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                 num_segments: int, *, impl: str = None) -> torch.Tensor:
    """Masked 1-D segment sum ``out[s] = sum(values[i] : seg[i]==s, valid[i])``.
    Invalid lanes contribute 0; segment ids outside ``[0, S)`` are dropped.
    Returns ``[S]`` in ``values``' dtype. ``impl`` (None: the registry's
    choice, family ``segment_fold``, resolved for every dtype as in the JAX
    package) picks K3 (``"cuda"``) or its plain version (``"torch"``) for
    the integer dtypes K3 takes; other dtypes fold with ``index_add_``."""
    C, S = values.shape[0], int(num_segments)
    impl = resolve_impl("segment_fold", impl=impl, device=values.device,
                        spec_key=f"C{C}xS{S}:{dtype_name(values.dtype)}")
    if values.dtype in _FOLD_DTYPES:
        if impl == "cuda":
            # strided or broadcast lanes (a per-lane constant such as the
            # word count's ones) made dense for the kernel (F23)
            return segment_fold_cuda(values.contiguous(), seg.contiguous(),
                                     valid.contiguous(), S)
        return segment_fold_plain(values, seg, valid, S)
    return _index_add_fold(values, seg, valid, S)


def segment_fold_plain(values, seg, valid, S: int) -> torch.Tensor:
    """Plain PyTorch version of K3: an exact int64 sum, wrapped to int32."""
    ok = valid & (seg >= 0) & (seg < S)
    acc = torch.zeros(S + 1, dtype=torch.int64, device=values.device)
    acc.index_add_(0, torch.where(ok, seg, S).long(),
                   torch.where(ok, values.to(torch.int64), 0))
    wrapped = torch.remainder(acc[:S] + 2 ** 31, 2 ** 32) - 2 ** 31
    return wrapped.to(torch.int32).to(values.dtype)


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, n: int, S: int, code: int) -> dict:
    out = [ctypes.c_int(0) for _ in range(5)]
    ws = ctypes.c_longlong(0)
    fn = cuda.function("segment", "wf_segment_fold_plan", _PLAN_ARGTYPES)
    with torch.cuda.device(device_index):
        cuda.check(fn(n, S, code, *(ctypes.byref(o) for o in out),
                      ctypes.byref(ws)), "segment_fold_plan")
    grid, smem, chosen, flushed, tile = (o.value for o in out)
    return {"grid": grid, "smem": smem, "tile": tile, "path": FOLD_PATHS[chosen],
            "flush": FOLD_FLUSHES[flushed], "ws_ints": ws.value,
            "zero": "memset" if flushed else "none"}


def segment_fold_plan(n: int, S: int, dtype=torch.int32, *, device=None) -> dict:
    """K3's launch for ``n`` lanes of ``dtype`` into ``S`` segments on the
    card: ``{"grid": CTAs, "smem": dynamic shared bytes a CTA, "tile": lanes
    a tile, "path": "direct" or "global", "flush": "workspace_reduce" (every
    output cell written once after a grid barrier) or "atomic" (into an
    output zeroed by a memset), "ws_ints": int32 workspace, "zero": "memset"
    or "none"}``."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return dict(_plan(index, int(n), int(S), _FOLD_DTYPES[dtype]))


def segment_fold_cuda(values, seg, valid, S: int, *, stats=None) -> torch.Tensor:
    """Launch K3 on ``values``' card. Raises on anything the kernel does not
    take. ``stats``: None, or an int32 ``[3]`` tensor on the card to which the
    launch adds the counts named by ``histogram.STATS``: tiles on the direct
    path, tiles on the global path (each lane adds straight to the output)
    and (always 0 here) empty tiles."""
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
    if n == 0 or S == 0:
        return torch.zeros((S,), dtype=values.dtype, device=dev)
    if stats is not None and (stats.device != dev or stats.dtype != torch.int32
                              or stats.shape != (3,)):
        raise ValueError("segment_fold_cuda: stats must be an int32 [3] tensor on the card")
    plan = segment_fold_plan(n, S, values.dtype, device=dev)
    out = torch.empty((S,), dtype=torch.int32, device=dev)
    ws = torch.empty((plan["ws_ints"],), dtype=torch.int32, device=dev) \
        if plan["ws_ints"] else None
    fn = cuda.function("segment", "wf_segment_fold", _ARGTYPES)
    count_launch("segment_fold")
    cuda.check(fn(cuda.ptr(values), _FOLD_DTYPES[values.dtype], cuda.ptr(seg),
                  cuda.ptr(valid), cuda.ptr(out), None if ws is None else cuda.ptr(ws),
                  None if stats is None else cuda.ptr(stats), n, S,
                  cuda.stream_ptr(dev)), "segment_fold_cuda")
    return out if values.dtype == torch.int32 else out.to(values.dtype)


def _index_add_fold(values, seg, valid, S: int) -> torch.Tensor:
    """Segment sum outside K3's domain (floats, int64, trailing dims): plain
    ``index_add_`` into a spill row that collects dropped lanes; on a CUDA
    float tensor, the ordered fold (fixed bits, equal to the CPU's).

    float16 and bfloat16 values with trailing dims fold as one 1-D
    ``index_add_`` over ``(segment, column)`` cells: on the CPU a 2-D
    ``index_add_`` of them sums in float32 and rounds once (torch 2.13),
    where the 1-D one rounds after every add, as XLA's ``segment_sum``
    does."""
    if values.dtype.is_floating_point and on_card("segment_fold_float", values):
        return segment_fold_float_cuda(values, seg, valid, S)
    dev = values.device
    ok = valid & (seg >= 0) & (seg < S)
    m = ok.reshape(ok.shape + (1,) * (values.ndim - 1))
    masked = torch.where(m, values, torch.zeros((), dtype=values.dtype, device=dev))
    tail = tuple(values.shape[1:])
    cell = torch.where(ok, seg, S).long()
    if values.ndim > 1 and values.dtype in (torch.float16, torch.bfloat16):
        D = math.prod(tail)
        cell = (cell[:, None] * D + torch.arange(D, device=dev)).reshape(-1)
        out = torch.zeros(((S + 1) * D,), dtype=values.dtype, device=dev)
        return out.index_add_(0, cell, masked.reshape(-1)).reshape((S + 1,) + tail)[:S]
    out = torch.zeros((S + 1,) + tail, dtype=values.dtype, device=dev)
    return out.index_add_(0, cell, masked)[:S]


def segment_fold_float_cuda(values, seg, valid, S: int) -> torch.Tensor:
    """Float segment sum on the card in stream order per segment: a stable
    sort of the lanes by segment (dropped lanes last), their rows gathered
    in that order, each segment's start found by ``searchsorted`` where S
    <= C or the rows have several columns (else the kernel finds the runs
    itself), then ``wf_segment_fold_ordered`` sums every run in order (see
    ``csrc/segment.cu``). Raises on anything the helper does not take."""
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
    if S == 0 or D == 0 or C == 0:
        return out.zero_()
    ok = valid & (seg >= 0) & (seg < S)
    sorted_seg, perm = torch.sort(torch.where(ok, seg.to(torch.int32), S), stable=True)
    rows = torch.empty((C + _ROW_PAD, D), dtype=values.dtype, device=dev)
    torch.index_select(values.reshape(C, D), 0, perm, out=rows[:C])
    starts = None
    if D > 1 or S <= C:
        starts = torch.searchsorted(sorted_seg, torch.arange(S + 1, dtype=torch.int32,
                                                             device=dev))
    work = torch.empty((1 + 3 * (C // FOLD_RUN_LONG + 1),), dtype=torch.int64, device=dev)
    fn = cuda.function("segment", "wf_segment_fold_ordered", _ORDERED_ARGTYPES)
    count_launch("segment_fold_float")
    cuda.check(fn(cuda.ptr(rows), cuda.ptr(sorted_seg),
                  None if starts is None else cuda.ptr(starts), cuda.ptr(out), cuda.ptr(work),
                  C, S, D, _ORDERED_DTYPES[values.dtype], cuda.stream_ptr(dev)),
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
    (0-based, in stream order): int32 ``[C]``. One stable sort, each sorted
    lane's segment start found by a binary search of its own key, and one
    scatter back to stream order. (The JAX package carries the starts forward
    with ``cummax``; on the card ``torch.cummax`` over 2^20 lanes took 2.5 ms,
    H100 80GB HBM3 at 700 W, ``chip_smoke.py --profile``.)"""
    c = keys.shape[0]
    dev = keys.device
    if c == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    sorted_keys, orig = _sort_by_key(keys, valid)
    iota = torch.arange(c, dtype=torch.int32, device=dev)
    seg_start = torch.searchsorted(sorted_keys, sorted_keys).to(torch.int32)
    out = torch.zeros((c,), dtype=torch.int32, device=dev)
    out[orig] = iota - seg_start
    return out


def _bmask(valid: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``valid [C]`` shaped to broadcast against ``v [C, ...]``."""
    return valid.reshape(valid.shape + (1,) * (v.ndim - 1))


def as_identity(identity, device):
    """An operator's ``identity`` as it keeps it: a Python number as it is,
    anything else (a tensor, an array) a tensor on ``device``, moved there
    once at construction."""
    if isinstance(identity, (bool, int, float)):
        return identity
    return torch.as_tensor(identity, device=device)


def identity_full(identity, dtype, device, shape=None) -> torch.Tensor:
    """``identity`` in ``dtype`` on ``device``: as it is (it broadcasts) when
    ``shape`` is None, else a new tensor of ``shape``."""
    if isinstance(identity, torch.Tensor):
        t = torch.as_tensor(identity, dtype=dtype, device=device)
        return t if shape is None else t.expand(tuple(shape)).clone()
    return torch.full(() if shape is None else tuple(shape), identity, dtype=dtype,
                      device=device)


def _full(identity, v: torch.Tensor, shape=None) -> torch.Tensor:
    return identity_full(identity, v.dtype, v.device, shape)


def segment_reduce(values: Any, keys: torch.Tensor, valid: torch.Tensor,
                   num_keys: int, combine: Callable = None, identity=0) -> Any:
    """Per-key reduction of a batch: a pytree of ``[num_keys, ...]`` tensors.

    The default combine is addition (:func:`segment_fold`, kernel K3 for
    1-D integer values); ``torch.maximum``/``torch.minimum`` take a
    ``scatter_reduce``; any other associative ``combine(a, b)`` goes through a
    sorted segmented scan. Keys without a valid lane get ``identity``. As in
    the JAX package, an invalid lane whose key is in range still enters the
    max/min as ``identity``, and keys outside ``[0, num_keys)`` are dropped."""
    S = int(num_keys)
    if combine is None:
        def red(v):
            if v.ndim == 1:
                return segment_fold(v, keys, valid, S)
            return _index_add_fold(v, keys, valid, S)
        return tree_map(red, values)
    if combine in (torch.maximum, torch.minimum):
        return tree_map(lambda v: _segment_extreme(v, keys, valid, S,
                                                   combine is torch.maximum, identity),
                        values)
    return _segment_scan_reduce(values, keys, valid, S, combine, identity)


def _segment_extreme(v, keys, valid, S: int, is_max: bool, identity):
    """``segment_max``/``segment_min`` with the JAX package's masking
    (segment.py:198-207): invalid lanes enter as ``identity``, untouched
    keys give ``identity``."""
    dev = v.device
    in_range = (keys >= 0) & (keys < S)
    idx = torch.where(in_range, keys, S).long()
    vals = torch.where(_bmask(valid, v), v, _full(identity, v))
    if v.dtype.is_floating_point:
        start = float("-inf") if is_max else float("inf")
    else:
        start = torch.iinfo(v.dtype).min if is_max else torch.iinfo(v.dtype).max
    out = torch.full((S + 1,) + tuple(v.shape[1:]), start, dtype=v.dtype, device=dev)
    out.scatter_reduce_(0, _bmask(idx, v).expand(v.shape), vals,
                        reduce="amax" if is_max else "amin", include_self=True)
    touched = torch.zeros((S + 1,), dtype=torch.bool, device=dev)
    # index_fill_ takes the value as a kernel argument; ``touched[i] = True``
    # would copy a host tensor, which a CUDA-graph capture refuses
    touched.index_fill_(0, torch.where(valid & in_range, keys, S).long(), True)
    return torch.where(_bmask(touched, out), out, _full(identity, out))[:S]


def _segmented_scan(values: Any, starts: torch.Tensor, combine: Callable) -> Any:
    """Inclusive segmented scan along axis 0: lane i gets the combine of its
    segment's lanes up to i, in order (``starts`` marks each segment's first
    lane). Log-depth doubling: at distance d, a lane not yet cut off by a
    segment start combines the partial ``d`` lanes back into its own."""
    n = starts.shape[0]
    flag = starts.clone()
    d = 1
    while d < n:
        prev_flag = flag[:-d]

        def step(v):
            merged = combine(v[:-d], v[d:])
            keep = _bmask(flag[d:], v[d:])
            return torch.cat([v[:d], torch.where(keep, v[d:], merged)])
        values = tree_map(step, values)
        flag = torch.cat([flag[:d], flag[d:] | prev_flag])
        d *= 2
    return values


def _segment_scan_reduce(values, keys, valid, S: int, combine, identity):
    """General associative combine (the JAX package's ``_sorted_segment_scan``
    then a scatter of each segment's last lane into its key row)."""
    dev = keys.device
    if keys.shape[0] == 0:
        return tree_map(lambda v: _full(identity, v, (S,) + tuple(v.shape[1:])), values)
    seg_keys, orig = _sort_by_key(keys, valid)
    seg_valid = seg_keys != torch.iinfo(keys.dtype).max
    sv = tree_map(lambda v: torch.where(_bmask(seg_valid, v), v.index_select(0, orig),
                                        _full(identity, v)), values)
    starts = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                        seg_keys[1:] != seg_keys[:-1]])
    scanned = _segmented_scan(sv, starts, combine)
    nxt = torch.cat([seg_keys[1:], torch.full((1,), -1, dtype=seg_keys.dtype, device=dev)])
    is_last = (seg_keys != nxt) & seg_valid & (seg_keys >= 0)
    out_idx = torch.where(is_last, torch.clamp(seg_keys, max=S), S).long()

    def scatter(v):
        out = _full(identity, v, (S + 1,) + tuple(v.shape[1:]))
        out[out_idx] = v              # one lane per key row; the rest to row S
        return out[:S]
    return tree_map(scatter, scanned)


def segment_prefix_scan(values: Any, keys: torch.Tensor, valid: torch.Tensor,
                        combine: Callable, identity=0, *, carry_in: Any = None) -> Any:
    """Per-key inclusive prefix scan in stream order: lane i gets the combine
    of every earlier live lane of its key and its own (after ``carry_in``,
    a per-key table ``[num_keys, ...]`` read with ``table_lookup``), in the
    lanes' own positions. Invalid lanes hold no meaningful value.

    ``torch.add`` takes the JAX package's formulation (one stable sort by
    key, one global cumulative sum over the sorted lanes, each segment's
    base subtracted, one scatter back to stream order). Its integer results
    are exact; its float results carry the rounding of a prefix at the
    magnitude of the whole batch's running total, summed in another order
    than XLA's, so float bits differ from the JAX package's once partial
    sums leave the integers below 2^24 (:func:`prefix_sum` keeps them the
    same on every device and run). Any other associative ``combine`` runs
    the log-depth segmented scan."""
    from .lookup import table_lookup
    c = keys.shape[0]
    dev = keys.device
    seg_keys, orig = _sort_by_key(keys, valid)
    seg_valid = seg_keys != torch.iinfo(keys.dtype).max
    if combine is torch.add:
        # each sorted lane's segment start (the JAX package's cummax of the
        # start flags), found by a binary search of its own key
        seg_start = torch.searchsorted(seg_keys, seg_keys).to(torch.int32)
        before = torch.clamp(seg_start - 1, min=0).long()

        def one(v):
            sv = torch.where(_bmask(seg_valid, v), v.index_select(0, orig),
                             _full(identity, v))
            cs = prefix_sum(sv)
            base = torch.where(_bmask(seg_start > 0, cs), cs.index_select(0, before),
                               torch.zeros((), dtype=v.dtype, device=dev))
            out = torch.zeros_like(cs)
            out[orig] = cs - base
            return out
        out = tree_map(one, values)
    else:
        sv = tree_map(lambda v: torch.where(_bmask(seg_valid, v), v.index_select(0, orig),
                                            _full(identity, v)), values)
        starts = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                            seg_keys[1:] != seg_keys[:-1]]) if c else seg_valid

        def unsort(v):
            out = torch.zeros_like(v)
            out[orig] = v
            return out
        out = tree_map(unsort, _segmented_scan(sv, starts, combine))
    if carry_in is not None:
        # associativity: fold(carry, v1..vr) == combine(carry, fold(v1..vr))
        out = tree_map(lambda v, t: combine(table_lookup(t, keys, traced=True), v),
                       out, carry_in)
    return out


def prefix_sum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along axis 0 in ``v``'s dtype. Integers take
    ``torch.cumsum`` (wrapping, exact in any order). Floats take a log-depth
    doubling scan (at distance d = 1, 2, 4, ... each lane adds the partial d
    lanes back), whose additions happen in one fixed order, so its bits are
    the same on the CPU and the card and from run to run: the card's
    ``torch.cumsum`` adds its tiles' partials in an order that varies
    between runs for floats."""
    if not v.dtype.is_floating_point:
        return torch.cumsum(v, dim=0, dtype=v.dtype)
    d = 1
    while d < v.shape[0]:
        v = torch.cat([v[:d], v[d:] + v[:-d]])
        d *= 2
    return v


def tree_reduce(combine: Callable, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Log-depth reduction of ``axis`` with an associative ``combine``: the
    JAX package's ``_tree_reduce`` (``operators/win_seqffat.py``), pairing
    for pairing. Each round combines the first half with the second (element
    i with element half + i) and carries an odd element over, so results
    equal the JAX package's where ``combine`` rounds. Up to three elements
    that keeps the operand order; from four on, a combine that does not
    commute sees them out of order, in both packages."""
    n = x.shape[axis]
    while n > 1:
        half = n // 2
        a, b = x.narrow(axis, 0, half), x.narrow(axis, half, half)
        x = torch.cat([combine(a, b), x.narrow(axis, 2 * half, n - 2 * half)], dim=axis)
        n = half + (n - 2 * half)
    return x.squeeze(axis)


register_kernel("segment_fold", "torch", segment_fold_plain, reference=True)
register_kernel("segment_fold", "cuda", segment_fold_cuda, devices=("cuda",))

"""Table lookups and the stream-table join's key table.

Counterpart of ``windflow_tpu/ops/lookup.py``: :func:`table_lookup` (kernel
K2), :func:`join_probe` (kernel K5), the versioned JoinTable built on it
(``join_table_*``) and the JoinTable's tiered-state hooks
(``join_table_tier_*``, the ``divert=`` path of the upsert).

``table_lookup``: ``table[idx]`` for the campaign join and per-key table
reads. On the TPU a gather
is serial, so the JAX package picks a one-hot formulation by table size: a
select-reduce for small tables and a factored one-hot matmul (the Pallas
kernel ``_pallas_factored_lookup``) for 128 < K <= 65536. Both give
``table[idx]`` with 0 for an index outside ``[0, K)``. The kernel registry
(``ops/registry.py``, families ``lookup`` and ``join_probe``, resolved at
each entry with the JAX package's spec key) picks that function's
implementation: ``cuda``, the hand-written gather ``csrc/lookup.cu`` (kernel
K2), the default for a CUDA tensor, or ``torch``, the plain version beside
it, the default on the CPU.

Routing follows the JAX package's rule (``windflow_tpu/ops/lookup.py:24-32,
72-95``), in one of its two readings:

- K <= 2048: select or factored branch — both ``table[idx]``, 0 out of range;
- 2048 < K <= 65536: factored branch when the table is f32-exact, else the
  ``take`` branch. For a concrete table (a direct eager call, as eager JAX
  runs it) that is read from the values: floats all finite, ints of <= 16
  bits, or int values below 2^24 in magnitude (one device sync). Inside an
  operator's ``apply`` (``traced=True``) the table is what JAX's jitted
  chain sees, a tracer, and only the dtype counts: bool and 8- or 16-bit
  integer tables take the factored branch; floats and wider integers take
  ``take``. No device value is read, so the step can be captured in a CUDA
  graph;
- K > 65536: the ``take`` branch.

:func:`table_lookup_many` reads several tables through one index: each
table routed and its selection recorded as :func:`table_lookup` does it,
and the tables on K2's branch gathered in one launch (``csrc/lookup.cu``'s
``wf_table_lookup_many``: each lane's index loaded once for all of them),
:data:`LOOKUP_MAX_TABLES` tables a launch. Its plain version,
:func:`lookup_many_plain`, is :func:`lookup_plain` for each table in turn.

A 2-D table ``[K, V]`` (a per-key state row of V values) takes the JAX
package's select-reduce up to :data:`SELECT_MAX_ROWS_2D` rows (``table[idx]``,
0 out of range, ``-0.0`` read as ``+0.0``) and ``take`` above, as does any
table of more dimensions. The JAX package computes the 2-D select outside any
Pallas kernel, so K2 stays 1-D: a 2-D table on the card goes through the
plain version (one ``index_select`` and a mask).

The ``take`` branch was never a kernel: it keeps ``jnp.take``'s semantics in
plain PyTorch (a negative index wraps once; out of range gives the dtype's
fill: NaN, the signed minimum, the unsigned maximum, or True).

Float ``-0.0``: the select and factored branches sum a one-hot product, so a
``-0.0`` entry comes back as ``+0.0`` there, except from a one-row table (XLA
drops a sum over one element). K2 and its plain version do the same; the
``take`` branch returns ``-0.0`` as ``jnp.take`` does.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda
from ..batch import dtype_name, jax_leaves, jax_unflatten, tree_leaves, tree_map
from .registry import count_launch, register_kernel, resolve_impl

#: C signature of K2's entry point (pointers and the stream as void*)
_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])

#: C signature of the grouped entry point: the tables', outputs', Ks',
#: element sizes' and zero_fix flags' host arrays, the count, idx, n, stream
_MANY_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_longlong, ctypes.c_void_p])

#: the most tables one grouped K2 launch reads (``csrc/lookup.cu``'s
#: ``WF_LOOKUP_MAX_TABLES``); :func:`table_lookup_many` splits a larger group
LOOKUP_MAX_TABLES = 16

#: tables up to this size take the JAX select or factored branch whatever
#: their values
SELECT_MAX_ROWS_2D = 2048
#: the factored path handles tables up to this many rows
FACTORED_MAX_ROWS = 1 << 16


def table_lookup(table: torch.Tensor, idx: torch.Tensor, *,
                 traced: bool = False, impl: str = None) -> torch.Tensor:
    """``table[idx]`` with the JAX package's out-of-range semantics for the
    table's size. ``table``: ``[K]`` or ``[K, V]`` (``[K, ...]`` takes
    ``take``); ``idx``: i32 ``[C]``. ``traced``: route as JAX's jitted chain
    does, from K and dtype alone (every operator's ``apply``); False reads a
    concrete 1-D table's values, as eager JAX does. ``impl``: ``"cuda"`` or
    ``"torch"`` for the gather (None: the registry's choice)."""
    return table_lookup_many([table], idx, traced=traced, impl=impl)[0]


def table_lookup_many(tables, idx: torch.Tensor, *, traced: bool = True,
                      impl: str = None) -> list:
    """``[table_lookup(t, idx, traced=traced, impl=impl) for t in tables]``
    with the tables on K2's branch gathered together: one launch for up to
    :data:`LOOKUP_MAX_TABLES` of them (one more launch for each further
    :data:`LOOKUP_MAX_TABLES`). Each table is routed, and its selection
    resolved under its own spec key, as :func:`table_lookup` does it; the
    outputs come back in the tables' order. ``traced`` defaults to True:
    the callers are operators' ``apply``."""
    tables = list(tables)
    outs = [None] * len(tables)
    group = []                      # (position, table) on K2's branch, kernel impl
    for i, t in enumerate(tables):
        sel = _resolve(t, idx, impl)
        branch = _branch(t, traced)
        if branch == "select2d":
            outs[i] = lookup_plain(t, idx)
        elif branch == "take":
            outs[i] = take(t, idx)
        elif sel == "cuda":
            group.append((i, t))
        else:
            outs[i] = lookup_plain(t, idx)
    if len(group) == 1:
        i, t = group[0]
        outs[i] = gather_or_zero(t, idx, impl="cuda")
    elif group:
        # strided or broadcast lanes made dense for the kernel (F23)
        dense = idx.contiguous()
        for s in range(0, len(group), LOOKUP_MAX_TABLES):
            part = group[s:s + LOOKUP_MAX_TABLES]
            got = lookup_many_cuda([t.contiguous() for _, t in part], dense)
            for (i, _), o in zip(part, got):
                outs[i] = o
    return outs


def _resolve(table: torch.Tensor, idx: torch.Tensor, impl: str) -> str:
    """The registry's selection for ``table`` read through ``idx``, recorded
    under the JAX package's spec key."""
    return resolve_impl(
        "lookup", impl=impl, device=table.device,
        spec_key=f"C{idx.shape[0]}xK{table.shape[0]}:{dtype_name(table.dtype)}")


def _branch(table: torch.Tensor, traced: bool) -> str:
    """The JAX package's branch for ``table``: ``"select2d"`` (a 2-D table of
    at most :data:`SELECT_MAX_ROWS_2D` rows), ``"take"``, or ``"k2"`` (the
    select or factored branch of a 1-D table: K2's function)."""
    K = table.shape[0]
    if table.ndim > 1:
        return "select2d" if table.ndim == 2 and K <= SELECT_MAX_ROWS_2D else "take"
    exact = _exact_dtype if traced else _factored_ok
    if K <= SELECT_MAX_ROWS_2D or (K <= FACTORED_MAX_ROWS and exact(table)):
        return "k2"
    return "take"


def _exact_dtype(table: torch.Tensor) -> bool:
    """The JAX package's exactness test for a traced table (lookup.py:24-32,
    72-90 with ``concrete`` False): a float table never takes the factored
    branch, bool and <= 16-bit integer tables always."""
    if table.dtype.is_floating_point or table.is_complex():
        return False
    return table.dtype == torch.bool or torch.iinfo(table.dtype).bits <= 16


def _factored_ok(table: torch.Tensor) -> bool:
    """The JAX package's exactness test for a concrete table (lookup.py:72-84)."""
    if table.dtype.is_floating_point:
        return bool(torch.isfinite(table).all())
    if _exact_dtype(table):
        return True
    if table.is_complex():
        return False
    return bool(table.abs().max() < (1 << 24))


def gather_or_zero(table: torch.Tensor, idx: torch.Tensor, *,
                   impl: str = None) -> torch.Tensor:
    """``table[idx]``, 0 where ``idx`` is outside ``[0, K)``: K2 (``impl``
    ``"cuda"``) or the plain version (``"torch"``); None resolves unrecorded
    (the default: K2 on a CUDA tensor)."""
    if impl is None:
        impl = resolve_impl("lookup", device=table.device, record=False)
    if impl == "cuda":
        # strided or broadcast lanes made dense for the kernel (F23)
        return lookup_cuda(table.contiguous(), idx.contiguous())
    return lookup_plain(table, idx)


def _zero_fix(table: torch.Tensor) -> bool:
    """Whether a select-sum over ``table``'s rows turns ``-0.0`` into ``+0.0``:
    float values, and at least two rows (a one-row sum is the row itself)."""
    return table.dtype.is_floating_point and table.shape[0] >= 2


def _plus_zero(v: torch.Tensor) -> torch.Tensor:
    """``-0.0 -> +0.0``, every other value (NaN included) unchanged."""
    return torch.where(v == 0, torch.zeros((), dtype=v.dtype, device=v.device), v)


def lookup_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2, and the 2-D select-reduce
    (``[K, V]`` tables: rows, 0 out of range)."""
    if table.shape[0] == 0:
        return torch.zeros(tuple(idx.shape) + tuple(table.shape[1:]), dtype=table.dtype,
                           device=table.device)
    ok = (idx >= 0) & (idx < table.shape[0])
    g = table.index_select(0, torch.where(ok, idx, 0).long())
    g = torch.where(_rows(ok, g), g, torch.zeros((), dtype=table.dtype,
                                                 device=table.device))
    return _plus_zero(g) if _zero_fix(table) else g


def _rows(mask: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A lane mask ``[C]`` shaped to broadcast against gathered rows ``[C, ...]``."""
    return mask.reshape(mask.shape + (1,) * (g.ndim - 1))


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
                  table.element_size(), int(_zero_fix(table)),
                  cuda.stream_ptr(table.device)), "lookup_cuda")
    return out


def lookup_many_plain(tables, idx: torch.Tensor) -> list:
    """Plain PyTorch version of the grouped K2: :func:`lookup_plain` for each
    table in turn."""
    return [lookup_plain(t, idx) for t in tables]


def lookup_many_cuda(tables, idx: torch.Tensor) -> list:
    """Launch the grouped K2 once on the tables' card: ``tables[k][idx]`` for
    each of up to :data:`LOOKUP_MAX_TABLES` 1-D tables, in their order.
    Raises on anything the kernel does not take (more tables included)."""
    tables = list(tables)
    if not 1 <= len(tables) <= LOOKUP_MAX_TABLES:
        raise ValueError(f"lookup_many_cuda: 1 to {LOOKUP_MAX_TABLES} tables a launch, "
                         f"got {len(tables)}")
    dev = tables[0].device
    if idx.ndim != 1 or idx.dtype != torch.int32 or idx.device != dev \
            or not idx.is_contiguous():
        raise ValueError(f"lookup_many_cuda: idx must be a contiguous int32 [C] tensor "
                         f"on {dev}, got {idx.dtype} {tuple(idx.shape)} on {idx.device}")
    for t in tables:
        if t.ndim != 1 or t.device != dev or not t.is_contiguous() \
                or t.element_size() not in (1, 2, 4, 8) or t.shape[0] >= 2 ** 31 \
                or t.is_complex():
            raise ValueError(f"lookup_many_cuda: each table must be a contiguous 1-D "
                             f"tensor of 1/2/4/8-byte real elements on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    n = idx.shape[0]
    outs = [torch.empty((n,), dtype=t.dtype, device=dev) for t in tables]
    if n == 0:
        return outs
    fn = cuda.function("lookup", "wf_table_lookup_many", _MANY_ARGTYPES)
    m = len(tables)
    ptrs = lambda ts: (ctypes.c_void_p * m)(*(t.data_ptr() for t in ts))  # noqa: E731
    ints = lambda vs: (ctypes.c_int * m)(*vs)  # noqa: E731
    count_launch("lookup")
    cuda.check(fn(ptrs(tables), ptrs(outs), ints(t.shape[0] for t in tables),
                  ints(t.element_size() for t in tables),
                  ints(int(_zero_fix(t)) for t in tables), m, cuda.ptr(idx), n,
                  cuda.stream_ptr(dev)), "lookup_many_cuda")
    return outs


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
    return torch.where(_rows(ok, g), g, torch.full((), fill, dtype=dt, device=table.device))


# ------------------------------------------------------ stream-table probe

#: largest key table the TPU's fused probe kernel accepted (its [BLK, K]
#: one-hot tile lived in VMEM). The port's kernel hashes the table and takes
#: any K; the constant stays for parity.
JOIN_PROBE_MAX_ROWS = 2048

#: most hash slots K5 holds in one block's shared memory: 2^14 slots of 8
#: bytes are 128 KB; 2^15 (256 KB) exceed the H100's 227 KB a block, so
#: larger tables are probed in device memory through L2
JOIN_PROBE_SMEM_SLOTS = 1 << 14

#: C signature of K5's entry point (pointers and the stream as void*)
_PROBE_ARGTYPES = ([ctypes.c_void_p] * 7
                   + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])

#: value dtypes that widen before the probe, as ``jnp.sum`` widens them
_PROBE_WIDEN = {torch.int8: torch.int32, torch.int16: torch.int32,
                torch.bool: torch.int32, torch.uint8: torch.uint32,
                torch.uint16: torch.uint32}

#: lanes x rows of one compare block of the plain probe (bounds its memory)
_PLAIN_PROBE_CELLS = 1 << 26


def join_probe(table_keys: torch.Tensor, table_vals: torch.Tensor,
               probe: torch.Tensor, valid: torch.Tensor, *, impl: str = None):
    """Stream-table join probe: ``(vals[C], hit bool[C])`` with
    ``vals[i] = table_vals[j]`` where ``table_keys[j] == probe[i]`` and
    ``hit[i]`` whether a row matched; a miss or an invalid lane gives
    ``(0, False)``.

    The JAX package's reference (``_join_probe_xla``) is a select-sum over
    the ``[C, K]`` compare, exact when the table's keys are unique (the
    JoinTable's invariant). The port matches it there: the value dtype is
    ``jnp.sum``'s (int8, int16 and bool widen to int32, uint8 and uint16 to
    uint32), a float ``-0.0`` comes back as ``+0.0`` when K >= 2, and a NaN
    stays on its own row. Where keys repeat (unused JoinTable slots all hold
    :data:`JOIN_KEY_SENTINEL`), both versions take the first matching row.
    ``impl`` (None: the registry's choice, family ``join_probe``): ``"cuda"``,
    kernel K5 (``csrc/join_probe.cu``, the default for a CUDA tensor), or
    ``"torch"``, the plain version (the default on the CPU).

    K5 hashes the table once per call, ``next_pow2(2K)`` slots of
    ``(key, row)`` built with atomics (equal keys share a slot holding their
    first row), then probes it with a persistent grid: O(C) expected
    lookups, not the ``C * K`` compares of the reference. While the slots
    fit in one block's shared memory (:data:`JOIN_PROBE_SMEM_SLOTS`, K <=
    8192) every block copies the table there once; above, the same kernel
    probes the table in device memory through L2. Its bound on the H100 is
    bytes: each lane read and written once and the table read once."""
    C, K = probe.shape[0], table_keys.shape[0]
    impl = resolve_impl("join_probe", impl=impl, device=table_keys.device,
                        spec_key=f"C{C}xK{K}:{dtype_name(table_vals.dtype)}")
    if impl == "cuda":
        # strided or broadcast lanes made dense for the kernel (F23)
        return join_probe_cuda(table_keys.contiguous(), table_vals.contiguous(),
                               probe.contiguous(), valid.contiguous())
    return join_probe_plain(table_keys, table_vals, probe, valid)


def _probe_dtype(dt: torch.dtype) -> torch.dtype:
    return _PROBE_WIDEN.get(dt, dt)


def join_probe_plain(table_keys, table_vals, probe, valid):
    """Plain PyTorch version of K5: the broadcast compare, in blocks of lanes
    so that the ``[C, K]`` mask stays small, then the first match's row."""
    K, C = table_keys.shape[0], probe.shape[0]
    dt = _probe_dtype(table_vals.dtype)
    dev = probe.device
    # uint32 has few kernels on the CPU: gather its bits as int32
    tv = table_vals.to(dt)
    if dt == torch.uint32:
        tv = tv.view(torch.int32)
    vals = torch.zeros((C,), dtype=tv.dtype, device=dev)
    hit = torch.zeros((C,), dtype=torch.bool, device=dev)
    if K > 0:
        step = max(1, _PLAIN_PROBE_CELLS // K)
        for a in range(0, C, step):
            oh = (probe[a:a + step, None] == table_keys[None, :]) & valid[a:a + step, None]
            h = oh.any(dim=1)
            j = oh.to(torch.uint8).argmax(dim=1)          # first True, or 0
            g = tv.index_select(0, j)
            vals[a:a + step] = torch.where(h, g, torch.zeros((), dtype=tv.dtype,
                                                             device=dev))
            hit[a:a + step] = h
    if dt.is_floating_point and K >= 2:
        vals = _plus_zero(vals)
    return (vals.view(torch.uint32) if dt == torch.uint32 else vals), hit


def join_probe_cuda(table_keys, table_vals, probe, valid):
    """Launch K5 on ``probe``'s card. Values of 4 bytes go to the kernel as
    they are; narrower integer values widen first and half floats go through
    float32 (exact both ways). Raises on anything else."""
    K, C = table_keys.shape[0], probe.shape[0]
    dev = probe.device
    for name, t, dt, n in (("table_keys", table_keys, torch.int32, K),
                           ("probe", probe, torch.int32, C),
                           ("valid", valid, torch.bool, C)):
        if t.device != dev or t.dtype != dt or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"join_probe_cuda: {name} must be a contiguous {dt} "
                             f"[{n}] tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    dt = _probe_dtype(table_vals.dtype)
    wide = dt
    if dt in (torch.float16, torch.bfloat16):
        wide = torch.float32
    if table_vals.device != dev or table_vals.shape != (K,) or table_vals.is_complex() \
            or torch.empty((), dtype=wide).element_size() != 4:
        raise ValueError(f"join_probe_cuda: table_vals must be a [{K}] tensor on "
                         f"{dev} of a real dtype of at most 4 bytes, got "
                         f"{table_vals.dtype} {tuple(table_vals.shape)} on "
                         f"{table_vals.device}")
    if K > 2 ** 30:
        raise ValueError(f"join_probe_cuda: table of {K} rows")
    tv = table_vals.to(wide).contiguous()
    vals = torch.empty((C,), dtype=wide, device=dev)
    hit = torch.empty((C,), dtype=torch.bool, device=dev)
    if C == 0:
        return vals.to(dt), hit
    log_m = max(1, (2 * K - 1).bit_length())          # 2^log_m = next_pow2(2K)
    slots = torch.empty((1 << log_m if K else 0,), dtype=torch.int64, device=dev)
    fn = cuda.function("join_probe", "wf_join_probe", _PROBE_ARGTYPES)
    count_launch("join_probe")
    cuda.check(fn(cuda.ptr(table_keys), cuda.ptr(tv), cuda.ptr(probe), cuda.ptr(valid),
                  cuda.ptr(vals), cuda.ptr(hit), cuda.ptr(slots), C, K, log_m,
                  int((1 << log_m) <= JOIN_PROBE_SMEM_SLOTS),
                  int(wide.is_floating_point and K >= 2), cuda.stream_ptr(dev)),
               "join_probe_cuda")
    return (vals if wide == dt else vals.to(dt)), hit


# ------------------------------------- versioned, watermark-consistent table

#: key value marking an unused table slot / an impossible probe. User join
#: keys must lie strictly inside (INT32_MIN, INT32_MAX): INT32_MIN is this
#: sentinel, INT32_MAX the upsert's sort sentinel.
JOIN_KEY_SENTINEL = -(1 << 31)

_I32 = torch.int32
_IMIN = -(1 << 31)
_IMAX = (1 << 31) - 1


def _scalar_leaves(val_spec) -> list:
    leaves = tree_leaves(val_spec)
    if not leaves:
        raise ValueError("JoinTable: value spec must have at least one leaf")
    for leaf in leaves:
        if tuple(getattr(leaf, "shape", ())) != ():
            raise ValueError(
                f"JoinTable values must be pytrees of SCALAR leaves (each "
                f"probed through join_probe as one [K] column); got leaf shape "
                f"{tuple(getattr(leaf, 'shape', '?'))}")
    return leaves


def join_table_init(num_slots: int, pending: int, val_spec, device) -> dict:
    """State of a versioned, watermark-consistent join table (counterpart of
    the JAX package's ``join_table_init``). An upsert ``(key, val, ts, id)``
    parks in a bounded pending ring until the build-side watermark (max ts
    seen) passes ``ts + delay``, then applies in ``(ts, id, arrival)`` order
    with last-writer-wins per key, so a probe reads the table as of the
    watermark. ``val_spec``: pytree of scalar spec tensors (shape ``()``),
    one value column each."""
    K, P = int(num_slots), int(pending)
    if K < 1 or P < 1:
        raise ValueError("join_table_init: num_slots and pending must be >= 1")
    _scalar_leaves(val_spec)

    def full(n, v, dt=_I32):
        return torch.full((n,), v, dtype=dt, device=device)

    def zcol(n):
        return tree_map(lambda s: torch.zeros((n,), dtype=s.dtype, device=device),
                        val_spec)

    def scalar(v):
        return torch.tensor(v, dtype=_I32, device=device)
    return {
        # the table proper: one row per key, latest applied version
        "key": full(K, JOIN_KEY_SENTINEL), "val": zcol(K),
        "ver": full(K, _IMIN), "vid": full(K, _IMIN), "vseq": full(K, _IMIN),
        "used": full(K, False, torch.bool),
        # pending ring: upserts not yet watermark-eligible (prefix-compacted)
        "pkey": full(P, 0), "pval": zcol(P), "pts": full(P, 0),
        "pid": full(P, 0), "pseq": full(P, 0), "pok": full(P, False, torch.bool),
        "wm": scalar(_IMIN),          # build-side watermark
        "seq": scalar(0),             # arrival stamp source
        "version": scalar(0),         # applied upserts (gauge)
        "dropped": scalar(0),         # ring/table overflow drops
    }


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].set(v, mode="drop")`` for ``idx`` in ``[0, len(arr)]``:
    the write lands in a spill row that is sliced off."""
    n = arr.shape[0]
    buf = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    buf[idx.long()] = v.to(arr.dtype)
    return buf[:n]


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the last key is the primary one; stable sorts,
    least significant key first."""
    perm = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        perm = perm.index_select(0, torch.argsort(k.index_select(0, perm), stable=True))
    return perm


def _isum(x: torch.Tensor) -> torch.Tensor:
    """Count of a bool tensor as an int32 scalar (JAX's int32 ``sum``)."""
    return x.sum(dtype=_I32)


def join_table_upsert(state: dict, key, val, ts, tid, ok, *, delay: int = 0,
                      divert: bool = False) -> dict:
    """Buffer the batch's build-side tuples and apply every upsert the
    watermark has made eligible (``ts <= wm - delay``): per key, the last
    writer by ``(ts, id, arrival)`` wins; fresh keys claim free slots in that
    order; a late but eligible upsert never rolls a slot back below its
    applied version. Overflowing the ring or a full table drops the upsert
    and counts it in ``state["dropped"]``. Fields equal the JAX package's
    ``join_table_upsert`` (untiered) bit for bit.

    The JAX form builds two ``[P, K]`` boolean matrices (the key's existing
    slot and the free-slot claim), which XLA fuses away; eager PyTorch would
    materialise them (4 GB each at P = 2^21, K = 2048). Here the existing
    slot is a :func:`join_probe` of every ring key against the used keys
    with values ``arange(K)`` (kernel K5 on the card; a miss gives slot 0,
    as ``argmax`` of an all-False row does), and the claim is the r-th
    ascending free slot for the entry of rank r.

    ``divert`` (a tiered table, ``join_table_tier_init``): a winning upsert
    that finds no free slot is not dropped but appended to the spill outbox
    with its version triplet; only a full outbox still drops, counted."""
    dev = state["key"].device
    P, K = state["pkey"].shape[0], state["key"].shape[0]
    ok = ok.to(torch.bool)
    key, ts, tid = key.to(_I32), ts.to(_I32), tid.to(_I32)

    # 1. append to the pending ring (live entries occupy a prefix)
    cnt = _isum(state["pok"])
    csum = torch.cumsum(ok.to(_I32), 0, dtype=_I32)
    pos = cnt + csum - 1
    keep = ok & (pos < P)
    dropped = count_drops(state["dropped"], "overflow_drops", _isum(ok & ~keep))
    slot = torch.where(keep, pos, P)
    arrive = state["seq"] + csum - 1
    pkey = _set_drop(state["pkey"], slot, key)
    pts = _set_drop(state["pts"], slot, ts)
    pid = _set_drop(state["pid"], slot, tid)
    pseq = _set_drop(state["pseq"], slot, arrive)
    pval = tree_map(lambda t, v: _set_drop(t, slot, v), state["pval"], val)
    pok = _set_drop(state["pok"], slot, torch.ones_like(ok))
    seq = state["seq"] + _isum(ok)

    # 2. advance the build-side watermark
    wm = torch.maximum(state["wm"], torch.where(ok, ts, _IMIN).max())

    # 3. eligible entries; per-key winner = last entry of its key group after
    #    one lexsort by (key, ts, id, seq); ineligible entries sort last
    elig = pok & (pts <= wm - int(delay))
    keysort = torch.where(elig, pkey, _IMAX)
    vperm = _lexsort((pseq, pid, pts, keysort))
    sk = keysort.index_select(0, vperm)
    nxt = torch.cat([sk[1:], torch.full((1,), _IMAX, dtype=_I32, device=dev)])
    win = torch.empty((P,), dtype=torch.bool, device=dev)
    win[vperm] = (sk != _IMAX) & (sk != nxt)

    # 4. slot resolution: the existing row wins, else the r-th fresh key (in
    #    (ts, id, seq) order) claims the r-th free slot (ascending index)
    used = state["used"]
    tk = torch.where(used, state["key"], JOIN_KEY_SENTINEL)
    slot_old, has_slot = join_probe(tk, torch.arange(K, dtype=_I32, device=dev),
                                    pkey, torch.ones((P,), dtype=torch.bool, device=dev))
    need_new = win & ~has_slot
    order = _lexsort((pseq, pid, torch.where(need_new, pts, _IMAX)))
    rnk = torch.empty((P,), dtype=_I32, device=dev)
    rnk[order] = torch.arange(P, dtype=_I32, device=dev)
    free_slots = torch.argsort(used.to(torch.uint8), stable=True)   # free first
    got_new = rnk < _isum(~used)
    slot_new = torch.where(got_new,
                           free_slots.index_select(0, rnk.clamp(max=K - 1).long())
                           .to(_I32), 0)
    lost = need_new & ~got_new
    if divert:
        S_ob = state["okey"].shape[0]
        drank = torch.cumsum(lost.to(_I32), 0, dtype=_I32) - 1
        fits = lost & (state["ocnt"] + drank < S_ob)
        div_pos = torch.where(fits, state["ocnt"] + drank, S_ob)
        div_n = _isum(fits)
        dropped = count_drops(dropped, "overflow_drops", _isum(lost & ~fits))
    else:
        dropped = count_drops(dropped, "overflow_drops", _isum(lost))

    # 5. never roll back: the pending version must beat the slot's applied one
    so = slot_old.long()
    o_ts, o_id, o_seq = (state[f].index_select(0, so) for f in ("ver", "vid", "vseq"))
    beats = ((pts > o_ts) | ((pts == o_ts) & (pid > o_id))
             | ((pts == o_ts) & (pid == o_id) & (pseq > o_seq)))
    write = win & torch.where(has_slot, beats, got_new)
    widx = torch.where(write, torch.where(has_slot, slot_old, slot_new), K)
    out = dict(state)
    out["key"] = _set_drop(state["key"], widx, pkey)
    out["ver"] = _set_drop(state["ver"], widx, pts)
    out["vid"] = _set_drop(state["vid"], widx, pid)
    out["vseq"] = _set_drop(state["vseq"], widx, pseq)
    out["used"] = _set_drop(used, widx, torch.ones_like(write))
    out["val"] = tree_map(lambda t, v: _set_drop(t, widx, v), state["val"], pval)
    out["version"] = state["version"] + _isum(write)
    if divert:
        out["okey"] = _set_drop(state["okey"], div_pos, pkey)
        out["oval"] = tree_map(lambda t, v: _set_drop(t, div_pos, v), state["oval"], pval)
        out["over"] = _set_drop(state["over"], div_pos, pts)
        out["ovid"] = _set_drop(state["ovid"], div_pos, pid)
        out["ovseq"] = _set_drop(state["ovseq"], div_pos, pseq)
        out["ocnt"] = state["ocnt"] + div_n
        out["spills"] = state["spills"] + div_n

    # 6. every eligible entry leaves the ring; recompact survivors (stable)
    pok2 = pok & ~elig
    order2 = torch.argsort((~pok2).to(torch.uint8), stable=True)
    take = lambda a: a.index_select(0, order2)  # noqa: E731
    out["pkey"], out["pts"], out["pid"], out["pseq"] = (
        take(pkey), take(pts), take(pid), take(pseq))
    out["pval"] = tree_map(take, pval)
    out["pok"] = take(pok2)
    out["wm"], out["seq"], out["dropped"] = wm, seq, dropped
    return out


def join_table_probe(state: dict, key: torch.Tensor, ok: torch.Tensor):
    """Probe the applied (watermark-visible) table: ``(vals pytree[C], hit
    bool[C])``. One value column is one :func:`join_probe`; several columns
    probe once for the slot and gather every column, as the JAX package
    does (so a column keeps its dtype there, and ``jnp.sum``'s otherwise)."""
    tk = torch.where(state["used"], state["key"], JOIN_KEY_SENTINEL)
    key = key.to(_I32)
    leaves = tree_leaves(state["val"])
    if len(leaves) == 1:
        v, hit = join_probe(tk, leaves[0], key, ok)
        return tree_map(lambda _: v, state["val"]), hit
    K = tk.shape[0]
    slot, hit = join_probe(tk, torch.arange(K, dtype=_I32, device=tk.device), key, ok)
    return tree_map(lambda tv: torch.where(
        hit, tv.index_select(0, slot.long()),
        torch.zeros((), dtype=tv.dtype, device=tv.device)), state["val"]), hit


def join_table_pending(state: dict) -> torch.Tensor:
    """Live pending-ring entries (int32 device scalar): upserts parked
    behind the watermark."""
    return _isum(state["pok"])


def join_table_stats(state: dict) -> dict:
    """Host-side health snapshot of one JoinTable state (a few small
    device-to-host reads; never on the hot path)."""
    K = int(state["key"].shape[0])
    P = int(state["pkey"].shape[0])
    used = int(state["used"].sum())
    return {
        "watermark_ts": int(state["wm"]),
        "applied_version": int(state["version"]),
        "table_slots": K,
        "table_used": used,
        "occupancy_pct": round(100.0 * used / K, 2),
        "pending_depth": int(state["pok"].sum()),
        "pending_capacity": P,
        "overflow_drops": int(state["dropped"]),
    }


def count_drops(counter: torch.Tensor, name: str, n) -> torch.Tensor:
    """The shared drop-accounting helper: ``counter + n``, with ``name``
    checked against :data:`observability.names.STAGE_COUNTERS`."""
    from ..observability.names import STAGE_COUNTERS
    if name not in STAGE_COUNTERS:
        raise ValueError(f"count_drops: {name!r} is not registered in "
                         f"observability/names.py::STAGE_COUNTERS")
    return counter + n


# ------------------------------------------------------ tiered state hooks
#
# The JoinTable's side of tiered keyed state (``state/tiered.py``), the
# counterparts of the JAX package's ``join_table_tier_*``: the same fields and
# results bit for bit, computed without its dense ``[R, K]`` and ``[R, S]``
# compares (3.2 G and 9.7 G cells at R = 49,152, K = 65,536, S = 196,608):
#
# - a key's hot slot (``any``/``argmax`` of the key compare) is one
#   :func:`join_probe` of the lanes against the used keys with the slot
#   indices as values (K5 on the card; it takes the first equal key, as
#   ``argmax`` does, and slot 0 on a miss);
# - the newest live outbox entry of a key is one stable sort of the live
#   outbox keys and a ``searchsorted`` (:func:`outbox_find_last`);
# - "the r-th admitted key claims the r-th free slot" is a gather from the
#   free slots' positions (:func:`claim_free_slots`);
# - ``jnp.lexsort((arange, lap))`` is one stable ``argsort`` of ``lap``.
#
# ``lookup(keys, want)`` is the cold tier's read (``JoinTableTier.lookup``:
# ``ops/cold_probe.py`` on the card, the store's host lookup on the CPU).

def hot_slot(tkeys: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor):
    """``(slot [R] int32, hit [R])``: the first index ``j`` with ``tkeys[j] ==
    keys[i]`` (0 where none), and whether a valid lane found one, as
    ``argmax``/``any`` of the ``[R, K]`` compare give them."""
    K = tkeys.shape[0]
    return join_probe(tkeys, torch.arange(K, dtype=_I32, device=tkeys.device),
                      keys.to(_I32), valid)


def outbox_find_last(okey: torch.Tensor, ocnt: torch.Tensor, keys: torch.Tensor,
                     need: torch.Tensor):
    """Newest live outbox entry of each key: ``(need & found [R], index [R]
    int32)``, the index the largest live position holding the key (0 where
    none), for every lane. Appends are chronological, so the largest index
    is the newest entry."""
    S = okey.shape[0]
    dev = okey.device
    live = torch.arange(S, dtype=_I32, device=dev) < ocnt
    sk, perm = torch.sort(torch.where(live, okey.to(torch.int64), 1 << 40), stable=True)
    k64 = keys.to(torch.int64)
    pos = torch.searchsorted(sk, k64, right=True) - 1
    posc = pos.clamp(min=0)
    hit = (pos >= 0) & (sk.index_select(0, posc) == k64)
    idx = torch.where(hit, perm.index_select(0, posc), 0).to(_I32)
    return need & hit, idx


def claim_free_slots(used: torch.Tensor, adm: torch.Tensor):
    """Deterministic fresh slots: the r-th admitted lane claims the r-th free
    slot (ascending). ``(got [R], slot [R] int32)``; ``slot`` is 0 where the
    lane's admission rank has no free slot."""
    K = used.shape[0]
    rank = torch.cumsum(adm.to(_I32), 0, dtype=_I32) - 1
    free_slots = torch.argsort(used.to(torch.uint8), stable=True)   # free first
    inr = (rank >= 0) & (rank < _isum(~used))
    slot = torch.where(inr, free_slots.index_select(0, rank.clamp(0, K - 1).long())
                       .to(_I32), 0)
    return inr & adm, slot


def join_table_tier_init(state: dict, outbox: int, val_spec) -> dict:
    """Grow a :func:`join_table_init` state with the tiered fields: per-slot
    last-access positions (``lap``/``tick``: batch positions, never wall
    clock), the bounded spill outbox (``okey``/``oval``/``over``/``ovid``/
    ``ovseq``/``ocnt``) and the device movement counters."""
    dev = state["key"].device
    K, S = state["key"].shape[0], int(outbox)
    if S < 1:
        raise ValueError("join_table_tier_init: outbox must be >= 1")

    def full(n, v):
        return torch.full((n,), v, dtype=_I32, device=dev)
    out = dict(state)
    out["lap"] = full(K, 0)
    out["tick"] = torch.zeros((), dtype=_I32, device=dev)
    out["okey"] = full(S, JOIN_KEY_SENTINEL)
    out["oval"] = tree_map(lambda s: torch.zeros((S,), dtype=s.dtype, device=dev), val_spec)
    out["over"] = full(S, _IMIN)
    out["ovid"] = full(S, _IMIN)
    out["ovseq"] = full(S, _IMIN)
    for k in ("ocnt", "spills", "readmits"):
        out[k] = torch.zeros((), dtype=_I32, device=dev)
    return out


def join_table_tier_fallback(state: dict, keys: torch.Tensor, miss: torch.Tensor):
    """Post-upsert read fallback: a probe lane that still misses the hot
    table reads the newest outbox entry of its key (this batch's diverted
    upserts, unsettled spills). Returns ``(vals [R] tree, hit [R])``."""
    keys = keys.to(_I32)
    hit, idx = outbox_find_last(state["okey"], state["ocnt"], keys,
                                miss.to(torch.bool) & (keys != JOIN_KEY_SENTINEL))
    return tree_map(lambda leaf: leaf.index_select(0, idx), state["oval"]), hit


def join_table_tier_resolve(state: dict, keys: torch.Tensor, ok: torch.Tensor, lookup):
    """The miss -> readmit round of a tiered table, inside the step: every
    wanted key missing from the hot table is searched in the spill outbox
    (newest entry wins), then in the cold tier (``lookup``), and found rows
    are readmitted through the fresh-slot rule (one slot a distinct key, the
    r-th readmitted key the r-th free slot). Hot hits are touched
    (``lap = tick``). Returns ``(state, fb_vals, fb_ok)``: each lane's cold
    value, for the lanes whose row found no free slot."""
    from .segment import segment_rank
    K = state["key"].shape[0]
    keys = keys.to(_I32)
    ok = ok.to(torch.bool) & (keys != JOIN_KEY_SENTINEL)
    tick = state["tick"]
    tk = torch.where(state["used"], state["key"], JOIN_KEY_SENTINEL)
    slot_tab, in_tab = hot_slot(tk, keys, ok)
    lap = _set_drop(state["lap"], torch.where(in_tab, slot_tab, K), tick)
    need = ok & ~in_tab
    in_ob, oidxc = outbox_find_last(state["okey"], state["ocnt"], keys, need)
    ob_leaves = [leaf.index_select(0, oidxc) for leaf in jax_leaves(state["oval"])]
    ob_m = [state[f].index_select(0, oidxc) for f in ("over", "ovid", "ovseq")]
    # the cold tier for the keys still missing; duplicate lanes look up
    # independently (the same row), only admission dedups
    need_host = need & ~in_ob
    res = lookup(keys, need_host)
    found = res[0] & need_host
    fb_ok = in_ob | found
    adm_leaves = [torch.where(in_ob, o, h.to(o.dtype)) for o, h in zip(ob_leaves, res[4:])]
    m0, m1, m2 = (torch.where(in_ob, o, h) for o, h in zip(ob_m, res[1:4]))
    adm = fb_ok & (segment_rank(keys, fb_ok) == 0)
    got, slot = claim_free_slots(state["used"], adm)
    widx = torch.where(got, slot, K)
    out = dict(state)
    out["key"] = _set_drop(state["key"], widx, keys)
    out["val"] = jax_unflatten(state["val"], [
        _set_drop(t, widx, v) for t, v in zip(jax_leaves(state["val"]), adm_leaves)])
    out["ver"] = _set_drop(state["ver"], widx, m0)
    out["vid"] = _set_drop(state["vid"], widx, m1)
    out["vseq"] = _set_drop(state["vseq"], widx, m2)
    out["used"] = _set_drop(state["used"], widx, torch.ones_like(got))
    out["lap"] = _set_drop(lap, widx, tick)
    out["readmits"] = state["readmits"] + _isum(got)
    return out, jax_unflatten(state["val"], adm_leaves), fb_ok


def join_table_tier_touch(state: dict, keys: torch.Tensor, ok: torch.Tensor) -> dict:
    """Refresh last-access positions for a batch's keys after the upsert
    applied (fresh upserts claimed slots the resolve pass could not see)."""
    K = state["key"].shape[0]
    keys = keys.to(_I32)
    tk = torch.where(state["used"], state["key"], JOIN_KEY_SENTINEL)
    slot, hit = hot_slot(tk, keys, ok.to(torch.bool) & (keys != JOIN_KEY_SENTINEL))
    out = dict(state)
    out["lap"] = _set_drop(state["lap"], torch.where(hit, slot, K), state["tick"])
    return out


def join_table_tier_evict(state: dict, hot_target: int) -> dict:
    """Pressure eviction: when occupancy exceeds ``hot_target``, the coldest
    ``used - hot_target`` keys (by last access, slot index breaking ties) go
    to the spill outbox and their slots are freed, bounded by the outbox's
    free space. Closes the batch by advancing ``tick``."""
    K, S = state["key"].shape[0], state["okey"].shape[0]
    dev = state["key"].device
    used = state["used"]
    need = torch.minimum(torch.clamp(_isum(used) - int(hot_target), min=0),
                         S - state["ocnt"])
    perm = torch.argsort(torch.where(used, state["lap"], _IMAX), stable=True)
    r = torch.arange(K, dtype=_I32, device=dev)
    sel = (r < need) & used.index_select(0, perm)
    opos = torch.where(sel, state["ocnt"] + r, S)
    out = dict(state)
    out["okey"] = _set_drop(state["okey"], opos, state["key"].index_select(0, perm))
    out["oval"] = tree_map(lambda t, src: _set_drop(t, opos, src.index_select(0, perm)),
                           state["oval"], state["val"])
    for o, f in (("over", "ver"), ("ovid", "vid"), ("ovseq", "vseq")):
        out[o] = _set_drop(state[o], opos, state[f].index_select(0, perm))
    cleared = torch.where(sel, perm, K)
    out["used"] = _set_drop(used, cleared, torch.zeros_like(sel))
    out["key"] = _set_drop(state["key"], cleared,
                           torch.full_like(state["key"], JOIN_KEY_SENTINEL))
    n = _isum(sel)
    out["ocnt"] = state["ocnt"] + n
    out["spills"] = state["spills"] + n
    out["tick"] = state["tick"] + 1
    return out


def join_table_tier_stats(state: dict) -> dict:
    """Device-side tier numbers beside :func:`join_table_stats` (a few small
    device-to-host reads): hot occupancy, outbox depth, movement counters."""
    K = int(state["key"].shape[0])
    S = int(state["okey"].shape[0])
    used = int(state["used"].sum())
    return {"hot_slots": K, "hot_used": used, "hot_pct": round(100.0 * used / K, 2),
            "outbox_slots": S, "outbox_depth": int(state["ocnt"]),
            "state_spills": int(state["spills"]),
            "state_readmits": int(state["readmits"])}



register_kernel("lookup", "torch", lookup_plain, reference=True)
register_kernel("lookup", "cuda", lookup_cuda, devices=("cuda",))
register_kernel("join_probe", "torch", join_probe_plain, reference=True)
register_kernel("join_probe", "cuda", join_probe_cuda, devices=("cuda",))

__all__ = ["table_lookup", "table_lookup_many", "LOOKUP_MAX_TABLES", "gather_or_zero",
           "lookup_plain", "lookup_cuda", "lookup_many_plain", "lookup_many_cuda", "take",
           "JOIN_PROBE_MAX_ROWS", "JOIN_PROBE_SMEM_SLOTS", "join_probe",
           "join_probe_plain", "join_probe_cuda", "JOIN_KEY_SENTINEL", "join_table_init",
           "join_table_upsert", "join_table_probe", "join_table_pending",
           "join_table_stats", "count_drops", "hot_slot",
           "outbox_find_last", "claim_free_slots", "join_table_tier_init",
           "join_table_tier_fallback", "join_table_tier_resolve", "join_table_tier_touch",
           "join_table_tier_evict", "join_table_tier_stats"]

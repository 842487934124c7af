"""Table lookups and the stream-table join's key table.

Counterpart of ``windflow_tpu/ops/lookup.py``: :func:`table_lookup` (kernel
K2), :func:`join_probe` (kernel K5) and the versioned JoinTable built on it
(``join_table_*``).

``table_lookup``: ``table[idx]`` for the campaign join and per-key table
reads. On the TPU a gather
is serial, so the JAX package picks a one-hot formulation by table size: a
select-reduce for small tables and a factored one-hot matmul (the Pallas
kernel ``_pallas_factored_lookup``) for 128 < K <= 65536. Both give
``table[idx]`` with 0 for an index outside ``[0, K)``; on a CUDA tensor that
function is the hand-written gather ``csrc/lookup.cu`` (kernel K2), on a CPU
tensor the plain version beside it.

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
from ..batch import tree_leaves, tree_map
from .registry import count_launch

#: C signature of K2's entry point (pointers and the stream as void*)
_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])

#: tables up to this size take the JAX select or factored branch whatever
#: their values
SELECT_MAX_ROWS_2D = 2048
#: the factored path handles tables up to this many rows
FACTORED_MAX_ROWS = 1 << 16


def table_lookup(table: torch.Tensor, idx: torch.Tensor, *,
                 traced: bool = False) -> torch.Tensor:
    """``table[idx]`` with the JAX package's out-of-range semantics for the
    table's size. ``table``: 1-D ``[K]``; ``idx``: i32 ``[C]``. ``traced``:
    route as JAX's jitted chain does, from K and dtype alone (every
    operator's ``apply``); False reads a concrete table's values, as eager
    JAX does."""
    if table.ndim != 1:
        raise NotImplementedError(
            "table_lookup: only 1-D tables are ported so far (2-D state "
            "tables come with the per-key window paths, ROADMAP Queue 1 item 9)")
    K = table.shape[0]
    exact = _exact_dtype if traced else _factored_ok
    if K <= SELECT_MAX_ROWS_2D or (K <= FACTORED_MAX_ROWS and exact(table)):
        return gather_or_zero(table, idx)
    return take(table, idx)


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


def gather_or_zero(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, 0 where ``idx`` is outside ``[0, K)``: K2 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if table.device.type == "cuda":
        return lookup_cuda(table, idx)
    if table.device.type == "cpu":
        return lookup_plain(table, idx)
    raise ValueError(f"table_lookup: unsupported device {table.device}")


def _zero_fix(table: torch.Tensor) -> bool:
    """Whether a select-sum over ``table``'s rows turns ``-0.0`` into ``+0.0``:
    float values, and at least two rows (a one-row sum is the row itself)."""
    return table.dtype.is_floating_point and table.shape[0] >= 2


def _plus_zero(v: torch.Tensor) -> torch.Tensor:
    """``-0.0 -> +0.0``, every other value (NaN included) unchanged."""
    return torch.where(v == 0, torch.zeros((), dtype=v.dtype, device=v.device), v)


def lookup_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    if table.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=table.dtype, device=table.device)
    ok = (idx >= 0) & (idx < table.shape[0])
    g = table.index_select(0, torch.where(ok, idx, 0).long())
    g = torch.where(ok, g, torch.zeros((), dtype=table.dtype, device=table.device))
    return _plus_zero(g) if _zero_fix(table) else g


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
               probe: torch.Tensor, valid: torch.Tensor):
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
    A CUDA tensor goes to kernel K5 (``csrc/join_probe.cu``), a CPU tensor
    to the plain version.

    K5 hashes the table once per call, ``next_pow2(2K)`` slots of
    ``(key, row)`` built with atomics (equal keys share a slot holding their
    first row), then probes it with a persistent grid: O(C) expected
    lookups, not the ``C * K`` compares of the reference. While the slots
    fit in one block's shared memory (:data:`JOIN_PROBE_SMEM_SLOTS`, K <=
    8192) every block copies the table there once; above, the same kernel
    probes the table in device memory through L2. Its bound on the H100 is
    bytes: each lane read and written once and the table read once."""
    if table_keys.device.type == "cuda":
        return join_probe_cuda(table_keys, table_vals, probe, valid)
    if table_keys.device.type == "cpu":
        return join_probe_plain(table_keys, table_vals, probe, valid)
    raise ValueError(f"join_probe: unsupported device {table_keys.device}")


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


def join_table_upsert(state: dict, key, val, ts, tid, ok, *, delay: int = 0) -> dict:
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
    ascending free slot for the entry of rank r."""
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


__all__ = ["table_lookup", "gather_or_zero", "lookup_plain", "lookup_cuda", "take",
           "JOIN_PROBE_MAX_ROWS", "JOIN_PROBE_SMEM_SLOTS", "join_probe",
           "join_probe_plain", "join_probe_cuda", "JOIN_KEY_SENTINEL", "join_table_init",
           "join_table_upsert", "join_table_probe", "join_table_pending",
           "join_table_stats", "count_drops"]

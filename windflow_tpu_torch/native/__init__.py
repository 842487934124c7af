"""The native host runtime: SPSC rings, thread pinning, AoS/SoA framing, key
hashing, and the cold tier's key index.

Counterpart of ``windflow_tpu/native/__init__.py``. The sources are the port's
own copies under ``csrc/`` (``spsc_queue.cpp``, ``ingest.cpp``), and
``host_store.cpp``, the index of ``state/host_store.py``; they are compiled by
``g++`` into one shared library under ``build/native/`` at the repository root
at first use and loaded with ``ctypes``. The file name carries a hash of the
sources and flags, so an edited source rebuilds and a built one is reused.
Nothing here runs at import.

A failed build raises: unlike the JAX package there is no pure-Python deque
standing in for the ring, and no numpy copy standing in for the native pass.
Both machines the port runs on have ``g++`` (``nvcc`` needs it).

ctypes releases the GIL around every native call, so a ring wait or an unpack
does not hold the other stage threads back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")
SOURCES = ("spsc_queue.cpp", "ingest.cpp", "host_store.cpp")

_lock = threading.Lock()
_lib = None

_P = ctypes.POINTER
#: every exported symbol with its signature (None restype = ctypes' c_int)
_SYMBOLS = [
    ("wf_queue_create", ctypes.c_void_p, [ctypes.c_uint64]),
    ("wf_queue_destroy", None, [ctypes.c_void_p]),
    ("wf_queue_push", ctypes.c_int, [ctypes.c_void_p, ctypes.c_uint64]),
    ("wf_queue_pop", ctypes.c_int, [ctypes.c_void_p, _P(ctypes.c_uint64)]),
    ("wf_queue_push_spin", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]),
    ("wf_queue_pop_spin", ctypes.c_int,
     [ctypes.c_void_p, _P(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_uint64]),
    ("wf_queue_size", ctypes.c_uint64, [ctypes.c_void_p]),
    ("wf_pin_thread", ctypes.c_int, [ctypes.c_int]),
    ("wf_hardware_concurrency", ctypes.c_int, []),
    ("wf_queue_selfbench", ctypes.c_double, [ctypes.c_uint64, ctypes.c_uint64]),
    ("wf_unpack_records", None,
     [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
      _P(ctypes.c_uint64), _P(ctypes.c_uint64), _P(ctypes.c_char_p)]),
    ("wf_pack_records", None,
     [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
      _P(ctypes.c_uint64), _P(ctypes.c_uint64), _P(ctypes.c_char_p)]),
    ("wf_hash_str_keys", None,
     [ctypes.c_char_p, _P(ctypes.c_int64), ctypes.c_uint64, ctypes.c_uint32,
      _P(ctypes.c_int32)]),
    ("wf_hash_fixed_str_keys", None,
     [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
      ctypes.c_uint32, _P(ctypes.c_int32)]),
    ("wf_hash_int_keys", None,
     [_P(ctypes.c_int64), ctypes.c_uint64, ctypes.c_uint32, _P(ctypes.c_int32)]),
    # the cold tier's key index (host_store.cpp, state/host_store.py)
    ("wf_hs_upsert", ctypes.c_int64, [ctypes.c_void_p] * 2 + [ctypes.c_int]
     + [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_void_p] * 6
     + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p]),
    ("wf_hs_append", ctypes.c_int64, [ctypes.c_void_p] * 2 + [ctypes.c_int]
     + [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_void_p] * 6
     + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p]),
    ("wf_hs_lookup", ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int]
     + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p]),
    ("wf_hs_fetch", None, [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
     + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]),
    ("wf_hs_remove", None, [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                                    ctypes.c_int64, ctypes.c_void_p,
                                                    ctypes.c_void_p, ctypes.c_int64,
                                                    ctypes.c_void_p]),
    ("wf_hs_reindex", None, [ctypes.c_void_p] * 2 + [ctypes.c_int]
     + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2),
]


def _target() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwfnative-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if its file is missing; returns its path. Raises
    with the compiler's output if the build fails. The build writes to a
    name of its own (pid and thread) and renames it into place, so two
    processes building at once both end with a whole file."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES),
           "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native runtime build failed to run g++: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed (g++ rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    """The bound library, built first if needed (once, under a lock)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, restype, argtypes in _SYMBOLS:
                fn = getattr(lib, name)
                if restype is not None:
                    fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


class SPSCQueue:
    """Bounded single-producer single-consumer queue of Python objects over the
    native ring: the ring moves opaque uint64 tokens and a side table maps
    tokens to objects (batch handles). The producer alone writes a token's
    entry and the consumer alone removes it, so the table needs no lock."""

    def __init__(self, capacity: int = 1024):
        self._lib = _load()
        self._objs = {}
        self._seq = 0
        self._q = self._lib.wf_queue_create(int(capacity))

    def push(self, obj, spin: int = 1024) -> None:
        """Enqueue ``obj``; spins, then yields and later naps (50 µs a
        try), while the ring is full."""
        self._seq += 1
        tok = self._seq
        self._objs[tok] = obj
        self._lib.wf_queue_push_spin(self._q, tok, spin)

    def pop(self, spin: int = 1024, max_yields: int = 1 << 20):
        """``(True, obj)``, or ``(False, None)`` once ``max_yields`` yields
        passed with the ring empty (a 50 µs nap, past the first 64 rounds,
        counts for 16)."""
        tok = ctypes.c_uint64()
        if not self._lib.wf_queue_pop_spin(self._q, ctypes.byref(tok), spin, max_yields):
            return False, None
        return True, self._objs.pop(tok.value)

    def size(self) -> int:
        return int(self._lib.wf_queue_size(self._q))

    def __del__(self):
        if getattr(self, "_q", None) is not None:
            self._lib.wf_queue_destroy(self._q)
            self._q = None


def _field_layout(dt, names):
    nf = len(names)
    offs = (ctypes.c_uint64 * nf)(*[dt.fields[f][1] for f in names])
    szs = (ctypes.c_uint64 * nf)(*[dt.fields[f][0].itemsize for f in names])
    return offs, szs


def _as_cp(addr: int):
    return ctypes.cast(ctypes.c_void_p(addr), ctypes.c_char_p)


def _reshape_subdtypes(outs: dict, dt, n: int) -> dict:
    """Structured subdtype fields (``('f4', (3,))``) come back flat."""
    for f in outs:
        sub = dt.fields[f][0]
        if sub.subdtype is not None:
            outs[f] = outs[f].view(sub.subdtype[0]).reshape((n,) + sub.subdtype[1])
    return outs


def unpack_records(records, fields=None):
    """AoS -> SoA in one native pass: ``records`` is a numpy structured array
    (the framing of network or disk ingest); returns ``{field: contiguous
    column}``. The native counterpart of the reference's per-tuple
    Source/Shipper copy (``wf/source.hpp:184``, ``wf/shipper.hpp:87``). A
    strided (non-contiguous) record view is copied field by field by numpy."""
    import numpy as np
    lib = _load()
    dt = records.dtype
    names = list(fields if fields is not None else dt.names)
    if not records.flags["C_CONTIGUOUS"]:
        return {f: np.ascontiguousarray(records[f]) for f in names}
    n = records.shape[0]
    outs = {f: np.empty(n, dt.fields[f][0]) for f in names}
    offs, szs = _field_layout(dt, names)
    nf = len(names)
    lib.wf_unpack_records(
        records.ctypes.data_as(ctypes.c_char_p), n, dt.itemsize, nf, offs, szs,
        (ctypes.c_char_p * nf)(*[_as_cp(outs[f].ctypes.data) for f in names]))
    return _reshape_subdtypes(outs, dt, n)


def parallel_unpack(records, workers: int = None, fields=None):
    """Sharded AoS -> SoA framing: the record buffer split into ``workers``
    contiguous row slices, each transposed by the native pass in its own
    thread straight into the shared columns at its row offset (no per-slice
    allocation, no concatenation, order kept). ctypes releases the GIL
    around each native call, so the slices unpack at once: the counterpart
    of the reference sweeping 1-14 source threads
    (``wf/source.hpp:284-296``) applied to host framing.

    ``workers=None`` uses :func:`hardware_concurrency`; 1 (or one row, or a
    strided view) is :func:`unpack_records`."""
    import numpy as np
    lib = _load()
    if workers is None:
        workers = hardware_concurrency()
    n = records.shape[0]
    workers = max(1, min(int(workers), n or 1))
    if workers == 1 or not records.flags["C_CONTIGUOUS"]:
        return unpack_records(records, fields)
    dt = records.dtype
    names = list(fields if fields is not None else dt.names)
    outs = {f: np.empty(n, dt.fields[f][0]) for f in names}
    bounds = [round(w * n / workers) for w in range(workers + 1)]
    offs, szs = _field_layout(dt, names)
    nf = len(names)
    errors = []

    def one(lo, hi):
        try:
            if hi > lo:
                # a row of a field's column is the FIELD's itemsize (12 for
                # ('f4', (3,)); the allocated array's base dtype says 4)
                dsts = (ctypes.c_char_p * nf)(*[
                    _as_cp(outs[f].ctypes.data + lo * dt.fields[f][0].itemsize)
                    for f in names])
                lib.wf_unpack_records(_as_cp(records.ctypes.data + lo * dt.itemsize),
                                      hi - lo, dt.itemsize, nf, offs, szs, dsts)
        except BaseException as e:      # noqa: BLE001 — re-raised after the join
            errors.append(e)

    threads = [threading.Thread(target=one, args=(bounds[w], bounds[w + 1]),
                                name="wf-unpack") for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return _reshape_subdtypes(outs, dt, n)


def pack_records(columns: dict, dtype):
    """SoA -> AoS egress (sinks emitting framed records): the inverse of
    :func:`unpack_records`. Every column is checked against its field before
    any copy."""
    import numpy as np
    lib = _load()
    names = list(dtype.names)
    n = len(np.asarray(columns[names[0]]))
    out = np.empty(n, dtype)
    cols = []
    for f in names:
        fdt = dtype.fields[f][0]
        col = np.ascontiguousarray(np.asarray(columns[f]),
                                   fdt.base if fdt.subdtype else fdt)
        if col.nbytes != n * fdt.itemsize:
            raise ValueError(
                f"pack_records: column '{f}' has {col.shape} {col.dtype} "
                f"({col.nbytes} bytes) but field needs {n} x {fdt.itemsize} bytes")
        cols.append(col)                         # keeps the pointers alive
    offs, szs = _field_layout(dtype, names)
    nf = len(names)
    lib.wf_pack_records(
        out.ctypes.data_as(ctypes.c_char_p), n, dtype.itemsize, nf, offs, szs,
        (ctypes.c_char_p * nf)(*[col.ctypes.data_as(ctypes.c_char_p) for col in cols]))
    return out


def hash_keys_native(keys, num_slots: int):
    """Native key -> slot hashing, bit-identical to the scalar arithmetic of
    ``windflow_tpu_torch.batch.hash_key_to_slot``: 32-bit FNV-1a for string
    and bytes arrays, the Knuth uint64 multiply for integer arrays. Returns
    int32 slots of the keys' shape, or None for another dtype (object
    arrays), which the caller hashes key by key."""
    import numpy as np
    lib = _load()
    arr = np.asarray(keys)
    out = np.empty(arr.size, np.int32)
    i32p = out.ctypes.data_as(_P(ctypes.c_int32))
    if arr.dtype.kind in "iu":
        k = np.ascontiguousarray(arr.ravel().astype(np.int64))
        lib.wf_hash_int_keys(k.ctypes.data_as(_P(ctypes.c_int64)), arr.size,
                             num_slots, i32p)
        return out.reshape(arr.shape)
    if arr.dtype.kind == "S":
        a = np.ascontiguousarray(arr.ravel())
        lib.wf_hash_fixed_str_keys(a.ctypes.data_as(ctypes.c_char_p), a.size,
                                   a.dtype.itemsize, a.dtype.itemsize, num_slots, i32p)
        return out.reshape(arr.shape)
    if arr.dtype.kind == "U":
        # batches repeat few keys: hash the distinct ones, scatter back
        uniq, inv = np.unique(arr.ravel(), return_inverse=True)
        enc = [s.encode() for s in uniq.tolist()]
        offsets = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=offsets[1:])
        uout = np.empty(len(enc), np.int32)
        lib.wf_hash_str_keys(b"".join(enc), offsets.ctypes.data_as(_P(ctypes.c_int64)),
                             len(enc), num_slots, uout.ctypes.data_as(_P(ctypes.c_int32)))
        return uout[inv.ravel()].reshape(arr.shape)
    return None


def pin_thread(core: int) -> bool:
    """Pin the calling thread to ``core`` (the reference's default mapping,
    one core a node); False if the OS refused."""
    return _load().wf_pin_thread(int(core)) == 0


def hardware_concurrency() -> int:
    return int(_load().wf_hardware_concurrency())


def native_available() -> bool:
    """True once the library is built and bound; False if it cannot be (the
    reason is raised by every other function of this module)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def queue_selfbench(n: int = 2_000_000, capacity: int = 1024) -> float:
    """Raw ring throughput (tokens/s) measured entirely in C between an
    unpinned producer and consumer thread (``wf_queue_selfbench``): the
    fastest of 16 equal slices of the ``n`` tokens, each timed by the CPU
    time both threads spent on it, so time the scheduler gave to other
    processes does not count. The number the reference's FastFlow SPSC
    queues compete on."""
    return float(_load().wf_queue_selfbench(int(n), int(capacity)))


__all__ = ["SPSCQueue", "build", "hardware_concurrency", "hash_keys_native",
           "native_available", "pack_records", "parallel_unpack", "pin_thread",
           "queue_selfbench", "unpack_records"]

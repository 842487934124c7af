"""Cold-tier keyed store: the host side of the two-tier state layer.

The port's own copy of ``windflow_tpu/state/host_store.py`` (that module
imports no JAX, but the port imports nothing of the JAX package), with the
same semantics, counters and manifests, array for array and row for row.

The device tables of the stateful operators (the JoinTable of
``ops/lookup.py``, the session and top-N slot directories) are fixed in
size; the :class:`HostStore` is where cold keys live between touches, a
growable store of columns keyed by int64 keys:

- **spill in** (``upsert``/``append``): applied by the
  :class:`~windflow_tpu_torch.state.tiered.TieredTable` settle point from the
  copied device outbox;
- **readmission out** (``lookup``/``fetch_multi``): on the CPU a host call
  from inside the step; on the card the kernels of ``ops/csrc/cold_probe.cu``
  (``cold_probe``, ``cold_fetch``), which read the store in mapped host
  memory;
- **watermark compaction** (``compact_below``).

Two shapes: ``unique=True`` (keyed tables: one row a key, last writer wins by
the lexicographic ``(m0, m1, m2)`` meta, so a stale spill never rolls a newer
cold row back) and ``unique=False`` (a multimap: every appended row is kept
until compaction retires it; ``fetch_multi`` returns up to ``rows_per_key``
rows a key, oldest first, without removing them).

Where the JAX store keeps a Python dict from key to row (or list of rows),
this one keeps an open-addressing index (``native/csrc/host_store.cpp``: its
hash, probe order and per-row write and probe passes, each one C call) of
16-byte slots ``{key, head row}``, and a next-row link a multimap row (a
key's rows in append order). A row's value columns sit in one record
(:func:`record_layout`: a multiple of 16 bytes; each column is a strided
numpy view of the records) behind the multimap's link, or behind a unique
store's meta (its low 32 bits, what the probe returns; a unique key has one
row and needs no link), so the card reads a row in as few requests as the
record has 16-byte chunks: q3's record is one. The int64 meta stays on the
host, for the last-writer-wins compare, compaction and the manifest.

With ``device`` a CUDA device, the records live in pinned, mapped host
memory (:class:`~windflow_tpu_torch.ops.cold_probe.MappedBuffer`), and the
index has a mirror in the card's memory, which the kernels walk: a walk
costs device-memory reads, and only a hit's record crosses the host link.
Every C pass that writes slots lists them, and the writer copies just those
slots across with one launch of the ``cold_scatter`` kernel on the current
stream (the chain's, whose next step reads them; the slots staged in a
mapped buffer), with an event behind it: a writer waits for it before it
touches the host index or the staging again. A rebuild of the index
(growth, compaction, a restore) copies the whole slot array from the pinned
host index with one copy, waited for at once (a store is built, grown and
restored on whichever stream is current). A fixed descriptor in the card's
memory holds the mirror's and the records' device addresses, rewritten by a
copy on the current stream when the store grows: a CUDA graph captured
before stays valid. A restore that fits rewrites the current arrays and
mirror in place; the arrays and mirror a grow (or a larger restore) replaces
are freed at once, after a wait on the whole device for the launches that
may still read them (``cudaFreeHost`` may wait for it too): once a
doubling.

Readmissions: the JAX store counts the found lanes of every callback. Here a
host ``lookup`` counts on the host, and the kernel adds its found lanes to a
counter in device memory (:meth:`readmit_counter`) that only the kernel
writes; every read of the counters (``counters``, ``manifest``) folds in
what it gained since the last read (one small copy that waits for the
current stream). ``restore`` resets both. Probes under :meth:`uncounted`
(a warm-up step whose results are dropped) count nothing.

The writers (the settle point, a restore, TopN's EOS drain) run on the chain's
driving thread while no step of that chain runs; one lock guards the store
all the same.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..native import _load as _native

#: initial row capacity; grows geometrically
_INIT_CAP = 256
#: manifest schema version (the JAX store's)
_MANIFEST_VERSION = 1


def _cp(a: np.ndarray):
    return a.ctypes.data


def record_layout(dtypes: Dict[str, np.dtype], shapes: Dict[str, tuple],
                  unique: bool = False) -> Tuple[int, Dict[str, int]]:
    """Bytes a record (a multiple of 16) and each column's byte offset in
    it: first a multimap row's next-row link (int64) or a unique row's meta
    low words (three int32), then the columns from the widest element down,
    each at its element's alignment."""
    offs, off = {}, 12 if unique else 8
    for k in sorted(dtypes, key=lambda c: -dtypes[c].itemsize):
        a = dtypes[k].itemsize
        off = -(-off // a) * a
        offs[k] = off
        off += a * int(np.prod(shapes[k], dtype=np.int64))
    return -(-off // 16) * 16, offs


class HostStore:
    """Growable host-memory column store keyed by int join keys.

    ``cols``: name -> dtype; ``col_shapes``: name -> trailing shape of a row
    (default scalar). ``device``: None keeps the store in ordinary host
    memory; a CUDA device maps it for that card's :func:`cold_probe`."""

    def __init__(self, name: str, cols: Dict[str, np.dtype],
                 col_shapes: Optional[Dict[str, tuple]] = None,
                 unique: bool = True, device=None):
        self.name = name
        self.unique = bool(unique)
        self._dtypes = {k: np.dtype(v) for k, v in cols.items()}
        self._shapes = {k: tuple(col_shapes.get(k, ())) if col_shapes else ()
                        for k in cols}
        self._rec_bytes, self._offs = record_layout(self._dtypes, self._shapes,
                                                     self.unique)
        self.device = None if device is None else torch.device(device)
        self._mapped = self.device is not None and self.device.type == "cuda"
        if self._mapped and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lock = threading.RLock()
        self._bufs = []          # mapped buffers of the current arrays
        self._desc = None
        self._readmit_dev = None
        self._dev_seen = 0       # the device counter's value at the last fold
        self._mirror = None      # the index's slots in the card's memory
        self._staging = None     # mapped (key, head, slot, 0) entries for cold_scatter
        self._upkeep = None      # event after the last copy to the mirror
        #: the mirror's upkeep: cold_scatter launches and whole-index uploads
        self.mirror_scatters = 0
        self.mirror_uploads = 0
        self._uncounted = 0  # wf-lint: single-writer[driver, stage] depth of uncounted() blocks
        if self._mapped:
            from ..ops.cold_probe import DESC_WORDS
            # the descriptor in the card's memory, written from a pinned copy
            self._desc_t = torch.zeros((DESC_WORDS,), dtype=torch.int64, pin_memory=True)
            self._desc = self._desc_t.numpy()
            self._desc_dev = torch.zeros((DESC_WORDS,), dtype=torch.int64, device=self.device)
            self._readmit_dev = torch.zeros((1,), dtype=torch.int64, device=self.device)
            self._scratch_dev = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.spilled_rows = 0        # rows applied from device outboxes
        self.readmitted_rows = 0     # rows handed back to the device tier
        self.compacted_rows = 0      # rows retired by watermark compaction
        self._alloc(_INIT_CAP, 0)

    # -- columns, for the probe ------------------------------------------------------

    @property
    def col_names(self) -> list:
        return list(self._dtypes)

    def torch_dtype(self, col: str) -> torch.dtype:
        return torch.from_numpy(np.zeros((), self._dtypes[col])).dtype

    def col_shape(self, col: str) -> tuple:
        return self._shapes[col]

    @property
    def record_bytes(self) -> int:
        """Bytes of a row's record (its next-row link and value columns)."""
        return self._rec_bytes

    @property
    def mirror(self) -> Optional[torch.Tensor]:
        """The index's slots in the card's memory (int64 ``[slots, 2]``:
        key, head row), which the kernels walk; None without a card."""
        return self._mirror

    def index_slots(self) -> np.ndarray:
        """A copy of the host index's slots (int64 ``[slots, 2]``), what
        :attr:`mirror` holds once the copies in flight have landed."""
        with self._lock:
            return self._idx.copy()

    def descriptor_address(self) -> int:
        """Device address of the descriptor (``ops/csrc/cold_probe.cu``), in
        the card's memory."""
        if not self._mapped:
            raise ValueError(f"HostStore {self.name!r} is not mapped for a card")
        return self._desc_dev.data_ptr()

    def readmit_counter(self) -> torch.Tensor:
        """The device int64 ``[1]`` the kernel adds its found lanes to (a
        scratch counter under :meth:`uncounted`)."""
        if not self._mapped:
            raise ValueError(f"HostStore {self.name!r} is not mapped for a card")
        return self._scratch_dev if self._uncounted else self._readmit_dev

    @contextlib.contextmanager
    def uncounted(self):
        """Probes inside the block count no readmissions: the host lookup
        skips its count and the kernel adds to a scratch counter. For a step
        whose results are dropped (``CompiledChain``'s warm-up)."""
        self._uncounted += 1
        try:
            yield
        finally:
            self._uncounted -= 1

    # -- internals --------------------------------------------------------------------

    def _sync(self) -> None:
        """Wait on the current stream (the chain's, on its driving thread)
        for the launches that may read the mapped arrays. Not a device-wide
        sync."""
        if self._mapped:
            torch.cuda.current_stream(self.device).synchronize()

    def _wait_upkeep(self) -> None:
        """Wait for the last copy to the mirror, which reads the host index
        (and the staging): every writer calls it before it writes them."""
        if self._upkeep is not None:
            self._upkeep.synchronize()
            self._upkeep = None

    def _alloc(self, cap: int, keep: int) -> None:
        """Arrays of ``cap`` rows (an index of ``2 * cap`` slots), the first
        ``keep`` rows copied from the current ones; the index is rebuilt and
        the replaced mapped arrays and mirror are freed."""
        if self._mapped and self._bufs:
            # no launch of any stream reads the descriptor or the old arrays
            torch.cuda.synchronize(self.device)
        self._wait_upkeep()
        bufs: list = []
        lg = max(1, int(2 * cap - 1).bit_length())
        key = np.zeros((cap,), np.int64)
        live = np.zeros((cap,), np.bool_)
        meta = np.zeros((cap, 3), np.int64)
        if self._mapped:
            from ..ops.cold_probe import MappedBuffer
            bufs.append(MappedBuffer(cap * self._rec_bytes))
            rec = bufs[0].array(np.uint8, (cap, self._rec_bytes))
        else:
            rec = np.zeros((cap, self._rec_bytes), np.uint8)
        if keep:
            key[:keep] = self._key[:keep]
            live[:keep] = self._live[:keep]
            meta[:keep] = self._meta[:keep]
            rec[:keep] = self._rec[:keep]
        self._cap, self._lg = cap, lg
        self._key, self._live, self._meta, self._rec = key, live, meta, rec
        head = rec[:, :12].view(np.int32) if self.unique else rec[:, :8].view(np.int64)
        self._nxt = None if self.unique else head[:, 0]
        self._rmeta = head if self.unique else None
        self._cols = {}
        for k, dt in self._dtypes.items():
            o = self._offs[k]
            nb = dt.itemsize * int(np.prod(self._shapes[k], dtype=np.int64))
            self._cols[k] = rec[:, o:o + nb].view(dt).reshape((cap,) + self._shapes[k])
        if self._mapped:
            # the host index pinned, for the whole-index copy to the mirror
            self._idx_t = torch.zeros((1 << lg, 2), dtype=torch.int64, pin_memory=True)
            self._idx = self._idx_t.numpy()
            self._mirror = torch.empty((1 << lg, 2), dtype=torch.int64, device=self.device)
        else:
            self._idx = np.zeros((1 << lg, 2), np.int64)
        self._itail = np.zeros((1 << lg,), np.int64)
        self._n = getattr(self, "_n", 0) if keep else 0
        if self._mapped:
            from ..ops.cold_probe import (DESC_COL0, DESC_LG, DESC_NCOLS, DESC_REC,
                                          DESC_REC_BYTES, DESC_SLOTS)
            d = self._desc
            d[DESC_SLOTS], d[DESC_LG], d[DESC_NCOLS] = self._mirror.data_ptr(), lg, \
                len(self._cols)
            d[DESC_REC], d[DESC_REC_BYTES] = bufs[0].dev, self._rec_bytes
            for c, k in enumerate(self._cols):
                d[DESC_COL0 + 2 * c] = self._offs[k]
                d[DESC_COL0 + 2 * c + 1] = int(np.prod(self._shapes[k], dtype=np.int64)) \
                    * self._dtypes[k].itemsize
            self._desc_dev.copy_(self._desc_t, non_blocking=True)
            self._bufs = bufs    # the replaced buffers are freed here
        self._reindex()

    def _grow(self, need: int) -> None:
        cap = self._cap
        while cap < need:
            cap *= 2
        if cap != self._cap:
            self._alloc(cap, self._n)

    def _index_args(self):
        return (_cp(self._idx), _cp(self._itail), self._lg)

    def _rec_args(self):
        """The C passes' record pointers: next-row links, meta low words,
        the record stride in int64 words."""
        return (None if self._nxt is None else _cp(self._rec),
                None if self._rmeta is None else _cp(self._rec), self._rec_bytes // 8)

    def _reindex(self) -> None:
        self._wait_upkeep()
        nxt, _, ns = self._rec_args()
        _native().wf_hs_reindex(*self._index_args(), _cp(self._key), _cp(self._live), nxt,
                                ns, self._n)
        self._slots_written(None)

    def _slots_written(self, slots: Optional[np.ndarray]) -> None:
        """Bring the card's mirror up to the host index after a C pass that
        wrote ``slots`` (every slot when None): one ``cold_scatter`` of the
        listed slots on the current stream (the chain's, whose next step
        reads the mirror), with an event behind it (:meth:`_wait_upkeep`),
        or one copy of the whole index, waited for. A store without a card
        keeps no mirror."""
        if not self._mapped or (slots is not None and len(slots) == 0):
            return
        stream = torch.cuda.current_stream(self.device)
        if slots is None:
            # waited for at once: a store is built, grown and restored on
            # whichever stream is current, and its readers may run on another
            self._mirror.copy_(self._idx_t, non_blocking=True)
            self.mirror_uploads += 1
            stream.synchronize()
            return
        from ..ops.cold_probe import MappedBuffer, cold_scatter_cuda
        n = len(slots)
        if self._staging is None or self._staging.nbytes < 32 * n:
            size = 32 * max(n, 1 << max(8, (n - 1).bit_length()))
            self._staging = MappedBuffer(size)
            self._staged = self._staging.array(np.int64, (size // 32, 4))
        st = self._staged[:n]
        st[:, :2] = self._idx[slots]
        st[:, 2] = slots
        cold_scatter_cuda(self._mirror, self._staging.dev, n)
        self.mirror_scatters += 1
        ev = torch.cuda.Event()
        ev.record(stream)
        self._upkeep = ev

    def _rebuild(self) -> None:
        """Compact away dead rows (holes) when they dominate the storage."""
        live_idx = np.flatnonzero(self._live[:self._n])
        n = len(live_idx)
        self._key[:n] = self._key[live_idx]
        self._meta[:n] = self._meta[live_idx]
        self._rec[:n] = self._rec[live_idx]
        self._live[:self._n] = False
        self._live[:n] = True
        self._n = n
        self._reindex()

    def _write(self, fn: str, keys, m0, m1, m2, cols: dict, ok) -> int:
        """One C pass of ``upsert``/``append`` over the ok lanes, then each
        written lane's value row copied in (the last writer of a row wins)
        and the slots it wrote copied to the mirror."""
        keys = np.asarray(keys)
        r = len(keys)
        ok = np.ones(r, np.bool_) if ok is None else np.asarray(ok, np.bool_)
        i64 = lambda a: np.ascontiguousarray(np.asarray(a).reshape(r), np.int64)  # noqa: E731
        k64, a, b, c = i64(keys), i64(m0), i64(m1), i64(m2)
        ok = np.ascontiguousarray(ok)
        self._grow(self._n + int(ok.sum()))
        self._wait_upkeep()
        n = np.asarray([self._n], np.int64)
        dest = np.empty(r, np.int64)
        touched, nt = np.empty(max(r, 1), np.int64), np.zeros(1, np.int64)
        done = getattr(_native(), fn)(
            *self._index_args(), _cp(self._key), _cp(self._live), _cp(self._meta),
            *self._rec_args(), _cp(n), _cp(k64), _cp(a), _cp(b), _cp(c),
            _cp(ok.view(np.uint8)), r, _cp(dest), _cp(touched), len(touched), _cp(nt))
        self._n = int(n[0])
        # a new key writes one slot, so the list holds them all
        self._slots_written(touched[:int(nt[0])])
        lanes = np.flatnonzero(dest >= 0)
        rows = dest[lanes]
        # the last lane written to a row wins (lanes apply in order)
        _, last = np.unique(rows[::-1], return_index=True)
        sel = lanes[len(lanes) - 1 - last]
        for k, v in cols.items():
            self._cols[k][dest[sel]] = np.asarray(v)[sel]
        return int(done)

    # -- write side (settle point / spill application) --------------------------------

    def upsert(self, keys, m0, m1, m2, cols: dict, ok=None) -> int:
        """Apply spilled rows, last writer wins per key by ``(m0, m1, m2)``
        (unique mode). Returns the number of rows applied (newer or new)."""
        if not self.unique:
            raise ValueError("upsert is the unique-mode write; use append")
        with self._lock:
            applied = self._write("wf_hs_upsert", keys, m0, m1, m2, cols, ok)
            self.spilled_rows += applied
        return applied

    def append(self, keys, m0, m1, m2, cols: dict, ok=None) -> int:
        """Append rows unconditionally (multimap mode)."""
        if self.unique:
            raise ValueError("append is the multimap write; use upsert")
        with self._lock:
            n = self._write("wf_hs_append", keys, m0, m1, m2, cols, ok)
            self.spilled_rows += n
        return n

    # -- read side --------------------------------------------------------------------

    def lookup(self, keys, want) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Unique-mode probe: ``(found [R] bool, meta [R, 3] int64, cols
        {name: [R, ...]})``, zeros where not found. Rows stay in the store."""
        keys = np.ascontiguousarray(np.asarray(keys), np.int64)
        want = np.ascontiguousarray(np.asarray(want, np.bool_))
        r = len(keys)
        rows = np.empty(r, np.int64)
        with self._lock:
            hits = _native().wf_hs_lookup(_cp(self._idx), self._lg, _cp(keys),
                                          _cp(want.view(np.uint8)), r, _cp(rows))
            found = rows >= 0
            j = rows[found]
            meta = np.zeros((r, 3), np.int64)
            meta[found] = self._meta[j]
            out = {}
            for k, dt in self._dtypes.items():
                out[k] = np.zeros((r,) + self._shapes[k], dt)
                out[k][found] = self._cols[k][j]
            if not self._uncounted:
                self.readmitted_rows += int(hits)
        return found, meta, out

    def fetch_multi(self, keys, want, rows_per_key: int
                    ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Multimap probe: up to ``rows_per_key`` rows a wanted key, ``(mask
        [R, M] bool, meta [R, M, 3], cols {name: [R, M, ...]})``, oldest rows
        first. Rows are not removed and not counted as readmitted."""
        keys = np.ascontiguousarray(np.asarray(keys), np.int64)
        want = np.ascontiguousarray(np.asarray(want, np.bool_))
        r, m = len(keys), int(rows_per_key)
        rows = np.empty((r, m), np.int64)
        with self._lock:
            nxt, _, ns = self._rec_args()
            _native().wf_hs_fetch(_cp(self._idx), self._lg, nxt, ns, _cp(keys),
                                  _cp(want.view(np.uint8)), r, m, _cp(rows))
            mask = rows >= 0
            j = rows[mask]
            meta = np.zeros((r, m, 3), np.int64)
            meta[mask] = self._meta[j]
            out = {}
            for k, dt in self._dtypes.items():
                out[k] = np.zeros((r, m) + self._shapes[k], dt)
                out[k][mask] = self._cols[k][j]
        return mask, meta, out

    def pop_keys(self, max_keys: int) -> Tuple[np.ndarray, dict]:
        """Remove and return up to ``max_keys`` keys' rows in ascending key
        order (unique mode): the EOS drain the tiered TopN flush waves ride.
        Returns ``(keys [n] int64, cols {name: [n, ...]})``."""
        if not self.unique:
            raise ValueError("pop_keys drains a unique-mode store")
        with self._lock:
            keys = np.sort(self._key[:self._n][self._live[:self._n]])[:int(max_keys)]
            keys = np.ascontiguousarray(keys, np.int64)
            rows = np.empty(len(keys), np.int64)
            # a removal empties a slot and moves part of its run back: room
            # for eight moves a key, else the whole index is copied
            touched, nt = np.empty(8 * len(keys) + 64, np.int64), np.zeros(1, np.int64)
            self._wait_upkeep()
            _native().wf_hs_remove(*self._index_args(), _cp(keys), len(keys), _cp(rows),
                                   _cp(touched), len(touched), _cp(nt))
            self._slots_written(touched[:int(nt[0])] if nt[0] >= 0 else None)
            self._live[rows] = False
            out = {k: self._cols[k][rows].copy() for k in self._cols}
        return keys, out

    # -- watermark compaction ---------------------------------------------------------

    def compact_below(self, col: str, threshold: int) -> int:
        """Retire every live row whose ``col`` value (``m0``/``m1``/``m2``:
        the meta triplet; a row's largest element for a column of several)
        is strictly below ``threshold``. Returns the rows retired."""
        removed = 0
        with self._lock:
            n = self._n
            if col in ("m0", "m1", "m2"):
                vals = self._meta[:n, ("m0", "m1", "m2").index(col)]
            else:
                vals = self._cols[col][:n]
            dead = self._live[:n] & (vals.reshape(n, -1).max(axis=1) < threshold
                                     if vals.ndim > 1 else vals < threshold)
            idx = np.flatnonzero(dead)
            if len(idx):
                self._live[idx] = False
                removed = len(idx)
                self._reindex()
                if self._live[:n].sum() * 2 < n:
                    self._rebuild()
            self.compacted_rows += removed
        return removed

    # -- introspection / durability ---------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return int(self._live[:self._n].sum())

    def key_count(self) -> int:
        with self._lock:
            live = self._live[:self._n]
            return int(live.sum()) if self.unique else \
                len(np.unique(self._key[:self._n][live]))

    def _fold_readmits(self) -> None:
        """Add the kernel's found lanes since the last fold to the host count:
        one read of the device counter, which waits for the current stream
        and writes nothing, so a read from another thread cannot race the
        kernel's adds (it may miss the ones still in flight)."""
        if self._readmit_dev is not None:
            n = int(self._readmit_dev.item())
            self.readmitted_rows += n - self._dev_seen
            self._dev_seen = n

    def counters(self) -> dict:
        with self._lock:
            self._fold_readmits()
            return {"state_spills": self.spilled_rows,
                    "state_readmits": self.readmitted_rows,
                    "state_compactions": self.compacted_rows}

    def manifest(self) -> Dict[str, np.ndarray]:
        """Checkpointable snapshot: dense copies of the live rows and the
        counters, the JAX store's arrays in its row order."""
        with self._lock:
            self._fold_readmits()
            live_idx = np.flatnonzero(self._live[:self._n])
            out = {"key": self._key[live_idx].copy(),
                   "meta": self._meta[live_idx].copy(),
                   "counters": np.asarray(
                       [_MANIFEST_VERSION, self.spilled_rows,
                        self.readmitted_rows, self.compacted_rows], np.int64)}
            for k in self._cols:
                out[f"col_{k}"] = self._cols[k][live_idx].copy()
            return out

    def restore(self, manifest: Dict[str, np.ndarray]) -> None:
        """Replace the store content with a :meth:`manifest` snapshot, in the
        current arrays when they hold it; the device readmission counter
        restarts from zero."""
        with self._lock:
            keys = np.asarray(manifest["key"])
            n = len(keys)
            # the failed attempt's launches may still read the arrays
            self._sync()
            cap = max(_INIT_CAP, 1 << max(1, (n - 1).bit_length()))
            if cap > self._cap:
                self._alloc(cap, 0)
            else:
                self._live[:self._n] = False
            self._n = n
            self._key[:n] = keys
            self._live[:n] = True
            self._meta[:n] = np.asarray(manifest["meta"]).reshape(n, 3)
            if self._rmeta is not None:
                self._rmeta[:n] = self._meta[:n].astype(np.int32)
            for k in self._cols:
                self._cols[k][:n] = np.asarray(manifest[f"col_{k}"])
            ctr = np.asarray(manifest.get("counters", np.zeros(4, np.int64)))
            self.spilled_rows = int(ctr[1]) if len(ctr) > 1 else 0
            self.readmitted_rows = int(ctr[2]) if len(ctr) > 2 else 0
            self.compacted_rows = int(ctr[3]) if len(ctr) > 3 else 0
            if self._readmit_dev is not None:
                self._readmit_dev.zero_()
                self._dev_seen = 0
            self._reindex()


__all__ = ["HostStore"]

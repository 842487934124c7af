"""The cold-tier reads of tiered keyed state, and the mapped host memory they read.

A helper kernel (it replaces no TPU kernel): the JAX package reads a tiered
table's cold tier with an ordered ``io_callback`` inside the compiled step
(``JoinTableTier.lookup_cb``, ``SlotTableTier.lookup_cb``). A CUDA graph
cannot call Python, so on the card the step reads the port's
:class:`~windflow_tpu_torch.state.host_store.HostStore` itself: the store
keeps its records in pinned host memory mapped into the card's address space
(:class:`MappedBuffer`) and a mirror of its key index in the card's memory,
and ``csrc/cold_probe.cu`` walks the mirror, a group of threads a lane
(one for a 16-byte record), and reads a hit's record over the host link,
through a fixed descriptor, so a graph captured before the store grew stays
valid. The store keeps the mirror up
with :func:`cold_scatter_cuda` (a third entry point of the same source, a
helper kernel registered as ``cold_scatter``; its plain version
:func:`cold_scatter_plain`): after each write, the slots it wrote, staged
in mapped memory by :func:`stage_slots`, 20 bytes an entry.

:func:`cold_probe` returns what ``HostStore.lookup`` gives for the wanted
lanes, in the form the JAX callbacks hand back: ``(found [R] bool, m0, m1,
m2 [R] int32 (the meta's low 32 bits), one [R, ...] tensor per value column
in the store's column order)``, zeros where a lane is not wanted or its key
is absent. On a CUDA tensor it launches the kernel (the store must be a
unique store mapped on that card, with its mirror: nothing falls back to
the host index); on a CPU tensor it runs the plain version, the store's own
``lookup`` over a synchronous host round trip, which is also what the CPU
path of every tiered operator runs.

:func:`cold_fetch` is the multimap read of the interval join's archive tier
(``ArchiveTier.fetch_cb`` in the JAX package, an ordered ``io_callback``):
up to ``M`` rows a wanted lane's key, oldest first, ``(mask [R, M] bool, one
[R, M, ...] tensor per value column in the store's column order)``, zeros
past a chain's end. On the card it is the second entry point of
``csrc/cold_probe.cu`` (a helper kernel too, registered as ``cold_fetch``),
which finds a key's head row in the mirror and walks the store's next-row
links in mapped memory, a group of threads
a lane reading each row's record (its link and value columns) in 16-byte
chunks (a KB at a time, so a record may be of any width); its plain
version is ``HostStore.fetch_multi``. The fetch is
read-only in both packages: it counts no readmission.

Inside a static-analysis trace (``analysis/progcheck.py``: fake tensors under
the registry's plain selection) both reads give their kernel's outputs
unread, zeros of their shapes, so the traced step is the card's program.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from . import cuda
from .registry import count_launch, on_card, traced

#: value columns the kernel takes (its ``WF_COLD_MAXC``)
MAX_COLS = 16
#: descriptor words (its ``WF_COLD_*``): the index's slots in the card's
#: memory (int64 [2^lg, 2]: key, head row), lg, the column count, the
#: records' base (``state/host_store.py::record_layout``), a record's bytes,
#: then from ``DESC_COL0`` each column's (offset in a record, bytes a row)
DESC_SLOTS = 0
DESC_LG = 1
DESC_NCOLS = 2
DESC_REC = 3
DESC_REC_BYTES = 4
DESC_COL0 = 5
#: int64 words of the descriptor (its ``WF_COLD_DESC``)
DESC_WORDS = DESC_COL0 + 2 * MAX_COLS

_P = ctypes.POINTER
_ALLOC_ARGTYPES = [ctypes.c_longlong, _P(ctypes.c_void_p), _P(ctypes.c_void_p)]
_PROBE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
_SCATTER_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
_FETCH_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _free(host: int) -> None:
    cuda.function("cold_probe", "wf_host_free", [ctypes.c_void_p])(ctypes.c_void_p(host))


class MappedBuffer:
    """``nbytes`` of pinned host memory mapped into the card's address space
    (``cudaHostAlloc(..., cudaHostAllocMapped)`` through ``csrc/cold_probe.cu``):
    :attr:`host` for numpy views, :attr:`dev` for kernels. Freed when
    collected (``cudaFreeHost``), so an owner keeps every buffer a kernel may
    still read."""

    def __init__(self, nbytes: int):
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        fn = cuda.function("cold_probe", "wf_host_alloc", _ALLOC_ARGTYPES)
        cuda.check(fn(int(nbytes), ctypes.byref(host), ctypes.byref(dev)), "wf_host_alloc")
        self.host, self.dev, self.nbytes = host.value, dev.value, int(nbytes)
        self._raw = (ctypes.c_char * max(1, self.nbytes)).from_address(self.host)
        weakref.finalize(self, _free, self.host)

    def array(self, dtype, shape) -> np.ndarray:
        """A zero-filled numpy view of the buffer (it keeps no reference to
        the buffer: the owner does)."""
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64))
        a = np.frombuffer(self._raw, dtype=dt, count=n).reshape(shape)
        a[...] = 0
        return a


def cold_probe(store, keys: torch.Tensor, want: torch.Tensor):
    """The cold tier's row for each wanted lane (see the module docstring):
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if on_card("cold_probe", keys):
        return cold_probe_cuda(store, keys, want)
    if traced(keys):
        return _unread(keys, (), store, [torch.bool] + [torch.int32] * 3)
    if keys.device.type in ("cpu", "cuda"):
        return cold_probe_plain(store, keys, want)
    raise ValueError(f"cold_probe: unsupported device {keys.device}")


def _unread(keys: torch.Tensor, inner: tuple, store, heads: list):
    """A read's outputs unread (zeros ``[R, *inner, ...]``): the heads of
    ``heads`` dtypes, then one tensor per value column."""
    R, dev = keys.shape[0], keys.device
    return (*[torch.zeros((R,) + inner, dtype=dt, device=dev) for dt in heads],
            *[torch.zeros((R,) + inner + tuple(store.col_shape(k)),
                          dtype=store.torch_dtype(k), device=dev)
              for k in store.col_names])


def cold_probe_plain(store, keys: torch.Tensor, want: torch.Tensor):
    """Plain version: ``store.lookup`` on the host (a synchronous round trip;
    it counts the found lanes into the store's readmissions)."""
    found, meta, cols = store.lookup(keys.cpu().numpy(), want.cpu().numpy())
    dev = keys.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(found), t(meta[:, 0].astype(np.int32)), t(meta[:, 1].astype(np.int32)),
            t(meta[:, 2].astype(np.int32)), *[t(cols[k]) for k in store.col_names])


def _check_cuda_args(what: str, store, keys: torch.Tensor, want: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: a store not mapped on the
    keys' card, keys not a contiguous int32 ``[R]`` tensor, want not bool
    ``[R]`` on that card, too many value columns."""
    dev = keys.device
    R = keys.shape[0]
    if keys.dtype != torch.int32 or keys.ndim != 1 or not keys.is_contiguous():
        raise ValueError(f"{what}: keys must be a contiguous int32 [R] tensor, "
                         f"got {keys.dtype} {tuple(keys.shape)}")
    if want.dtype != torch.bool or want.shape != (R,) or want.device != dev \
            or not want.is_contiguous():
        raise ValueError(f"{what}: want must be a contiguous bool [{R}] tensor "
                         f"on {dev}, got {want.dtype} {tuple(want.shape)} on {want.device}")
    if store.device != dev or store.mirror is None:
        raise ValueError(f"{what}: store {store.name!r} is mapped for "
                         f"{store.device} (mirror {store.mirror is not None}), the keys "
                         f"are on {dev}")
    unique = what == "cold_probe_cuda"
    if store.unique != unique:
        raise ValueError(f"{what}: reads a {'unique' if unique else 'multimap'} store's "
                         f"records, {store.name!r} is not one")
    if len(store.col_names) > MAX_COLS:
        raise ValueError(f"{what}: {len(store.col_names)} value columns, the "
                         f"kernel takes {MAX_COLS}")


def cold_probe_cuda(store, keys: torch.Tensor, want: torch.Tensor):
    """Launch ``csrc/cold_probe.cu``'s probe on ``keys``' card; raises on
    anything the kernel does not take (:func:`_check_cuda_args`)."""
    _check_cuda_args("cold_probe_cuda", store, keys, want)
    dev = keys.device
    R = keys.shape[0]

    def empty(dt, shape=()):
        return torch.empty((R,) + tuple(shape), dtype=dt, device=dev)
    found = empty(torch.bool)
    m0, m1, m2 = empty(torch.int32), empty(torch.int32), empty(torch.int32)
    cols = [empty(store.torch_dtype(k), store.col_shape(k)) for k in store.col_names]
    if R == 0:
        return (found, m0, m1, m2, *cols)
    outs = (ctypes.c_void_p * MAX_COLS)(*[c.data_ptr() for c in cols])
    fn = cuda.function("cold_probe", "wf_cold_probe", _PROBE_ARGTYPES)
    count_launch("cold_probe")
    cuda.check(fn(ctypes.c_void_p(store.descriptor_address()), cuda.ptr(keys),
                  cuda.ptr(want), R, store.record_bytes, cuda.ptr(found), cuda.ptr(m0),
                  cuda.ptr(m1),
                  cuda.ptr(m2), outs, len(cols), cuda.ptr(store.readmit_counter()),
                  cuda.stream_ptr(dev)), "cold_probe_cuda")
    return (found, m0, m1, m2, *cols)


#: slot numbers are int32 in the staging: an index copy holds fewer slots
MAX_SCATTER_SLOTS = 1 << 31


def slots_offset(n: int) -> int:
    """Byte offset of the slot numbers in a staging of ``n`` entries: the
    pairs' ``16 n`` bytes rounded up to a 128-byte line (the kernel's
    ``wf_scatter_slots_at``)."""
    return (16 * int(n) + 127) & ~127


def staging_bytes(n: int) -> int:
    """Bytes a staging of ``n`` entries takes (:func:`stage_slots`)."""
    return slots_offset(n) + 4 * int(n)


def stage_slots(idx: np.ndarray, slots: np.ndarray, buf: np.ndarray) -> int:
    """Lay out ``cold_scatter``'s staging of the index ``idx`` (int64 ``[S,
    2]``: key, head row) at ``slots`` in the bytes ``buf`` (uint8, at least
    :func:`staging_bytes` long, 16-byte aligned): ``n`` 16-byte pairs
    ``idx[slots]``, then from the next 128-byte line ``n`` int32 slot
    numbers. Returns ``n``."""
    slots = np.asarray(slots)
    n = len(slots)
    if len(idx) >= MAX_SCATTER_SLOTS:
        raise ValueError(f"stage_slots: an index of {len(idx)} slots; the staging holds "
                         f"int32 slot numbers (under {MAX_SCATTER_SLOTS})")
    if buf.dtype != np.uint8 or buf.ndim != 1 or len(buf) < staging_bytes(n):
        raise ValueError(f"stage_slots: buf must be uint8 bytes, at least "
                         f"{staging_bytes(n)} of them, got {buf.dtype} {buf.shape}")
    o = slots_offset(n)
    buf[:16 * n].view(np.int64).reshape(n, 2)[:] = idx[slots]
    buf[o:o + 4 * n].view(np.int32)[:] = slots
    return n


def cold_scatter_plain(mirror: torch.Tensor, staged: np.ndarray, n: int) -> None:
    """Plain version: one indexed copy of ``n`` staged entries (the bytes
    :func:`stage_slots` wrote) into their slots (the pairs and slot numbers
    copied to the mirror's device first)."""
    o = slots_offset(n)
    pairs = torch.from_numpy(staged[:16 * n].view(np.int64).reshape(n, 2).copy())
    at = torch.from_numpy(staged[o:o + 4 * n].view(np.int32).astype(np.int64))
    mirror[at.to(mirror.device)] = pairs.to(mirror.device)


def cold_scatter_cuda(mirror: torch.Tensor, staging_dev: int, n: int) -> None:
    """Launch ``csrc/cold_probe.cu``'s scatter of ``n`` entries staged in
    mapped memory at device address ``staging_dev`` (:func:`stage_slots`)
    into ``mirror`` on the current stream; raises on a mirror the kernel
    does not take (2^31 slots or more among them) or a misaligned staging."""
    if mirror.dtype != torch.int64 or mirror.ndim != 2 or mirror.shape[1] != 2 \
            or not mirror.is_contiguous() or mirror.device.type != "cuda":
        raise ValueError(f"cold_scatter_cuda: mirror must be a contiguous int64 [S, 2] "
                         f"CUDA tensor, got {mirror.dtype} {tuple(mirror.shape)} on "
                         f"{mirror.device}")
    if mirror.shape[0] >= MAX_SCATTER_SLOTS:
        raise ValueError(f"cold_scatter_cuda: a mirror of {mirror.shape[0]} slots; slot "
                         f"numbers are int32 (under {MAX_SCATTER_SLOTS})")
    if int(staging_dev) % 16:
        raise ValueError(f"cold_scatter_cuda: the staging at {staging_dev:#x} is not "
                         f"16-byte aligned")
    if n <= 0:
        return
    fn = cuda.function("cold_probe", "wf_cold_scatter", _SCATTER_ARGTYPES)
    count_launch("cold_scatter")
    cuda.check(fn(ctypes.c_void_p(staging_dev), int(n), cuda.ptr(mirror),
                  cuda.stream_ptr(mirror.device)), "cold_scatter_cuda")


def cold_fetch(store, keys: torch.Tensor, want: torch.Tensor, rows: int):
    """Up to ``rows`` rows of each wanted lane's key (see the module
    docstring): the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if on_card("cold_fetch", keys):
        return cold_fetch_cuda(store, keys, want, rows)
    if traced(keys):
        return _unread(keys, (int(rows),), store, [torch.bool])
    if keys.device.type in ("cpu", "cuda"):
        return cold_fetch_plain(store, keys, want, rows)
    raise ValueError(f"cold_fetch: unsupported device {keys.device}")


def cold_fetch_plain(store, keys: torch.Tensor, want: torch.Tensor, rows: int):
    """Plain version: ``store.fetch_multi`` on the host (a synchronous round
    trip)."""
    mask, _meta, cols = store.fetch_multi(keys.cpu().numpy(), want.cpu().numpy(),
                                          int(rows))
    dev = keys.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(mask), *[t(cols[k]) for k in store.col_names])


def cold_fetch_cuda(store, keys: torch.Tensor, want: torch.Tensor, rows: int):
    """Launch ``csrc/cold_probe.cu``'s fetch on ``keys``' card; raises on
    anything the kernel does not take (:func:`_check_cuda_args`, ``rows``
    below 1)."""
    _check_cuda_args("cold_fetch_cuda", store, keys, want)
    M = int(rows)
    if M < 1:
        raise ValueError(f"cold_fetch_cuda: rows must be >= 1, got {rows}")
    dev = keys.device
    R = keys.shape[0]
    mask = torch.empty((R, M), dtype=torch.bool, device=dev)
    cols = [torch.empty((R, M) + tuple(store.col_shape(k)), dtype=store.torch_dtype(k),
                        device=dev) for k in store.col_names]
    if R == 0:
        return (mask, *cols)
    outs = (ctypes.c_void_p * MAX_COLS)(*[c.data_ptr() for c in cols])
    fn = cuda.function("cold_probe", "wf_cold_fetch", _FETCH_ARGTYPES)
    count_launch("cold_fetch")
    cuda.check(fn(ctypes.c_void_p(store.descriptor_address()), cuda.ptr(keys),
                  cuda.ptr(want), R, M, store.record_bytes, cuda.ptr(mask), outs, len(cols),
                  cuda.stream_ptr(dev)), "cold_fetch_cuda")
    return (mask, *cols)


__all__ = ["MAX_COLS", "DESC_SLOTS", "DESC_LG", "DESC_NCOLS", "DESC_REC", "DESC_REC_BYTES",
           "DESC_COL0", "DESC_WORDS", "MappedBuffer",
           "cold_probe", "cold_probe_plain", "cold_probe_cuda", "MAX_SCATTER_SLOTS",
           "slots_offset", "staging_bytes", "stage_slots", "cold_scatter_plain",
           "cold_scatter_cuda", "cold_fetch", "cold_fetch_plain",
           "cold_fetch_cuda"]

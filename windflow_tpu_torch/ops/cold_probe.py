"""The cold-tier reads of tiered keyed state, and the mapped host memory they read.

A helper kernel (it replaces no TPU kernel): the JAX package reads a tiered
table's cold tier with an ordered ``io_callback`` inside the compiled step
(``JoinTableTier.lookup_cb``, ``SlotTableTier.lookup_cb``). A CUDA graph
cannot call Python, so on the card the step reads the port's
:class:`~windflow_tpu_torch.state.host_store.HostStore` itself: the store
keeps its key index, meta and value columns in pinned host memory mapped
into the card's address space (:class:`MappedBuffer`), and
``csrc/cold_probe.cu`` probes them, one thread a lane, through a fixed
descriptor, so a graph captured before the store grew stays valid.

:func:`cold_probe` returns what ``HostStore.lookup`` gives for the wanted
lanes, in the form the JAX callbacks hand back: ``(found [R] bool, m0, m1,
m2 [R] int32 (the meta's low 32 bits), one [R, ...] tensor per value column
in the store's column order)``, zeros where a lane is not wanted or its key
is absent. On a CUDA tensor it launches the kernel (the store must be mapped
on that card); on a CPU tensor it runs the plain version, the store's own
``lookup`` over a synchronous host round trip, which is also what the CPU
path of every tiered operator runs.

:func:`cold_fetch` is the multimap read of the interval join's archive tier
(``ArchiveTier.fetch_cb`` in the JAX package, an ordered ``io_callback``):
up to ``M`` rows a wanted lane's key, oldest first, ``(mask [R, M] bool, one
[R, M, ...] tensor per value column in the store's column order)``, zeros
past a chain's end. On the card it is the second entry point of
``csrc/cold_probe.cu`` (a helper kernel too, registered as ``cold_fetch``),
which walks the store's next-row links in mapped memory; its plain version is
``HostStore.fetch_multi``. The fetch is read-only in both packages: it counts
no readmission.

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
#: descriptor word of the next-row links (its ``WF_COLD_NXT``) and of the
#: first column's base (its ``WF_COLD_COL0``)
DESC_NXT = 5
DESC_COL0 = 6
#: int64 words of the descriptor (its ``WF_COLD_DESC``): index keys, index
#: heads, lg, meta, column count, next-row links, then (base, bytes a row) a
#: column
DESC_WORDS = DESC_COL0 + 2 * MAX_COLS

_P = ctypes.POINTER
_ALLOC_ARGTYPES = [ctypes.c_longlong, _P(ctypes.c_void_p), _P(ctypes.c_void_p)]
_PROBE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
_FETCH_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
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
    if store.device != dev:
        raise ValueError(f"{what}: store {store.name!r} is mapped for "
                         f"{store.device}, the keys are on {dev}")
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
                  cuda.ptr(want), R, cuda.ptr(found), cuda.ptr(m0), cuda.ptr(m1),
                  cuda.ptr(m2), outs, len(cols), cuda.ptr(store.readmit_counter()),
                  cuda.stream_ptr(dev)), "cold_probe_cuda")
    return (found, m0, m1, m2, *cols)


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
                  cuda.ptr(want), R, M, cuda.ptr(mask), outs, len(cols),
                  cuda.stream_ptr(dev)), "cold_fetch_cuda")
    return (mask, *cols)


__all__ = ["MAX_COLS", "DESC_NXT", "DESC_COL0", "DESC_WORDS", "MappedBuffer",
           "cold_probe", "cold_probe_plain", "cold_probe_cuda", "cold_fetch",
           "cold_fetch_plain", "cold_fetch_cuda"]

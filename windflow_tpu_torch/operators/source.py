"""Source — stream generation.

Counterpart of ``windflow_tpu/operators/source.py`` (reference ``wf/source.hpp``):

- :class:`DeviceSource`: ``f(i) -> payload`` runs under ``torch.func.vmap``
  over the global tuple index tensor, so a batch is generated on the device
  with no host-to-device traffic. Both reference flavours are deduced from the
  signature: itemized ``f(i) -> payload`` (``bool(tuple_t&)``) and loop
  ``f(i, shipper)`` (``bool(Shipper&)``), which pushes 0..``max_fanout``
  tuples per index through a :class:`~windflow_tpu_torch.shipper.Shipper`.
  ``key_fn(i)`` and ``ts_fn(i)`` set the control fields (``setControlFields``).
- :class:`GeneratorSource`: a host iterator of numpy payloads, framed into
  fixed-capacity batches on the host and copied to the device once a batch
  (pinned memory, ``non_blocking``, on a CUDA device). Arbitrary keys hash
  into slots with ``hash_key_to_slot``.

- :class:`RecordSource`: a host iterator of numpy structured arrays (AoS
  records, the framing of network and disk streams), transposed to SoA
  columns by one native pass (``native/``), optionally sharded over
  ``framing_workers`` threads.
- :func:`prefetch_to_device` / :meth:`SourceBase.batches_prefetched`: a
  worker thread frames and copies batches ahead of the consumer, on a CUDA
  stream of its own, and hands each over behind an event
  (``runtime/handoff.py``).

The index is ``int32`` (:data:`CTRL_DTYPE`), exactly as in the JAX package:
index arithmetic in user functions (YSB's ``(i * 7919) % N_ADS``) wraps at
2^31 the same way, so the two packages generate the same stream.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..basic import routing_modes_t, DEFAULT_BATCH_SIZE
from ..batch import (Batch, CTRL_DTYPE, abstract_spec, hash_key_to_slot, spec_of,
                     tree_leaves, tree_map, vmap_lanes)
from ..context import RuntimeContext
from ..meta import classify_source_flavour
from .base import Basic_Operator

_I32_MAX = torch.iinfo(CTRL_DTYPE).max


def prefetch_to_device(batches: Iterator[Batch], depth: int = 3, pause_event=None,
                       device=None) -> Iterator[Batch]:
    """Overlapped ingest: a worker thread (``wf-prefetch``) pulls ``batches``
    (each ``next`` frames a batch on the host and copies it to the card, or
    generates it there) and keeps up to ``depth`` of them ready in a bounded
    queue, so the copy of batch N+1 overlaps the work on batch N. The
    reference GPU operators' pinned-buffer ``cudaMemcpyAsync`` and double
    buffering (``wf/map_gpu_node.hpp:224-340``) at the source boundary.

    On the card (``device``, None = ``"cuda"``) the worker runs on a CUDA
    stream of its own: its copies come from pinned memory on that stream,
    and each batch is handed over behind an event that the consumer's
    stream waits on (``runtime/handoff.py``). An exception in the worker is
    raised at the consumer. While ``pause_event`` (a ``threading.Event``) is
    set the worker pulls nothing new. Closing the generator early, or
    exhausting it, stops the worker."""
    import queue
    import threading
    from contextlib import nullcontext
    from ..device import resolve_device
    from ..runtime.handoff import receive, send

    dev = resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
    END, ERR = object(), object()
    stop = threading.Event()        # the consumer is gone: the worker exits

    def put_guarded(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            with torch.cuda.stream(stream) if stream is not None else nullcontext():
                it = iter(batches)
                while True:
                    while (pause_event is not None and pause_event.is_set()
                           and not stop.is_set()):
                        time.sleep(0.001)
                    if stop.is_set():
                        return
                    try:
                        b = next(it)
                    except StopIteration:
                        break
                    if not put_guarded(send(b)):
                        return
            put_guarded(END)
        except BaseException as e:      # noqa: BLE001 — raised at the consumer
            put_guarded((ERR, e))

    threading.Thread(target=worker, daemon=True, name="wf-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if item[0] is ERR:
                raise item[1]
            yield receive(item)
    finally:
        # on exhaustion and on an early close alike: the worker stops, and
        # the batches still queued are dropped
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


class SourceBase(Basic_Operator):
    routing = routing_modes_t.NONE

    def batches(self, batch_size: int, cursor=None) -> Iterator[Batch]:
        """The stream as device batches. ``cursor`` is a resume token
        returned by :meth:`cursor`."""
        raise NotImplementedError

    def batches_prefetched(self, batch_size: int = DEFAULT_BATCH_SIZE, depth: int = 3,
                           pause_event=None) -> Iterator[Batch]:
        """The stream of :meth:`batches`, framed and copied (a host source)
        or generated (a device source) in a worker thread up to ``depth``
        batches ahead of the consumer (:func:`prefetch_to_device`)."""
        host_iter = getattr(self, "_host_batches", None)
        src = ((self._to_device(hb) for hb in host_iter(batch_size)) if host_iter
               else self.batches(batch_size))
        return prefetch_to_device(src, depth, pause_event=pause_event, device=self.device)

    def out_capacity(self, batch_size: int) -> int:
        """Capacity of emitted batches (a loop source expands by its fan-out)."""
        return batch_size

    def payload_spec(self) -> Any:
        raise NotImplementedError

    def _ingest_key(self, key):
        """Key -> slot policy of the host sources: hash into ``[0, num_keys)``
        when ``num_keys`` is set (``hash(key) % n``); otherwise keys must
        already be integer slot indices."""
        if key is None:
            return None
        num_keys = getattr(self, "num_keys", None)
        if num_keys is not None:
            return hash_key_to_slot(key, num_keys)
        arr = np.asarray(key)
        if arr.dtype.kind not in "iu":
            raise TypeError(
                f"{self.name}: non-integer keys (dtype {arr.dtype}) require "
                f"num_keys=N to hash them into key slots")
        return arr

    def _open_seek(self, cursor):
        """Host-source resume from a token ``{"batch": k, "next_id": id}``: a
        factory declaring a parameter named ``from_batch`` is called with
        ``k``; any other is replayed with its first ``k`` items skipped,
        unframed. Returns (items to skip, iterator) and primes the counters
        :meth:`cursor` reads."""
        tok = cursor or {}
        skip = int(tok.get("batch", 0))
        self._emitted = skip
        self._next_id = int(tok.get("next_id", 0))
        if skip:
            try:
                if "from_batch" in inspect.signature(self.it_factory).parameters:
                    return 0, self.it_factory(from_batch=skip)
            except (TypeError, ValueError):
                pass
        return skip, self.it_factory()

    def cursor(self):
        """Resume token at a batch boundary (None before the first batch)."""
        if not getattr(self, "_emitted", 0):
            return None
        return {"batch": self._emitted, "next_id": getattr(self, "_next_id", 0)}

    def _frame(self, payload, key, ts, n: int, batch_size: int, next_id: int) -> dict:
        """Host framing: every column zero-padded to ``batch_size``,
        progressive ids, the tail masked. Returns numpy arrays
        ``{"key", "id", "ts", "payload", "valid"}``."""
        if n > batch_size:
            raise ValueError(f"{self.name}: chunk of {n} tuples > batch_size={batch_size}")
        pad = batch_size - n

        def pad_to(a):
            a = np.asarray(a)
            return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
        ids = np.arange(next_id, next_id + batch_size, dtype=np.int32)
        return {"key": (pad_to(key).astype(np.int32) if key is not None
                        else np.zeros(batch_size, np.int32)),
                "id": ids,
                "ts": pad_to(ts).astype(np.int32) if ts is not None else ids,
                "payload": tree_map(pad_to, payload),
                "valid": np.arange(batch_size) < n}

    def _to_device(self, host: dict) -> Batch:
        """One host-to-device copy of a framed batch: from pinned memory,
        ``non_blocking``, on the current stream of a CUDA device; plain
        tensors on the CPU."""
        cuda = self.device.type == "cuda"

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if cuda:
                return t.pin_memory().to(self.device, non_blocking=True)
            return t
        return Batch(key=put(host["key"]), id=put(host["id"]), ts=put(host["ts"]),
                     payload=tree_map(put, host["payload"]), valid=put(host["valid"]))


class DeviceSource(SourceBase):
    """Synthetic on-device source: ``payload = vmap(f)(global_index)``
    (itemized), or the pushes of ``f(i, shipper)`` stacked into
    ``max_fanout`` slots an index (loop; ``when=`` masks make the number of
    tuples an index emits data-dependent at a fixed shape)."""

    def __init__(self, fn: Callable, total: int, *, name: str = "source",
                 parallelism: int = 1, key_fn: Callable = None, ts_fn: Callable = None,
                 num_keys: int = 1, max_fanout: int = 4,
                 context: Optional[RuntimeContext] = None, device=None):
        super().__init__(name, parallelism, device)
        self.fn = fn
        self.is_loop, self.is_rich = classify_source_flavour(fn)
        self.total = int(total)
        self.key_fn = key_fn
        self.ts_fn = ts_fn
        self.num_keys = num_keys
        self.max_fanout = int(max_fanout)
        self.context = context or RuntimeContext(parallelism, 0)

    def out_capacity(self, batch_size: int) -> int:
        return batch_size * self.max_fanout if self.is_loop else batch_size

    def _payload_fn(self):
        return (lambda x: self.fn(x, self.context)) if self.is_rich else self.fn

    def _loop_one(self, i, key, ts):
        """Loop flavour, one index: its pushes stacked into ``max_fanout``
        slots (payload ``[F, ...]``, when, key and ts ``[F]``); unused slots
        repeat the first push, masked off."""
        from ..shipper import Shipper
        sh = Shipper(self.max_fanout)
        if self.is_rich:
            self.fn(i, sh, self.context)
        else:
            self.fn(i, sh)
        payloads, whens, keys, tss = sh._recorded()
        n = len(payloads)
        if n == 0:
            raise ValueError(f"{self.name}: loop source pushed nothing (need >=1 "
                             f"push; use when=False for no-emit)")
        F = self.max_fanout
        as_i32 = lambda x: torch.as_tensor(x, device=i.device).to(CTRL_DTYPE)  # noqa: E731
        pay = payloads + [payloads[0]] * (F - n)
        whn = ([torch.as_tensor(w, device=i.device) for w in whens]
               + [torch.zeros((), dtype=torch.bool, device=i.device)] * (F - n))
        ks = [as_i32(key if k is None else k) for k in keys] + [as_i32(key)] * (F - n)
        xs = [as_i32(ts if x is None else x) for x in tss] + [as_i32(ts)] * (F - n)
        return (tree_map(lambda *ls: torch.stack(ls), *pay), torch.stack(whn),
                torch.stack(ks), torch.stack(xs))

    def make_batch(self, start, batch_size: int) -> Batch:
        """The batch of global indices ``[start, start + batch_size)``;
        ``start`` is an int or an int32 device scalar (the device cursor).
        It launches under ``LAUNCH_GATE.shared()`` (F30)."""
        from ..runtime.graphs import LAUNCH_GATE
        with LAUNCH_GATE.shared():
            return self._make_batch(start, batch_size)

    def _make_batch(self, start, batch_size: int) -> Batch:
        start = torch.as_tensor(start, dtype=CTRL_DTYPE, device=self.device)
        i = start + torch.arange(batch_size, dtype=CTRL_DTYPE, device=self.device)
        if self.key_fn is not None:
            key = vmap_lanes(self.key_fn, i).to(CTRL_DTYPE)
        elif self.num_keys > 1:
            key = i % self.num_keys
        else:
            key = torch.zeros_like(i)
        ts = vmap_lanes(self.ts_fn, i).to(CTRL_DTYPE) if self.ts_fn else i
        valid = i < self.total
        if self.is_loop:
            F = self.max_fanout
            pay, when, ks, xs = vmap_lanes(self._loop_one, i, key, ts)
            flat = lambda a: a.reshape((batch_size * F,) + tuple(a.shape[2:]))  # noqa: E731
            fan = torch.arange(F, dtype=CTRL_DTYPE, device=self.device)
            return Batch(key=flat(ks), id=flat(i[:, None] * F + fan[None, :]),
                         ts=flat(xs), payload=tree_map(flat, pay),
                         valid=flat(when.to(torch.bool) & valid[:, None]))
        payload = vmap_lanes(self._payload_fn(), i)
        return Batch(key=key, id=i, ts=ts, payload=payload, valid=valid)

    def payload_spec(self):
        def build(dev):
            i = torch.zeros((1,), dtype=CTRL_DTYPE, device=dev)
            if self.is_loop:                                   # drop the fan-out axis
                return tree_map(lambda a: a[:, 0], vmap_lanes(self._loop_one, i, i, i)[0])
            return vmap_lanes(self._payload_fn(), i)
        return abstract_spec(build)

    def batches(self, batch_size: int = DEFAULT_BATCH_SIZE, cursor=None):
        """The stream as device batches. The cursor is a device scalar advanced
        on the device: no host-to-device copy per batch. ``cursor`` (a batch
        count, :meth:`cursor`'s token) resumes by index arithmetic."""
        if self.total > _I32_MAX:
            raise ValueError(
                f"DeviceSource total={self.total} exceeds the i32 control dtype "
                f"({_I32_MAX}); chunk the stream into multiple sources/runs")
        self._pos = int(cursor or 0)
        cur = torch.full((), self._pos * batch_size, dtype=CTRL_DTYPE, device=self.device)
        for _ in range(self._pos * batch_size, self.total, batch_size):
            self._pos += 1              # before the yield: cursor() counts this batch
            b = self.make_batch(cur, batch_size)
            cur = cur + batch_size
            yield b

    def cursor(self):
        return getattr(self, "_pos", 0)


class GeneratorSource(SourceBase):
    """Host source: ``it_factory()`` yields payload pytrees (numpy arrays of
    equal leading size <= batch_size) or ``(payload, key, ts)`` triples.
    ``spec`` is the per-tuple payload spec (tensors or numpy arrays without
    the capacity axis; only shape and dtype are read).

    Arbitrary keys (strings, large or sparse ints): pass ``num_keys`` to hash
    every key into ``[0, num_keys)`` at ingest (``hash(key) % n``). Without
    ``num_keys``, keys must already be integer slot indices."""

    def __init__(self, it_factory: Callable[[], Iterator], spec: Any, *,
                 name: str = "source", parallelism: int = 1,
                 num_keys: Optional[int] = None, device=None):
        super().__init__(name, parallelism, device)
        self.it_factory = it_factory
        self._spec = spec_of(tree_map(
            lambda a: torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                                      else a)[None], spec))
        self.num_keys = num_keys

    def payload_spec(self):
        return self._spec

    def _host_batches(self, batch_size: int = DEFAULT_BATCH_SIZE, cursor=None):
        skip, it = self._open_seek(cursor)
        for i, item in enumerate(it):
            if i < skip:        # replay skip: no framing, no transfer
                continue
            self._emitted += 1
            if isinstance(item, tuple) and len(item) == 3:
                payload, key, ts = item
                key = self._ingest_key(key)
            else:
                payload, key, ts = item, None, None
            n = np.shape(tree_leaves(payload)[0])[0]
            nid = self._next_id          # counters move before the yield
            self._next_id += n
            yield self._frame(payload, key, ts, n, batch_size, nid)

    def batches(self, batch_size: int = DEFAULT_BATCH_SIZE, cursor=None):
        for hb in self._host_batches(batch_size, cursor=cursor):
            yield self._to_device(hb)


class RecordSource(SourceBase):
    """AoS record ingest: ``it_factory()`` yields numpy *structured arrays*
    (one record a row, the framing of network and disk streams), each
    transposed to SoA columns in one native pass
    (``native/csrc/ingest.cpp::wf_unpack_records``, the counterpart of the
    reference's per-tuple Source/Shipper copy, ``wf/source.hpp:184``).
    Control fields come from named record fields: ``key_field`` (hashed
    into ``[0, num_keys)`` when ``num_keys`` is set, else integer slots) and
    ``ts_field`` (default: the tuple index). The other fields are the
    payload, numeric or bool only. ``framing_workers > 1`` shards the
    transpose over threads (``native.parallel_unpack``); None means
    ``hardware_concurrency()``. A factory with a ``from_batch`` parameter
    resumes from a :meth:`cursor` token without replaying."""

    def __init__(self, it_factory: Callable[[], Iterator[np.ndarray]],
                 record_dtype: np.dtype, *, key_field: Optional[str] = None,
                 ts_field: Optional[str] = None, num_keys: Optional[int] = None,
                 name: str = "record_source", parallelism: int = 1,
                 framing_workers: Optional[int] = 1, device=None):
        super().__init__(name, parallelism, device)
        self.it_factory = it_factory
        self.framing_workers = framing_workers
        self.dtype = np.dtype(record_dtype)
        for role, fname in (("key_field", key_field), ("ts_field", ts_field)):
            if fname is not None and fname not in (self.dtype.names or ()):
                raise ValueError(f"{name}: {role}='{fname}' is not a field of "
                                 f"{self.dtype} (fields: {self.dtype.names})")
        self.key_field = key_field
        self.ts_field = ts_field
        self.num_keys = num_keys
        self.payload_fields = [f for f in self.dtype.names
                               if f not in (key_field, ts_field)]
        if not self.payload_fields:
            raise ValueError(f"{name}: no payload fields left in {self.dtype}")
        for f in self.payload_fields:
            fdt = self.dtype.fields[f][0]
            base = fdt.subdtype[0] if fdt.subdtype else fdt
            if base.kind not in "biufc":
                raise TypeError(
                    f"{name}: payload field '{f}' has dtype {base}: only numeric or "
                    f"bool fields can become device tensors (route string fields "
                    f"through key_field=, or drop them from the record dtype)")

    def payload_spec(self):
        spec = {}
        for f in self.payload_fields:
            fdt = self.dtype.fields[f][0]
            base, shape = (fdt.subdtype if fdt.subdtype else (fdt, ()))
            dtype = torch.from_numpy(np.zeros(0, base)).dtype
            spec[f] = torch.empty(tuple(shape), dtype=dtype, device="meta")
        return spec

    def _host_batches(self, batch_size: int = DEFAULT_BATCH_SIZE, cursor=None):
        from ..native import parallel_unpack, unpack_records
        if self.framing_workers == 1:
            unpack = unpack_records
        else:
            unpack = lambda r: parallel_unpack(r, workers=self.framing_workers)  # noqa: E731
        skip, it = self._open_seek(cursor)
        for i, rec in enumerate(it):
            if i < skip:        # replay skip: no unpack, no framing
                continue
            self._emitted += 1
            rec = np.asarray(rec, self.dtype)
            n = rec.shape[0]
            cols = unpack(rec)
            key = self._ingest_key(cols[self.key_field]) if self.key_field else None
            ts = cols[self.ts_field] if self.ts_field else None
            payload = {f: cols[f] for f in self.payload_fields}
            nid = self._next_id          # counters move before the yield
            self._next_id += n
            yield self._frame(payload, key, ts, n, batch_size, nid)

    def batches(self, batch_size: int = DEFAULT_BATCH_SIZE, cursor=None):
        for hb in self._host_batches(batch_size, cursor=cursor):
            yield self._to_device(hb)


# reference-style alias
Source = DeviceSource

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

``RecordSource`` and the prefetching ingest thread are not ported (ROADMAP
Queue 1 item 10b).

The index is ``int32`` (:data:`CTRL_DTYPE`), exactly as in the JAX package:
index arithmetic in user functions (YSB's ``(i * 7919) % N_ADS``) wraps at
2^31 the same way, so the two packages generate the same stream.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..basic import routing_modes_t, DEFAULT_BATCH_SIZE
from ..batch import (Batch, CTRL_DTYPE, hash_key_to_slot, spec_of, tree_leaves,
                     tree_map, vmap_lanes)
from ..context import RuntimeContext
from ..meta import classify_source_flavour
from .base import Basic_Operator

_I32_MAX = torch.iinfo(CTRL_DTYPE).max


class SourceBase(Basic_Operator):
    routing = routing_modes_t.NONE

    def batches(self, batch_size: int, cursor=None) -> Iterator[Batch]:
        """The stream as device batches. ``cursor`` is a resume token
        returned by :meth:`cursor`."""
        raise NotImplementedError

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
        ``non_blocking``, on a CUDA device; plain tensors on the CPU."""
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
        ``start`` is an int or an int32 device scalar (the device cursor)."""
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
        i = torch.zeros((1,), dtype=CTRL_DTYPE, device=self.device)
        if self.is_loop:
            pay = vmap_lanes(self._loop_one, i, i, i)[0]
            return spec_of(tree_map(lambda a: a[:, 0], pay))   # drop the fan-out axis
        return spec_of(vmap_lanes(self._payload_fn(), i))

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


# reference-style alias
Source = DeviceSource

"""The micro-batch: the unit of data flow in the port.

Counterpart of ``windflow_tpu/batch.py``. The stream is a sequence of
fixed-capacity structure-of-arrays :class:`Batch` values:

- ``key``/``id``/``ts`` are the reference's tuple control fields
  ``getControlFields() -> (key, id, ts)`` lifted to ``int32`` tensors
  (:data:`CTRL_DTYPE`; the source's index arithmetic must wrap exactly as the
  JAX package's does, so these never widen to int64).
- ``payload`` is a pytree (dict / list / tuple) of ``[C, ...]`` tensors.
- ``valid`` is the occupancy mask: fixed capacity + mask keeps every shape static.

Per-tuple user functions receive a :class:`TupleRef` and run under
``torch.func.vmap`` (:func:`map_tuples`), the counterpart of the JAX package's
``jax.vmap`` over ``tuple_refs``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

#: dtype of the (key, id, ts) control fields
CTRL_DTYPE = torch.int32

#: Host-side sidecar metadata (a trace id): it rides on the Python Batch object
#: under this attribute, set with ``object.__setattr__`` on the frozen
#: dataclass and never as a field, so it changes no tensor. The port carries
#: it only; causal tracing itself is not ported (ROADMAP Queue 1 item 16).
#: ``dataclasses.replace``, ``split_batch`` and ``concat_batches`` build new
#: objects and drop it.
TRACE_META_ATTR = "_wf_trace"


def trace_meta(batch):
    """The batch's host-side trace metadata, or None."""
    return getattr(batch, TRACE_META_ATTR, None)


# --------------------------------------------------------------- pytrees

def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and matching ``rest`` trees).
    Containers: dict, list, tuple; ``None`` is an empty subtree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


# ----------------------------------------------------------------- Batch

@dataclasses.dataclass(frozen=True)
class Batch:
    """Fixed-capacity SoA micro-batch of tuples. Lanes where ``valid`` is False
    are padding: operators ignore them."""

    key: torch.Tensor      # i32[C] — key slot in [0, max_keys)
    id: torch.Tensor       # i32[C] — per-key progressive id
    ts: torch.Tensor       # i32[C] — timestamp
    payload: Any           # pytree of [C, ...] tensors
    valid: torch.Tensor    # bool[C]

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key.device

    @staticmethod
    def empty(capacity: int, payload_spec: Any, device) -> "Batch":
        """An all-invalid batch. ``payload_spec`` is a pytree of per-tuple
        spec tensors (any device; only shape and dtype are read)."""
        def mk(spec):
            return torch.zeros((capacity,) + tuple(spec.shape), dtype=spec.dtype,
                               device=device)
        z = lambda: torch.zeros((capacity,), dtype=CTRL_DTYPE, device=device)  # noqa: E731
        return Batch(key=z(), id=z(), ts=z(), payload=tree_map(mk, payload_spec),
                     valid=torch.zeros((capacity,), dtype=torch.bool, device=device))

    @staticmethod
    def of(payload: Any, key=None, id=None, ts=None, valid=None, *,
           device) -> "Batch":
        """Build a batch from payload arrays (numpy or tensors) on ``device``."""
        as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
        payload = tree_map(as_t, payload)
        leaves = tree_leaves(payload)
        if not leaves:
            raise ValueError("payload must contain at least one array")
        c = leaves[0].shape[0]
        z = torch.zeros((c,), dtype=CTRL_DTYPE, device=device)
        ctrl = lambda a: z if a is None else as_t(a, CTRL_DTYPE)  # noqa: E731
        return Batch(key=ctrl(key), id=ctrl(id), ts=ctrl(ts), payload=payload,
                     valid=(torch.ones((c,), dtype=torch.bool, device=device)
                            if valid is None else as_t(valid, torch.bool)))

    def replace(self, **kw) -> "Batch":
        return dataclasses.replace(self, **kw)

    def with_payload(self, payload: Any) -> "Batch":
        return dataclasses.replace(self, payload=payload)

    def mask(self, keep: torch.Tensor) -> "Batch":
        """Intersect the validity mask with ``keep`` (the Filter primitive)."""
        return dataclasses.replace(self, valid=self.valid & keep)

    def count(self) -> torch.Tensor:
        """Number of live tuples (an int32 device scalar)."""
        return self.valid.sum(dtype=torch.int32)

    def take(self, order: torch.Tensor, valid: torch.Tensor = None) -> "Batch":
        """Lanes ``order`` of every field; ``valid`` replaces the gathered mask."""
        take = lambda a: a.index_select(0, order)  # noqa: E731
        return Batch(key=take(self.key), id=take(self.id), ts=take(self.ts),
                     payload=tree_map(take, self.payload),
                     valid=take(self.valid) if valid is None else valid)

    def compact(self) -> "Batch":
        """Pack live tuples to the front (stable): the JAX package's stable
        argsort of the invalid flag. Invalid lanes move to the tail; the
        capacity is unchanged."""
        order = torch.argsort((~self.valid).to(torch.int8), stable=True)
        return self.take(order)

    def select(self, idx: torch.Tensor, valid: torch.Tensor) -> "Batch":
        """Gather lanes ``idx`` with a new validity mask (size may differ)."""
        idx = idx.to(torch.int64)
        return self.take(idx, valid & self.valid.index_select(0, idx))

    def sorted_by(self, *, by: str = "ts") -> "Batch":
        """Stable sort of the live tuples by ``ts`` or ``id``, invalid lanes to
        the tail: the batch-level counterpart of the Ordering_Node."""
        k = self.ts if by == "ts" else self.id
        big = torch.iinfo(CTRL_DTYPE).max
        return self.take(torch.argsort(torch.where(self.valid, k, big), stable=True))

    def to_host(self) -> dict:
        """All lanes as numpy arrays: ``{"key", "id", "ts", "payload", "valid"}``."""
        np_ = lambda t: t.detach().cpu().numpy()  # noqa: E731
        return {"key": np_(self.key), "id": np_(self.id), "ts": np_(self.ts),
                "payload": tree_map(np_, self.payload), "valid": np_(self.valid)}


@dataclasses.dataclass(frozen=True)
class TupleRef:
    """Per-tuple view handed to user functions under ``vmap``: ``key``/``id``/
    ``ts`` are the control fields; payload fields are attributes (dict
    payloads) or ``.data`` (any pytree)."""

    key: torch.Tensor
    id: torch.Tensor
    ts: torch.Tensor
    data: Any

    def __getattr__(self, name):
        data = object.__getattribute__(self, "data")
        if isinstance(data, dict) and name in data:
            return data[name]
        raise AttributeError(name)


def tuple_refs(batch: Batch) -> TupleRef:
    """Batched TupleRef (each field keeps its capacity axis)."""
    return TupleRef(key=batch.key, id=batch.id, ts=batch.ts, data=batch.payload)


def vmap_lanes(fn: Callable, lanes: torch.Tensor, *more: Any) -> Any:
    """``torch.func.vmap(fn)(lanes, *more)`` with every output on ``lanes``'
    device (a constant built on the CPU inside ``fn`` comes back expanded to
    ``[C]`` on the CPU otherwise)."""
    out = torch.func.vmap(fn)(lanes, *more)
    return tree_map(lambda t: torch.as_tensor(t).to(lanes.device), out)


def map_tuples(fn: Callable, batch: Batch) -> Any:
    """``fn(TupleRef) -> pytree`` over every lane of ``batch`` — the
    counterpart of ``jax.vmap(fn)(tuple_refs(b))``."""
    return vmap_lanes(lambda k, i, ts, d: fn(TupleRef(key=k, id=i, ts=ts, data=d)),
                      batch.key, batch.id, batch.ts, batch.payload)


def host_view(batch: Batch) -> dict:
    """Live lanes of ``batch`` as numpy: ``{"key", "id", "ts", "payload"}`` —
    the view a host Sink callback receives."""
    h = batch.to_host()
    v = h["valid"]
    return {"key": h["key"][v], "id": h["id"][v], "ts": h["ts"][v],
            "payload": tree_map(lambda a: a[v], h["payload"])}


def hash_key_to_slot(key, num_slots: int):
    """Map user keys (strings, bytes, ints of any size, numpy arrays of them)
    to key slots in ``[0, num_slots)``: the reference's ``hash(key) % n``
    routing contract applied at ingest. Deterministic across runs (unlike
    Python's salted ``hash``), and bit-identical to the JAX package: strings
    and bytes hash by 32-bit FNV-1a, integers by a Knuth multiply in uint64
    wraparound. The JAX package's native C array pass computes the same
    arithmetic; here numpy does."""
    if isinstance(key, (str, bytes)):
        return _fnv1a(key) % num_slots
    if isinstance(key, (int, np.integer)):
        k = int(key) & 0xFFFFFFFFFFFFFFFF
        return int((k * 2654435761) % (1 << 64) % num_slots)
    arr = np.asarray(key)
    if arr.dtype.kind in "USO":                        # strings / bytes / objects
        uniq, inv = np.unique(arr.ravel(), return_inverse=True)
        slots = np.asarray([hash_key_to_slot(u, num_slots) for u in uniq.tolist()],
                           np.int32)
        return slots[inv].reshape(arr.shape)
    if arr.dtype.kind not in "iu":
        raise TypeError(
            f"hash_key_to_slot: keys must be ints, strings, or bytes, got dtype "
            f"{arr.dtype} (float keys would silently truncate and merge)")
    return ((arr.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(num_slots)
            ).astype(np.int32)


def _fnv1a(s) -> int:
    if isinstance(s, str):
        data = s.encode()
    elif isinstance(s, bytes):
        data = s
    else:
        raise TypeError(f"hash_key_to_slot: unhashable key {s!r} "
                        f"(expected str/bytes, got {type(s).__name__})")
    h = 2166136261
    for ch in data:
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF         # FNV-1a
    return h


def concat_batches(a: Batch, b: Batch) -> Batch:
    """Concatenate two batches along the capacity axis (merge primitive)."""
    cat = lambda x, y: torch.cat([x, y], dim=0)  # noqa: E731
    return Batch(key=cat(a.key, b.key), id=cat(a.id, b.id), ts=cat(a.ts, b.ts),
                 payload=tree_map(cat, a.payload, b.payload), valid=cat(a.valid, b.valid))


def split_batch(batch: Batch, capacity: int) -> list:
    """Slice a batch into ``capacity``-sized pieces along the capacity axis,
    lane content kept verbatim: the inverse of :func:`concat_batches`.
    ``capacity`` must divide the batch's."""
    c = batch.capacity
    capacity = int(capacity)
    if capacity < 1 or c % capacity:
        raise ValueError(f"split_batch: capacity {capacity} does not divide "
                         f"the batch capacity {c}")
    if capacity == c:
        return [batch]
    return [Batch(key=batch.key[s:s + capacity], id=batch.id[s:s + capacity],
                  ts=batch.ts[s:s + capacity],
                  payload=tree_map(lambda a: a[s:s + capacity], batch.payload),  # noqa: B023
                  valid=batch.valid[s:s + capacity])
            for s in range(0, c, capacity)]


class MutableTupleRef:
    """Mutable per-tuple view behind the reference's in-place signatures
    (``void(tuple_t&)`` Map): payload attribute writes are recorded under
    ``vmap`` and become the output payload. Control fields stay read-only.
    Needs a dict payload (named fields)."""

    __slots__ = ("_ctrl", "_data")

    def __init__(self, ref: TupleRef):
        object.__setattr__(self, "_ctrl", {"key": ref.key, "id": ref.id, "ts": ref.ts})
        if not isinstance(ref.data, dict):
            raise TypeError(
                "in-place map functions need a dict payload (named fields); "
                "return a new payload instead for pytree payloads")
        object.__setattr__(self, "_data", dict(ref.data))

    def __getattr__(self, name):
        ctrl = object.__getattribute__(self, "_ctrl")
        if name in ctrl:
            return ctrl[name]
        data = object.__getattribute__(self, "_data")
        if name == "data":
            return data
        if name in data:
            return data[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in ("key", "id", "ts"):
            raise TypeError(
                f"control field '{name}' is read-only in user functions (the "
                f"reference owns setControlFields in its routing layer)")
        object.__getattribute__(self, "_data")[name] = value

    def _payload(self):
        return dict(object.__getattribute__(self, "_data"))


def same_capacity(batches) -> int:
    """The one capacity of ``batches``; raises for an empty list or mixed
    capacities."""
    if not batches:
        raise ValueError("stack_batches: need at least one batch")
    c0 = batches[0].capacity
    for b in batches[1:]:
        if b.capacity != c0:
            raise ValueError(
                f"stack_batches: mixed capacities {c0} vs {b.capacity} — a "
                f"scanned program is captured for ONE (K, capacity) shape; "
                f"the MicrobatchAccumulator groups same-capacity runs")
    return c0


def stack_batches(batches) -> Batch:
    """Stack K same-capacity batches along a new leading axis: every leaf
    ``[C, ...]`` becomes ``[K, C, ...]``. The scan-dispatch transport
    (``CompiledChain.push_many``: the captured K-step program reads its
    batches from one stacked input). Inverse of :func:`unstack_batches`;
    lane content is kept verbatim."""
    batches = list(batches)
    same_capacity(batches)
    first = batches[0]
    return Batch(
        key=torch.stack([b.key for b in batches]), id=torch.stack([b.id for b in batches]),
        ts=torch.stack([b.ts for b in batches]),
        payload=tree_map(lambda *xs: torch.stack(xs), first.payload,
                         *(b.payload for b in batches[1:])),
        valid=torch.stack([b.valid for b in batches]))


def unstack_batches(stacked: Batch, k: int = None) -> list:
    """The K capacity-C batches of a stacked batch (leaves ``[K, C, ...]``),
    as views into it: the inverse of :func:`stack_batches`."""
    if k is None:
        k = stacked.key.shape[0]
    return [Batch(key=stacked.key[i], id=stacked.id[i], ts=stacked.ts[i],
                  payload=tree_map(lambda a: a[i], stacked.payload),  # noqa: B023
                  valid=stacked.valid[i]) for i in range(k)]


def spec_of(tree: Any) -> Any:
    """Per-tuple spec of a batched pytree: meta tensors without the capacity axis."""
    return tree_map(lambda t: torch.empty(tuple(t.shape[1:]), dtype=t.dtype,
                                          device="meta"), tree)


__all__ = ["CTRL_DTYPE", "TRACE_META_ATTR", "Batch", "TupleRef", "MutableTupleRef",
           "tuple_refs", "map_tuples", "vmap_lanes", "host_view", "spec_of",
           "stack_batches", "unstack_batches", "concat_batches", "split_batch",
           "hash_key_to_slot", "trace_meta", "tree_map", "tree_leaves"]

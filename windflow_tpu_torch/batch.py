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
#: dataclass and never as a field, so it changes no tensor. Causal tracing
#: (``observability/tracing.py``) mints and reads it.
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


def is_node(x) -> bool:
    """A dataclass instance: a tree node whose fields are its children."""
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def flatten_with_paths(tree: Any) -> list:
    """``(keystr, leaf)`` of every leaf in the order and with the paths
    ``jax.tree_util.tree_flatten_with_path`` gives a JAX tree of the same
    shape: dict keys sorted, dataclass fields in order, ``None`` an empty
    subtree."""
    out = []

    def walk(x, prefix):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{prefix}[{k!r}]")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{prefix}[{i}]")
        elif is_node(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{prefix}.{f.name}")
        else:
            out.append((prefix, x))
    walk(tree, "")
    return out


def jax_leaves(tree: Any) -> list:
    """The leaves in ``jax.tree.leaves`` order (:func:`flatten_with_paths`)."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def jax_unflatten(tree: Any, new_leaves: list) -> Any:
    """``tree``'s structure over ``new_leaves`` given in :func:`jax_leaves`
    order (dicts keep their own key order)."""
    it = iter(new_leaves)

    def walk(x):
        if x is None:
            return None
        if isinstance(x, dict):
            done = {k: walk(x[k]) for k in sorted(x)}
            return {k: done[k] for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if is_node(x):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return next(it)
    return walk(tree)


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

    def live_payload(self) -> Any:
        """Host-side: the payload restricted to the live lanes (numpy)."""
        v = self.valid.detach().cpu().numpy()
        return tree_map(lambda t: t.detach().cpu().numpy()[v], self.payload)


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
    device. A constant that ``fn`` builds on the host (``torch.ones(())``)
    comes back from ``vmap`` expanded to ``[C, ...]`` on the CPU; it is
    rebuilt on the lanes' device with ``torch.full``, because a copy from
    the host would be refused inside a CUDA-graph capture."""
    out = torch.func.vmap(fn)(lanes, *more)
    return tree_map(lambda t: _on_lanes(torch.as_tensor(t), lanes.device), out)


def _on_lanes(t: torch.Tensor, device) -> torch.Tensor:
    if t.device == device:
        return t
    if t.dim() and t.shape[0] and t.stride(0) == 0:   # one value per lane: a constant
        base = t[0]
        vals = [torch.full((), v, dtype=t.dtype, device=device)
                for v in base.reshape(-1).tolist()]
        const = (torch.stack(vals).reshape(base.shape) if vals
                 else torch.empty(base.shape, dtype=t.dtype, device=device))
        return const.expand(t.shape)
    return t.to(device)


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
    wraparound. An array of ints, bytes or strings goes through one native C
    pass (``native/csrc/ingest.cpp``) with the same arithmetic."""
    if isinstance(key, (str, bytes)):
        return _fnv1a(key) % num_slots
    if isinstance(key, (int, np.integer)):
        k = int(key) & 0xFFFFFFFFFFFFFFFF
        return int((k * 2654435761) % (1 << 64) % num_slots)
    arr = np.asarray(key)
    if arr.dtype.kind not in "USOiu":
        raise TypeError(
            f"hash_key_to_slot: keys must be ints, strings, or bytes, got dtype "
            f"{arr.dtype} (float keys would silently truncate and merge)")
    if arr.ndim == 0:                                  # one key held in an array
        return np.asarray(hash_key_to_slot(arr.item(), num_slots), np.int32)
    if arr.dtype.kind == "O":                          # Python objects, each hashed alone
        uniq, inv = np.unique(arr.ravel(), return_inverse=True)
        slots = np.asarray([hash_key_to_slot(u, num_slots) for u in uniq.tolist()],
                           np.int32)
        return slots[inv].reshape(arr.shape)
    from .native import hash_keys_native
    return hash_keys_native(arr, num_slots)


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


def concat_batches(a: Batch, *more: Batch) -> Batch:
    """Concatenate batches along the capacity axis, in order (merge
    primitive); one batch is returned as it is."""
    if not more:
        return a
    bs = (a,) + more
    cat = lambda *xs: torch.cat(xs, dim=0)  # noqa: E731
    return Batch(key=cat(*[b.key for b in bs]), id=cat(*[b.id for b in bs]),
                 ts=cat(*[b.ts for b in bs]), payload=tree_map(cat, *[b.payload for b in bs]),
                 valid=cat(*[b.valid for b in bs]))


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


def dtype_name(dtype) -> str:
    """A dtype as the JAX package writes it (``float32``, not
    ``torch.float32``): its spec keys, cache keys and signatures."""
    return str(dtype).replace("torch.", "")


def spec_of(tree: Any) -> Any:
    """Per-tuple spec of a batched pytree: meta tensors without the capacity axis."""
    return tree_map(lambda t: torch.empty(tuple(t.shape[1:]), dtype=t.dtype,
                                          device="meta"), tree)


class _OnDevice(torch.overrides.TorchFunctionMode):
    """Every tensor operand of a torch call moved to ``device`` (a closure's
    table on the card becomes a meta tensor of its shape, no data read; a
    meta spec becomes zeros on the CPU), every ``device`` argument replaced
    by it, ``.cpu()``/``.cuda()`` kept there."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    def _move(self, x):
        if isinstance(x, torch.Tensor):
            if x.device == self.device:
                return x
            if x.device.type == "meta":          # no values: zeros stand in
                return torch.zeros(x.shape, dtype=x.dtype, device=self.device)
            return x.to(self.device)
        if isinstance(x, torch.device):
            return self.device
        if type(x) in (list, tuple):
            return type(x)(self._move(v) for v in x)
        return x

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = {k: self._move(v) for k, v in (kwargs or {}).items()}
        if kwargs.get("device") is not None:
            kwargs["device"] = self.device
        if func in (torch.Tensor.cpu, torch.Tensor.cuda):
            return self._move(args[0])
        if func is torch.Tensor.to:
            args = tuple(self.device if isinstance(a, str) else a for a in args)
        return func(*(self._move(a) for a in args), **kwargs)


def abstract_spec(build: Callable[[torch.device], Any]) -> Any:
    """``spec_of(build(dev))`` without device work, the counterpart of the
    JAX package's ``jax.eval_shape``: ``build`` makes its probe rows on
    ``dev`` and runs the user function over them. ``dev`` is the meta
    device; every tensor the function reaches is moved there and every
    kernel resolves to its plain version, unrecorded
    (``ops/registry.py::plain_selection``). Where an op has no meta kernel
    the probe runs again on the CPU. A function that reads a value
    (``.item()``, ``bool(t)``) fails here, as under ``jax.eval_shape``."""
    from .ops.registry import plain_selection
    for dev in (torch.device("meta"), torch.device("cpu")):
        try:
            with plain_selection(), dev, _OnDevice(dev):
                out = build(dev)
        except (NotImplementedError, RuntimeError) as e:
            if dev.type == "cpu" or not _no_meta_kernel(e):
                raise
            continue
        return spec_of(out)


def _no_meta_kernel(e: BaseException) -> bool:
    """An op without a meta kernel: an aten op with none registered for the
    Meta backend, or a custom op without a fake implementation."""
    return isinstance(e, NotImplementedError) or "no fake impl" in str(e)


__all__ = ["CTRL_DTYPE", "TRACE_META_ATTR", "Batch", "TupleRef", "MutableTupleRef",
           "tuple_refs", "map_tuples", "vmap_lanes", "host_view", "spec_of",
           "stack_batches", "unstack_batches", "concat_batches", "split_batch",
           "hash_key_to_slot", "trace_meta", "tree_map", "tree_leaves", "is_node", "dtype_name",
           "flatten_with_paths", "jax_leaves", "jax_unflatten", "abstract_spec"]

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

import torch

#: dtype of the (key, id, ts) control fields
CTRL_DTYPE = torch.int32


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


def spec_of(tree: Any) -> Any:
    """Per-tuple spec of a batched pytree: meta tensors without the capacity axis."""
    return tree_map(lambda t: torch.empty(tuple(t.shape[1:]), dtype=t.dtype,
                                          device="meta"), tree)


__all__ = ["CTRL_DTYPE", "Batch", "TupleRef", "tuple_refs", "map_tuples",
           "vmap_lanes", "host_view", "spec_of", "tree_map", "tree_leaves"]

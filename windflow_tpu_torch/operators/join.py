"""Stream-table join: enrichment of a probe stream from a build stream.

Counterpart of ``windflow_tpu/operators/join.py::StreamTableJoin`` (untiered,
event-time monitoring off). Both sides arrive merged in one stream;
``side_fn`` separates them per tuple. Build-side tuples upsert into the
versioned, watermark-consistent JoinTable of ``ops/lookup.py`` (last writer
by ``(ts, id)`` wins per key); probe-side tuples then read the table as of
the build watermark through ``join_probe`` (kernel K5 on the card). Each
apply runs K5 twice: once inside the upsert (the ring keys' existing slots)
and once for the probe.

Not ported yet: ``IntervalJoin`` (Nexmark q4, ROADMAP Queue 1 item 11),
tiered state (``tiered=``, item 13) and event-time monitoring (item 16).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..basic import DEFAULT_MAX_KEYS, routing_modes_t
from ..batch import Batch, TupleRef, map_tuples, spec_of, tree_map, vmap_lanes
from ..ops.lookup import join_table_init, join_table_probe, join_table_upsert
from .base import Basic_Operator


def refuse_tiered(name: str, tiered) -> None:
    """Tiered keyed state is not ported: anything but ``tiered=None`` raises."""
    if tiered is not None:
        raise NotImplementedError(
            f"{name}: tiered keyed state (tiered=) is not ported yet "
            f"(ROADMAP Queue 1 item 13)")


class StreamTableJoin(Basic_Operator):
    """Stream-table join over one merged (tagged) stream.

    ``side_fn(t) -> bool`` marks build-side tuples (table upserts); every
    other tuple probes. ``key_fn(t) -> i32`` gives the join key on both sides
    (keys must lie strictly inside the int32 range); ``val_fn(t) -> pytree of
    scalars`` the build side's value columns. ``emit(t, v) -> payload``
    shapes the probe side's output (default: the probe payload merged with
    the value dict). An upsert becomes visible once the build watermark
    passes ``ts + delay``. Misses are masked out (inner join) unless
    ``emit_misses=True`` (left join, zero values)."""

    routing = routing_modes_t.KEYBY

    def __init__(self, side_fn: Callable, key_fn: Callable, val_fn: Callable, *,
                 num_slots: int = DEFAULT_MAX_KEYS, pending: Optional[int] = None,
                 delay: int = 0, emit: Optional[Callable] = None,
                 emit_misses: bool = False, tiered=None,
                 name: str = "stream_table_join", parallelism: int = 1, device=None):
        refuse_tiered(name, tiered)
        super().__init__(name, parallelism, device)
        if delay < 0:
            raise ValueError(f"{name}: delay (lateness) must be >= 0")
        self.side_fn = side_fn
        self.key_fn = key_fn
        self.val_fn = val_fn
        self.num_slots = int(num_slots)
        self.pending = None if pending is None else int(pending)
        self.delay = int(delay)
        self.emit_misses = bool(emit_misses)
        self.emit = emit
        self._pending_resolved = pending

    def bind_geometry(self, batch_capacity: int) -> None:
        # one batch of pure build tuples always fits, with headroom for
        # upserts parked behind a nonzero delay
        self._pending_resolved = (2 * int(batch_capacity) if self.pending is None
                                  else self.pending)

    def _emit(self, t: TupleRef, v):
        if self.emit is not None:
            return self.emit(t, v)
        if isinstance(t.data, dict) and isinstance(v, dict):
            return {**t.data, **v}
        return {"probe": t.data, "join": v}

    def _emit_lanes(self, batch: Batch, vals):
        return vmap_lanes(
            lambda k, i, ts, d, v: self._emit(TupleRef(key=k, id=i, ts=ts, data=d), v),
            batch.key, batch.id, batch.ts, batch.payload, vals)

    def _val_spec(self, payload_spec):
        return spec_of(map_tuples(self.val_fn, Batch.empty(1, payload_spec, self.device)))

    def init_state(self, payload_spec: Any):
        pending = self._pending_resolved or 2 * DEFAULT_MAX_KEYS
        return join_table_init(self.num_slots, pending, self._val_spec(payload_spec),
                               self.device)

    def out_spec(self, payload_spec: Any) -> Any:
        b = Batch.empty(1, payload_spec, self.device)
        vals = tree_map(lambda s: torch.zeros((1,), dtype=s.dtype, device=self.device),
                        self._val_spec(payload_spec))
        return spec_of(self._emit_lanes(b, vals))

    def apply(self, state, batch: Batch):
        build = map_tuples(self.side_fn, batch).to(torch.bool) & batch.valid
        probe_mask = batch.valid & ~build
        jkey = map_tuples(self.key_fn, batch).to(torch.int32)
        bval = map_tuples(self.val_fn, batch)
        # upsert before probe: a probe sees every build tuple up to and
        # including its own batch (the as-of-watermark read point)
        state = join_table_upsert(state, jkey, bval, batch.ts, batch.id, build,
                                  delay=self.delay)
        vals, hit = join_table_probe(state, jkey, probe_mask)
        payload = self._emit_lanes(batch, vals)
        valid = probe_mask & (hit | self.emit_misses)
        return state, batch.replace(payload=payload, valid=valid)


__all__ = ["StreamTableJoin", "refuse_tiered"]

"""Linear operator chain + host run loop.

Counterpart of ``windflow_tpu/runtime/pipeline.py`` (``CompiledChain``:
``push``, ``flush``, ``states``; ``Pipeline.run``). The JAX package traces the
chain into one jitted XLA program; PyTorch runs eagerly, so a push is the
operators' ``apply`` in order, each launching its own kernels on the current
CUDA stream. The host does not wait for the card inside a push (except where
an operator must read a device value, e.g. Win_SeqFFAT's flush), so the host
queues batch N+1 while the card runs batch N.

Scan dispatch (``dispatch=``, ``runtime/dispatch.py``): ``push_many`` runs K
same-capacity batches as one device program, a CUDA graph of K captured steps
replayed by one host call (``runtime/graphs.py``), byte-identical to K
``push`` calls; on the CPU it is the plain loop over the same step. ``flush``
stays eager and outside any graph: Win_Seq's and Win_SeqFFAT's flush read a
device value.

Tiered keyed state (``state/tiered.py``): after every ``push`` and every
``push_many`` the chain runs its tiered operators' spill maintenance (one
maintenance point after K steps, as the JAX package does), on the driving
thread, before the next push is launched; ``tier_settle``/``tier_snapshot``/
``tier_restore`` and the checkpoint manifests serve the recovery layer.

EOS protocol: the source exhausts; then each stateful operator's ``flush``
drains residual state and the flushed batches cascade through the remaining
suffix of the chain; the source's exhaustion is journaled (``eos``).

Monitoring (``observability/``): ``Pipeline(monitoring=, trace=)`` runs a
``Monitor`` (registry, reporter, journal, health ledger) and a ``Tracer``
for the run; ``event_time=`` (or the monitoring config's sub-toggle) builds
the operators with lateness histograms in their state. A sampled push
(every ``SERVICE_SAMPLE_EVERY``-th, and while a journal or the health ledger
is active also pushes 2, 4 and 8, as the JAX package samples) waits for the
chain's stream and journals a ``launch`` record; a sampled fused launch
(only while one of them is active) a ``dispatch_fused`` record. With
neither active nothing is added to the unmonitored path: no wait, no
launch.

The control plane (``control=``, ``control/``; None consults
``WF_CONTROL``, off by default), as in the JAX package: with autotune on the
operators are bound at the capacity ladder's top rung, every rung's step is
made ready before the first batch (:meth:`CompiledChain.warm`), a
``Rebatcher`` at the ingest boundary concatenates or slices the source's
batches to the rung a ``CapacityAutotuner`` picks from the host wall time of
``decide_every`` pushes (no push waits for the card), and the plan persists
in a tuning cache. With ``dispatch=`` K > 1 and ``autotune_k`` the same
hill-climber tunes K over ``build_k_ladder(K)``, every K rung captured
before the run. Admission offers each source batch to an
``AdmissionController`` and sheds or holds it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import Any, List, Optional, Sequence

import torch

from ..basic import DEFAULT_BATCH_SIZE
from ..batch import (Batch, dtype_name, jax_leaves, same_capacity, stack_batches,
                     tree_leaves, unstack_batches)
from ..device import resolve_device
from ..operators.base import Basic_Operator
from ..operators.sink import ReduceSink, Sink
from ..observability import device_health as _dh
from ..observability import journal as _journal
from ..observability import tracing as _tracing
from ..operators.source import SourceBase
from ..parallel.mesh import ShardedTensor, global_tree
from . import dispatch as _dispatch
from .graphs import LAUNCH_GATE, StepGraph, leaves, rebuild


def resolve_batch_hint(ops) -> Optional[int]:
    """Smallest ``withBatch`` hint among ``ops`` (each hint is a capacity
    ceiling, the reference GPU builders' ``batch_len``; a fused chain cannot
    exceed any member's), or None when no operator carries one."""
    hints = [op._batch_hint for op in ops
             if getattr(op, "_batch_hint", None) is not None]
    return min(hints) if hints else None


def record_source_launch(source, batch: Batch) -> None:
    """Per-batch source stats: one launch and the host-to-device bytes the
    batch cost (a DeviceSource generates on the device: none). The one place
    H2D bytes are counted; every driver calls it as it pulls a batch."""
    from ..operators.source import DeviceSource
    hd = 0 if isinstance(source, DeviceSource) else _batch_nbytes(batch)
    source.get_StatsRecords()[0].record_launch(hd_bytes=hd)


def _observed() -> bool:
    """A journal or the health ledger is active: the sampled service points
    follow the JAX package's schedule and journal their records."""
    return _journal.get_active() is not None or _dh.get_active() is not None


def _early_sample(c: int) -> bool:
    """Pushes 2, 4 and 8 (the JAX package's early samples: short runs get
    service-time percentiles; push 1 would time the first build)."""
    return 1 < c < CompiledChain.SERVICE_SAMPLE_EVERY and (c & (c - 1)) == 0


def _health_sig(tree) -> str:
    """Shape and dtype signature of a batch tree, in the JAX package's form
    (``(64,)/int32;...``): the capture ledger's cache key component."""
    return ";".join(f"{tuple(t.shape)}/{dtype_name(t.dtype)}"
                    for t in jax_leaves(tree))


def _batch_nbytes(batch: Batch) -> int:
    return sum(t.numel() * t.element_size()
               for t in (batch.key, batch.id, batch.ts, batch.valid,
                         *tree_leaves(batch.payload)))


def _launching(method):
    """``method`` under ``LAUNCH_GATE.shared()``: a profiler session neither
    starts nor stops while it launches (F30, ``runtime/graphs.py``)."""
    @functools.wraps(method)
    def gated(*args, **kwargs):
        with LAUNCH_GATE.shared():
            return method(*args, **kwargs)
    return gated


class CompiledChain:  # wf-lint: single-writer[driver, stage]
    """Operators ``ops`` (no source/sink) bound to one device and one batch
    capacity. ``push(batch, from_op=i)`` runs ``ops[i:]``: the main path
    (i=0) and the EOS flush cascades."""

    #: every Nth push is timed to completion (a wait on the current stream,
    #: where the push launched its kernels: the counterpart of the JAX
    #: package's block_until_ready on the push's output, which stalls no
    #: other stage thread's stream) and recorded as the entry op's service
    #: time; the other pushes never wait
    SERVICE_SAMPLE_EVERY = 16

    def __init__(self, ops: Sequence[Basic_Operator], in_spec: Any,
                 batch_capacity: int = None, device=None, event_time: bool = None):
        self.ops = list(ops)
        # event-time monitoring sizes operator state, so it binds here,
        # before init_state; None consults WF_MONITORING/_EVENT_TIME. Set on
        # every operator: an operator reused by another chain must not keep
        # this chain's toggle
        if event_time is None:
            from ..observability import event_time_enabled
            event_time = event_time_enabled(None)
        self.event_time = bool(event_time)
        for op in self.ops:
            op._event_time = self.event_time
        self._drop_synced = {}      # id(op) -> {kind: last journaled total}
        # withDevice hints: one device a chain, so two different hints are an error
        hinted = {str(op._device): op._device for op in self.ops
                  if getattr(op, "_device", None) is not None}
        if len(hinted) > 1:
            names = ", ".join(f"{op.getName()}->{op._device}" for op in self.ops
                              if getattr(op, "_device", None) is not None)
            raise ValueError(
                f"conflicting withDevice hints inside one fused chain ({names}); a "
                f"CompiledChain runs on one device — split the graph at the device "
                f"boundary")
        if device is None and hinted:
            device = next(iter(hinted.values()))
        if batch_capacity is None:
            batch_capacity = resolve_batch_hint(self.ops)
        self.device = resolve_device(device)
        #: the batch capacity the operators' geometry is bound to
        self.capacity = batch_capacity
        for op in self.ops:
            if op.device != self.device:
                raise ValueError(
                    f"operator {op.getName()!r} lives on {op.device} but the "
                    f"chain runs on {self.device}; build them on one device")
        self.specs = [in_spec]          # specs[i] = input payload spec of ops[i]
        cap = batch_capacity
        for op in self.ops:
            if cap is not None:
                op.bind_geometry(cap)
                cap = op.out_capacity(cap)
            self.specs.append(op.out_spec(self.specs[-1]))
        self.states = [op.init_state(self.specs[i]) for i, op in enumerate(self.ops)]
        #: operators with tiered keyed state: their controllers' maintain runs
        #: after every push (empty unless some operator was built tiered)
        self._tier_ops = [j for j, op in enumerate(self.ops) if op.tier_controllers()]
        self._push_count = 0
        self._fused_count = 0       # push_many launches
        #: (from_op, kind, signature) run once: the capture ledger's notes
        self._noted = set()
        #: stage label of the health ledger and the trace spans: the drivers
        #: set it (``seg<i>``, ``pipe<i>``; ``chain`` by default)
        self.label = "chain"
        #: the captured K-step programs, (from_op, K, capacity) -> StepGraph (card)
        self.graphs = {}
        self._warmed = set()    # (from_op, capacity) run once eagerly
        #: set by the threaded drivers while their stage threads run: every
        #: graph was captured before they started, and a capture now (which
        #: synchronizes the device and fails in global capture mode while
        #: other threads launch) raises instead
        self.capture_closed = False

    def warm(self, capacity: int) -> None:
        """Make the per-batch step of ``capacity`` ready WITHOUT touching
        operator state: one eager step over an all-invalid batch, its
        results dropped (:meth:`_warm`), which builds and sets up every
        kernel at these shapes. After warming every rung of a capacity
        ladder the autotuner's switches run programs already made ready."""
        self._warm(0, int(capacity))

    def reset_states(self) -> None:
        """Re-initialize every operator's state (supervised replay of a chain
        that did not exist at the last checkpoint). The new tensors reach a
        captured graph at its next replay, as restored ones do."""
        self.states = [op.init_state(self.specs[i]) for i, op in enumerate(self.ops)]

    @property
    def out_spec(self):
        return self.specs[-1]

    @_launching
    def push(self, batch: Batch, from_op: int = 0) -> Batch:
        """Run one batch through ops[from_op:]; updates states; returns the out batch."""
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, chain on {self.device}")
        self._push_count += 1
        c = self._push_count
        sampled = c % self.SERVICE_SAMPLE_EVERY == 0 or (_observed() and _early_sample(c))
        hl, t0c = self._health_begin("push")
        if hl is not None:
            self._note(hl, from_op, "step", batch)
        t0 = time.perf_counter() if sampled else None
        timer = self._device_timer(hl, sampled)
        out = batch
        for j in range(from_op, len(self.ops)):
            self.states[j], out = self.ops[j].apply(self.states[j], out)
        service_s = self._sampled_wait(hl, timer, t0) if sampled else None
        if sampled and _journal.get_active() is not None:
            _journal.record("launch", op=self.ops[from_op].getName() if self.ops else "",
                            from_op=from_op, push=c, service_s=round(service_s, 6))
        self._health_end(hl, t0c, from_op)
        if self._tier_ops:
            self._tier_maintain()
        if sampled:
            # the sampled push already waited: the drop readback rides it
            self._journal_drops(batch)
        self._record(from_op, 1, batch, out, service_s,
                     exemplar=None if service_s is None else _tracing.tid_of(batch))
        return out

    # -- runtime-health ledger (MonitoringConfig.health) ----------------------------

    def _health_begin(self, cause: str):
        """(ledger, t0) when the health ledger is active, with the cause of
        any first run noted in this call; (None, 0.0) when off."""
        hl = _dh.get_active()
        if hl is None:
            return None, 0.0
        hl.set_cause(cause)
        return hl, time.perf_counter()

    def _note(self, hl, from_op: int, kind: str, example, k: int = None) -> None:
        """Note the first run of the ``(from_op, kind)`` program at
        ``example``'s signature (a first eager step, or a graph capture)."""
        sig = _health_sig(example)
        key = (from_op, kind, sig)
        if key in self._noted:
            return
        self._noted.add(key)
        leaves = jax_leaves(example)
        cap = None if not leaves else int(leaves[0].shape[1 if kind == "scan" else 0])
        hl.note_trace(self.label, from_op, kind, sig, capacity=cap, k=k)

    def _health_end(self, hl, t0c: float, from_op: int) -> None:
        """Commit the notes this call parked, with the call's duration (the
        first build or capture and the first run: what a user waits for)."""
        if hl is not None:
            hl.commit_pending(time.perf_counter() - t0c,
                              op=self.ops[from_op].getName() if self.ops else "")

    def _device_timer(self, hl, sampled: bool):
        """Two CUDA events around a sampled push's launches while the ledger
        is active (the device side of the dispatch/device split), else None."""
        if not sampled or hl is None or self.device.type != "cuda":
            return None
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record(torch.cuda.current_stream(self.device))
        return ev

    def _sampled_wait(self, hl, timer, t0: float) -> float:
        """Wait for a sampled push's launches (the current stream) and return
        its service time; with the ledger active also note the split: host
        time of the launching call (dispatch) against the device time between
        the events (on the CPU, the wait)."""
        t_disp = time.perf_counter()
        if timer is not None:
            timer[1].record(torch.cuda.current_stream(self.device))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t_done = time.perf_counter()
        # a call that built or captured (pending notes) is not a service
        # sample of the split: its dispatch time is the build
        if hl is not None and not hl.has_pending() and hl.service_sample():
            device_s = (timer[0].elapsed_time(timer[1]) / 1e3 if timer is not None
                        else t_done - t_disp)
            hl.note_service(self.label, dispatch_s=t_disp - t0, device_s=device_s)
        return t_done - t0

    def state_footprints(self) -> dict:
        """Per-operator state bytes from the state tensors' shapes and dtypes
        (no device access): the memory ledger's rows. A sharded leaf counts
        its global shape, as the JAX package's ``nbytes`` does."""
        out: dict = {}
        for op, st in zip(self.ops, self.states):
            n = sum(t.shape.numel() * t.dtype.itemsize for t in jax_leaves(st)
                    if isinstance(t, (torch.Tensor, ShardedTensor)))
            out[op.getName()] = out.get(op.getName(), 0) + n
        return out

    def _journal_drops(self, batch) -> None:
        """``lateness_drop`` records for every operator drop counter that grew
        since the last readback, with the trace coordinates of ``batch`` (the
        sampled batch whose wait this read rides; None at EOS). Only with
        event-time monitoring on and a journal active."""
        if not self.event_time or _journal.get_active() is None:
            return
        tid = _tracing.tid_of(batch) if batch is not None else None
        for op, st in zip(self.ops, self.states):
            counters = op.drop_counters(st)
            if not counters:
                continue
            prev = self._drop_synced.setdefault(id(op), {})
            for kind, val in counters.items():
                delta = int(val) - prev.get(kind, 0)
                if delta <= 0:
                    continue
                prev[kind] = int(val)
                fields = {"op": op.getName(), "kind": kind, "n": delta, "total": int(val)}
                if tid is not None:
                    fields["tid"] = int(tid)
                    fields["pos"] = _tracing.trace_pos(tid)
                _journal.record("lateness_drop", **fields)

    def _record(self, from_op: int, k: int, batch: Batch, out: Batch,
                service_time_s: float = None, exemplar=None) -> None:
        """Stats of one dispatch of ``k`` batches: k batches and their bytes
        per op, one launch (with its service time when sampled) on the entry
        op."""
        in_bytes, out_bytes = _batch_nbytes(batch), _batch_nbytes(out)
        for j in range(from_op, len(self.ops)):
            rec = self.ops[j].get_StatsRecords()[0]
            rec.batches_received += k
            rec.batches_sent += k
            rec.bytes_received += k * in_bytes
            rec.bytes_sent += k * out_bytes
        if from_op < len(self.ops):
            self.ops[from_op].get_StatsRecords()[0].record_launch(service_time_s,
                                                                  exemplar=exemplar)

    def _k_steps(self, from_op: int):
        """``fn(states, stacked) -> (states, outs)``: the K batches of a
        stacked batch through ops[from_op:] in order, the per-batch step
        of :meth:`push` K times."""
        def fn(states, stacked):
            states = list(states)
            outs = []
            for b in unstack_batches(stacked):
                for j in range(from_op, len(self.ops)):
                    states[j], b = self.ops[j].apply(states[j], b)
                outs.append(b)
            return states, outs
        return fn

    @_launching
    def _warm(self, from_op: int, capacity: int) -> None:
        """One eager step of ops[from_op:] over an all-invalid batch, on
        fresh state objects over the same tensors, its results dropped:
        builds, loads and sets up every kernel of the step at these shapes,
        which a capture needs first (``runtime/graphs.py``). It writes no
        state, and its cold-tier probes count no readmissions. Its kernel
        launches are real and counted."""
        if (from_op, capacity) in self._warmed:
            return
        b = Batch.empty(capacity, self.specs[from_op], self.device)
        hl, t0c = self._health_begin("warm")
        if hl is not None:
            self._note(hl, from_op, "step", b)
        states = rebuild(self.states, leaves(self.states))
        with contextlib.ExitStack() as uncounted:
            for j in self._tier_ops:
                for t in self.ops[j].tier_controllers():
                    uncounted.enter_context(t.store.uncounted())
            for j in range(from_op, len(self.ops)):
                states[j], b = self.ops[j].apply(states[j], b)
        self._warmed.add((from_op, capacity))
        self._health_end(hl, t0c, from_op)

    def _graph(self, from_op: int, k: int, capacity: int,
               cause: str = "push_many") -> StepGraph:
        """The captured K-step program for ``(from_op, k, capacity)``: warmed,
        then captured over the chain's states at first use (the health
        ledger notes the capture under ``cause``). Capture runs nothing, so
        it touches no state."""
        key = (from_op, k, capacity)
        g = self.graphs.get(key)
        if g is None:
            if self.capture_closed:
                raise RuntimeError(f"{key}: no graph was captured before the stage "
                                   f"threads started, and none is captured while they run")
            self._warm(from_op, capacity)
            empty = stack_batches([Batch.empty(capacity, self.specs[from_op], self.device)] * k)
            hl, t0c = self._health_begin(cause)
            if hl is not None:
                self._note(hl, from_op, "scan", empty, k=k)
            g = self.graphs[key] = StepGraph(self._k_steps(from_op), list(self.states), empty,
                                             name=f"{self.label}:{from_op}:k{k}:c{capacity}")
            self._health_end(hl, t0c, from_op)
        return g

    def warm_scan(self, k: int, capacity: int) -> None:
        """Make ready the K-fused program for ``(k, capacity)`` WITHOUT
        touching operator state: the eager warm-up step and, on the card,
        the capture. K <= 1 warms the per-batch step only, and a chain with
        no operator (a graph's source pipe before a merge) captures nothing:
        its K-step program would be an empty graph."""
        self._warm(0, capacity)
        if k > 1 and self.device.type == "cuda" and self.ops:
            self._graph(0, int(k), capacity, cause="warm_scan")

    @_launching
    def push_many(self, batches: Sequence[Batch], from_op: int = 0) -> List[Batch]:
        """Run K same-capacity batches through ops[from_op:] as ONE device
        program; updates states; returns the K out batches in order,
        byte-identical to K sequential :meth:`push` calls. On the card that
        is one replay of the graph captured for ``(from_op, K, capacity)``
        (its inputs copied in, its outputs cloned out); on the CPU, and
        past the last operator, the plain loop over the same step. Stats: K
        batches counted per op, ONE launch on the entry op. K = 1 delegates
        to :meth:`push`."""
        batches = list(batches)
        if len(batches) == 1:
            return [self.push(batches[0], from_op=from_op)]
        for b in batches:
            if b.device != self.device:
                raise ValueError(f"batch on {b.device}, chain on {self.device}")
        k = len(batches)
        # per-launch sampling, only while observed (the unmonitored fused
        # path never waits)
        self._fused_count += 1
        c = self._fused_count
        sampled = _observed() and (c % self.SERVICE_SAMPLE_EVERY == 0 or _early_sample(c))
        hl, t0c = self._health_begin("push_many")
        t0 = time.perf_counter() if sampled else None
        if self.device.type == "cuda" and from_op < len(self.ops):
            g = self._graph(from_op, k, same_capacity(batches))
            timer = self._device_timer(hl, sampled)
            _stack_into(g.inputs, batches)
            states, outs = g.run(self.states)
        else:
            stacked = stack_batches(batches)
            if hl is not None:
                self._note(hl, from_op, "scan", stacked, k=k)
            timer = None
            states, outs = self._k_steps(from_op)(self.states, stacked)
        service_s = self._sampled_wait(hl, timer, t0) if sampled else None
        if sampled and _journal.get_active() is not None:
            _journal.record("dispatch_fused",
                            op=self.ops[from_op].getName() if self.ops else "",
                            from_op=from_op, k=k, launch=c, service_s=round(service_s, 6))
        self._health_end(hl, t0c, from_op)
        self.states = list(states)
        if self._tier_ops:
            self._tier_maintain()
        if sampled:
            self._journal_drops(next(
                (b for b in batches if _tracing.tid_of(b) is not None), None))
        self._push_count += k
        tid = next((t for t in map(_tracing.tid_of, batches) if t is not None), None)
        self._record(from_op, k, batches[0], outs[0], service_s,
                     exemplar=None if service_s is None else tid)
        return outs

    # -- tiered keyed state (state/tiered.py) -----------------------------------------

    def _tier_maintain(self) -> None:
        """Per-push maintenance of every tiered operator: the spill pipeline
        and the compaction cadence (a function of stream position, so
        supervised replay re-walks it)."""
        for j in self._tier_ops:
            st = self.states[j]
            for t in self.ops[j].tier_controllers():
                st = t.maintain(st)
            self.states[j] = st

    def tier_settle(self) -> None:
        """Drain every tiered operator's outbox into its host store
        synchronously and drop the copies in flight: the pre-snapshot
        barrier, after which (states, stores) is a consistent pair."""
        for j in self._tier_ops:
            st = self.states[j]
            for t in self.ops[j].tier_controllers():
                st = t.settle(st)
            self.states[j] = st

    def tier_snapshot(self):
        """Host copies of every tiered operator's cold tier (callers settle
        first); None when no operator is tiered."""
        if not self._tier_ops:
            return None
        return {j: [t.manifest() for t in self.ops[j].tier_controllers()]
                for j in self._tier_ops}

    def tier_restore(self, snap) -> None:
        """Restore the cold tiers from a :meth:`tier_snapshot`; the failed
        attempt's copies in flight are discarded (the restored states still
        hold those rows in their outboxes: replay re-derives the spill)."""
        for j in self._tier_ops:
            mans = (snap or {}).get(j)
            for i, t in enumerate(self.ops[j].tier_controllers()):
                if mans is not None and i < len(mans):
                    t.restore(mans[i])
                else:
                    t.discard_inflight()

    def tier_manifests(self) -> dict:
        """``{"tier<op>_<ctl>_<name>": ndarray}`` of every cold tier: the
        checkpoint file's layout (the JAX package's)."""
        return {f"tier{j}_{i}_{k}": v
                for j in self._tier_ops
                for i, t in enumerate(self.ops[j].tier_controllers())
                for k, v in t.manifest().items()}

    def tier_restore_manifests(self, arrays: dict) -> None:
        """Restore cold tiers from checkpoint arrays (the
        :meth:`tier_manifests` layout); a tier the file lacks (a checkpoint
        written before the operator was tiered) keeps its store, and its
        copies in flight are discarded."""
        for j in self._tier_ops:
            for i, t in enumerate(self.ops[j].tier_controllers()):
                prefix = f"tier{j}_{i}_"
                man = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}
                if man:
                    t.restore(man)
                else:
                    t.discard_inflight()

    @_launching
    def flush(self) -> List[Batch]:
        """EOS: drain every operator in order, cascading flushed batches through
        the remaining suffix. Returns the final out-batches produced."""
        outs: List[Batch] = []
        for i, op in enumerate(self.ops):
            while True:
                self.states[i], fb = op.flush(self.states[i])
                if fb is None:
                    break
                if i + 1 < len(self.ops):
                    outs.append(self.push(fb, from_op=i + 1))
                else:
                    outs.append(fb)
        return outs

    def sync_stats(self) -> None:
        if self._tier_ops:
            # the EOS barrier: spills in flight settle, so the final counters
            # (and a following checkpoint) are consistent
            self.tier_settle()
        for op, st in zip(self.ops, self.states):
            op.collect_stats(st)
        self._journal_drops(None)

    def result(self) -> dict:
        """Results of the ReduceSink terminal ops (device accumulators; a
        sharded chain's gathered)."""
        return {op.name: op.result(global_tree(self.states[i]))
                for i, op in enumerate(self.ops) if isinstance(op, ReduceSink)}


def _stack_into(stacked: Batch, batches: Sequence[Batch]) -> None:
    """Copy K batches into a stacked batch's ``[K, C, ...]`` leaves: one
    ``torch.stack(..., out=)`` a leaf."""
    per_batch = [leaves(b) for b in batches]
    for i, leaf in enumerate(leaves(stacked)):
        torch.stack([lv[i] for lv in per_batch], out=leaf)


class Pipeline:
    """Source -> ops... -> sink, run batch-at-a-time on ``device``
    (None = ``"cuda"``; raises without CUDA). ``batch_size=None`` takes the
    smallest ``withBatch`` hint of the operators, else the default.
    ``dispatch=`` turns on scan dispatch (:class:`~.dispatch.DispatchConfig`:
    None consults ``WF_DISPATCH``, off by default): groups of K batches go
    through ``CompiledChain.push_many``, the partial tail at EOS too.
    ``prefetch=N > 0`` frames and copies the source's batches in a worker
    thread N batches ahead (``SourceBase.batches_prefetched``); setting
    :attr:`prefetch_pause` suspends that worker. ``monitoring=`` and
    ``trace=`` (None consults ``WF_MONITORING`` / ``WF_TRACE``, resolved at
    :meth:`run`) run a ``Monitor`` and a ``Tracer`` for the run;
    ``event_time=`` (None: the monitoring config's sub-toggle) builds the
    operators with lateness histograms. ``control=`` is the control plane
    (:class:`~..control.ControlConfig`: None consults ``WF_CONTROL``, off by
    default), resolved here because the capacity ladder binds the chain's
    geometry: with autotune on the operators are bound at the ladder's top
    rung, so every smaller rung runs inside the same state."""

    def __init__(self, source: SourceBase, ops: Sequence[Basic_Operator],
                 sink: Optional[Sink] = None, *,
                 batch_size: Optional[int] = None, device=None,
                 event_time: bool = None, dispatch=None, prefetch: int = 0,
                 monitoring=None, trace=None, control=None):
        from ..control import ControlConfig, build_ladder
        self._control = ControlConfig.resolve(control)
        self.device = resolve_device(device)
        self.source = source
        self.sink = sink
        self.batch_size = int(batch_size or resolve_batch_hint(ops) or DEFAULT_BATCH_SIZE)
        self.prefetch = int(prefetch)
        #: set to suspend the prefetch worker (batches already made stay
        #: consumable)
        self.prefetch_pause = threading.Event()
        #: resolved at run(), so an env change after construction counts
        self._dispatch_arg = dispatch
        self._monitoring_arg = monitoring
        self._monitor = None
        self._trace_arg = trace
        self._tracer = None
        if source.device != self.device:
            raise ValueError(f"source {source.getName()!r} lives on {source.device} "
                             f"but the pipeline runs on {self.device}")
        if event_time is None:
            # geometry-binding: resolved now, from the monitoring argument
            from ..observability import event_time_enabled
            event_time = event_time_enabled(monitoring)
        cap = source.out_capacity(self.batch_size)
        self._ladder = None
        if self._control is not None and self._control.autotune:
            self._ladder = build_ladder(cap, up=self._control.ladder_up,
                                        down=self._control.ladder_down)
            cap = self._ladder[-1]
        self.chain = CompiledChain(ops, source.payload_spec(), batch_capacity=cap,
                                   device=self.device, event_time=event_time)
        #: the last run's capacity and K tuners (None when off)
        self.tuner = self.ktuner = None

    def _tuner(self, ladder, start, cache_key_fn, name: str, gauge: str):
        """A ``CapacityAutotuner`` over ``ladder`` from the control config,
        with the tuning cache and its key when ``cache_path`` is set."""
        from ..control import (CapacityAutotuner, TuningCache, chain_signature,
                               device_kind, payload_signature)
        cfg = self._control
        cache = key = None
        if cfg.cache_path:
            cache = TuningCache(cfg.cache_path)
            key = cache_key_fn(chain_signature(self.chain.ops),
                               payload_signature(self.chain.specs[0]),
                               device_kind(self.device))
        return CapacityAutotuner(
            ladder, start_capacity=start, decide_every=cfg.decide_every,
            settle_batches=cfg.settle_batches,
            improve_threshold=cfg.improve_threshold, cache=cache, cache_key=key,
            name=self.source.getName() + name, gauge=gauge)

    def _make_controller(self):
        """The run's control pieces from the resolved config: (autotuner,
        rebatcher, admission), each None when its part is off."""
        cfg = self._control
        if cfg is None:
            return None, None, None
        from ..control import Rebatcher, admission_from_config, tuning_key
        base = self.source.out_capacity(self.batch_size)
        tuner = rebatcher = None
        if cfg.autotune and self._ladder and len(self._ladder) > 1:
            tuner = self._tuner(self._ladder, base, tuning_key, "-pipeline",
                                "chosen_capacity")
            rebatcher = Rebatcher(base)
            if tuner.capacity != base:        # a cache warm start: actuate now
                rebatcher.set_target(tuner.capacity)
            if cfg.prewarm:
                # a converged warm start runs the cached rung and the base
                # (drain, pass-through) only
                caps = {tuner.capacity, base} if tuner.converged else self._ladder
                with _dh.cause("autotune_prewarm"):
                    for c in sorted(caps):
                        self.chain.warm(c)
        admission = admission_from_config(cfg, base, driver="pipeline")
        return tuner, rebatcher, admission

    def _make_dispatcher(self):
        """``dispatch=`` resolved into (config, K tuner), both None when
        dispatch is off. The K tuner is the capacity hill-climber over
        ``build_k_ladder(K)`` (1 included: the per-batch push), its winner
        kept in the tuning cache under a dispatch key; every K rung is
        captured before the first batch when ``prewarm``."""
        dcfg = _dispatch.DispatchConfig.resolve(self._dispatch_arg)
        if dcfg is None:
            return None, None
        base = self.source.out_capacity(self.batch_size)
        cfg = self._control
        ktuner = None
        if dcfg.autotune_k and cfg is not None and cfg.autotune and dcfg.k > 1:
            from ..control import dispatch_tuning_key
            ladder = _dispatch.build_k_ladder(dcfg.k)
            ktuner = self._tuner(ladder, dcfg.k, dispatch_tuning_key, "-dispatch-k",
                                 "dispatch_k")
            if dcfg.prewarm:
                ks = {ktuner.capacity, 1} if ktuner.converged else ladder
                with _dh.cause("autotune_prewarm"):
                    for kr in sorted(ks):
                        self.chain.warm_scan(kr, base)
        elif dcfg.prewarm and dcfg.k > 1:
            self.chain.warm_scan(dcfg.k, base)
        return dcfg, ktuner

    def run(self) -> dict:
        """Drive the stream to EOS; returns ``chain.result()``."""
        from ..observability import Monitor, MonitoringConfig, TraceConfig, Tracer
        cfg = MonitoringConfig.resolve(self._monitoring_arg)
        if cfg is not None and self._monitor is None:
            self._monitor = Monitor(cfg, self.source.getName() + "-pipeline")
            self._monitor.registry.register_pipeline(self)
            self._monitor.start()
        mon = self._monitor
        tcfg = TraceConfig.resolve(self._trace_arg)
        if tcfg is not None and self._tracer is None:
            self._tracer = Tracer(tcfg, self.source.getName() + "-pipeline").start()
        try:
            return self._run(mon)
        finally:
            if self._tracer is not None:
                self._tracer.finish()
            if mon is not None:
                mon.finish(self)

    def _run(self, mon) -> dict:
        # e2e samples (a host sink only): the n-th batch fed to the chain is
        # stamped when the policy samples it, and its output's receipt closes
        # the sample
        stamps = collections.deque()
        e2e = mon is not None and self.sink is not None
        n_out = 0
        n_fed = 0

        def emit(out):
            nonlocal n_out
            if self.sink is not None:
                span = _tracing.service(out, "sink")
                self.sink.consume(out)
                if span is not None:
                    span.done()
            if stamps and stamps[0][0] == n_out:
                _n, t0, tid = stamps.popleft()
                mon.registry.record_e2e(time.perf_counter() - t0, exemplar=tid)
            n_out += 1
        tuner, rebatcher, admission = self._make_controller()
        dcfg, ktuner = self._make_dispatcher()
        self.tuner, self.ktuner = tuner, ktuner
        if mon is not None and mon.remediation is not None:
            # bind the actuators this run owns (control/remediation.py): an
            # unbound one skips loudly. scale_rate takes the bucket lock; the
            # re-climb request is an Event the tuner consumes at its next
            # on_batch: both safe from the Reporter tick
            if admission is not None:
                mon.remediation.bind(
                    "admission_rate",
                    lambda a, _adm=admission: _adm.scale_rate(a.factor, a.floor))
            if tuner is not None or ktuner is not None:
                def _reclimb(_a, _t=tuner, _k=ktuner):
                    names = []
                    for t in (_t, _k):
                        if t is not None:
                            t.request_reclimb()
                            names.append(t.name)
                    return {"tuners": names}
                mon.remediation.bind("autotune_reclimb", _reclimb)

        def pushed(b):
            # tuner accounting after each pushed batch, in batch order
            if tuner is not None:
                newcap = tuner.on_batch(b.capacity)
                if newcap is not None:
                    rebatcher.set_target(newcap)
            if ktuner is not None:
                newk = ktuner.on_batch(b.capacity)
                if newk is not None:
                    runner.set_k(newk)
        runner = _dispatch.GroupRunner(
            self.chain, dcfg, emit,
            capacities=self._ladder if rebatcher is not None else None,
            pushed=pushed if tuner is not None or ktuner is not None else None)
        if ktuner is not None:
            runner.set_k(ktuner.capacity)
        if mon is not None and tuner is not None:
            mon.registry.attach_gauge("control_chosen_capacity", lambda: tuner.capacity)
        if mon is not None and dcfg is not None:
            mon.registry.attach_gauge("dispatch_k", lambda: runner.k)

        def fed(rb):
            nonlocal n_fed
            if e2e and mon.config.should_sample_e2e(n_fed):
                stamps.append((n_fed, time.perf_counter(), _tracing.tid_of(rb)))
            n_fed += 1
            runner.feed(rb)

        def feed(b):
            for rb in (rebatcher.feed(b) if rebatcher is not None else (b,)):
                fed(rb)
        batches = (self.source.batches_prefetched(self.batch_size, self.prefetch,
                                                  pause_event=self.prefetch_pause)
                   if self.prefetch else self.source.batches(self.batch_size))
        for n, batch in enumerate(batches):
            record_source_launch(self.source, batch)
            _tracing.ingest(batch, n)
            # the shed journal coordinate is the offered position, which
            # trace ids are minted from
            for ab in ((batch,) if admission is None else admission.offer(batch, pos=n)):
                feed(ab)
        _journal.record("eos", pipeline=self.source.getName())
        if admission is not None:
            for ab in admission.drain():            # the bounded held tail
                feed(ab)
        if rebatcher is not None:
            for rb in rebatcher.drain():            # a partial up-rung buffer
                fed(rb)
        runner.finish()                  # the partial tail < K, then the flush
        if self.sink is not None:
            self.sink.consume(None)      # empty-optional EOS signal (wf/sink.hpp)
        self.chain.sync_stats()
        for op in [self.source, *self.chain.ops,
                   *([self.sink] if self.sink is not None else [])]:
            op.close()
        return self.chain.result()

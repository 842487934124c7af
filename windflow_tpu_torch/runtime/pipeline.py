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
suffix of the chain; the source's exhaustion is journaled (``eos``). The
monitoring, control and tracing hooks of the JAX driver are not ported yet;
``event_time=True`` (event-time monitoring) raises.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, List, Optional, Sequence

import torch

from ..basic import DEFAULT_BATCH_SIZE
from ..batch import Batch, same_capacity, stack_batches, tree_leaves, unstack_batches
from ..device import resolve_device
from ..operators.base import Basic_Operator
from ..operators.sink import ReduceSink, Sink
from ..observability import journal as _journal
from ..operators.source import SourceBase
from . import dispatch as _dispatch
from .graphs import StepGraph, leaves, rebuild


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


def _refuse_event_time(event_time) -> None:
    if event_time:
        raise NotImplementedError(
            "event-time monitoring (event_time=True) is not ported yet "
            "(ROADMAP Queue 1 item 16)")


def _batch_nbytes(batch: Batch) -> int:
    return sum(t.numel() * t.element_size()
               for t in (batch.key, batch.id, batch.ts, batch.valid,
                         *tree_leaves(batch.payload)))


class CompiledChain:
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
        _refuse_event_time(event_time)
        self.ops = list(ops)
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
        #: the captured K-step programs, (from_op, K, capacity) -> StepGraph (card)
        self.graphs = {}
        self._warmed = set()    # (from_op, capacity) run once eagerly
        #: set by the threaded drivers while their stage threads run: every
        #: graph was captured before they started, and a capture now (which
        #: synchronizes the device and fails in global capture mode while
        #: other threads launch) raises instead
        self.capture_closed = False

    def reset_states(self) -> None:
        """Re-initialize every operator's state (supervised replay of a chain
        that did not exist at the last checkpoint). The new tensors reach a
        captured graph at its next replay, as restored ones do."""
        self.states = [op.init_state(self.specs[i]) for i, op in enumerate(self.ops)]

    @property
    def out_spec(self):
        return self.specs[-1]

    def push(self, batch: Batch, from_op: int = 0) -> Batch:
        """Run one batch through ops[from_op:]; updates states; returns the out batch."""
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, chain on {self.device}")
        self._push_count += 1
        sampled = self._push_count % self.SERVICE_SAMPLE_EVERY == 0
        t0 = time.perf_counter() if sampled else None
        out = batch
        for j in range(from_op, len(self.ops)):
            self.states[j], out = self.ops[j].apply(self.states[j], out)
        if self._tier_ops:
            self._tier_maintain()
        if sampled and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._record(from_op, 1, batch, out,
                     time.perf_counter() - t0 if sampled else None)
        return out

    def _record(self, from_op: int, k: int, batch: Batch, out: Batch,
                service_time_s: float = None) -> None:
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
            self.ops[from_op].get_StatsRecords()[0].record_launch(service_time_s)

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
        states = rebuild(self.states, leaves(self.states))
        with contextlib.ExitStack() as uncounted:
            for j in self._tier_ops:
                for t in self.ops[j].tier_controllers():
                    uncounted.enter_context(t.store.uncounted())
            for j in range(from_op, len(self.ops)):
                states[j], b = self.ops[j].apply(states[j], b)
        self._warmed.add((from_op, capacity))

    def _graph(self, from_op: int, k: int, capacity: int) -> StepGraph:
        """The captured K-step program for ``(from_op, k, capacity)``: warmed,
        then captured over the chain's states at first use. Capture runs
        nothing, so it touches no state."""
        key = (from_op, k, capacity)
        g = self.graphs.get(key)
        if g is None:
            if self.capture_closed:
                raise RuntimeError(f"{key}: no graph was captured before the stage "
                                   f"threads started, and none is captured while they run")
            self._warm(from_op, capacity)
            empty = Batch.empty(capacity, self.specs[from_op], self.device)
            g = self.graphs[key] = StepGraph(self._k_steps(from_op), list(self.states),
                                              stack_batches([empty] * k))
        return g

    def warm_scan(self, k: int, capacity: int) -> None:
        """Make ready the K-fused program for ``(k, capacity)`` WITHOUT
        touching operator state: the eager warm-up step and, on the card,
        the capture. K <= 1 warms the per-batch step only."""
        self._warm(0, capacity)
        if k > 1 and self.device.type == "cuda":
            self._graph(0, int(k), capacity)

    def push_many(self, batches: Sequence[Batch], from_op: int = 0) -> List[Batch]:
        """Run K same-capacity batches through ops[from_op:] as ONE device
        program; updates states; returns the K out batches in order,
        byte-identical to K sequential :meth:`push` calls. On the card that
        is one replay of the graph captured for ``(from_op, K, capacity)``
        (its inputs copied in, its outputs cloned out); on the CPU the plain
        loop over the same step. Stats: K batches counted per op, ONE
        launch on the entry op. K = 1 delegates to :meth:`push`."""
        batches = list(batches)
        if len(batches) == 1:
            return [self.push(batches[0], from_op=from_op)]
        for b in batches:
            if b.device != self.device:
                raise ValueError(f"batch on {b.device}, chain on {self.device}")
        k = len(batches)
        if self.device.type == "cuda":
            g = self._graph(from_op, k, same_capacity(batches))
            _stack_into(g.inputs, batches)
            states, outs = g.run(self.states)
        else:
            states, outs = self._k_steps(from_op)(self.states, stack_batches(batches))
        self.states = list(states)
        if self._tier_ops:
            self._tier_maintain()
        self._push_count += k
        self._record(from_op, k, batches[0], outs[0])
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

    def result(self) -> dict:
        """Results of the ReduceSink terminal ops (device accumulators)."""
        return {op.name: op.result(self.states[i])
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
    :attr:`prefetch_pause` suspends that worker."""

    def __init__(self, source: SourceBase, ops: Sequence[Basic_Operator],
                 sink: Optional[Sink] = None, *,
                 batch_size: Optional[int] = None, device=None,
                 event_time: bool = None, dispatch=None, prefetch: int = 0):
        _refuse_event_time(event_time)
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
        if source.device != self.device:
            raise ValueError(f"source {source.getName()!r} lives on {source.device} "
                             f"but the pipeline runs on {self.device}")
        self.chain = CompiledChain(ops, source.payload_spec(),
                                   batch_capacity=source.out_capacity(self.batch_size),
                                   device=self.device)

    def _dispatch_config(self) -> Optional[_dispatch.DispatchConfig]:
        """``dispatch=`` resolved (None when off), with the K-step program
        made ready up front when ``prewarm``."""
        cfg = _dispatch.DispatchConfig.resolve(self._dispatch_arg)
        if cfg is None:
            return None
        _dispatch.refuse_k_tuner(cfg)
        if cfg.prewarm and cfg.k > 1:
            self.chain.warm_scan(cfg.k, self.source.out_capacity(self.batch_size))
        return cfg

    def run(self) -> dict:
        """Drive the stream to EOS; returns ``chain.result()``."""
        def emit(out):
            if self.sink is not None:
                self.sink.consume(out)
        runner = _dispatch.GroupRunner(self.chain, self._dispatch_config(), emit)
        batches = (self.source.batches_prefetched(self.batch_size, self.prefetch,
                                                  pause_event=self.prefetch_pause)
                   if self.prefetch else self.source.batches(self.batch_size))
        for batch in batches:
            record_source_launch(self.source, batch)
            runner.feed(batch)
        _journal.record("eos", pipeline=self.source.getName())
        runner.finish()                  # the partial tail < K, then the flush
        if self.sink is not None:
            self.sink.consume(None)      # empty-optional EOS signal (wf/sink.hpp)
        self.chain.sync_stats()
        for op in [self.source, *self.chain.ops,
                   *([self.sink] if self.sink is not None else [])]:
            op.close()
        return self.chain.result()

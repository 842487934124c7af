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

EOS protocol: the source exhausts; then each stateful operator's ``flush``
drains residual state and the flushed batches cascade through the remaining
suffix of the chain. The monitoring, control and tracing hooks of the JAX
driver are not ported yet; ``event_time=True`` (event-time monitoring)
raises.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence

import torch

from ..basic import DEFAULT_BATCH_SIZE
from ..batch import Batch, same_capacity, stack_batches, tree_leaves, unstack_batches
from ..device import resolve_device
from ..operators.base import Basic_Operator
from ..operators.sink import ReduceSink, Sink
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

    #: every Nth push is timed to completion (one device synchronize) and
    #: recorded as the entry op's service time; the other pushes never wait
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
        self._push_count = 0
        #: the captured K-step programs, (from_op, K, capacity) -> StepGraph (card)
        self.graphs = {}
        self._warmed = set()    # (from_op, capacity) run once eagerly

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
        if sampled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
        state. Its kernel launches are real and counted."""
        if (from_op, capacity) in self._warmed:
            return
        b = Batch.empty(capacity, self.specs[from_op], self.device)
        states = rebuild(self.states, leaves(self.states))
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
        self._push_count += k
        self._record(from_op, k, batches[0], outs[0])
        return outs

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
    through ``CompiledChain.push_many``, the partial tail at EOS too."""

    def __init__(self, source: SourceBase, ops: Sequence[Basic_Operator],
                 sink: Optional[Sink] = None, *,
                 batch_size: Optional[int] = None, device=None,
                 event_time: bool = None, dispatch=None):
        _refuse_event_time(event_time)
        self.device = resolve_device(device)
        self.source = source
        self.sink = sink
        self.batch_size = int(batch_size or resolve_batch_hint(ops) or DEFAULT_BATCH_SIZE)
        #: resolved at run(), so an env change after construction counts
        self._dispatch_arg = dispatch
        if source.device != self.device:
            raise ValueError(f"source {source.getName()!r} lives on {source.device} "
                             f"but the pipeline runs on {self.device}")
        self.chain = CompiledChain(ops, source.payload_spec(),
                                   batch_capacity=source.out_capacity(self.batch_size),
                                   device=self.device)

    def _make_accumulator(self) -> Optional[_dispatch.MicrobatchAccumulator]:
        """``dispatch=`` resolved into an accumulator (None when off), with
        the K-step program made ready up front when ``prewarm``."""
        cfg = _dispatch.DispatchConfig.resolve(self._dispatch_arg)
        if cfg is None:
            return None
        _dispatch.refuse_k_tuner(cfg)
        if cfg.prewarm and cfg.k > 1:
            self.chain.warm_scan(cfg.k, self.source.out_capacity(self.batch_size))
        return _dispatch.MicrobatchAccumulator(cfg.k, cfg.linger_s)

    def run(self) -> dict:
        """Drive the stream to EOS; returns ``chain.result()``."""
        acc = self._make_accumulator()

        def deliver(outs):
            if self.sink is not None:
                for out in outs:
                    self.sink.consume(out)
        for batch in self.source.batches(self.batch_size):
            record_source_launch(self.source, batch)
            if acc is None:
                deliver([self.chain.push(batch)])
            else:
                for group in acc.feed(batch):
                    deliver(_dispatch.fused_push(self.chain, group))
        if acc is not None:
            tail = acc.drain()                # the partial tail < K at EOS
            if tail:
                deliver(_dispatch.fused_push(self.chain, tail))
        deliver(self.chain.flush())
        if self.sink is not None:
            self.sink.consume(None)      # empty-optional EOS signal (wf/sink.hpp)
        self.chain.sync_stats()
        for op in [self.source, *self.chain.ops,
                   *([self.sink] if self.sink is not None else [])]:
            op.close()
        return self.chain.result()

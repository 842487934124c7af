"""Linear operator chain + host run loop.

Counterpart of ``windflow_tpu/runtime/pipeline.py`` (``CompiledChain``:
``push``, ``flush``, ``states``; ``Pipeline.run``). The JAX package traces the
chain into one jitted XLA program; PyTorch runs eagerly, so a push is the
operators' ``apply`` in order, each launching its own kernels on the current
CUDA stream. The host does not wait for the card inside a push (except where
an operator must read a device value, e.g. Win_SeqFFAT's flush), so the host
queues batch N+1 while the card runs batch N.

EOS protocol: the source exhausts; then each stateful operator's ``flush``
drains residual state and the flushed batches cascade through the remaining
suffix of the chain. The monitoring, control, tracing and scan-dispatch hooks
of the JAX driver are not ported yet; ``event_time=True`` (event-time
monitoring) raises.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from ..basic import DEFAULT_BATCH_SIZE
from ..batch import Batch, tree_leaves
from ..device import resolve_device
from ..operators.base import Basic_Operator
from ..operators.sink import ReduceSink, Sink
from ..operators.source import SourceBase


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

    def __init__(self, ops: Sequence[Basic_Operator], in_spec: Any,
                 batch_capacity: int = None, device=None, event_time: bool = None):
        _refuse_event_time(event_time)
        self.ops = list(ops)
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

    @property
    def out_spec(self):
        return self.specs[-1]

    def push(self, batch: Batch, from_op: int = 0) -> Batch:
        """Run one batch through ops[from_op:]; updates states; returns the out batch."""
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, chain on {self.device}")
        self._push_count += 1
        in_bytes = _batch_nbytes(batch)
        out = batch
        for j in range(from_op, len(self.ops)):
            self.states[j], out = self.ops[j].apply(self.states[j], out)
        out_bytes = _batch_nbytes(out)
        for j in range(from_op, len(self.ops)):
            rec = self.ops[j].get_StatsRecords()[0]
            rec.batches_received += 1
            rec.batches_sent += 1
            rec.bytes_received += in_bytes
            rec.bytes_sent += out_bytes
        if from_op < len(self.ops):
            self.ops[from_op].get_StatsRecords()[0].record_launch()
        return out

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


class Pipeline:
    """Source -> ops... -> sink, run batch-at-a-time on ``device``
    (None = ``"cuda"``; raises without CUDA)."""

    def __init__(self, source: SourceBase, ops: Sequence[Basic_Operator],
                 sink: Optional[Sink] = None, *,
                 batch_size: Optional[int] = None, device=None,
                 event_time: bool = None):
        _refuse_event_time(event_time)
        self.device = resolve_device(device)
        self.source = source
        self.sink = sink
        self.batch_size = int(batch_size or DEFAULT_BATCH_SIZE)
        if source.device != self.device:
            raise ValueError(f"source {source.getName()!r} lives on {source.device} "
                             f"but the pipeline runs on {self.device}")
        self.chain = CompiledChain(ops, source.payload_spec(),
                                   batch_capacity=source.out_capacity(self.batch_size),
                                   device=self.device)

    def run(self) -> dict:
        """Drive the stream to EOS; returns ``chain.result()``."""
        for batch in self.source.batches(self.batch_size):
            self.source.get_StatsRecords()[0].record_launch()
            out = self.chain.push(batch)
            if self.sink is not None:
                self.sink.consume(out)
        for out in self.chain.flush():
            if self.sink is not None:
                self.sink.consume(out)
        if self.sink is not None:
            self.sink.consume(None)      # empty-optional EOS signal (wf/sink.hpp)
        self.chain.sync_stats()
        for op in [self.source, *self.chain.ops,
                   *([self.sink] if self.sink is not None else [])]:
            op.close()
        return self.chain.result()

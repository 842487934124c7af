"""PipeGraph + MultiPipe — the composition layer, with the serial push driver.

Counterpart of ``windflow_tpu/runtime/pipegraph.py`` (reference
``wf/pipegraph.hpp``: PipeGraph ``:104-244``, MultiPipe ``:255-571``, split
``:3030-3062``, select ``:3065-3081``, merge ``:2992-3026``, the Application
Tree ``AppNode`` ``:64-75``). Each MultiPipe's operator chain runs as one
:class:`~windflow_tpu_torch.runtime.pipeline.CompiledChain`; the DAG between
MultiPipes (split and merge edges) is driven by a host push loop:

- ``add(op)`` / ``chain(op)`` append to the chain; ``chain`` records whether
  the operator fused (FORWARD) or fell back to a routed add, as the
  reference does, and ``dump_DOTGraph`` renders the outcome.
- ``split(fn, n)``: ``fn(t)`` per tuple under ``torch.func.vmap`` returns an
  int branch (compared with ``== i`` as int32) or a ``[n]`` bool multicast
  mask; branch i receives the batch masked to its tuples.
- ``select(i)``: the i-th split branch; ``merge(*others)``: several streams
  into one, legal as in the reference (independent roots, a whole split
  subtree, or contiguous sibling branches). In ``Mode.DETERMINISTIC`` a merge
  goes through an :class:`~windflow_tpu_torch.parallel.ordering.
  Ordering_Node` (TS_RENUMBERING when a count-based window follows), whose
  released prefix is re-sliced to ``batch_size`` so the downstream chain
  keeps one shape (and on the card, replays one captured graph).
- EOS: a source that runs dry flushes its pipe and closes its merge
  channels (cascading to consumers whose inputs are all done); then every
  pipe flushes in topological order and every sink gets ``None``.

Scan dispatch (``dispatch=``) buffers root batches in arrival order and runs
each root's run as one ``push_many``; downstream hops stay per batch, in the
per-batch order.

The threaded driver (``run(threaded=True)``): one host thread a MultiPipe and
one a source, one native SPSC ring a dataflow edge (:meth:`PipeGraph._iter_edges`,
``queue_capacity=``), a merge polling its rings round-robin. Each thread runs
under a CUDA stream of its own and batches cross edges only through
``runtime/handoff.py``. DETERMINISTIC merges go through the same
Ordering_Node as the serial driver; splits deliver through ``split_masks``;
each pipe thread dispatches with its own accumulator
(``runtime/dispatch.py::GroupRunner``). ``start(threaded=True)`` builds every
pipe's chain and captures every graph a thread may replay before any thread
starts.

Supervised execution (``run_supervised``): aligned checkpoints of every
pipe's state, replay from the committed source positions and exactly-once
delivery on every sink (``runtime/supervisor.py``); with ``shards=`` (or
``WF_SHARDS``) above 1, shard-local supervision over key ranges, with an
explicit ``reshard=`` plan and ``shard_key=``.

The EOS records of the JAX drivers are journaled (``eos_flush`` a pipe in
the serial driver's EOS flush, ``eos_propagate`` a pipe thread's end).
``monitoring=`` and ``trace=`` (None consults ``WF_MONITORING`` /
``WF_TRACE``) run a ``Monitor`` (registry over the graph, a depth gauge a
ring under the threaded driver, topology dumps at the end) and a ``Tracer``
from :meth:`PipeGraph.start`; trace ids are minted per root stream and
offered position, each pipe's chain is the stage ``pipe<i>``, and the
monitoring argument's event-time toggle builds the chains. ``control=`` is
refused by name (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import torch

from ..basic import DEFAULT_BATCH_SIZE, Mode, ordering_mode_t, routing_modes_t
from ..batch import Batch, map_tuples, tree_map
from ..device import resolve_device
from ..observability import journal as _journal
from ..observability import tracing as _tracing
from ..operators.base import Basic_Operator
from ..operators.sink import Sink
from ..operators.source import SourceBase
from ..parallel.emitters import split_masks
from . import dispatch as _dispatch
from .pipeline import (CompiledChain, record_source_launch, refuse_control,
                       resolve_batch_hint)


def _spec_sig(spec):
    """Structure, shapes and dtypes of a payload spec: what merge compares."""
    if isinstance(spec, dict):
        return ("dict", tuple((k, _spec_sig(v)) for k, v in spec.items()))
    if isinstance(spec, (list, tuple)):
        return (type(spec).__name__, tuple(_spec_sig(v) for v in spec))
    return (tuple(spec.shape), spec.dtype)


class AppNode:
    """Node of the Application Tree (``wf/pipegraph.hpp:64-75``). A merge
    removes the absorbed pipes' nodes from the live forest (``absorbed``
    set, ``parent`` cleared); the live forest is the nodes not absorbed."""

    def __init__(self, mp: "MultiPipe", parent: Optional["AppNode"] = None):
        self.mp = mp
        self.parent = parent
        self.children: List[AppNode] = []
        self.absorbed = False

    def absorb(self) -> None:
        """Detach this node (and its subtree) from the live forest."""
        self.absorbed = True
        self.parent = None
        for c in self.children:
            c.absorb()


class MultiPipe:
    """A growing chain of operators with optional split/merge structure."""

    def __init__(self, graph: "PipeGraph", source: Optional[SourceBase] = None):
        self.graph = graph
        self.source = source
        self.ops: List[Basic_Operator] = []
        self.sink: Optional[Sink] = None
        self.has_sink = False
        self.split_fn: Optional[Callable] = None
        self.split_branches: List[MultiPipe] = []
        self.merge_inputs: List[MultiPipe] = []
        self._dataflow_parent: Optional[MultiPipe] = None   # split-branch feeder
        self._chain: Optional[CompiledChain] = None
        self._outputs_to: List[MultiPipe] = []
        self._ordering = None     # Ordering_Node of a DETERMINISTIC merge
        # application-tree position of a PARTIAL merge result: the reference
        # re-parents the merged AppNode under the split parent, replacing the
        # absorbed sibling branches (wf/pipegraph.hpp:944-952)
        self._merge_parent: Optional[MultiPipe] = None
        self._covers_idx: tuple = ()

    # -- construction (wf/pipegraph.hpp:1565-2950) ----------------------------------

    def add(self, op: Basic_Operator) -> "MultiPipe":
        self._check_open()
        if isinstance(op, Sink):
            raise TypeError(
                f"add({op.name}): host Sinks terminate a MultiPipe — use "
                f"add_sink()/chain_sink() (in-graph reductions stay addable via "
                f"ReduceSink)")
        op._mark_used()
        op._chained = False
        self.graph._register(op)
        self.ops.append(op)
        return self

    def chain(self, op: Basic_Operator) -> "MultiPipe":
        """Queue-free fusion when the operator is FORWARD, a routed ``add``
        otherwise (``wf/pipegraph.hpp:1602-1640``); the outcome is recorded on
        the operator."""
        self.add(op)
        op._chained = op.getRoutingMode() in (routing_modes_t.FORWARD,
                                              routing_modes_t.NONE)
        return self

    def add_sink(self, sink: Sink) -> "MultiPipe":
        self._check_open()
        sink._mark_used()
        self.graph._register(sink)
        self.sink = sink
        self.has_sink = True
        return self

    chain_sink = add_sink

    # -- split / select / merge -----------------------------------------------------

    def split(self, fn: Callable, n_branches: int) -> "MultiPipe":
        """``fn(t) -> int branch`` or ``fn(t) -> bool[n]`` multicast mask."""
        self._check_open()
        if self.has_sink:
            raise RuntimeError("cannot split a MultiPipe with a sink")
        self.split_fn = fn
        self.split_branches = []
        node = self.graph._node_of(self)
        for _ in range(n_branches):
            child = MultiPipe(self.graph)
            child._dataflow_parent = self
            self.split_branches.append(child)
            cn = AppNode(child, node)
            node.children.append(cn)
            self.graph._nodes[id(child)] = cn
        return self

    def select(self, i: int) -> "MultiPipe":
        if self.split_fn is None:
            raise RuntimeError("select() on a non-split MultiPipe (wf/pipegraph.hpp:3065)")
        if not (0 <= i < len(self.split_branches)):
            raise IndexError(f"branch {i} of {len(self.split_branches)}")
        return self.split_branches[i]

    def merge(self, *others: "MultiPipe") -> "MultiPipe":
        """Merge this pipe's output with ``others`` into a new MultiPipe
        (legality as in ``wf/pipegraph.hpp:813-965,2992-3026``)."""
        pipes = [self, *others]
        merge_parent, covers_idx = self.graph._check_merge_legality(pipes)
        sigs = [_spec_sig(p._out_payload_spec()) for p in pipes]
        if any(s != sigs[0] for s in sigs[1:]):
            raise TypeError("merge(): incompatible tuple types "
                            "(wf/pipegraph.hpp:1573-1578 typeid check)")
        merged = MultiPipe(self.graph)
        merged.merge_inputs = pipes
        merged._merge_parent = merge_parent
        merged._covers_idx = covers_idx
        # Application-Tree surgery: the merged node is a LEAF replacing the
        # absorbed subtrees, under the split parent for merge-partial (and
        # nested merge-full), as a root for merge-ind / root-level merge-full
        node = AppNode(merged)
        if merge_parent is not None:
            parent_node = self.graph._node_of(merge_parent)
            node.parent = parent_node

            def _child_idxs(c):
                if c.mp._merge_parent is merge_parent:
                    return set(c.mp._covers_idx)
                return {i for i, b in enumerate(merge_parent.split_branches)
                        if b is c.mp}
            target = set(covers_idx)
            new_children, replaced = [], False
            for c in parent_node.children:
                ci = _child_idxs(c)
                if ci and ci <= target:
                    c.absorb()
                    if not replaced:
                        new_children.append(node)
                        replaced = True
                else:
                    new_children.append(c)
            parent_node.children = new_children
        else:
            for p in pipes:
                self.graph._node_of(p).absorb()
        for p in pipes:
            p._outputs_to.append(merged)
        self.graph._nodes[id(merged)] = node
        self.graph._merged_roots = [r for r in self.graph._merged_roots if r not in pipes]
        self.graph._merged_roots.append(merged)
        return merged

    def join_with(self, other: "MultiPipe", join_op) -> "MultiPipe":
        """Merge this pipe with ``other`` (both carry the tagged payload
        schema) and add ``join_op``, a StreamTableJoin or IntervalJoin whose
        ``side_fn`` separates the sides again. Under ``Mode.DETERMINISTIC`` the
        merge's Ordering_Node fixes the interleave, so the join is
        byte-identical across drivers."""
        from ..operators.join import IntervalJoin, StreamTableJoin
        if not isinstance(join_op, (StreamTableJoin, IntervalJoin)):
            raise TypeError(
                f"join_with expects a StreamTableJoin/IntervalJoin operator, got "
                f"{type(join_op).__name__}")
        merged = self.merge(other)
        merged.add(join_op)
        return merged

    # -- internals ------------------------------------------------------------------

    def _check_open(self):
        if self.split_fn is not None:
            raise RuntimeError("MultiPipe already split; use select()")
        if self.has_sink:
            raise RuntimeError("MultiPipe already has a sink")

    def _in_payload_spec(self):
        if self.source is not None:
            return self.source.payload_spec()
        if self.merge_inputs:
            return self.merge_inputs[0]._out_payload_spec()
        return self._dataflow_parent._out_payload_spec()

    def _out_payload_spec(self):
        spec = self._in_payload_spec()
        for op in self.ops:
            spec = op.out_spec(spec)
        return spec

    def _compile(self, batch_capacity: int) -> CompiledChain:
        if self._chain is None:
            from ..observability import event_time_enabled
            self._chain = CompiledChain(
                self.ops, self._in_payload_spec(), batch_capacity=batch_capacity,
                device=self.graph.device,
                event_time=event_time_enabled(self.graph._monitoring_arg))
            # the health ledger's and the flight recorder's stage label
            self._chain.label = self.graph._trace_label(self)
        return self._chain


class PipeGraph:
    """The streaming environment (``wf/pipegraph.hpp:104-244``), on one
    ``device`` (None = ``"cuda"``; raises without CUDA)."""

    def __init__(self, name: str = "pipegraph", mode: Mode = Mode.DEFAULT,
                 batch_size: int = None, monitoring=None, control=None,
                 trace=None, dispatch=None, device=None, queue_capacity=8):
        refuse_control(control)
        #: None = consult WF_MONITORING / WF_TRACE; resolved at start()
        self._monitoring_arg = monitoring
        self._monitor = None
        self._trace_arg = trace
        self._tracer = None
        self._trace_labels = None
        #: the serial driver's e2e sample in flight (source framing time)
        self._e2e_t0 = None
        self.name = name
        self.mode = mode
        self.device = resolve_device(device)
        #: None = resolved at start(): the smallest withBatch hint of the
        #: registered operators, else DEFAULT_BATCH_SIZE
        self.batch_size = batch_size
        self._dispatch_arg = dispatch
        self._dispatch = None
        #: the threaded driver's ring capacity a edge (one int, a dict by edge
        #: label or index, or ``(label, index) -> int``)
        self.queue_capacity = queue_capacity
        self._threaded = False
        self._roots: List[MultiPipe] = []
        self._merged_roots: List[MultiPipe] = []
        self._nodes = {}
        self._operators: List[Basic_Operator] = []
        self._started = False
        self._ended = False
        self._exhausted = set()       # pipe ids whose inputs are known complete

    # -- reference surface ----------------------------------------------------------

    def add_source(self, source: SourceBase) -> MultiPipe:
        if self._started:
            raise RuntimeError("graph already running")
        source._mark_used()
        self._register(source)
        mp = MultiPipe(self, source)
        self._roots.append(mp)
        self._nodes[id(mp)] = AppNode(mp)
        return mp

    def run(self, threaded: bool = False):
        """Drive the graph to completion: the serial push driver, or with
        ``threaded`` one host thread a MultiPipe and a source."""
        self.start(threaded=threaded)
        return self.wait_end()

    def run_supervised(self, *, checkpoint_every: int = 8, max_restarts: int = 3,
                       **hardening):
        """Supervised execution of the whole DAG: aligned checkpoints, replay
        from the committed positions on failure, exactly-once delivery on
        every sink (``runtime/supervisor.py::run_graph_supervised``; the
        reference's failure model is exit(EXIT_FAILURE)). ``hardening``
        forwards the recovery knobs: ``backoff_base``/``backoff_cap``
        (decorrelated-jitter restart backoff), ``dead_letter``/
        ``poison_threshold`` (poison-batch quarantine), ``step_timeout``
        (hung-step watchdog), ``faults`` (a FaultPlan/FaultInjector),
        ``dispatch``, and shard-local supervision's ``shards``, ``reshard``
        and ``shard_key``. Sets :attr:`supervised_restarts` (and, sharded,
        :attr:`_shard_report`: ``names.py::SHARD_GAUGES`` rows a shard)."""
        from .supervisor import run_graph_supervised
        return run_graph_supervised(self, checkpoint_every=checkpoint_every,
                                    max_restarts=max_restarts, **hardening)

    def start(self, threaded: bool = False):
        """Resolve the batch size and dispatch and make the roots' programs
        ready. ``threaded``: :meth:`wait_end` runs the threaded driver, and
        every pipe's chain is built and every graph its thread may replay
        captured now (:meth:`_prepare_threaded`)."""
        if self.batch_size is None:
            self.batch_size = resolve_batch_hint(self._operators) or DEFAULT_BATCH_SIZE
        self._started = True
        self._threaded = threaded
        if self._monitor is None:
            from ..observability import Monitor, MonitoringConfig
            cfg = MonitoringConfig.resolve(self._monitoring_arg)
            if cfg is not None:
                self._monitor = Monitor(cfg, self.name)
                self._monitor.registry.register_graph(self)
                self._monitor.start()
        if self._tracer is None:
            from ..observability import TraceConfig, Tracer
            tcfg = TraceConfig.resolve(self._trace_arg)
            if tcfg is not None:
                self._tracer = Tracer(tcfg, self.name).start()
        if threaded:
            self._prepare_threaded()
            return
        if self._dispatch is None:
            cfg = _dispatch.DispatchConfig.resolve(self._dispatch_arg)
            if cfg is not None:
                _dispatch.refuse_k_tuner(cfg)
                if cfg.prewarm and cfg.k > 1:
                    # the roots' K-step programs made ready before the first
                    # batch, as Pipeline does (runs no batch, touches no state)
                    for mp in self._roots:
                        cap = mp.source.out_capacity(self.batch_size)
                        mp._compile(cap).warm_scan(cfg.k, cap)
            self._dispatch = cfg

    def wait_end(self):
        """Drive the whole DAG to completion: the sources round-robin, one
        batch at a time, each pushed through its pipe and onward."""
        if self._ended:
            return self._results()
        if not self._started:
            self.start()
        try:
            if self._threaded:
                return self._run_threaded()
            return self._run_serial()
        finally:
            if self._tracer is not None:
                self._tracer.finish()
            if self._monitor is not None:
                self._monitor.finish(self)

    def _trace_label(self, mp) -> str:
        """The flight recorder's (and the health ledger's) stage label of one
        pipe: ``pipe<i>`` by its index in :meth:`_all_pipes`."""
        if self._trace_labels is None or id(mp) not in self._trace_labels:
            self._trace_labels = {id(p): f"pipe{i}" for i, p in enumerate(self._all_pipes())}
        return self._trace_labels.get(id(mp), "pipe?")

    def _run_serial(self):
        from .. import control as _control
        live = [(mp, mp.source.batches(self.batch_size)) for mp in self._roots]
        pos = 0
        # trace ids are minted per (root stream, offered position a root): the
        # coordinates the supervised driver replays
        root_idx = {id(mp): i for i, mp in enumerate(self._roots)}
        offered = {id(mp): 0 for mp in self._roots}
        n_pushed = 0
        # scan dispatch: batches buffer in ARRIVAL order across all roots and
        # run together the moment any root holds K; each root's run is one
        # push_many, and the outputs deliver in the arrival interleave, so
        # every downstream merge sees the per-batch order
        dk = self._dispatch.k if self._dispatch is not None and self._dispatch.k > 1 else 0
        buf: list = []           # (mp, batch, e2e t0 or None) in arrival order
        buf_n: dict = {}

        def flush_buf():
            if not buf:
                return
            outs = {}
            for mp2 in self._roots:
                run = [b for m, b, _ in buf if m is mp2]
                if run:
                    outs[id(mp2)] = iter(self._compute_many(mp2, run, dk))
            for m, _, t0 in buf:
                self._e2e_t0 = t0
                self._deliver(m, next(outs[id(m)]))
                self._e2e_t0 = None
            buf.clear()
            buf_n.clear()
            _control.set_gauge("dispatch_linger_depth", 0)

        while live:
            mp, it = live[pos % len(live)]
            try:
                batch = next(it)
            except StopIteration:
                live.remove((mp, it))
                flush_buf()            # buffered batches land before this root flushes
                self._exhaust(mp)
                continue
            record_source_launch(mp.source, batch)
            _tracing.ingest(batch, offered[id(mp)], stream=root_idx[id(mp)])
            offered[id(mp)] += 1
            pos += 1
            sampled = (self._monitor is not None
                       and self._monitor.config.should_sample_e2e(n_pushed))
            n_pushed += 1
            t0 = time.perf_counter() if sampled else None
            if not dk:
                # e2e sample: source framing to the first sink's receipt
                self._e2e_t0 = t0
                self._push(mp, batch)
                self._e2e_t0 = None
                continue
            buf.append((mp, batch, t0))
            buf_n[id(mp)] = buf_n.get(id(mp), 0) + 1
            _control.set_gauge("dispatch_linger_depth", len(buf))
            if buf_n[id(mp)] >= dk:
                flush_buf()
        # EOS: every pipe in topological order; a merged pipe first drains its
        # Ordering_Node (tuples held back by the low watermark)
        pipe_idx = {id(p): i for i, p in enumerate(self._all_pipes())}
        for mp in self._topo_order():
            _journal.record("eos_flush", graph=self.name, pipe=pipe_idx.get(id(mp)))
            if mp._ordering is not None:
                for piece in self._chunks(mp._ordering.flush(),
                                          mp._ordering.last_release_count):
                    self._push(mp, piece)
            self._flush_pipe(mp)
        for mp in self._all_pipes():
            if mp.sink is not None:
                mp.sink.consume(None)
        for mp in self._all_pipes():
            if mp._chain is not None:
                mp._chain.sync_stats()
        for op in self._operators:
            op.close()                # closing_func per replica
        self._ended = True
        return self._results()

    def getNumThreads(self) -> int:
        """Total replicas over the operators (the reference counts threads)."""
        return sum(op.getParallelism() for op in self._operators)

    def listOperators(self) -> List[Basic_Operator]:
        return list(self._operators)

    def dump_stats(self, log_dir: str = "log"):
        """Every operator's Stats_Record as JSON under ``log_dir``; returns
        the paths written."""
        return [rec.dump_to_file(log_dir) for op in self._operators
                for rec in op.get_StatsRecords()]

    def dump_DOTGraph(self, path: str = None) -> str:
        """Graphviz text of the graph (GRAPHVIZ_WINDFLOW, ``wf/pipegraph.hpp:
        226-237,1450-1518``), the JAX package's text."""
        lines = ["digraph PipeGraph {", "  rankdir=LR;"]

        def op_label(o):
            if o._chained:
                return f"{o.getName()} (chained)"
            mode = o.getRoutingMode().name.lower()
            return (o.getName() if mode in ("forward", "none")
                    else f"{o.getName()} ({mode})")

        def label(mp, idx):
            ops = " | ".join(op_label(o) for o in mp.ops) or "(empty)"
            src = f"{mp.source.getName()} -> " if mp.source else ""
            snk = f" -> {mp.sink.getName()}" if mp.sink else ""
            return f'  mp{idx} [shape=record, label="{src}{ops}{snk}"];'
        pipes = self._all_pipes()
        index = {id(p): i for i, p in enumerate(pipes)}
        for i, p in enumerate(pipes):
            lines.append(label(p, i))
        for p in pipes:
            for b in p.split_branches:
                lines.append(f"  mp{index[id(p)]} -> mp{index[id(b)]} [label=split];")
            for m in p._outputs_to:
                lines.append(f"  mp{index[id(p)]} -> mp{index[id(m)]} [label=merge];")
        lines.append("}")
        dot = "\n".join(lines)
        if path:
            with open(path, "w") as f:
                f.write(dot)
        return dot

    # -- driver internals -----------------------------------------------------------

    def _register(self, op):
        self._operators.append(op)

    def _node_of(self, mp) -> AppNode:
        return self._nodes[id(mp)]

    def _all_pipes(self) -> List[MultiPipe]:
        out, seen = [], set()

        def visit(mp):
            if id(mp) in seen:
                return
            seen.add(id(mp))
            out.append(mp)
            for b in mp.split_branches:
                visit(b)
            for m in mp._outputs_to:
                visit(m)
        for r in self._roots:
            visit(r)
        return out

    def _topo_order(self) -> List[MultiPipe]:
        """Upstream-before-downstream order for EOS flushing."""
        order, seen = [], set()

        def visit(mp):
            if id(mp) in seen:
                return
            seen.add(id(mp))
            for up in mp.merge_inputs:
                visit(up)
            if mp._dataflow_parent is not None:
                visit(mp._dataflow_parent)
            order.append(mp)
        for p in self._all_pipes():
            visit(p)
        return order

    def _push(self, mp: MultiPipe, batch: Batch):
        """One batch through mp's chain and onward through its edges."""
        chain = mp._compile(batch.capacity)
        span = _tracing.service(batch, chain.label)
        out = chain.push(batch)
        if span is not None:
            span.done()
            _tracing.carry(batch, out)
        self._deliver(mp, out)

    def _compute_many(self, mp: MultiPipe, batches, k: int):
        """Outputs of a buffered run of mp's batches, not delivered: runs of
        up to ``k`` same-capacity batches as one ``push_many``, byte-identical
        to the per-batch pushes."""
        acc = _dispatch.MicrobatchAccumulator(max(int(k), 1), publish_gauge=False)
        groups = []
        for b in batches:
            groups += acc.feed(b)
        if len(acc):
            groups.append(acc.drain())
        outs = []
        for g in groups:
            chain = mp._compile(g[0].capacity)
            outs += _dispatch.fused_push(chain, g, chain.label)
        return outs

    def _ordering_of(self, merged: MultiPipe):
        """The merge's Ordering_Node (DETERMINISTIC mode): TS_RENUMBERING when a
        count-based window follows the merge (``wf/pipegraph.hpp:1954-1957``),
        so released tuples carry progressive ids; TS otherwise."""
        if merged._ordering is None:
            from ..parallel.ordering import Ordering_Node
            cb_downstream = any(getattr(getattr(op, "spec", None), "is_cb", False)
                                for op in merged.ops)
            mode = ordering_mode_t.TS_RENUMBERING if cb_downstream else ordering_mode_t.TS
            merged._ordering = Ordering_Node(len(merged.merge_inputs), mode,
                                             device=self.device)
        return merged._ordering

    def _chunks(self, batch: Optional[Batch], n: Optional[int] = None,
                compact: bool = False):
        """Re-slice a released (variable-capacity) batch into pieces of
        ``batch_size`` lanes, so downstream chains keep one shape. ``n`` is
        the live count when the caller has it (an Ordering_Node release is a
        sorted prefix); otherwise it is read from the device (after a
        compaction when ``compact``)."""
        if batch is None:
            return
        b = batch.compact() if compact else batch
        if n is None:
            n = int(b.valid.sum())
        cap = self.batch_size
        for s in range(0, n, cap):
            def cut(a):
                seg = a[s:s + cap]
                pad = cap - seg.shape[0]
                if pad:
                    seg = torch.cat([seg, seg.new_zeros((pad,) + tuple(seg.shape[1:]))])
                return seg
            yield Batch(key=cut(b.key), id=cut(b.id), ts=cut(b.ts),
                        payload=tree_map(cut, b.payload), valid=cut(b.valid))

    def _deliver(self, mp: MultiPipe, out: Batch):
        if mp.sink is not None:
            mp.sink.consume(out)
            if self._e2e_t0 is not None and self._monitor is not None:
                self._monitor.registry.record_e2e(time.perf_counter() - self._e2e_t0,
                                                  exemplar=_tracing.tid_of(out))
                self._e2e_t0 = None    # one sample a sampled source batch
        if mp.split_fn is not None:
            self._push_split(mp, out)
        for merged in mp._outputs_to:
            if self.mode == Mode.DETERMINISTIC:
                onode = self._ordering_of(merged)
                rel = onode.push(merged.merge_inputs.index(mp), out)
                for piece in self._chunks(rel, onode.last_release_count):
                    self._push(merged, piece)
            else:
                self._push(merged, out)

    def _push_split(self, mp: MultiPipe, out: Batch):
        sel = map_tuples(mp.split_fn, out)
        for branch, keep in zip(mp.split_branches,
                                split_masks(sel, len(mp.split_branches))):
            masked = out.mask(keep)
            _tracing.carry(out, masked)     # mask() makes a new Batch
            self._push(branch, masked)

    def _check_merge_legality(self, pipes):
        """The reference's merge rules (``wf/pipegraph.hpp:813-965,2992-3026``).

        Entry checks: at least two distinct pipes, all of this graph, none
        already merged, split, or terminated by a sink. Structural cases:
        merge-ind (independent roots), merge-full (a whole split subtree,
        collapsed bottom-up like ``get_MergedNodes1``), merge-partial
        (siblings under one split parent with CONTIGUOUS branch indexes).
        Returns (app-tree parent, covered indexes) of a partial merge, else
        (None, ())."""
        if len(pipes) < 2:
            raise RuntimeError(
                "merge must be applied to at least two MultiPipe instances "
                "(wf/pipegraph.hpp:2996-2999)")
        if len({id(p) for p in pipes}) != len(pipes):
            raise RuntimeError("a MultiPipe cannot be merged with itself "
                               "(wf/pipegraph.hpp:3003-3008)")
        for p in pipes:
            if id(p) not in self._nodes:
                raise RuntimeError("MultiPipe to be merged does not belong to "
                                   "this PipeGraph (wf/pipegraph.hpp:673-676)")
            if p._outputs_to:
                raise RuntimeError("MultiPipe has already been merged "
                                   "(application-tree leaf check, "
                                   "wf/pipegraph.hpp:678)")
            if p.split_fn is not None:
                raise RuntimeError("a split MultiPipe cannot be merged — merge "
                                   "its branches (wf/pipegraph.hpp:678)")
            if p.has_sink:
                raise RuntimeError("a MultiPipe with a sink has no output to merge")

        # each work item covers a set of branch indexes under its app-tree
        # parent (a split branch its own index, a partial-merge result the
        # indexes it absorbed); items covering ALL of a parent's branches
        # collapse into that parent, bottom-up
        def cover_of(p):
            """(app-tree parent, covered branch-index set); (None, None) = root."""
            if p._merge_parent is not None:
                return p._merge_parent, set(p._covers_idx)
            par = p._dataflow_parent
            if par is None:
                return None, None
            return par, {next(i for i, b in enumerate(par.split_branches) if b is p)}

        work = list(pipes)
        changed = True
        while changed:
            changed = False
            by_parent: dict = {}
            for p in work:
                par, idxs = cover_of(p)
                if par is not None:
                    by_parent.setdefault(id(par), (par, []))[1].append((p, idxs))
            for par, items in by_parent.values():
                covered = set().union(*(i for _, i in items))
                if covered == set(range(len(par.split_branches))):
                    drop = {id(p) for p, _ in items}
                    work = [w for w in work if id(w) not in drop] + [par]
                    changed = True
                    break
        covers = [cover_of(w) for w in work]
        if all(par is None for par, _ in covers):
            return None, ()            # merge-ind, or merge-full collapsed to roots
        if any(par is None for par, _ in covers):
            raise RuntimeError("the requested merge operation is not supported: "
                               "mixed roots and split branches "
                               "(wf/pipegraph.hpp:963-965)")
        if len({id(par) for par, _ in covers}) != 1:
            raise RuntimeError("the requested merge operation is not supported: "
                               "branches of different split parents "
                               "(wf/pipegraph.hpp:963-965)")
        par = covers[0][0]
        idxs = sorted(set().union(*(i for _, i in covers)))
        if idxs != list(range(idxs[0], idxs[0] + len(idxs))):
            raise RuntimeError("sibling MultiPipes to be merged must be "
                               "contiguous branches of the same MultiPipe "
                               "(wf/pipegraph.hpp:903-910)")
        return par, tuple(idxs)

    def _exhaust(self, mp: MultiPipe):
        """mp's inputs are complete: flush its chain, close its channels into
        DETERMINISTIC merges (a frozen watermark must not gate the surviving
        channels), and cascade to consumers whose inputs are all done."""
        if id(mp) in self._exhausted:
            return
        self._exhausted.add(id(mp))
        self._flush_pipe(mp)
        for branch in mp.split_branches:
            self._exhaust(branch)
        for merged in mp._outputs_to:
            if self.mode == Mode.DETERMINISTIC:
                onode = self._ordering_of(merged)
                rel = onode.close_channel(merged.merge_inputs.index(mp))
                for piece in self._chunks(rel, onode.last_release_count):
                    self._push(merged, piece)
            if all(id(p) in self._exhausted for p in merged.merge_inputs):
                self._exhaust(merged)

    # -- threaded driver ------------------------------------------------------------

    def _iter_edges(self):
        """Dataflow edges of the threaded driver in ring-creation order:
        ``(producer, consumer, label, index)``, ``producer`` None for a
        source's edge. The one enumeration of the rings, read by
        :meth:`_run_threaded` (and by a validator of ring capacities)."""
        pipes = self._all_pipes()
        pipe_idx = {id(p): i for i, p in enumerate(pipes)}
        n = 0
        for p in pipes:
            if p.source is not None:
                yield None, p, f"src->{pipe_idx[id(p)]}", n
                n += 1
            for b in p.split_branches:
                yield p, b, f"{pipe_idx[id(p)]}->{pipe_idx[id(b)]}", n
                n += 1
            for m in p._outputs_to:
                yield p, m, f"{pipe_idx[id(p)]}->{pipe_idx[id(m)]}", n
                n += 1

    def _prepare_threaded(self):
        """Before any thread starts: each pipe's chain built at the capacity
        its input has (a root: its source's; a split branch: its parent's
        output; a DETERMINISTIC merge: ``batch_size``, the Ordering_Node's
        re-slicing; a DEFAULT merge: its first input's output), each merge's
        Ordering_Node made, and with dispatch every K' in 2..K captured at
        that capacity (``threaded.prewarm``)."""
        from .threaded import prewarm
        cfg = _dispatch.DispatchConfig.resolve(self._dispatch_arg)
        if cfg is not None:
            _dispatch.refuse_k_tuner(cfg)
        self._dispatch = cfg
        out_cap = {}
        for mp in self._topo_order():
            if mp.source is not None:
                cap = mp.source.out_capacity(self.batch_size)
            elif mp.merge_inputs:
                if self.mode == Mode.DETERMINISTIC:
                    self._ordering_of(mp)
                    cap = self.batch_size
                else:
                    cap = out_cap[id(mp.merge_inputs[0])]
            else:
                cap = out_cap[id(mp._dataflow_parent)]
            chain = mp._compile(cap)
            for op in chain.ops:
                cap = op.out_capacity(cap)
            out_cap[id(mp)] = cap
            if cfg is not None:
                prewarm(chain, cfg.k, chain.capacity)

    def _run_threaded(self):
        from ..native import SPSCQueue
        from .faults import drain_queue_to_sentinel
        from .handoff import receive, send
        from .threaded import (EOS, join_streams, on_stream,
                               resolve_edge_capacity, stage_stream)

        pipes = self._all_pipes()
        pipe_idx = {id(p): i for i, p in enumerate(pipes)}
        # one SPSC ring a dataflow edge (one producer, one consumer); a pipe
        # with several inputs (a merge) polls its rings round-robin
        in_queues = {id(p): [] for p in pipes}
        out_edges = {}                  # (producer id | "src", consumer id) -> ring
        channel_of = {}                 # ring id -> merge channel
        edge_label = {}                 # ring id -> edge label
        for prod, dst, label, index in self._iter_edges():
            cap = resolve_edge_capacity(self.queue_capacity, label, index)
            q = SPSCQueue(cap)
            in_queues[id(dst)].append(q)
            out_edges[("src" if prod is None else id(prod), id(dst))] = q
            edge_label[id(q)] = label
            if self._monitor is not None:
                # ring depth near capacity: the consumer pipe is the bottleneck
                self._monitor.registry.attach_queue_gauge(label, q.size, capacity=cap)
            if prod is not None and dst.merge_inputs:
                channel_of[id(q)] = dst.merge_inputs.index(prod)
        errors: list = []

        def deliver(mp, out):
            if mp.sink is not None:
                mp.sink.consume(out)
            if mp.split_fn is not None:
                sel = map_tuples(mp.split_fn, out)
                for branch, keep in zip(mp.split_branches,
                                        split_masks(sel, len(mp.split_branches))):
                    q = out_edges[(id(mp), id(branch))]
                    masked = out.mask(keep)
                    _tracing.carry(out, masked)
                    _tracing.event(masked, edge_label[id(q)], "enq")
                    q.push(send(masked))
            for merged in mp._outputs_to:
                q = out_edges[(id(mp), id(merged))]
                _tracing.event(out, edge_label[id(q)], "enq")
                q.push(send(out))

        def pipe_body(mp, stream):
            onode = mp._ordering if self.mode == Mode.DETERMINISTIC else None
            live = list(in_queues[id(mp)])
            try:
                with on_stream(stream):
                    runner = _dispatch.GroupRunner(mp._chain, self._dispatch,
                                                   lambda out: deliver(mp, out),
                                                   publish_gauge=False)

                    def released(rel):
                        for piece in self._chunks(rel, onode.last_release_count):
                            runner.feed(piece)
                    yields = 0
                    while live:
                        # a round that found every ring empty waits in the
                        # native pop (GIL released) on the next round, so
                        # an idle merge does not spin in Python against the
                        # threads that have work
                        got = False
                        for q in list(live):
                            ok, item = q.pop(spin=64, max_yields=yields)
                            if not ok:
                                runner.idle()
                                continue
                            got = True
                            if item is EOS:
                                live.remove(q)
                                if onode is not None and id(q) in channel_of:
                                    released(onode.close_channel(channel_of[id(q)]))
                                continue
                            batch = receive(item)
                            _tracing.event(batch, edge_label[id(q)], "deq")
                            if onode is not None and id(q) in channel_of:
                                released(onode.push(channel_of[id(q)], batch))
                            else:
                                runner.feed(batch)
                        yields = 0 if got else (256 if len(live) == 1 else 16)
                    if onode is not None:
                        released(onode.flush())
                    runner.finish()
                    if mp.sink is not None:
                        mp.sink.consume(None)
            except BaseException as e:          # noqa: BLE001 — raised after the join
                errors.append(e)
                # drain the remaining input rings to EOS, so that producers
                # blocked on a full ring behind this pipe finish and send
                # their own EOS
                for q in list(live):
                    if drain_queue_to_sentinel(q, EOS):
                        live.remove(q)
            finally:
                _journal.record("eos_propagate", graph=self.name, pipe=pipe_idx[id(mp)])
                for branch in mp.split_branches:
                    out_edges[(id(mp), id(branch))].push(EOS)
                for merged in mp._outputs_to:
                    out_edges[(id(mp), id(merged))].push(EOS)

        def source_body(mp, stream):
            q = out_edges[("src", id(mp))]
            stream_idx = self._roots.index(mp)
            try:
                with on_stream(stream):
                    for n, batch in enumerate(mp.source.batches(self.batch_size)):
                        record_source_launch(mp.source, batch)
                        _tracing.ingest(batch, n, stream=stream_idx)
                        _tracing.event(batch, edge_label[id(q)], "enq")
                        q.push(send(batch))
            except BaseException as e:          # noqa: BLE001
                errors.append(e)
            finally:
                q.push(EOS)

        streams = []
        threads = []
        for i, p in enumerate(pipes):
            streams.append(stage_stream(self.device))
            threads.append(threading.Thread(target=pipe_body, args=(p, streams[-1]),
                                            name=f"wf-pipe{i}"))
        for p in self._roots:
            streams.append(stage_stream(self.device))
            threads.append(threading.Thread(target=source_body, args=(p, streams[-1]),
                                            name=f"wf-src-{p.source.getName()}"))
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            for p in pipes:
                if p._chain is not None:
                    p._chain.capture_closed = False
        errors += join_streams(self.device, streams)
        if errors:
            raise errors[0]
        for p in pipes:
            if p._chain is not None:
                p._chain.sync_stats()
        for op in self._operators:
            op.close()                # closing_func per replica
        self._ended = True
        return self._results()

    def _flush_pipe(self, mp: MultiPipe):
        if mp._chain is None:
            return
        for out in mp._chain.flush():
            self._deliver(mp, out)

    def _results(self):
        res = {}
        for mp in self._all_pipes():
            if mp._chain is not None:
                res.update(mp._chain.result())
        return res


__all__ = ["AppNode", "MultiPipe", "PipeGraph"]

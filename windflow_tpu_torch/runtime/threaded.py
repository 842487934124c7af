"""The threaded pipeline: one host thread a stage, joined by the native SPSC rings.

Counterpart of ``windflow_tpu/runtime/threaded.py``. The reference runs one OS
thread a node joined by FastFlow's lock-free queues (``ff_pipeline::run()``,
``wf/pipegraph.hpp:1522-1533``). Here, as in the JAX package, the unit is the
*segment*: each segment (a :class:`~.pipeline.CompiledChain`) gets a host
thread that pops batches from its input ring (``native.SPSCQueue``), launches
its work and pushes its outputs downstream; a source thread makes the
batches and a sink thread consumes the results. While one thread waits on a
ring or in native code it holds no GIL, so the Python dispatch of stage i+1
overlaps the card's work on stage i.

On the card each stage thread runs under a CUDA stream of its own
(``torch.cuda.stream``). A batch moves between stages only through
``runtime/handoff.py``: the producer records an event behind its work, the
consumer's stream waits on it and takes every tensor of the batch into use
(``record_stream``). The host never waits for the card to hand a batch on.

Scan dispatch (``dispatch=``): each segment thread gathers up to K popped
batches in a ``MicrobatchAccumulator`` (dispatched short when its input ring
runs dry past the linger, and at EOS) and runs them with ``fused_push``. A
CUDA-graph capture synchronizes the device and, in global capture mode,
fails if another thread touches the legacy default stream or allocates
with ``cudaMalloc`` meanwhile; so every graph a segment may replay (each
K' in 2..K at the segment's capacity) is captured before the stage threads
start, and the chains refuse a capture while they run
(``CompiledChain.capture_closed``). A batch of another capacity (a flushed
batch of the segment before) runs eagerly, never as a group.

Failure handling, as in the JAX package:

- a failing stage drains its input ring to EOS before it exits, so an
  upstream producer never blocks for ever on a full ring behind a dead
  consumer, and it still sends EOS downstream;
- ``run()`` closes the source, the operators and the sink even when a stage
  failed, then raises the first stage error (a CUDA error included: each
  stage's stream is synchronized after the join);
- ``heartbeat_timeout`` starts a watchdog thread over per-stage heartbeats;
  a stage that stops beating is listed in ``watchdog_stale``. A stage blocked
  pushing into a full ring behind the stalled one stops beating too, so the
  list holds the whole blocked chain; the root cause is the furthest
  downstream.

Fault injection (``faults=``, ``runtime/faults.py``; None consults
``WF_FAULT_PLAN``), at the JAX package's sites with its ``stage``/``pos``
context: ``source.next`` per source batch, ``queue.stall`` and
``chain.step`` per batch a segment pops, ``sink.consume`` per batch the sink
thread takes. A ``stall`` fault sleeps in the stage thread (the latency the
watchdog must notice); an ``error`` fault fails the stage as any error does.
A stage the watchdog flags bumps the ``watchdog_timeouts`` recovery counter.

Monitoring and tracing (``monitoring=``, ``trace=``; None consults
``WF_MONITORING`` / ``WF_TRACE``), as in the JAX package: the registry holds
the source, each segment chain, the sink and a depth gauge a ring; the
source stamps every Nth enqueued batch and the sink closes the end-to-end
sample at its receipt; a traced batch records ``ingest`` at the source,
``enq``/``deq`` on every ring it crosses, a service span on each segment
(``seg<i>``) and on the sink. The chains' event-time toggle comes from the
``monitoring=`` argument (the JAX driver reads only the environment). A
stale stage is journaled (``watchdog_stale``).

The control plane (``control=``; None consults ``WF_CONTROL``), as in the
JAX package: a ``BackpressureGovernor`` watches every ring's depth, the
source thread calls its ``throttle`` before each enqueue (a throttle wait
beats the source's heartbeat) and its ``pause_event`` pauses the prefetch
worker; an ``AdmissionController`` sheds or holds at the source. A failing
stage and the end of the run stop the governor, so a throttled source never
waits on a ring nobody drains. Autotuning does not apply here: each
segment's capacity is its ring contract.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import nullcontext
from typing import List, Optional, Sequence

import torch

from ..basic import DEFAULT_BATCH_SIZE
from ..device import resolve_device
from ..native import SPSCQueue, pin_thread
from ..observability import journal as _journal
from ..observability import tracing as _tracing
from ..operators.sink import Sink
from ..operators.source import SourceBase
from . import dispatch as _dispatch
from . import faults as _faults
from .dispatch import GroupRunner
from .faults import drain_queue_to_sentinel
from .handoff import receive, send
from .pipeline import CompiledChain, record_source_launch, resolve_batch_hint

#: the end-of-stream marker on a ring (sent bare: it carries no event)
EOS = object()

def resolve_edge_capacity(spec, name: str, index: int, default: int = 8) -> int:
    """One ring's capacity: ``spec`` is one int for every edge, a dict keyed
    by edge name or index (a missing edge takes the default), or a callable
    ``(name, index) -> int``."""
    if callable(spec):
        cap = spec(name, index)
    elif isinstance(spec, dict):
        cap = spec.get(name, spec.get(index, default))
    else:
        cap = spec
    cap = int(cap)
    if cap < 1:
        raise ValueError(f"edge {name!r}: queue capacity must be >= 1, got {cap}")
    return cap


def stage_stream(device) -> Optional["torch.cuda.Stream"]:
    """A new CUDA stream for one stage thread, ordered after the work the
    calling thread has queued so far (the chains' initial states, the
    captures); None on the CPU."""
    if device.type != "cuda":
        return None
    s = torch.cuda.Stream(device)
    s.wait_stream(torch.cuda.current_stream(device))
    return s


def on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing on the CPU."""
    return torch.cuda.stream(stream) if stream is not None else nullcontext()


def join_streams(device, streams) -> List[BaseException]:
    """After the stage threads joined: the calling thread's stream waits for
    every stage stream, and each stage stream is synchronized, so an error
    of the card's work surfaces here. Returns the errors raised."""
    errors = []
    for s in streams:
        if s is None:
            continue
        try:
            s.synchronize()
            torch.cuda.current_stream(device).wait_stream(s)
        except RuntimeError as e:
            errors.append(e)
    return errors


def prewarm(chain: CompiledChain, k: int, capacity: int) -> None:
    """Make ready every program a stage thread may run on ``chain`` at
    ``capacity`` with dispatch at ``k`` (the eager step and each K' in
    2..k, captured on the card), then close the chain to new captures."""
    if chain.ops:
        for kk in range(2, max(int(k), 1) + 1):
            chain.warm_scan(kk, capacity)
    chain.capture_closed = True


class ThreadedPipeline:
    """Source -> [segment chains...] -> sink, one host thread a stage, on
    ``device`` (None = ``"cuda"``). ``queue_capacity`` sizes the rings
    (:func:`resolve_edge_capacity`); ``pin`` pins stage i to core i (the
    reference's default mapping); ``prefetch=N`` frames and copies the
    source's batches N ahead in a worker thread; ``dispatch=`` is scan
    dispatch per segment thread; ``monitoring=`` and ``trace=`` as
    ``Pipeline``'s."""

    def __init__(self, source: SourceBase, segments: Sequence[Sequence],
                 sink: Optional[Sink] = None, *,
                 batch_size: Optional[int] = None, queue_capacity=8, pin: bool = True,
                 heartbeat_timeout: Optional[float] = None, faults=None,
                 prefetch: int = 0, control=None, trace=None, dispatch=None,
                 monitoring=None, device=None):
        from ..control import ControlConfig
        self._control = ControlConfig.resolve(control)
        #: built in run() before the stage threads start; the stages read them
        self.governor = None  # wf-lint: single-writer[driver]
        self._admission = None  # wf-lint: single-writer[driver]
        self.device = resolve_device(device)
        if source.device != self.device:
            raise ValueError(f"source {source.getName()!r} lives on {source.device} "
                             f"but the pipeline runs on {self.device}")
        self.source = source
        self.sink = sink
        ops = [op for seg in segments for op in seg]
        self.batch_size = int(batch_size or resolve_batch_hint(ops) or DEFAULT_BATCH_SIZE)
        self.pin = pin
        self.heartbeat_timeout = heartbeat_timeout
        self.prefetch = int(prefetch)
        self._faults_arg = faults
        self._dispatch_arg = dispatch
        self._dispatch = None  # wf-lint: single-writer[driver]
        self._started = False
        self._monitoring_arg = monitoring
        self._monitor = None  # wf-lint: single-writer[driver]
        self._trace_arg = trace
        self._tracer = None
        # (enqueue index, perf_counter, trace id) of sampled batches: the
        # source appends, the sink pops at the matching receipt (the rings
        # keep order)
        self._e2e_stamps = collections.deque()  # wf-lint: single-writer[driver, stage]
        spec = source.payload_spec()
        cap = source.out_capacity(self.batch_size)
        from ..observability import event_time_enabled
        et = event_time_enabled(monitoring)
        self.chains: List[CompiledChain] = []
        for seg in segments:
            chain = CompiledChain(list(seg), spec, batch_capacity=cap, device=self.device,
                                  event_time=et)
            chain.label = f"seg{len(self.chains)}"
            spec = chain.out_spec
            for op in chain.ops:
                cap = op.out_capacity(cap)
            self.chains.append(chain)
        # ring i feeds chain i; the last ring feeds the sink thread
        n = len(self.chains)
        self.edge_names = [("src->seg0" if n else "src->sink")] + \
            [f"seg{i}->" + (f"seg{i + 1}" if i + 1 < n else "sink") for i in range(n)]
        self.edge_capacities = {name: resolve_edge_capacity(queue_capacity, name, i)
                                for i, name in enumerate(self.edge_names)}
        self.queues = [SPSCQueue(self.edge_capacities[name]) for name in self.edge_names]
        # stage threads append; run() reads after the joins
        self._errors: List[BaseException] = []  # wf-lint: single-writer[stage]
        # each stage writes its own slot; the watchdog tolerates a stale read
        self._beats = {}  # wf-lint: single-writer[stage]
        self._done = set()  # wf-lint: single-writer[stage]
        self.watchdog_stale: List[str] = []

    def queue_depths(self) -> dict:
        """Live ring depth a edge name (the backpressure signal)."""
        return {name: q.size() for name, q in zip(self.edge_names, self.queues)}

    # -- stage bodies -----------------------------------------------------------------

    def _beat(self, stage: str) -> None:
        self._beats[stage] = time.monotonic()

    def _source_body(self, core: int, stream):
        if self.pin:
            pin_thread(core)
        q = self.queues[0]
        self._beat("source")
        gov, adm = self.governor, self._admission

        def throttle():
            if gov is not None:
                # a throttle wait beats the heartbeat: backpressure is
                # intentional, not a hang the watchdog should flag
                gov.throttle(heartbeat=lambda: self._beat("source"))
                self._beat("source")
        try:
            with on_stream(stream):
                batches = (self.source.batches_prefetched(
                               self.batch_size, self.prefetch,
                               pause_event=gov.pause_event if gov is not None else None)
                           if self.prefetch else self.source.batches(self.batch_size))
                mon = self._monitor
                n_enq = 0
                for n, batch in enumerate(batches):
                    self._beat("source")
                    _faults.fire("source.next", stage="source", pos=n)
                    record_source_launch(self.source, batch)
                    _tracing.ingest(batch, n)
                    for ab in ((batch,) if adm is None else adm.offer(batch, pos=n)):
                        throttle()
                        if (mon is not None and self.sink is not None
                                and mon.config.should_sample_e2e(n_enq)):
                            # stamp the enqueue index (after admission),
                            # matched by receipt order at the sink
                            self._e2e_stamps.append((n_enq, time.perf_counter(),
                                                     _tracing.tid_of(ab)))
                        _tracing.event(ab, self.edge_names[0], "enq")
                        q.push(send(ab))
                        n_enq += 1
                if adm is not None:
                    for ab in adm.drain():      # the bounded held tail
                        throttle()
                        q.push(send(ab))
        except BaseException as e:          # noqa: BLE001 — raised by run()
            self._errors.append(e)
        finally:
            self._done.add("source")
            q.push(EOS)

    def _segment_body(self, i: int, core: int, stream):
        if self.pin:
            pin_thread(core)
        q_in, q_out = self.queues[i], self.queues[i + 1]
        edge_in, edge_out = self.edge_names[i], self.edge_names[i + 1]
        stage = f"seg{i}"
        self._beat(stage)
        eos_seen = False
        try:
            with on_stream(stream):
                def emit(out):
                    _tracing.event(out, edge_out, "enq")
                    q_out.push(send(out))
                runner = GroupRunner(self.chains[i], self._dispatch, emit,
                                     publish_gauge=False)
                n = 0
                while True:
                    self._beat(stage)
                    ok, item = q_in.pop(spin=256, max_yields=1024)
                    if not ok:
                        runner.idle()
                        continue
                    if item is EOS:
                        eos_seen = True
                        runner.finish()
                        break
                    _faults.fire("queue.stall", stage=stage, pos=n)
                    _faults.fire("chain.step", stage=stage, pos=n)
                    batch = receive(item)
                    _tracing.event(batch, edge_in, "deq")
                    runner.feed(batch)
                    n += 1
        except BaseException as e:          # noqa: BLE001
            self._errors.append(e)
            if self.governor is not None:
                self.governor.stop()        # a throttled source must not wait on
                #                             a ring this stage will drain
            if not eos_seen:
                drain_queue_to_sentinel(q_in, EOS)    # unwedge the upstream producer
        finally:
            self._done.add(stage)
            q_out.push(EOS)

    def _sink_body(self, core: int, stream):
        if self.pin:
            pin_thread(core)
        q = self.queues[-1]
        self._beat("sink")
        eos_seen = False
        try:
            with on_stream(stream):
                n = 0
                while True:
                    self._beat("sink")
                    ok, item = q.pop(spin=256, max_yields=1024)
                    if not ok:
                        continue
                    if item is EOS:
                        eos_seen = True
                        break
                    _faults.fire("sink.consume", stage="sink", pos=n)
                    batch = receive(item)
                    _tracing.event(batch, self.edge_names[-1], "deq")
                    span = _tracing.service(batch, "sink")
                    if self.sink is not None:
                        self.sink.consume(batch)
                    if span is not None:
                        span.done()
                    stamps = self._e2e_stamps
                    if stamps and stamps[0][0] == n:
                        _n, t0, tid = stamps.popleft()
                        self._monitor.registry.record_e2e(time.perf_counter() - t0,
                                                          exemplar=tid)
                    n += 1
                if self.sink is not None:
                    self.sink.consume(None)
        except BaseException as e:          # noqa: BLE001
            self._errors.append(e)
            if self.governor is not None:
                self.governor.stop()
            if not eos_seen:
                drain_queue_to_sentinel(q, EOS)
        finally:
            self._done.add("sink")

    def _watchdog_body(self, stop: threading.Event):
        t = self.heartbeat_timeout
        while not stop.wait(min(t / 4.0, 0.05)):
            now = time.monotonic()
            for stage, last in list(self._beats.items()):
                if stage in self._done or stage in self.watchdog_stale:
                    continue
                if now - last > t:
                    self.watchdog_stale.append(stage)
                    _faults.bump("watchdog_timeouts")
                    _journal.record("watchdog_stale", stage=stage,
                                    stalled_s=round(now - last, 3), timeout_s=t)

    # -- run --------------------------------------------------------------------------

    def start(self) -> None:
        """Resolve ``dispatch=`` and, when it is on, make every program a
        segment thread may run ready (:func:`prewarm`: on the card, every
        capture happens here, before any stage thread starts). ``run``
        calls it when the caller has not."""
        if self._started:
            return
        self._dispatch = _dispatch.DispatchConfig.resolve(self._dispatch_arg)
        if self._dispatch is not None:
            for chain in self.chains:
                prewarm(chain, self._dispatch.k, chain.capacity)
        self._started = True

    def run(self) -> dict:
        """Drive the stream to EOS; returns the chains' ``result()``."""
        self.start()
        injector = _faults.resolve(self._faults_arg)
        from ..observability import Monitor, MonitoringConfig, TraceConfig, Tracer
        mcfg = MonitoringConfig.resolve(self._monitoring_arg)
        self._e2e_stamps.clear()            # receipt indices restart at 0
        if mcfg is not None and self._monitor is None:
            self._monitor = Monitor(mcfg, self.source.getName() + "-threaded")
            reg = self._monitor.registry
            reg.register_operator(self.source)
            for chain in self.chains:
                reg.register_chain(chain.label, chain)
            if self.sink is not None:
                reg.register_operator(self.sink)
            for name, q in zip(self.edge_names, self.queues):
                reg.attach_queue_gauge(name, q.size, capacity=self.edge_capacities[name])
            self._monitor.start()
        tcfg = TraceConfig.resolve(self._trace_arg)
        if tcfg is not None and self._tracer is None:
            self._tracer = Tracer(tcfg, self.source.getName() + "-threaded").start()
        cfg = self._control
        if cfg is not None:
            from ..control import admission_from_config, governor_from_config
            self.governor = governor_from_config(cfg)
            if self.governor is not None:
                for name, q in zip(self.edge_names, self.queues):
                    self.governor.watch(name, q.size, self.edge_capacities[name])
            self._admission = admission_from_config(
                cfg, self.source.out_capacity(self.batch_size), driver="threaded")
        if (self._monitor is not None and self._monitor.remediation is not None
                and self._admission is not None):
            # bind the actuator this run owns (an unbound one skips loudly);
            # scale_rate takes the bucket lock, so the Reporter-thread
            # actuation is atomic against the source thread's offer()
            adm = self._admission
            self._monitor.remediation.bind(
                "admission_rate", lambda a: adm.scale_rate(a.factor, a.floor))
        try:
            with _faults.activate(injector):
                return self._run()
        finally:
            for chain in self.chains:
                chain.capture_closed = False
            if self.governor is not None:
                # a source never waits in a throttle past teardown (the
                # governor stays readable for the run's numbers)
                self.governor.stop()
            if self._monitor is not None:
                # the final snapshot; no topology target (the export models
                # Pipeline and PipeGraph shapes)
                self._monitor.finish()
            if self._tracer is not None:
                self._tracer.finish()

    def _run(self) -> dict:
        n = len(self.chains)
        streams = [stage_stream(self.device) for _ in range(n + 2)]
        threads = [threading.Thread(target=self._source_body, args=(0, streams[0]),  # wf-lint: thread-role[stage]
                                    name="wf-source")]
        for i in range(n):
            threads.append(threading.Thread(target=self._segment_body,  # wf-lint: thread-role[stage]
                                            args=(i, i + 1, streams[i + 1]),
                                            name=f"wf-seg{i}"))
        threads.append(threading.Thread(target=self._sink_body,  # wf-lint: thread-role[stage]
                                        args=(n + 1, streams[n + 1]), name="wf-sink"))
        stop_watchdog = threading.Event()
        watchdog = None
        if self.heartbeat_timeout:
            watchdog = threading.Thread(target=self._watchdog_body, args=(stop_watchdog,),  # wf-lint: thread-role[watchdog]
                                        daemon=True, name="wf-watchdog")
            watchdog.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if watchdog is not None:
            stop_watchdog.set()
            watchdog.join()
        errors = self._errors + join_streams(self.device, streams)
        err = errors[0] if errors else None
        # close everything before raising (the reference's closing_func and
        # svc_end run on the failure path too); a close error surfaces only
        # on a clean run
        for c in self.chains:
            if err is None:
                c.sync_stats()
            for op in c.ops:
                try:
                    op.close()
                except Exception as ce:     # noqa: BLE001
                    err = err or ce
        for op in (self.source, self.sink):
            if op is None:
                continue
            try:
                op.close()
            except Exception as ce:         # noqa: BLE001
                err = err or ce
        if err is not None:
            raise err
        res = {}
        for c in self.chains:
            res.update(c.result())
        return res


__all__ = ["EOS", "ThreadedPipeline", "drain_queue_to_sentinel",
           "prewarm", "resolve_edge_capacity"]

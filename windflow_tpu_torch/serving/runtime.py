"""ServingRuntime — a PipeGraph chain as a long-running multi-tenant service.

Counterpart of ``windflow_tpu/serving/runtime.py`` on the port's
``CompiledChain``: the same drive loop, swap, journal records and snapshot
section. It runs on the source's device, ``"cuda"`` unless the caller
passes ``device="cpu"``.

The drive loop is the :class:`~windflow_tpu_torch.runtime.pipeline.Pipeline`
discipline (one thread, batch-at-a-time, lazy monitoring resolution, the
same EOS cascade) with three serving-plane additions:

- **per-tenant admission**: each source batch is offered to its tenant's
  own :class:`~windflow_tpu_torch.control.admission.AdmissionController`
  (``tenants.TenantRegistry``), so a noisy tenant sheds inside its OWN
  bucket; the per-tenant counters ride the snapshot's ``serving`` section,
  the tenant-labelled SLO signals read them, and the ``tenant_rate``
  remediation actuator tightens exactly one tenant's bucket.
- **hot swap**: :meth:`ServingRuntime.swap_graph` replaces the compiled
  chain at a batch boundary with zero downtime — quiesce (settle in-flight
  tiered spills: the drain/seal stance applied at the chain level),
  warm the incoming chain BEFORE cutover (``swap_warm``: one eager step
  over an all-invalid batch, ``CompiledChain.warm``, builds and sets up
  every kernel at the batch shape), carry the operator states across when
  the state trees are shape-identical (recompiled/equivalent
  chains — byte-identical results for tuples on either side of the cut),
  and journal the whole thing as a ``graph_swap`` span.  Swaps arrive from
  any thread (or over the wire as ``swap`` control frames naming a graph
  registered via :meth:`register_graph`) and are CONSUMED only at batch
  boundaries on the drive thread — no locking in the hot path.
- **journaled lifecycle**: ``serving_start``/``serving_end`` events frame
  the run; the snapshot carries endpoint/graph/swap/frame counters.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional, Sequence

from ..basic import DEFAULT_BATCH_SIZE
from ..batch import flatten_with_paths
from ..device import resolve_device
from ..observability import journal as _journal
from ..observability import tracing as _tracing
from ..runtime.pipeline import (CompiledChain, record_source_launch,
                                resolve_batch_hint)
from .config import ServingConfig, serving_problems
from .framing import DEFAULT_TENANT
from .tenants import build_registry


def _states_compatible(a, b) -> bool:
    """True when two chains' state trees are structurally identical (the
    same leaf paths, ``jax.tree_util.keystr``'s, and every leaf's
    shape/dtype) — the carry-state-across-a-swap precondition.  A swap to
    an incompatible graph resets state instead (documented; the journal
    span records which happened)."""
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        if (getattr(x, "shape", None) != getattr(y, "shape", None)
                or getattr(x, "dtype", None) != getattr(y, "dtype", None)):
            return False
    return True


class ServingRuntime:
    """Source -> ops... -> sink as a swappable, tenant-isolated service.

    Duck-compatible with :class:`Pipeline` where the observability plane
    cares (``.source``/``.chain``/``.sink`` — ``MetricsRegistry.
    register_pipeline`` walks exactly those), so every existing snapshot/
    topology/SLO surface sees a serving run as a pipeline plus a
    ``serving`` section."""

    def __init__(self, source, ops: Sequence, sink=None, *,
                 batch_size: Optional[int] = None, serving=None,
                 monitoring=None, supervised: bool = False,
                 name: str = "serving", device=None):
        self.device = resolve_device(device)
        if source.device != self.device:
            raise ValueError(f"source {source.getName()!r} lives on "
                             f"{source.device} but the service runs on "
                             f"{self.device}")
        self.source = source
        self.sink = sink
        self.name = name
        if batch_size is None:
            batch_size = resolve_batch_hint(ops) or DEFAULT_BATCH_SIZE
        self.batch_size = batch_size
        self.config = ServingConfig.resolve(serving) or ServingConfig()
        self._monitoring_arg = monitoring
        self._supervised = bool(supervised)
        from ..observability import slo as _slo
        from ..observability import MonitoringConfig
        mcfg = MonitoringConfig.resolve(monitoring)
        probs = serving_problems(
            self.config, monitoring=monitoring, supervised=supervised,
            slo_specs=_slo.resolve_specs(mcfg.slo) if mcfg else None)
        if probs:
            raise ValueError("invalid serving setup (the validator reports "
                             "these as WF119 before the run): "
                             + "; ".join(probs))
        self._cap = getattr(source, "out_capacity",
                            lambda b: b)(batch_size)
        from ..observability import event_time_enabled
        self._event_time = event_time_enabled(monitoring)
        self.chain = CompiledChain(ops, source.payload_spec(),
                                   batch_capacity=self._cap,
                                   device=self.device,
                                   event_time=self._event_time)
        self.graph_label = "initial"
        #: named graphs a wire ``swap`` frame (or ``wf_serve swap``) may
        #: cut over to — single-writer: registered before run()
        self._graphs = {}
        #: pending swap requests, appended from ANY thread, consumed at
        #: batch boundaries on the drive thread (deque.append/popleft are
        #: atomic)                            # wf-lint: allow[unguarded]
        self._swap_queue: "collections.deque" = collections.deque()
        self.swaps_applied = 0
        self.swaps_rejected = 0
        self.registry = build_registry(
            self.config.resolved_tenants(), self._cap,
            supervised=supervised)
        self._monitor = None
        self._running = False                 # wf-lint: guarded-by[_run_lock]
        #: closes the swap_graph/run() TOCTOU: _running flips only under
        #: this lock, and swap_graph's not-running immediate apply holds it
        #: too — an apply on the caller thread can never overlap a drive
        #: loop that is just starting (or just ending)
        self._run_lock = threading.Lock()

    # -- graph management -----------------------------------------------

    def register_graph(self, label: str, ops: Sequence) -> None:
        """Name a candidate chain for wire-driven swaps (``swap`` control
        frames / ``wf_serve swap``)."""
        self._graphs[str(label)] = list(ops)

    def swap_graph(self, graph, label: Optional[str] = None) -> None:
        """Request a zero-downtime cutover to ``graph`` (an ops list, or
        the name of a registered graph).  Thread-safe: the request is
        queued and applied at the next batch boundary on the drive thread;
        when no run is live it applies immediately."""
        if isinstance(graph, str):
            label = label or graph
            ops = self._graphs.get(graph)
            if ops is None:
                raise ValueError(f"swap_graph: no graph registered under "
                                 f"{graph!r} (registered: "
                                 f"{', '.join(sorted(self._graphs)) or 'none'}"
                                 f")")
        else:
            ops = list(graph)
        self._swap_queue.append((label or f"swap{self.swaps_applied + 1}",
                                 ops))
        with self._run_lock:
            # under _run_lock either we see _running=True (the drive thread
            # consumes the queued request at its next batch boundary) or the
            # immediate apply completes before run() can flip _running and
            # start pushing batches
            if not self._running:
                self._consume_swaps()

    def _consume_swaps(self) -> None:
        """Batch-boundary swap point: drain API-queued requests plus any
        wire ``swap`` frames the socket source surfaced."""
        pop_wire = getattr(self.source, "pop_swap_request", None)
        while pop_wire is not None:
            label = pop_wire()
            if label is None:
                break
            if label in self._graphs:
                self._swap_queue.append((label, self._graphs[label]))
            else:
                self.swaps_rejected += 1
                _journal.record("graph_swap", graph=str(label),
                                rejected=True,
                                reason="unregistered graph name")
        while self._swap_queue:
            label, ops = self._swap_queue.popleft()
            self._apply_swap(label, ops)

    def _apply_swap(self, label: str, ops) -> None:
        t0 = time.perf_counter()  # wf-lint: allow[wall-clock] timing-only: swap metric
        with _journal.span("graph_swap", graph=str(label),
                           from_graph=self.graph_label):
            old = self.chain
            # quiesce: we are at a batch boundary (the only call site), so
            # the only in-flight device work is async tiered spills —
            # settle them before the old chain's states are read
            if old._tier_ops:
                old.tier_settle()
            new = CompiledChain(ops, self.source.payload_spec(),
                                batch_capacity=self._cap,
                                device=self.device,
                                event_time=self._event_time)
            new.label = old.label
            if self.config.swap_warm:
                # build and set up the incoming kernels BEFORE cutover —
                # the swap itself then only swaps pointers (the
                # pre-compiled-ladder switch trick); skipping this is a
                # WF119 finding
                new.warm(self._cap)
            carried = _states_compatible(old.states, new.states)
            if carried:
                new.states = old.states
            self.chain = new
            self.graph_label = str(label)
            self.swaps_applied += 1
            _journal.record(
                "graph_swap", graph=str(label), applied=True,
                carried_state=carried, warmed=bool(self.config.swap_warm),
                quiesce_ms=round((time.perf_counter() - t0) * 1e3, 3))  # wf-lint: allow[wall-clock] timing-only: swap metric

    # -- observability surface ------------------------------------------

    def serving_section(self) -> dict:
        """The snapshot's ``serving`` section (``names.py``:
        SERVING_GAUGES + per-tenant TENANT_GAUGES rows)."""
        sec = {"graph": self.graph_label,
               "swaps_applied": self.swaps_applied,
               "swaps_rejected": self.swaps_rejected}
        ep = getattr(self.source, "endpoint", None)
        if ep is not None:
            sec["endpoint"] = ep
        for ctr in ("frames_decoded", "frames_torn", "frames_dup",
                    "clients_seen"):
            v = getattr(self.source, ctr, None)
            if v is not None:
                sec[ctr] = int(v)
        if self.registry is not None:
            sec["tenants"] = self.registry.counters()
            sec["unknown_offered"] = self.registry.unknown_offered
        return sec

    # -- the drive loop -------------------------------------------------

    def _bind_remediation(self, mon) -> None:
        """Bind the actuators a serving run owns: ``tenant_rate`` resolves
        the firing action's SLO spec to its tenant label and tightens THAT
        tenant's bucket only — the isolation contract."""
        if mon is None or mon.remediation is None:
            return
        if self.registry is None:
            return
        spec_by_name = {s.name: s
                        for s in (mon.slo.specs if mon.slo else [])}

        def _tenant_rate(a, _reg=self.registry, _specs=spec_by_name):
            spec = _specs.get(a.slo)
            tenant = getattr(spec, "tenant", None)
            if tenant is None:
                raise ValueError(
                    f"tenant_rate action {a.name!r}: SLO {a.slo!r} carries "
                    f"no tenant label — bind admission_rate for run-wide "
                    f"shedding instead")
            return _reg.scale_rate(tenant, a.factor, a.floor)

        mon.remediation.bind("tenant_rate", _tenant_rate)

    def _start_monitor(self) -> None:
        """Build and start the run's Monitor, once, on this thread."""
        from ..observability import Monitor, MonitoringConfig
        cfg = MonitoringConfig.resolve(self._monitoring_arg)
        if cfg is not None and self._monitor is None:
            self._monitor = Monitor(cfg, self.name)
            self._monitor.registry.register_pipeline(self)
            self._monitor.registry.attach_serving(self.serving_section)
            self._monitor.start()

    def run(self):
        """Drive the service to EOS (all tenants closed their streams).
        The Pipeline.run contract: returns the chain's terminal results."""
        self._start_monitor()
        mon = self._monitor
        self._bind_remediation(mon)
        start = getattr(self.source, "start", None)
        if start is not None:
            start()
        _journal.record(
            "serving_start", runtime=self.name, graph=self.graph_label,
            endpoint=getattr(self.source, "endpoint", None),
            tenants=(self.registry.ids if self.registry is not None
                     else [DEFAULT_TENANT]))
        with self._run_lock:
            self._running = True
        try:
            n = 0
            n_offered = 0

            def drive(b, tenant=DEFAULT_TENANT, wire_s=0.0):
                nonlocal n
                sampled = (mon is not None and self.sink is not None
                           and mon.config.should_sample_e2e(n))
                t0 = time.perf_counter() if sampled else 0.0  # wf-lint: allow[wall-clock] timing-only: e2e sample
                span = _tracing.service(b, "chain")
                out = self.chain.push(b)
                if span is not None:
                    span.done()
                    _tracing.carry(b, out)
                if self.sink is not None:
                    sspan = _tracing.service(out, "sink")
                    self.sink.consume(out)
                    if sspan is not None:
                        sspan.done()
                if sampled:
                    dt = time.perf_counter() - t0  # wf-lint: allow[wall-clock] timing-only: e2e sample
                    ex = _tracing.tid_of(b)
                    mon.registry.record_e2e(dt, exemplar=ex)
                    if self.registry is not None:
                        # wire-to-sink per-tenant latency: the host service
                        # time plus the wire+source-queue segments measured
                        # at ingest (0 for unstamped/old clients) — feeds
                        # serving.tenants e2e_* and tenant_e2e_p99_ms
                        mon.registry.record_tenant_e2e(
                            tenant, dt + wire_s, exemplar=ex)
                n += 1

            # un-prefetched by design: last_tenant attribution requires
            # the drive thread to pull batches synchronously (sources.py)
            for batch in self.source.batches(self.batch_size):
                record_source_launch(self.source, batch)
                tenant = getattr(self.source, "last_tenant", DEFAULT_TENANT)
                wire = getattr(self.source, "last_wire", None)
                wire_s, extras = 0.0, None
                if wire is not None:
                    # wall clocks by design: t_send is the CLIENT's clock,
                    # t_recv this host's — a perf_counter pair could never
                    # cross the process boundary
                    t_recv = wire.get("t_recv")
                    t_send = wire.get("t_send")
                    extras = {"tenant": tenant, "seq": wire.get("seq")}
                    if t_recv is not None:
                        q_ms = max(time.time() - t_recv, 0.0) * 1e3  # wf-lint: allow[wall-clock] cross-process wire timing needs wall time
                        extras["queue_ms"] = round(q_ms, 3)
                        wire_s += q_ms / 1e3
                        if t_send is not None:
                            w_ms = max(t_recv - t_send, 0.0) * 1e3
                            extras["wire_ms"] = round(w_ms, 3)
                            wire_s += w_ms / 1e3
                    if wire.get("span") is not None:
                        extras["span"] = wire["span"]
                elif self.registry is not None:
                    extras = {"tenant": tenant}
                _tracing.ingest(batch, n_offered, extras=extras)
                self._consume_swaps()
                admitted = ([batch] if self.registry is None
                            else self.registry.offer(tenant, batch,
                                                     pos=n_offered))
                n_offered += 1
                for ab in admitted:
                    drive(ab, tenant, wire_s)
            _journal.record("eos", pipeline=self.name)
            self._consume_swaps()
            if self.registry is not None:
                for ab in self.registry.drain():
                    drive(ab)
            for out in self.chain.flush():
                if self.sink is not None:
                    self.sink.consume(out)
            if self.sink is not None:
                self.sink.consume(None)
            self.chain.sync_stats()
            _journal.record(
                "serving_end", runtime=self.name, graph=self.graph_label,
                batches=n, swaps=self.swaps_applied)
            for op in [self.source, *self.chain.ops,
                       *([self.sink] if self.sink is not None else [])]:
                op.close()
            return self.chain.result()
        finally:
            with self._run_lock:
                self._running = False
            if mon is not None:
                mon.finish(self)

    def run_background(self) -> threading.Thread:
        """Run the drive loop on a daemon thread (long-lived services; the
        caller joins or lets EOS end it).  Result/exception land on
        ``.background_result`` / ``.background_error``. The Monitor starts
        on the calling thread, so profile-on-page's first profiler session
        opens there (``stats.profiler_init``), not on the drive thread."""
        self.background_result = None
        self.background_error = None
        self._start_monitor()

        def _main():
            try:
                self.background_result = self.run()
            except BaseException as e:  # noqa: BLE001 — surfaced to joiner
                self.background_error = e

        # the spawned thread IS the drive thread — the caller hands the
        # driver role over and only joins/reads the result afterwards
        t = threading.Thread(target=_main, daemon=True,  # wf-lint: thread-role[driver]
                             name=f"wf-serve-drive[{self.name}]")
        t.start()
        return t

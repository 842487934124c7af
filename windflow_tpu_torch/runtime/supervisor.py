"""Failure detection + recovery: supervised execution, unsharded and shard-local.

Counterpart of ``windflow_tpu/runtime/supervisor.py``.
The reference's failure model is ``exit(EXIT_FAILURE)`` (no restarts, state
lost). Here operator state is a tree of tensors threaded through each step,
which makes recovery structural:

- **Detection**: any exception surfacing from a step (a CUDA error, a
  user-function error, an injected fault) is caught by the supervisor loop;
  a ``step_timeout`` watchdog additionally converts a *hung* step into a
  :class:`~windflow_tpu_torch.runtime.faults.WatchdogTimeout`.
- **Checkpoint alignment**: every ``checkpoint_every`` batches the supervisor
  copies all operator states to host memory (optionally also to ``.npz`` via
  ``spill_path``, atomically, with checksums and, with ``checkpoint_keep >
  1``, a retained lineage) together with the stream position.
- **Recovery**: on failure the states are rebuilt from the host copies, the
  source is re-opened at the checkpointed position, and processing resumes;
  up to ``max_restarts`` attempts per checkpoint interval (progress refills
  the budget), with exponential backoff and decorrelated jitter between
  attempts (``backoff_base``/``backoff_cap``).
- **Poison-batch quarantine**: with a ``dead_letter`` queue, a position that
  fails ``poison_threshold`` consecutive times is routed to the
  :class:`~windflow_tpu_torch.runtime.faults.DeadLetterQueue` and skipped
  (effective when ``poison_threshold <= max_restarts + 1``).
- **Exactly-once sink delivery**: outputs are copied to the host at once and
  released to the sink only when the *next* checkpoint commits; on failure
  the uncommitted outputs are discarded and regenerated by replay.
  Committed-but-undelivered outputs survive a sink fault in an outbox and are
  re-driven without replay.

What the card changes:

- A snapshot is a host copy of every state tensor. After a CUDA-graph replay
  ``chain.states`` are the graph's static tensors, which the next replay
  overwrites, so a snapshot that kept references would restore the latest
  state, not the committed one.
- A restore builds fresh tensors from the host copies every time (one
  snapshot may be restored twice in one interval, and a captured step
  consumes the states it is given). They reach a captured graph at its next
  replay (``runtime/graphs.py``).
- Every output is copied to the host, synchronously, before the sink can see
  it: that copy is where an asynchronous CUDA error of the step surfaces, so
  it is caught as the step's failure.
- A *sticky* CUDA error (an illegal address) leaves the CUDA context
  unusable: no in-process restore can recover it. The restore's own copies
  fail again, the restart budget runs out, and :class:`RestartExhausted`
  carries the CUDA error as ``__cause__``; the loop never hangs on it.
- The watchdog runs the step on a worker thread that enters the supervising
  thread's current CUDA stream (``faults.call_with_timeout``), and an
  abandoned worker is joined before the restore.

Requires a *replayable* source: ``DeviceSource`` resumes by index
arithmetic, ``GeneratorSource``/``RecordSource`` re-invoke their
``it_factory`` (``SourceBase._open_seek``).

Fault-injection sites (``runtime/faults.py``): ``source.next`` before each
batch pull, ``chain.step`` before each push, ``sink.consume`` before each
committed delivery, ``checkpoint.save``/``checkpoint.load`` inside the spill
path. The journal (``observability/journal.py``) gets a ``checkpoint`` span a
commit, a ``restore`` span a recovery (its duration also feeds the
``recovery_seconds`` counter: the time to recover), ``dead_letter`` and
``restart_exhausted`` records.

Shard-local supervision (``shards=`` or ``WF_SHARDS`` above 1): the key space
of one chain on one device is split into N key ranges
(``parallel/sharding.py``), each a recovery domain of its own
(:class:`ShardSupervisor`, :class:`_GraphShard`) with its own state set,
budget, backoff, quarantine and replay buffer: a failed shard restores and
replays only its own sub-batches while the others go on. Every shard pushes a
full-capacity sub-batch masked by ownership through the one chain, so a batch
costs N pushes. A coordinator (:class:`ShardedSupervisor`,
:class:`_ShardedGraphRun`) owns the source, the aligned checkpoint barrier
(per-shard files through ``checkpoint.save_sharded``) and live re-sharding
(``reshard=``, a ``ReshardPlan`` applied at a barrier: retiring shards sealed
to handoff files, changed shards rebuilt by replaying the committed prefix
through the new ownership). A failure outside any shard's step falls back to
the whole-domain restore. The journal gets ``shard_restore`` and ``reshard``
records beside the others. Dispatch K > 1 with shards, and tiered keyed state
with shards, raise ``ValueError`` as in the JAX package.

Tracing and monitoring, as in the JAX package: ``trace=`` (None consults
``WF_TRACE``) mints position-derived trace ids at ingest (a replay after a
restore re-mints the same ids; ``TraceConfig(ids="sequence")`` is refused),
each step opens a service span on ``chain`` and carries the id to its
output (to each shard's sub-batch, sharded), and a restore first closes the
failed attempt's open spans (``abort_open("restore")``) and drops the
health ledger's pending note. ``SupervisedPipeline`` builds its chain with
the environment's event-time toggle (``WF_MONITORING`` and
``WF_MONITORING_EVENT_TIME``); a supervised PipeGraph runs under the
graph's own ``monitoring=``/``trace=``, and its sharded runs add the
``shards`` section to the graph's snapshots. Tiered keyed state
(``state/tiered.py``) is supervised as in the JAX package: a snapshot settles
the tiered operators first and keeps their cold tiers' manifests beside the
states; a restore rewinds the stores and discards the copies in flight
(replay re-derives the spills).

The control plane under supervision, as in the JAX package:

- **Admission** (``control=``, ``WF_CONTROL``) must be replay-deterministic:
  only the positional bucket (``refill_per_batch``) with ``drop_newest``
  runs, and its state rides every checkpoint, so a replay re-sheds exactly
  the batches the failed attempt shed. A shed batch still advances the
  stream position. The graph driver's sources share one bucket, and with
  admission on its commits wait for a round boundary.
- **Warm start**: a capacity plan a live ``Pipeline`` persisted in the
  tuning cache (same chain signature, payload and device kind) sets the
  batch size; the autotuner itself does not run under supervision.
- **Barrier remediation** (``remediation=``, ``WF_REMEDIATION``,
  ``WF_REMEDIATION_COOLDOWN_S``, ``WF_REMEDIATION_MAX_ACTIONS``): a
  ``BarrierRemediation`` evaluates committed signals (the interval's shed
  ratio, the shards' hot fraction) at each commit barrier; its decision
  state and the scaled refill rate ride the admission snapshot, so a replay
  re-derives the same actions at the same barriers.
- **``reshard="auto"``** (sharded pipeline driver): after each commit the
  governor's ``recommend_reshard`` reads the shards' committed interval
  loads and plans a doubling when one shard carries most of the load; a
  doubling that does not lower the hot fraction stops it. A remediation
  reshard loses to it at the same barrier (``remediation_skip``,
  ``arbitration``).

Across processes, each process supervises the slice
``parallel/multihost.py::process_shard_slice`` gives it (pass it as
``shard_range=``); the shards need no collective.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import random
import time
from typing import Optional, Sequence

import torch

from ..basic import DEFAULT_BATCH_SIZE
from ..batch import tree_map
from ..device import resolve_device
from ..observability import device_health as _dh
from ..observability import journal as _journal
from ..observability import tracing as _tracing
from ..operators.base import Basic_Operator
from ..operators.sink import ReduceSink, Sink
from ..operators.source import SourceBase
from ..parallel.mesh import host_copy
from ..parallel.sharding import (ReshardPlan, ShardAssignment, affected_shards,
                                 make_splitter, resolve_shards)
from . import dispatch as _dispatch
from . import faults as _faults
from .graphs import leaves, rebuild
from .pipeline import CompiledChain, resolve_batch_hint


class RestartExhausted(RuntimeError):
    """Raised when a step keeps failing past ``max_restarts`` within one
    checkpoint interval; carries the last underlying error as ``__cause__``."""


@contextlib.contextmanager
def _restore_span(**fields):
    """Journal a ``restore`` span and add its measured duration to the
    ``recovery_seconds`` counter (the time to recover: timing only, never
    replayed data). A restore that itself raises counts nothing; the attempt
    that lands does."""
    t0 = time.perf_counter()              # wf-lint: allow[wall-clock] (a timer)
    with _journal.span("restore", **fields):
        yield
    _faults.bump("recovery_seconds",
                 round(time.perf_counter() - t0, 6))  # wf-lint: allow[wall-clock]


# ------------------------------------------------------------ control plane

def _supervised_admission(cfg, base_capacity: int, driver: str):
    """The supervised drivers' admission controller (None when admission is
    off). Shed decisions are part of the output, so a replay from a
    checkpoint must re-shed exactly the batches the failed attempt shed:
    the wall-clock ``TokenBucket`` (a restore changes its refill timeline)
    and the ``drop_oldest_ts`` holding cell (held batches would have to be
    in every checkpoint) are refused; the positional bucket with
    ``drop_newest`` runs, its state snapshotted with the checkpoints."""
    if cfg is None or not cfg.admission:
        return None
    if cfg.refill_per_batch is None:
        raise ValueError(
            "supervised admission control requires the deterministic "
            "ControlConfig(refill_per_batch=...) bucket — the wall-clock "
            "rate_tps bucket makes shed decisions time-dependent, which "
            "breaks exactly-once replay (use the live drivers for "
            "wall-clock rate limiting)")
    if cfg.shed_policy != "drop_newest":
        raise ValueError(
            "supervised admission control supports shed_policy='drop_newest' "
            "only (a drop_oldest_ts holding cell would have to be serialized "
            "into every checkpoint)")
    from ..control import AdmissionController, PositionBucket
    from ..control.admission import resolve_burst
    return AdmissionController(
        PositionBucket(cfg.refill_per_batch, resolve_burst(cfg, base_capacity)),
        "drop_newest", hold_max=0, driver=driver)


def _interval_drop_ratio(prev_adm, new_adm):
    """The just-committed interval's shed fraction, shed/(shed+admitted)
    between two committed admission snapshots: the barrier remediation's
    ``drop_ratio`` signal (a pure function of committed state). None for an
    empty interval (the zero-length EOS commit), which freezes the
    violation window instead of clearing it."""
    if prev_adm is None or new_adm is None:
        return None
    shed = int(new_adm.get("shed", 0)) - int(prev_adm.get("shed", 0))
    admitted = int(new_adm.get("admitted", 0)) - int(prev_adm.get("admitted", 0))
    total = shed + admitted
    return (shed / total) if total > 0 else None


def _apply_barrier_decision(d: dict, adm) -> None:
    """Actuate and journal one ``BarrierRemediation`` decision (a reshard
    decision reaches here after the sharded coordinator's arbitration, so
    only the admission rate actuates)."""
    from ..control import _state as _cstate
    if not d.get("applied"):
        _cstate.bump("remediation_skips")
        _journal.record("remediation_skip", **d)
        return
    if d.get("actuator") == "admission_rate" and adm is not None:
        d.update(adm.scale_rate(d["factor"], d["floor"]))
    _cstate.bump("remediation_actions")
    _journal.record("remediation_apply", **d)


def _barrier_remediation(arg, *, admission: bool, shards: int):
    """``remediation=`` (None consults ``WF_REMEDIATION``) resolved into a
    ``BarrierRemediation`` over the actuators the run owns, or None; the
    cooldown counts barriers, one a second of ``WF_REMEDIATION_COOLDOWN_S``."""
    from ..control import remediation as _remediation
    arg = arg if arg is not None else os.environ.get("WF_REMEDIATION")
    policy = _remediation.resolve_barrier_policy(arg, admission=admission, shards=shards)
    if policy is None:
        return None
    cool = float(os.environ.get("WF_REMEDIATION_COOLDOWN_S",
                                _remediation.DEFAULT_COOLDOWN_S))
    return _remediation.BarrierRemediation(
        policy, cooldown_barriers=max(1, int(round(cool))),
        max_actions=int(os.environ.get("WF_REMEDIATION_MAX_ACTIONS",
                                       _remediation.DEFAULT_MAX_ACTIONS)))


def _warm_start_capacity(cfg, ops, source, batch_size: int, device) -> int:
    """The batch size from a capacity plan a live ``Pipeline`` persisted in
    the tuning cache (same chain signature, payload and device kind), else
    ``batch_size``. The autotuner does not run under supervision: a capacity
    switch mid-stream would re-index the checkpoint positions."""
    if cfg is None or not cfg.autotune or not cfg.cache_path:
        return batch_size
    from ..control import (TuningCache, chain_signature, device_kind,
                           payload_signature, tuning_key)
    from ..control import _state as _cstate
    key = tuning_key(chain_signature(ops), payload_signature(source.payload_spec()),
                     device_kind(device))
    hit = TuningCache(cfg.cache_path).get(key)
    if not hit:
        return batch_size
    cap = int(hit["capacity"])
    _cstate.bump("tuning_cache_hits")
    _journal.record("tuning_warm_start", tuner="supervised", capacity=cap, key=key)
    return cap


def _supervised_tracer(trace_arg, name: str):
    """The started Tracer of a supervised run, or None. Its ids must be
    replay-stable: a restore replays from the committed position and a
    replayed batch must carry the id the failed attempt minted, so the
    position-derived ids (the default) are required and ``ids="sequence"``
    (a process counter) raises."""
    from ..observability import TraceConfig, Tracer
    cfg = TraceConfig.resolve(trace_arg)
    if cfg is None:
        return None
    _check_supervised_trace(cfg)
    return Tracer(cfg, name).start()


def _check_supervised_trace(cfg) -> None:
    if cfg is not None and cfg.ids != "position":
        raise ValueError(
            "supervised tracing requires TraceConfig(ids='position') — sequence ids "
            "are minted from a process counter, so a replay after restore would mint "
            "fresh ids and orphan every exemplar and ring-edge flow recorded before "
            "the failure (use the live drivers for sequence ids)")


def _abort_attempt() -> None:
    """Before a restore: close the failed attempt's open trace spans (tagged
    ``aborted``; the replay reopens them under the same ids) and drop the
    health ledger's note of a step that failed mid-build."""
    _tracing.abort_open("restore")
    _dh.clear_pending()


# --------------------------------------------------------- host copies

def _device_copy(x, device):
    return x.to(device, copy=True) if isinstance(x, torch.Tensor) else x


def host_tree(tree):
    """``tree`` (a state, a batch) with every tensor copied to the host (a
    sharded leaf assembled: ``parallel/mesh.py::host_copy``)."""
    return None if tree is None else rebuild(tree, [host_copy(x) for x in leaves(tree)])


def device_tree(tree, device):
    """A host tree rebuilt on ``device``: every tensor a fresh copy, every
    container a new object (so a fresh Win_Seq state, not marked consumed)."""
    return None if tree is None else rebuild(tree, [_device_copy(x, device)
                                                    for x in leaves(tree)])


# ---------------------------------------------------------- the pipeline

class SupervisedPipeline:
    """Source -> ops... -> sink with failure detection, checkpoint-aligned
    recovery and exactly-once sink delivery, on ``device`` (None =
    ``"cuda"``). ``batch_size=None`` takes the smallest ``withBatch`` hint of
    the operators, else the default. ``dispatch=`` (None consults
    ``WF_DISPATCH``) fuses up to K batches a device program with count-based
    group boundaries only: the accumulator is flushed before every commit and
    cleared on restore, so replay re-forms the same groups; a failed group
    replays per batch through its range, so quarantine keys the exact batch."""

    def __init__(self, source: SourceBase, ops: Sequence[Basic_Operator],
                 sink: Optional[Sink] = None, *,
                 batch_size: Optional[int] = None,
                 checkpoint_every: int = 8, max_restarts: int = 3,
                 spill_path: Optional[str] = None, checkpoint_keep: int = 1,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 dead_letter=None, poison_threshold: int = 3,
                 step_timeout: Optional[float] = None, faults=None,
                 control=None, trace=None, dispatch=None, shards=None,
                 reshard=None, shard_key=None, shard_range=None,
                 remediation=None, device=None):
        self._trace_arg = trace
        self._tracer = None
        #: shard-local supervision (``shards=`` or ``WF_SHARDS``; 1 runs the
        #: single-domain path): N > 1 splits the key space into N
        #: ShardSupervisor units under a ShardedSupervisor
        self._shards = resolve_shards(shards)
        self._reshard_arg = reshard
        #: the ownership key (TupleRef -> int, the KeyBy convention), needed
        #: when the stateful operators group on a derived key
        self._shard_key = shard_key
        #: this process supervises shards [lo, hi) of the global count
        self._shard_range = (tuple(int(x) for x in shard_range)
                             if shard_range is not None else None)
        if self._shard_range is not None and self._shards <= 1:
            raise ValueError(
                "shard_range= requires shards > 1 (or WF_SHARDS=N): with sharding off "
                "this host would silently supervise the WHOLE stream and the fleet "
                "would emit every output once per host — pass the global shard count "
                "alongside the slice")
        self._sharded = None          # the last run's ShardedSupervisor (report)
        self.device = resolve_device(device)
        if source.device != self.device:
            raise ValueError(f"source {source.getName()!r} lives on {source.device} "
                             f"but the supervised pipeline runs on {self.device}")
        self.source = source
        self.sink = sink
        from ..control import ControlConfig
        self._control = ControlConfig.resolve(control)
        self.batch_size = _warm_start_capacity(
            self._control, list(ops), source,
            int(batch_size or resolve_batch_hint(ops) or DEFAULT_BATCH_SIZE), self.device)
        self._admission = _supervised_admission(
            self._control, source.out_capacity(self.batch_size), "supervised-pipeline")
        #: barrier-mode remediation (this driver takes no monitoring=): a
        #: live engine acts on wall-clock verdicts, which a replay could not
        #: re-derive; with it off the checkpoints are the same as without
        self._remediation_arg = remediation      # validate()'s WF118 re-resolves it
        self._remediation = _barrier_remediation(
            remediation, admission=self._admission is not None, shards=self._shards)
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.max_restarts = int(max_restarts)
        self.spill_path = spill_path
        self.checkpoint_keep = max(1, int(checkpoint_keep))
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.dead_letter = dead_letter       # a DeadLetterQueue enables quarantine
        self.poison_threshold = max(1, int(poison_threshold))
        self.step_timeout = step_timeout
        self._faults_arg = faults
        #: resolved at start(), so an env change after construction counts
        self._dispatch_arg = dispatch
        self._dispatch = None
        self._started = False
        # event time from the environment (this driver takes no monitoring=);
        # the histograms ride the state snapshots, so a restore replays them
        self.chain = CompiledChain(list(ops), source.payload_spec(),
                                   batch_capacity=source.out_capacity(self.batch_size),
                                   device=self.device)
        if self._shards > 1 and self.chain._tier_ops:
            raise ValueError(
                "shard-local supervision (shards > 1) does not yet compose with tiered "
                "keyed state — the per-op HostStore is one process-wide cold tier, so a "
                "per-shard restore could roll back a peer shard's spilled rows; run "
                "tiered tables with shards=1 (or size the hot tables per shard and keep "
                "tiered= off)")
        self.restarts = 0                     # total recoveries (observability)

    # -- checkpointing ----------------------------------------------------------------

    def _snapshot(self):
        # host copies: the card's state may be lost with the card, and after
        # a replay the states are a captured graph's static tensors, which
        # the next replay overwrites. Tiered state settles first, so (states,
        # cold tiers) is a consistent pair.
        self.chain.tier_settle()
        return ([host_tree(st) for st in self.chain.states], self.chain.tier_snapshot())

    def _restore(self, snap):
        states, tiers = snap
        self.chain.states = [device_tree(st, self.device) for st in states]
        self.chain.tier_restore(tiers)

    # -- run --------------------------------------------------------------------------

    def start(self) -> None:
        """Resolve ``dispatch=`` and, when it is on with ``prewarm``, make
        ready every K' in 2..min(K, checkpoint_every) (on the card: captured),
        the group sizes a commit boundary can leave. ``run`` calls it when the
        caller has not."""
        if self._started:
            return
        cfg = _dispatch.DispatchConfig.resolve(self._dispatch_arg)
        if cfg is not None:
            if cfg.prewarm and cfg.k > 1 and self.chain.ops and self._shards == 1:
                cap = self.source.out_capacity(self.batch_size)
                for kk in range(2, min(cfg.k, self.checkpoint_every) + 1):
                    self.chain.warm_scan(kk, cap)
        self._dispatch = cfg
        self._started = True

    def run(self):
        """Drive the stream to EOS under supervision; returns
        ``chain.result()`` (sharded: every ReduceSink's shard partials
        combined)."""
        self.start()
        injector = _faults.resolve(self._faults_arg)
        self._tracer = _supervised_tracer(self._trace_arg,
                                         self.source.getName() + "-supervised")
        with _faults.activate(injector):
            try:
                if self._shards > 1:
                    self._sharded = ShardedSupervisor(self)
                    return self._sharded.run()
                return self._run()
            finally:
                if self._tracer is not None:
                    self._tracer.finish()

    def shard_report(self) -> dict:
        """Per-shard rows (``names.py::SHARD_GAUGES``) of the last sharded
        run; empty when ``shards`` resolved to 1."""
        return self._sharded.shard_report() if self._sharded is not None else {}

    def _run(self):
        dcfg = self._dispatch
        acc = acc_pos = None
        if dcfg is not None and dcfg.k > 1:
            # count-based flush only (no linger): group boundaries are a pure
            # function of stream position, so replay re-forms them
            acc = _dispatch.MicrobatchAccumulator(dcfg.k)
            acc_pos = []                      # positions of buffered batches
        snap = self._snapshot()
        snap_pos = 0                          # batches fully committed
        snap_cursor = None                    # source resume token at commit
        adm = self._admission
        rem = self._remediation
        snap_adm = adm.state() if adm is not None else None
        if rem is not None and adm is not None:
            # the barrier remediation's decision state rides the admission
            # snapshot (only when remediation is on): a restore resets it to
            # the committed decision point
            snap_adm = dict(snap_adm, remediation={"engine": rem.state(),
                                                   "rate": adm.current_rate()})
        pending = []                          # outputs since last commit
        outbox = []                           # committed, not yet delivered
        budget = self.max_restarts
        # backoff jitter is timing only: it never touches replayed data
        rng = random.Random()                 # wf-lint: allow[wall-clock]
        prev_sleep = self.backoff_base
        fail_pos = None                       # poison tracking: last fail position
        fail_streak = 0                       # consecutive failures at fail_pos
        quarantine_pos = None                 # armed: skip + dead-letter this pos
        quarantine_err = None
        degrade_hi = None                     # per-batch replay bound after a
        #                                       fused group failed (None = fuse)

        def deliver_outbox():
            # resumable: each output leaves the outbox only after the sink
            # took it, so a sink fault mid-commit re-delivers the remainder
            while outbox:
                _faults.fire("sink.consume", pos=snap_pos, pending=len(outbox))
                self.sink.consume(outbox[0])
                outbox.pop(0)

        def push_group(group, positions):
            # a fused-group failure is attributable only to the group's head,
            # so the replay degrades to per-batch through the group's range,
            # where the failure re-manifests at its true position
            nonlocal degrade_hi
            if len(group) > 1:
                try:
                    return _push_group_inner(group, positions)
                except BaseException:
                    degrade_hi = positions[-1]
                    raise
            return _push_group_inner(group, positions)

        def _push_group_inner(group, positions):
            nonlocal cur_pos
            cur_pos = positions[0]
            # spans open on the driving thread, before the watchdog worker
            # runs the push; k marks a fused group's members
            spans = [_tracing.service(b, "chain", k=len(group)) for b in group]
            p0 = positions[0]
            # a singleton takes the per-batch push (wrappers around
            # chain.push see every batch when dispatch is off)
            step = (lambda: [self.chain.push(group[0])] if len(group) == 1
                    else self.chain.push_many(group))
            outs = _faults.call_with_timeout(
                step, self.step_timeout, stage="chain.step",
                pre=lambda: _faults.fire("chain.step", pos=p0))
            for b, out, span in zip(group, outs, spans):
                if span is not None:
                    span.done()
                    _tracing.carry(b, out)
                # the host copy now: an asynchronous device fault surfaces
                # HERE, before the output could ever reach the sink
                pending.append(host_tree(out) if self.sink is not None else out)
            cur_pos = None

        def flush_acc():
            # a checkpoint boundary (or EOS) lands mid-accumulator: the
            # partial group dispatches short so the snapshot reflects every
            # position already read
            if acc is None or not len(acc):
                return
            tail = acc.drain()
            positions, acc_pos[:] = acc_pos[:len(tail)], []
            push_group(tail, positions)

        def commit(pos):
            nonlocal snap, snap_pos, snap_cursor, snap_adm, budget
            flush_acc()
            with _journal.span("checkpoint", at_batch=pos,
                               outputs_committed=len(pending)):
                # fallible work first: a failure here leaves the previous
                # commit intact (replay regenerates `pending`)
                new_snap = self._snapshot()   # host copies: faults surface here
                new_cursor = self.source.cursor()
                new_adm = adm.state() if adm is not None else None
                if rem is not None and adm is not None:
                    # the interval's committed shed ratio in, actuations out,
                    # before the commit point: the committed snapshot holds
                    # the rate and decision state after the actions (a
                    # failure below re-evaluates this barrier the same way)
                    ratio = _interval_drop_ratio(snap_adm, new_adm)
                    for d in rem.on_barrier(pos, {} if ratio is None
                                            else {"drop_ratio": ratio}):
                        _apply_barrier_decision(d, adm)
                    new_adm = dict(new_adm, remediation={"engine": rem.state(),
                                                         "rate": adm.current_rate()})
                if self.spill_path:
                    from .checkpoint import save_chain
                    save_chain(self.chain, self.spill_path,
                               meta={"batches_done": pos}, keep=self.checkpoint_keep)
                # -- the commit point: pure assignments, cannot fail --
                snap, snap_pos, snap_cursor = new_snap, pos, new_cursor
                snap_adm = new_adm
                budget = self.max_restarts    # progress refills the budget
                if self.sink is not None:
                    outbox.extend(pending)
                pending.clear()
                deliver_outbox()

        pos = 0
        cur_pos = None                        # batch position being processed
        while True:
            try:
                # no batch in flight yet: a failure in reopen/delivery below
                # must not be attributed to the previous attempt's batch
                cur_pos = None
                it = _reopen_source(self.source, self.batch_size, pos, snap_cursor)
                deliver_outbox()              # finish any interrupted delivery
                while True:
                    if quarantine_pos is not None and pos == quarantine_pos:
                        eos = self._quarantine(it, pos, quarantine_err)
                        quarantine_pos = quarantine_err = None
                        fail_pos, fail_streak = None, 0
                        if eos:
                            break
                        pos += 1
                        cur_pos = None
                        if pos - snap_pos >= self.checkpoint_every:
                            commit(pos)
                        continue
                    cur_pos = pos
                    _faults.fire("source.next", pos=pos)
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    # position-derived: a replay of this position re-mints
                    # the same id
                    _tracing.ingest(batch, pos)
                    if adm is not None and not adm.offer(batch, pos=pos):
                        # shed (the positional bucket: a replay from the
                        # committed bucket state re-sheds this batch)
                        pos += 1
                        cur_pos = None
                        if pos - snap_pos >= self.checkpoint_every:
                            commit(pos)
                        continue
                    if degrade_hi is not None and pos > degrade_hi:
                        degrade_hi = None     # past the failed group's range
                    if acc is None or degrade_hi is not None:
                        push_group([batch], [pos])
                    else:
                        acc_pos.append(pos)
                        for group in acc.feed(batch):
                            positions = acc_pos[:len(group)]
                            del acc_pos[:len(group)]
                            push_group(group, positions)
                    pos += 1
                    cur_pos = None
                    if pos - snap_pos >= self.checkpoint_every:
                        commit(pos)
                # EOS: flush, commit everything (inside the recovery loop: a
                # fault during the flush or the final commit replays too)
                cur_pos = None
                flush_acc()                   # partial tail < K at EOS
                for out in self.chain.flush():
                    pending.append(host_tree(out) if self.sink is not None else out)
                commit(pos)
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:        # noqa: BLE001 — the detection point
                # poison tracking: poison_threshold consecutive failures at one
                # position arm the quarantine. Only the arming failure is free;
                # every other one spends budget, so a deterministic error can
                # never livelock the restore loop.
                armed_now = False
                if self.dead_letter is not None and cur_pos is not None:
                    if cur_pos == fail_pos:
                        fail_streak += 1
                    else:
                        fail_pos, fail_streak = cur_pos, 1
                    if fail_streak >= self.poison_threshold and quarantine_pos is None:
                        quarantine_pos, quarantine_err = cur_pos, e
                        armed_now = True
                if not armed_now:
                    if budget <= 0:
                        _journal.record("restart_exhausted", at_batch=pos,
                                        error=type(e).__name__)
                        raise RestartExhausted(
                            f"step failed {self.max_restarts + 1}x within one "
                            f"checkpoint interval (at batch {pos})") from e
                    budget -= 1
                self.restarts += 1
                _faults.bump("restarts")
                # a watchdog-abandoned worker finishes (or gives up) before
                # the restore, so it never writes into the restored state
                _faults.join_abandoned_worker(e, self.step_timeout)
                _abort_attempt()
                with _restore_span(at_batch=pos, replay_from=snap_pos,
                                   attempt=self.restarts, error=type(e).__name__):
                    self._restore(snap)
                    if adm is not None:
                        adm.set_state(snap_adm)
                        if rem is not None and snap_adm is not None:
                            # set_state restores tokens and counters; the
                            # refill rate the remediation may have scaled and
                            # the decision state come from the commit too
                            rst = snap_adm.get("remediation") or {}
                            rem.set_state(rst.get("engine") or {})
                            adm.set_rate(float(rst.get("rate", adm.current_rate())))
                pending.clear()               # uncommitted: regenerated by replay
                if acc is not None:
                    acc.clear()               # replay re-feeds dropped batches
                    acc_pos.clear()
                pos = snap_pos                # replay uncommitted batches
                prev_sleep = _faults.backoff_sleep(
                    rng, prev_sleep, self.backoff_base, self.backoff_cap,
                    attempt=self.restarts)
        if self.sink is not None:
            self.sink.consume(None)
        for op in [self.source, *self.chain.ops,
                   *([self.sink] if self.sink is not None else [])]:
            op.close()
        return self.chain.result()

    def _quarantine(self, it, pos: int, error) -> bool:
        return _quarantine_skip(it, pos, error, self.dead_letter, "pipeline")


def _quarantine_skip(it, pos: int, error, dead_letter, driver: str,
                     **journal_fields) -> bool:
    """The quarantine protocol of both supervised drivers: dead-letter the
    batch at ``pos`` instead of processing it; returns True at EOS. The batch
    is still read from the source (no injection fires: the position is being
    skipped, not retried). A read that genuinely raises propagates and spends
    budget upstream: an unreadable position cannot be skipped."""
    try:
        batch = next(it)
    except StopIteration:
        return True
    _journal.record("dead_letter", at_batch=pos,
                    error=type(error).__name__ if error else None, **journal_fields)
    _faults.bump("dead_letters")
    dead_letter.put(batch, pos=pos, error=error, driver=driver)
    return False


def _reopen_source(source, batch_size: int, pos: int, cursor):
    """(Re-)open a source iterator at committed batch ``pos``. Seekable
    sources (``SourceBase.cursor``) resume from the token captured at the
    last commit; a source whose ``batches`` takes no ``cursor`` (found with
    ``inspect.signature``, never by catching ``TypeError``, which would mask
    one raised by the source) is fast-forwarded by ``pos`` batches."""
    if pos and cursor is not None and _accepts_cursor(source.batches):
        return source.batches(batch_size, cursor=cursor)
    it = source.batches(batch_size)
    for _ in range(pos):
        next(it, None)
    return it


def _accepts_cursor(fn) -> bool:
    """Does ``fn`` (a ``batches`` callable) accept a ``cursor`` keyword?"""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):           # a C callable etc.: assume it does
        return True
    return ("cursor" in params
            or any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()))


# ------------------------------------------------------ shard-local supervision

def _fresh_states(chain: CompiledChain) -> list:
    """Freshly initialized operator states for one shard on the chain's device
    (each shard owns its states; the chain's ops and programs are shared)."""
    return [op.init_state(chain.specs[i]) for i, op in enumerate(chain.ops)]


class _ShardRecoveryBase:
    """The per-shard failure bookkeeping of both sharded drivers
    (:class:`ShardSupervisor`, :class:`_GraphShard`): poison streaks with a
    budget-free arming failure, the restart budget and
    :class:`RestartExhausted`, the watchdog join, recovery timing, backoff,
    quarantine and the ``names.py::SHARD_GAUGES`` row. Subclasses supply
    ``_restore_for_replay``, ``_count_restart``, ``_replay_from``,
    ``_committed_tag``, ``_exhausted_message`` and ``_journal_fields``."""

    def _init_recovery(self, idx: int, co) -> None:
        self.idx = int(idx)
        self.co = co
        self.budget = co.max_restarts
        self.restarts = 0
        self.dead_letters = 0
        self.reshard_moves = 0
        self.occupancy_tuples = 0           # committed live tuples processed
        self.interval_tuples = 0            # the last committed interval's
        self.last_recovery_s = 0.0
        self.prev_sleep = co.backoff_base
        self._rng = random.Random()         # wf-lint: allow[wall-clock] backoff jitter
        self._fail_key = None               # poison streak: last failing key
        self._streak = 0
        self._quarantine_key = None         # armed: dead-letter this key
        self._quarantine_err = None
        self._rec_t0 = None

    def _restore_for_replay(self) -> None:
        raise NotImplementedError

    def _count_restart(self) -> None:
        raise NotImplementedError

    def _replay_from(self):
        raise NotImplementedError

    def _committed_tag(self):
        raise NotImplementedError

    def _exhausted_message(self, key) -> str:
        raise NotImplementedError

    def _journal_fields(self, key) -> dict:
        return {}

    def _on_failure(self, e, key) -> None:
        """The SupervisedPipeline recovery path scoped to one key range:
        poison tracking (only the arming failure is free), budget, watchdog
        join, restore, backoff."""
        armed_now = False
        if self.co.dead_letter is not None and key is not None:
            if key == self._fail_key:
                self._streak += 1
            else:
                self._fail_key, self._streak = key, 1
            if self._streak >= self.co.poison_threshold and self._quarantine_key is None:
                self._quarantine_key, self._quarantine_err = key, e
                armed_now = True
        if not armed_now:
            if self.budget <= 0:
                _journal.record("restart_exhausted", shard=self.idx,
                                error=type(e).__name__, **self._journal_fields(key))
                raise RestartExhausted(self._exhausted_message(key)) from e
            self.budget -= 1
        self.restarts += 1
        self._count_restart()
        _faults.bump("restarts")
        _faults.join_abandoned_worker(e, self.co.step_timeout)
        _abort_attempt()
        self._rec_t0 = time.perf_counter()    # wf-lint: allow[wall-clock] (a timer)
        _journal.record("shard_restore", shard=self.idx, replay_from=self._replay_from(),
                        attempt=self.restarts, error=type(e).__name__,
                        **self._journal_fields(key))
        self._restore_for_replay()
        self.prev_sleep = _faults.backoff_sleep(
            self._rng, self.prev_sleep, self.co.backoff_base, self.co.backoff_cap,
            attempt=self.restarts)

    def _quarantine_hit(self, pos, sub, driver: str, **fields) -> None:
        """Dead-letter the armed sub-batch and disarm (the caller blanks its
        replay slot): under sharding the sub-batch is the exact failing unit."""
        _journal.record("dead_letter", at_batch=pos, shard=self.idx,
                        error=(type(self._quarantine_err).__name__
                               if self._quarantine_err else None), **fields)
        _faults.bump("dead_letters")
        if self.co.dead_letter is not None:
            self.co.dead_letter.put(sub, pos=pos, error=self._quarantine_err, driver=driver)
        self.dead_letters += 1
        self._quarantine_key = self._quarantine_err = None
        self._fail_key, self._streak = None, 0

    def _finish_recovery_timing(self) -> None:
        if self._rec_t0 is not None:
            self.last_recovery_s = time.perf_counter() - self._rec_t0  # wf-lint: allow[wall-clock]
            self._rec_t0 = None
            # shard-local restores feed the same counter as whole-domain ones
            _faults.bump("recovery_seconds", round(self.last_recovery_s, 6))

    def report(self) -> dict:
        """One ``names.py::SHARD_GAUGES`` row."""
        return {"occupancy_tuples": self.occupancy_tuples, "restarts": self.restarts,
                "last_recovery_s": round(self.last_recovery_s, 6),
                "dead_letters": self.dead_letters, "reshard_moves": self.reshard_moves,
                "committed_pos": self._committed_tag()}


class ShardSupervisor(_ShardRecoveryBase):
    """One key range's supervision unit: its own budget, backoff, outbox,
    quarantine, watchdog-wrapped steps and (under ``spill_path``) checkpoint
    lineage. It borrows the coordinator's :class:`CompiledChain` (its states
    installed for each push) but fails alone: a fault in its step restores
    its snapshot and replays its sub-batches since its last commit while the
    other shards go on. Snapshots are host copies (a restored state is fresh
    tensors, never an alias of what a later push consumes)."""

    def __init__(self, idx: int, chain: CompiledChain, states, co):
        self._init_recovery(idx, co)        # co: the ShardedSupervisor
        self.chain = chain
        self.states = states
        self.snap = self._snapshot_states()
        self.snap_pos = 0
        self.replay = []                    # [(pos, sub)] since the last commit;
        #                                     sub None marks a quarantined slot
        self.pending = []                   # outputs since the last commit
        self.outbox = []                    # committed, not yet delivered

    def _snapshot_states(self):
        return [host_tree(st) for st in self.states]

    def _restore_states(self):
        self.states = [device_tree(st, self.chain.device) for st in self.snap]

    def _step(self, sub):
        self.chain.states = self.states
        out = self.chain.push(sub)
        self.states = self.chain.states
        return out

    def offer(self, pos: int, sub) -> None:
        """This shard's sub-batch of stream position ``pos``: buffered for
        replay, pushed under the watchdog, recovered shard-locally."""
        self.replay.append((pos, sub))
        self._drive(len(self.replay) - 1)

    def _drive(self, start: int) -> None:
        i = start
        while i < len(self.replay):
            pos, sub = self.replay[i]
            if sub is None:                 # a quarantined slot
                i += 1
                continue
            if self._quarantine_key is not None and pos == self._quarantine_key:
                self._quarantine_hit(pos, sub, f"sharded-pipeline:shard{self.idx}")
                self.replay[i] = (pos, None)
                i += 1
                continue
            span = _tracing.service(sub, "chain")
            try:
                _faults.fire("shard.kill", shard=self.idx, pos=pos)
                out = _faults.call_with_timeout(
                    lambda sub=sub: self._step(sub), self.co.step_timeout,
                    stage=f"shard{self.idx}.step")
                if span is not None:
                    span.done()
                    _tracing.carry(sub, out)
                self.pending.append(host_tree(out) if self.co.sink is not None else out)
                i += 1
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:      # noqa: BLE001 — the detection point
                self._on_failure(e, pos)
                i = 0                       # replay the whole interval
        self._finish_recovery_timing()

    def _restore_for_replay(self) -> None:
        self._restore_states()
        self.pending.clear()                # uncommitted: replay regenerates

    def _count_restart(self) -> None:
        self.co.p.restarts += 1

    def _replay_from(self):
        return self.snap_pos

    def _committed_tag(self):
        return self.snap_pos

    def _exhausted_message(self, key) -> str:
        return (f"shard {self.idx} failed {self.co.max_restarts + 1}x within one "
                f"checkpoint interval (at batch {key})")

    def _journal_fields(self, key) -> dict:
        return {"at_batch": key}

    def flush_supervised(self) -> None:
        """The EOS flush with the same shard-local recovery: a fault during
        it restores and replays this shard's interval, then flushes again."""
        while True:
            try:
                self.chain.states = self.states
                outs = _faults.call_with_timeout(self.chain.flush, self.co.step_timeout,
                                                 stage=f"shard{self.idx}.flush")
                self.states = self.chain.states
                for out in outs:
                    self.pending.append(host_tree(out) if self.co.sink is not None else out)
                return
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:      # noqa: BLE001 — the detection point
                self._on_failure(e, None)
                self._drive(0)

    def commit(self, pos: int, snap) -> None:
        """The shard's commit point (pure assignments: the coordinator did the
        fallible snapshot and save first)."""
        self.snap = snap
        self.snap_pos = pos
        n_interval = sum(int(sub.count()) for _p, sub in self.replay if sub is not None)
        self.occupancy_tuples += n_interval
        self.interval_tuples = n_interval
        self.replay.clear()
        self.budget = self.co.max_restarts
        if self.co.sink is not None:
            self.outbox.extend(self.pending)
        self.pending.clear()

    def deliver(self) -> None:
        """Resumable committed delivery."""
        while self.outbox:
            _faults.fire("sink.consume", shard=self.idx, pending=len(self.outbox))
            self.co.sink.consume(self.outbox[0])
            self.outbox.pop(0)


class ShardedSupervisor:
    """The control plane over N :class:`ShardSupervisor` units: the sharded
    form of :class:`SupervisedPipeline` (``shards=``/``WF_SHARDS``).

    It owns what is global: the source and its commit cursor, the aligned
    checkpoint barrier (each shard snapshots itself; spills fan out per
    shard through ``checkpoint.save_sharded``) and the re-sharding plan. A
    failure outside any shard's step (a source read, a checkpoint save, a
    delivery, a handoff) is recovered the whole-domain way: every shard back
    to its snapshot, the source reopened at the committed cursor.

    Live re-sharding runs at a checkpoint barrier in two phases: every
    retiring shard's committed state is sealed to a handoff file (or, without
    ``spill_path``, the ``reshard.handoff`` site is walked), then the shards
    whose key range is unchanged keep their state and the changed ones are
    rebuilt by replaying the committed prefix through the new ownership (the
    chain's own deterministic slot allocation, no per-operator migration).
    The barrier position makes a replay re-derive the same layout; a failure
    mid-handoff drops the seals and re-derives the move at the same barrier."""

    def __init__(self, p: "SupervisedPipeline"):
        dcfg = _dispatch.DispatchConfig.resolve(p._dispatch_arg)
        if dcfg is not None and dcfg.k > 1:
            raise ValueError(
                "shards > 1 does not compose with scan dispatch (K > 1): a fused group "
                "failure could not be attributed to one shard's replay extent — drop "
                "dispatch= (or run shards=1); the validator's WF115 catches this pre-run")
        self.p = p
        self.chain = p.chain
        self.source = p.source
        self.sink = p.sink
        self.dead_letter = p.dead_letter
        self.poison_threshold = p.poison_threshold
        self.step_timeout = p.step_timeout
        self.max_restarts = p.max_restarts
        self.backoff_base = p.backoff_base
        self.backoff_cap = p.backoff_cap
        self.checkpoint_every = p.checkpoint_every
        self.spill_path = p.spill_path
        self.checkpoint_keep = p.checkpoint_keep
        self.assignment = ShardAssignment(p._shards)
        plan = ReshardPlan.resolve(p._reshard_arg)
        #: reshard="auto": the governor's planner derives plans from the
        #: committed per-shard loads at each barrier
        self.auto_reshard = plan == "auto"
        self.pending_plan = None if self.auto_reshard else plan
        self._reshard_due = False
        self.reshard_count = 0
        self._auto_stopped = False
        self._auto_prev_ratio = None
        self._auto_check_pending = False
        #: barrier remediation (or None): evaluated in _barrier on committed
        #: signals; its state and the scaled rate are kept in snap_rem (the
        #: coordinator's half of the snapshot)
        self.rem = p._remediation
        self.snap_rem = None
        self._rem_drop_ratio = None         # the last committed interval's
        lo, hi = p._shard_range if p._shard_range is not None else (0, p._shards)
        if not (0 <= lo <= hi <= p._shards):
            raise ValueError(f"shard_range={p._shard_range} is not a sub-range of "
                             f"[0, {p._shards})")
        if (lo, hi) != (0, p._shards) and (self.auto_reshard
                                           or self.pending_plan is not None):
            raise ValueError(
                "live re-sharding under a multi-host shard_range is not yet supported — "
                "each host would have to apply the plan at the same barrier over DCN; "
                "run reshard on the single-host layout (or drop shard_range)")
        # an empty slice (lo == hi) supervises no shard and idles through the
        # stream
        self.shards = ([ShardSupervisor(lo, self.chain, self.chain.states, self)]
                       if lo < hi else [])
        for k in range(lo + 1, hi):
            self.shards.append(ShardSupervisor(k, self.chain, _fresh_states(self.chain),
                                               self))
        self.commit_pos = 0
        self.snap_cursor = None
        self.snap_adm = None
        self._gbudget = self.max_restarts

    def _splitter(self):
        return make_splitter(self.assignment, self.p._shard_key)

    def run(self):
        p = self.p
        adm = p._admission
        self.snap_adm = adm.state() if adm is not None else None
        if self.rem is not None:
            self.snap_rem = {"engine": self.rem.state(),
                             "rate": adm.current_rate() if adm is not None else None}
        rng = random.Random()               # wf-lint: allow[wall-clock] backoff jitter
        prev_sleep = self.backoff_base
        split = None
        while True:
            try:
                if self._reshard_due:
                    # a failure interrupted the handoff: re-derive the move at
                    # the same barrier, so the layout history matches a
                    # fault-free run's
                    self._apply_reshard(self.pending_plan, self.commit_pos, adm)
                    self._reshard_due = False
                    self.pending_plan = None
                    if self.auto_reshard:
                        # the retry arms the no-improvement check as the
                        # barrier does
                        self._auto_check_pending = True
                    split = None
                if split is None:
                    split = self._splitter()
                it = _reopen_source(self.source, p.batch_size, self.commit_pos,
                                    self.snap_cursor)
                for s in self.shards:
                    s.deliver()             # finish any interrupted delivery
                pos = self.commit_pos
                while True:
                    _faults.fire("source.next", pos=pos)
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    _tracing.ingest(batch, pos)
                    if adm is not None and not adm.offer(batch, pos=pos):
                        pos += 1
                        if pos - self.commit_pos >= self.checkpoint_every:
                            self._commit(pos, adm)
                            split = self._barrier(pos, adm, split)
                        continue
                    if self.shards:
                        subs = split(batch)
                        for s in self.shards:
                            sub = subs[s.idx]
                            _tracing.carry(batch, sub)
                            s.offer(pos, sub)
                    pos += 1
                    if pos - self.commit_pos >= self.checkpoint_every:
                        self._commit(pos, adm)
                        split = self._barrier(pos, adm, split)
                # EOS: every shard flushes under its own recovery, one final
                # commit, committed delivery
                for s in self.shards:
                    s.flush_supervised()
                self._commit(pos, adm)
                if self.pending_plan is not None or self._reshard_due:
                    # the stream ended before the plan's barrier: say so
                    _journal.record("reshard", aborted=True, at_pos=pos,
                                    error="stream ended before the plan's at_pos barrier")
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except RestartExhausted:
                raise
            except BaseException as e:      # noqa: BLE001 — the global detection point
                if self._gbudget <= 0:
                    _journal.record("restart_exhausted", at_batch=self.commit_pos,
                                    error=type(e).__name__)
                    raise RestartExhausted(
                        f"sharded run failed {self.max_restarts + 1}x within one "
                        f"checkpoint interval (committed {self.commit_pos})") from e
                self._gbudget -= 1
                p.restarts += 1
                _faults.bump("restarts")
                _faults.join_abandoned_worker(e, self.step_timeout)
                _abort_attempt()
                with _restore_span(at_batch=self.commit_pos, replay_from=self.commit_pos,
                                   shards=len(self.shards), error=type(e).__name__):
                    for s in self.shards:
                        s._restore_states()
                        s.pending.clear()
                        s.replay.clear()
                    if adm is not None:
                        adm.set_state(self.snap_adm)
                    if self.rem is not None and self.snap_rem is not None:
                        # the scaled rate and the decision state from the
                        # committed decision point
                        self.rem.set_state(self.snap_rem.get("engine") or {})
                        if adm is not None and self.snap_rem.get("rate") is not None:
                            adm.set_rate(float(self.snap_rem["rate"]))
                    if self.spill_path:
                        from .checkpoint import discard_handoffs
                        dropped = discard_handoffs(self.spill_path)
                        if dropped:
                            _journal.record("reshard", discarded=True, files=dropped)
                prev_sleep = _faults.backoff_sleep(rng, prev_sleep, self.backoff_base,
                                                   self.backoff_cap, attempt=p.restarts)
        if self.sink is not None:
            self.sink.consume(None)
        for op in [self.source, *self.chain.ops,
                   *([self.sink] if self.sink is not None else [])]:
            op.close()
        return self._merged_result()

    # -- the aligned barrier ----------------------------------------------------------

    def _commit(self, pos: int, adm) -> None:
        with _journal.span("checkpoint", at_batch=pos, shards=len(self.shards),
                           outputs_committed=sum(len(s.pending) for s in self.shards)):
            # fallible work first: snapshots, the cursor, the sharded spill
            new_snaps = [s._snapshot_states() for s in self.shards]
            new_cursor = self.source.cursor()
            new_adm = adm.state() if adm is not None else None
            drop_ratio = _interval_drop_ratio(self.snap_adm, new_adm)
            if self.spill_path and self.shards:
                from .checkpoint import save_sharded
                save_sharded(new_snaps, self.spill_path, layout=self.assignment.to_meta(),
                             meta={"batches_done": pos}, keep=self.checkpoint_keep,
                             shard_ids=[s.idx for s in self.shards])
            # -- the commit point: pure assignments --
            for s, sn in zip(self.shards, new_snaps):
                s.commit(pos, sn)
            self.commit_pos = pos
            self.snap_cursor = new_cursor
            self.snap_adm = new_adm
            self._rem_drop_ratio = drop_ratio
            self._gbudget = self.max_restarts
            for s in self.shards:
                s.deliver()

    def _barrier(self, pos: int, adm, split):
        """After a commit: derive a plan (``reshard="auto"``), let the
        remediation act, and apply a pending plan whose barrier has come.
        Returns the (possibly new) splitter."""
        if self.auto_reshard and self.pending_plan is None and not self._auto_stopped:
            from ..control.governor import recommend_reshard
            loads = {s.idx: s.interval_tuples for s in self.shards}
            vals = list(loads.values())
            total = sum(vals)
            # the hot fraction (max/total) is scale-free across shard counts:
            # a split halves it, one unsplittable hot key keeps it
            frac = (max(vals) / total) if total > 0 else 0.0
            if self._auto_check_pending and total >= float(len(vals)):
                # the first measured barrier after an auto reshard (only that
                # one): did the doubling lower the hot fraction?
                self._auto_check_pending = False
                if frac >= 0.9 * self._auto_prev_ratio:
                    # it did not: the skew sits in one key slot, which
                    # key % 2N cannot split, so auto resharding stops
                    self._auto_stopped = True
                    _journal.record("reshard", aborted=True, at_pos=pos,
                                    error="auto-stopped: hot fraction "
                                          f"{frac:.2f} did not improve")
                self._auto_prev_ratio = None
            elif not self._auto_check_pending:
                plan = recommend_reshard(loads, self.assignment)
                if plan is not None:
                    self.pending_plan = plan
                    self._auto_prev_ratio = frac
        if self.rem is not None:
            # after the auto derivation (arbitration sees this barrier's plan)
            # and before the due-check (a remediation reshard lands here)
            self._remediate_barrier(pos, adm)
        if self.pending_plan is not None and pos >= self.pending_plan.at_pos:
            self._reshard_due = True
        if self._reshard_due:
            self._apply_reshard(self.pending_plan, pos, adm)
            self._reshard_due = False
            self.pending_plan = None
            if self.auto_reshard:
                self._auto_check_pending = True
            return self._splitter()
        return split

    def _remediate_barrier(self, pos: int, adm) -> None:
        """Deterministic remediation at the sharded barrier: the committed
        interval's shed ratio (from :meth:`_commit`) and the shards' hot
        fraction in, actuations out. Runs after the commit, and folds the
        engine state and the scaled rate into ``snap_rem`` at once, so a
        later failure restores to the state after the decisions."""
        vals = [s.interval_tuples for s in self.shards]
        total = sum(vals)
        signals = {}
        if total > 0:
            signals["shard_skew"] = max(vals) / total
        if adm is not None and self._rem_drop_ratio is not None:
            signals["drop_ratio"] = self._rem_drop_ratio
        for d in self.rem.on_barrier(pos, signals):
            if d.get("applied") and d.get("actuator") == "reshard":
                if self.auto_reshard or self.pending_plan is not None or self._reshard_due:
                    # one resharder wins: an armed auto reshard (or a plan
                    # already pending) owns the barrier
                    _apply_barrier_decision(dict(d, applied=False, reason="arbitration"),
                                            None)
                    continue
                act = next(a for a in self.rem.actions if a.name == d["action"])
                from ..control.governor import recommend_reshard
                plan = recommend_reshard({s.idx: s.interval_tuples for s in self.shards},
                                         self.assignment, hot_fraction=act.target)
                if plan is None:
                    # the planner disagrees (shard ceiling, or too little load)
                    _apply_barrier_decision(dict(d, applied=False, reason="no_plan"), None)
                    continue
                self.pending_plan = plan
                _apply_barrier_decision(d, None)
            else:
                _apply_barrier_decision(d, adm)
        self.snap_rem = {"engine": self.rem.state(),
                         "rate": adm.current_rate() if adm is not None else None}

    # -- live re-sharding -------------------------------------------------------------

    def _apply_reshard(self, plan, pos: int, adm) -> None:
        old = self.assignment
        try:
            new = plan.apply_to(old)
        except ValueError as e:
            _journal.record("reshard", aborted=True, at_pos=pos, error=str(e))
            return
        if new == old:
            return
        with _journal.span("reshard", from_shards=old.num_shards, to_shards=new.num_shards,
                           moves=len(new.moves), at_pos=pos):
            # phase 1, drain: seal every retiring shard's committed state (or
            # walk the site in memory); a failure here goes to the global
            # handler, which drops the seals, and the plan stays due
            if self.spill_path:
                from .checkpoint import seal_handoff
                seal_handoff([s.snap for s in self.shards], self.spill_path,
                             layout=old.to_meta(), at_pos=pos)
            else:
                for s in self.shards:
                    _faults.fire("reshard.handoff", shard=s.idx, at_pos=pos)
            # phase 2, re-admit: unchanged shards keep their state, changed
            # ones replay the committed prefix (outputs dropped: the old
            # layout committed them)
            self.shards = self._readmit(old, new, pos)
            self.assignment = new
            self.reshard_count += 1
            # the new layout commits at once (the replay buffers are empty at
            # a barrier, and the shards' interval loads restart); then the
            # seals are obsolete
            self._commit(pos, adm)
            if self.spill_path:
                from .checkpoint import discard_handoffs
                discard_handoffs(self.spill_path)

    def _readmit(self, old, new, upto: int) -> list:
        affected = affected_shards(old, new)
        keep = {}
        if new.num_shards == old.num_shards:
            keep = {s.idx: s for s in self.shards if s.idx not in affected}
        rebuilt = [i for i in range(new.num_shards) if i not in keep]
        fresh = {i: _fresh_states(self.chain) for i in rebuilt}
        if upto > 0 and rebuilt:
            split = make_splitter(new, self.p._shard_key)
            # a fresh positional bucket re-derives the shed pattern
            radm = _supervised_admission(self.p._control,
                                         self.source.out_capacity(self.p.batch_size),
                                         "sharded-readmit")
            it = self.source.batches(self.p.batch_size)
            for ppos in range(upto):
                try:
                    batch = next(it)
                except StopIteration:
                    break
                if radm is not None and not radm.offer(batch, pos=ppos):
                    continue
                subs = split(batch)
                for i in rebuilt:
                    self.chain.states = fresh[i]
                    try:
                        self.chain.push(subs[i])
                        fresh[i] = self.chain.states
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except BaseException as e:  # noqa: BLE001 — a poison sub-batch
                        # the live run already dead-lettered (or new poison
                        # under the new mask): quarantine it here, the
                        # rebuild must not kill a run recovery survived
                        # (fresh[i] keeps the states from before the push)
                        _journal.record("dead_letter", at_batch=ppos, shard=i,
                                        during_reshard=True, error=type(e).__name__)
                        _faults.bump("dead_letters")
                        if self.dead_letter is not None:
                            self.dead_letter.put(subs[i], pos=ppos, error=e,
                                                 driver=f"sharded-readmit:shard{i}")
        units = []
        prior = {s.idx: s for s in self.shards}
        for i in range(new.num_shards):
            if i in keep:
                units.append(keep[i])
                continue
            u = ShardSupervisor(i, self.chain, fresh[i], self)
            u.snap_pos = upto
            u.reshard_moves = prior[i].reshard_moves + 1 if i in prior else 1
            u.occupancy_tuples = prior[i].occupancy_tuples if i in prior else 0
            u.restarts = prior[i].restarts if i in prior else 0
            u.dead_letters = prior[i].dead_letters if i in prior else 0
            units.append(u)
        return units

    # -- results and reporting --------------------------------------------------------

    def _merged_result(self):
        """Every ReduceSink's shard partials combined with its own associative
        ``combine`` (a key's rows live in one shard)."""
        res = {}
        for i, op in enumerate(self.chain.ops):
            if isinstance(op, ReduceSink):
                acc = None
                for s in self.shards:
                    v = op.result(s.states[i])
                    acc = v if acc is None else tree_map(op.combine, acc, v)
                if acc is None:
                    # an empty slice: the identity-valued reduction
                    acc = op.result(op.init_state(self.chain.specs[i]))
                res[op.name] = acc
        return res

    def shard_report(self) -> dict:
        return {s.idx: s.report() for s in self.shards}



# ------------------------------------------------------------ graph level

class _CommitBufferSink:
    """Output-commit shim over a pipe's Sink during supervised graph
    execution: outputs are copied to the host at once (an asynchronous device
    fault surfaces before anything reaches the user callback) but delivered
    only at checkpoint commit. Committed outputs move to an ``outbox`` that
    survives restore and drains resumably. Under the sharded driver,
    ``shard`` routes uncommitted outputs into per-shard buckets (a shard's
    restore discards only its own) and ``mute`` drops outputs (the
    re-sharding prefix replay: the old layout committed them)."""

    def __init__(self, real):
        self.real = real
        self.pending = []                     # uncommitted (discarded on restore)
        self.outbox = []                      # committed, not yet delivered
        self.shard = None
        self.mute = False
        self.pending_by = {}                  # shard -> [batches]

    def consume(self, batch):
        if batch is None:
            return                # EOS: delivered by the supervisor at the end
        if self.mute:
            return
        host = host_tree(batch)
        if self.shard is None:
            self.pending.append(host)
        else:
            self.pending_by.setdefault(self.shard, []).append(host)

    def pending_count(self):
        return len(self.pending) + sum(len(v) for v in self.pending_by.values())

    def seal(self):
        self.outbox.extend(self.pending)
        self.pending = []
        for s in sorted(self.pending_by):     # deterministic shard order
            self.outbox.extend(self.pending_by[s])
        self.pending_by = {}

    def deliver(self):
        while self.outbox:
            _faults.fire("sink.consume", pending=len(self.outbox))
            self.real.consume(self.outbox[0])
            self.outbox.pop(0)

    def discard(self, shard=None):
        if shard is None:
            self.pending = []                 # the outbox survives: committed
            self.pending_by = {}
        else:
            self.pending_by.pop(shard, None)


def _graph_snapshot(graph):
    """Host copies of every pipe's chain states and cold tiers (settled
    first), Ordering_Node state, and the exhausted set."""
    chains, orders, tiers = [], [], []
    for mp in graph._all_pipes():
        if mp._chain is not None:
            mp._chain.tier_settle()
        chains.append(None if mp._chain is None else
                      [host_tree(st) for st in mp._chain.states])
        tiers.append(None if mp._chain is None else mp._chain.tier_snapshot())
        o = mp._ordering
        if o is not None:
            o.settle()        # the trim owed by the last push, before copying
        orders.append(None if o is None else {
            "pending": host_tree(o._pending),
            "chan": host_copy(o._pending_chan),
            "wm": host_copy(o._wm_dev),
            "next_id": host_copy(o._next_id)})
    return {"chains": chains, "orders": orders, "tiers": tiers,
            "exhausted": set(graph._exhausted)}


def _graph_restore(graph, snap):
    dev = graph.device
    for mp, ch, od, tr in zip(graph._all_pipes(), snap["chains"], snap["orders"],
                              snap["tiers"]):
        if mp._chain is not None:
            if ch is None:
                mp._chain.reset_states()      # a chain born after the checkpoint
            else:
                mp._chain.states = [device_tree(st, dev) for st in ch]
            mp._chain.tier_restore(tr)
        if od is None:
            mp._ordering = None               # recreated lazily, fresh
        else:
            o = mp._ordering or graph._ordering_of(mp)
            o._pending = device_tree(od["pending"], dev)
            o._pending_chan = _device_copy(od["chan"], dev)
            o._wm_dev = _device_copy(od["wm"], dev)
            o._next_id = _device_copy(od["next_id"], dev)
            # a snapshot of another writer may hold the pool unsorted; merge
            # and release need the sorted invariant (it also drops the counts
            # still owed, which sized a pool the restore replaced)
            o.resort_pending()
    graph._exhausted = set(snap["exhausted"])


def run_graph_supervised(graph, *, checkpoint_every: int = 8, max_restarts: int = 3,
                         backoff_base: float = 0.05, backoff_cap: float = 2.0,
                         dead_letter=None, poison_threshold: int = 3,
                         step_timeout: Optional[float] = None, faults=None,
                         control=None, dispatch=None, shards=None, reshard=None,
                         shard_key=None, shard_range=None):
    """Supervised push-driver execution of a whole PipeGraph DAG: aligned
    checkpoints over every pipe's state (chains, Ordering_Nodes, the
    exhausted set), replayable sources re-opened at the committed positions,
    and exactly-once delivery on every sink. The DAG analogue of
    :class:`SupervisedPipeline`, with the same backoff, quarantine and
    watchdog. ``dispatch=`` (explicit wins over the graph's own) fuses K
    root batches a device program with count-based group boundaries only.
    ``shards=`` (or ``WF_SHARDS``) above 1 runs the sharded driver
    (:class:`_ShardedGraphRun`), with an explicit ``reshard=`` plan and
    ``shard_key=``. ``control=`` (explicit wins over the graph's own) runs
    the deterministic admission: one shared positional bucket over every
    source, commits at round boundaries while it is on."""
    if shard_range is not None:
        raise ValueError(
            "shard_range= (the multi-host slice) is not yet supported on the "
            "supervised graph driver — it would be silently ignored and every host "
            "would supervise ALL shards (duplicated outputs); run one "
            "SupervisedPipeline per slice, or drop shard_range")
    injector = _faults.resolve(faults)
    with _faults.activate(injector):
        n_shards = resolve_shards(shards)
        if n_shards > 1:
            return _ShardedGraphRun(
                graph, shards=n_shards, reshard=reshard, shard_key=shard_key,
                checkpoint_every=checkpoint_every, max_restarts=max_restarts,
                backoff_base=backoff_base, backoff_cap=backoff_cap,
                dead_letter=dead_letter, poison_threshold=poison_threshold,
                step_timeout=step_timeout, control=control, dispatch=dispatch).run()
        return _run_graph_supervised(
            graph, checkpoint_every=checkpoint_every, max_restarts=max_restarts,
            backoff_base=backoff_base, backoff_cap=backoff_cap,
            dead_letter=dead_letter, poison_threshold=poison_threshold,
            step_timeout=step_timeout, control=control, dispatch=dispatch)


def _graph_control(graph, control):
    """The supervised graph run's control config: an explicit ``control=``
    wins over the graph's own (its constructor or ``WF_CONTROL``)."""
    if control is not None:
        from ..control import ControlConfig
        return ControlConfig.resolve(control)
    return graph._control


def _graph_trace_check(graph) -> None:
    """Refuse sequence trace ids before ``graph.start()`` activates the
    tracer and the reporter (whose finish is armed only after it)."""
    from ..observability import TraceConfig
    _check_supervised_trace(graph._tracer.config if graph._tracer is not None
                           else TraceConfig.resolve(graph._trace_arg))


def _run_graph_supervised(graph, *, checkpoint_every, max_restarts, backoff_base,
                          backoff_cap, dead_letter, poison_threshold, step_timeout,
                          control=None, dispatch=None):
    _graph_trace_check(graph)
    if not graph._started:
        graph.start()
    # ONE shared positional bucket over every source: its shed pattern is a
    # pure function of the round-robin offer order, replay-stable with the
    # state snapshotted at each commit
    adm = _supervised_admission(_graph_control(graph, control), graph.batch_size,
                                "supervised-graph")
    # scan dispatch (explicit dispatch= wins over the graph's own): batches
    # buffer in arrival order across all roots and flush together the moment
    # any root holds K; delivery keeps the round-robin interleave. Boundaries
    # are count-based, a pure function of the offer order, so a replay after
    # a restore re-forms the same groups.
    dcfg = (_dispatch.DispatchConfig.resolve(dispatch) if dispatch is not None
            else graph._dispatch)
    dk = dcfg.k if dcfg is not None and dcfg.k > 1 else 0
    mon_cfg = graph._monitor.config if graph._monitor is not None else None
    # trace stream coordinates: the root index (the push driver's)
    root_idx = {id(mp): i for i, mp in enumerate(graph._roots)}
    buf = []                         # (mp, batch, pos, e2e t0) in arrival order
    buf_n = {}                       # root id -> batches buffered
    degrade = {}                     # root id -> per-batch replay bound after a
    #                                  fused run failed
    pipes = graph._all_pipes()
    originals = {}
    for mp in pipes:
        if mp.sink is not None:
            originals[id(mp)] = mp.sink
            mp.sink = _CommitBufferSink(mp.sink)
    shims = [mp.sink for mp in pipes if id(mp) in originals]

    committed_pos = {id(mp): 0 for mp in graph._roots}
    committed_cursor = {id(mp): None for mp in graph._roots}
    snap = _graph_snapshot(graph)
    snap_adm = adm.state() if adm is not None else None
    budget = max_restarts
    graph.supervised_restarts = 0
    rng = random.Random()                     # wf-lint: allow[wall-clock] backoff jitter
    prev_sleep = backoff_base
    poison_threshold = max(1, int(poison_threshold))
    fail_key = None                           # (pipe id, position) streak
    fail_streak = 0
    quarantine_key = None
    quarantine_err = None
    cur_key = None                            # batch being processed right now

    def commit(pos):
        nonlocal snap, snap_adm, committed_pos, committed_cursor, budget
        # partial groups dispatch short first, so the snapshot reflects every
        # position already read
        flush_accs()
        with _journal.span("checkpoint", graph=graph.name,
                           batches_committed=sum(pos.values()),
                           outputs_pending=sum(len(sh.pending) for sh in shims)):
            # fallible first: snapshot and cursors; the previous commit stays
            # intact if either fails
            new_snap = _graph_snapshot(graph)   # host copies: faults surface here
            new_cursor = {id(mp): mp.source.cursor() for mp in graph._roots}
            new_adm = adm.state() if adm is not None else None
            # the commit point: pure assignments
            snap = new_snap
            snap_adm = new_adm
            committed_pos = dict(pos)
            committed_cursor = new_cursor
            budget = max_restarts             # progress refills the budget
            for sh in shims:
                sh.seal()
            for sh in shims:
                sh.deliver()                  # resumable committed delivery

    def flush_accs():
        # compute per root (a failed run flags its root for per-batch replay
        # through its range), then deliver in the original arrival order
        nonlocal cur_key
        if not buf:
            return
        outs = {}
        for mp2 in graph._roots:
            entries = [(b, p) for m, b, p, _ in buf if m is mp2]
            if not entries:
                continue
            run = [b for b, _ in entries]
            p0 = entries[0][1]
            cur_key = (id(mp2), p0)
            try:
                outs[id(mp2)] = iter(_faults.call_with_timeout(
                    lambda mp2=mp2, run=run: graph._compute_many(mp2, run, dk),
                    step_timeout, stage="graph.step",
                    pre=lambda p0=p0: _faults.fire("chain.step", pos=p0)))
            except BaseException:
                if len(run) > 1:
                    degrade[id(mp2)] = entries[-1][1]
                raise
        for m, b, p, t0 in buf:
            cur_key = (id(m), p)      # delivery failure attribution
            graph._e2e_t0 = t0
            out = next(outs[id(m)])
            # delivery (downstream pushes, ordering, sink consume) stays under
            # the step watchdog, like the per-batch path's whole-push wrapper
            _faults.call_with_timeout(lambda m=m, out=out: graph._deliver(m, out),
                                      step_timeout, stage="graph.step")
            graph._e2e_t0 = None
        buf.clear()
        buf_n.clear()
        cur_key = None

    def ingest(mp, batch, p, sampled):
        hi = degrade.get(id(mp))
        if hi is not None and p > hi:
            degrade.pop(id(mp))       # past the failed run: resume fusing
        t0 = time.perf_counter() if sampled else None   # wf-lint: allow[wall-clock] e2e telemetry
        # degrade is global while any root is inside a failed run's range:
        # per-batch ingest keeps the round-robin arrival order for every root
        if not dk or degrade:
            graph._e2e_t0 = t0
            _faults.call_with_timeout(
                lambda: graph._push(mp, batch), step_timeout, stage="graph.step",
                pre=lambda: _faults.fire("chain.step", pos=p))
            graph._e2e_t0 = None
            return
        buf.append((mp, batch, p, t0))
        buf_n[id(mp)] = buf_n.get(id(mp), 0) + 1
        if buf_n[id(mp)] >= dk:
            flush_accs()

    try:
        while True:
            try:
                cur_key = None
                pos = dict(committed_pos)
                iters = {}
                for mp in graph._roots:
                    iters[id(mp)] = _reopen_source(mp.source, graph.batch_size,
                                                   pos[id(mp)], committed_cursor[id(mp)])
                for sh in shims:
                    sh.deliver()              # finish any interrupted delivery
                live = [mp for mp in graph._roots if id(mp) not in graph._exhausted]
                since = 0
                n_pushed = 0
                while live:
                    for mp in list(live):
                        key = (id(mp), pos[id(mp)])
                        if quarantine_key is not None and key == quarantine_key:
                            eos = _quarantine_skip(
                                iters[id(mp)], pos[id(mp)], quarantine_err,
                                dead_letter, "graph", graph=graph.name)
                            quarantine_key = quarantine_err = None
                            fail_key, fail_streak = None, 0
                            if eos:
                                live.remove(mp)
                                flush_accs()
                                graph._exhaust(mp)
                                continue
                            pos[id(mp)] += 1
                            since += 1
                            # with admission on, commits wait for the round
                            # boundary (a replay restarts the round at source
                            # 0: a snapshot mid-round would resume the shared
                            # bucket against a rotated offer order)
                            if since >= checkpoint_every and adm is None:
                                cur_key = None
                                commit(pos)
                                since = 0
                            continue
                        cur_key = key
                        _faults.fire("source.next", pos=pos[id(mp)])
                        try:
                            batch = next(iters[id(mp)])
                        except StopIteration:
                            live.remove(mp)
                            cur_key = None
                            # buffered batches (every root's) land before
                            # this root's chain flushes downstream
                            flush_accs()
                            graph._exhaust(mp)
                            continue
                        # position-derived ids: a replay re-mints them
                        _tracing.ingest(batch, pos[id(mp)], stream=root_idx[id(mp)])
                        if adm is not None and not adm.offer(
                                batch, pos=pos[id(mp)], stream=root_idx[id(mp)]):
                            # shed (a replay re-sheds it); no commit mid-round
                            pos[id(mp)] += 1
                            since += 1
                            cur_key = None
                            continue
                        ingest(mp, batch, pos[id(mp)],
                               mon_cfg is not None and mon_cfg.should_sample_e2e(n_pushed))
                        n_pushed += 1
                        pos[id(mp)] += 1
                        since += 1
                        cur_key = None
                    if since >= checkpoint_every:
                        commit(pos)
                        since = 0
                # EOS: ordering drain + topological flush (wait_end's order)
                cur_key = None
                for mp in graph._topo_order():
                    if mp._ordering is not None:
                        for piece in graph._chunks(mp._ordering.flush(),
                                                   mp._ordering.last_release_count):
                            graph._push(mp, piece)
                    graph._flush_pipe(mp)
                commit(pos)
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:        # noqa: BLE001 — the detection point
                armed_now = False
                if dead_letter is not None and cur_key is not None:
                    if cur_key == fail_key:
                        fail_streak += 1
                    else:
                        fail_key, fail_streak = cur_key, 1
                    if fail_streak >= poison_threshold and quarantine_key is None:
                        quarantine_key, quarantine_err = cur_key, e
                        armed_now = True
                if not armed_now:
                    if budget <= 0:
                        _journal.record("restart_exhausted", graph=graph.name,
                                        error=type(e).__name__)
                        raise RestartExhausted(
                            f"graph step failed {max_restarts + 1}x within one "
                            f"checkpoint interval") from e
                    budget -= 1
                graph.supervised_restarts += 1
                _faults.bump("restarts")
                _faults.join_abandoned_worker(e, step_timeout)
                _abort_attempt()
                # a sampled push that raised leaves its e2e stamp armed
                graph._e2e_t0 = None
                with _restore_span(graph=graph.name, attempt=graph.supervised_restarts,
                                   error=type(e).__name__):
                    _graph_restore(graph, snap)
                    if adm is not None:
                        adm.set_state(snap_adm)
                buf.clear()           # replay re-feeds the dropped batches
                buf_n.clear()
                for sh in shims:
                    sh.discard()
                prev_sleep = _faults.backoff_sleep(
                    rng, prev_sleep, backoff_base, backoff_cap,
                    attempt=graph.supervised_restarts)
        for mp in pipes:
            if id(mp) in originals:
                originals[id(mp)].consume(None)
        for mp in pipes:
            if mp._chain is not None:
                mp._chain.sync_stats()
        for op in graph._operators:
            op.close()
        graph._ended = True
        return graph._results()
    finally:
        for mp in pipes:
            if id(mp) in originals:
                mp.sink = originals[id(mp)]
        if graph._tracer is not None:
            graph._tracer.finish()
        if graph._monitor is not None:
            graph._monitor.finish(graph)


# -------------------------------------------------- the sharded graph driver

def _graph_capture(graph) -> dict:
    """References to the whole graph's mutable state (chain states,
    Ordering_Nodes, the exhausted set): the unit the sharded graph driver
    swaps, N shards sharing one graph object, each with its own state set.
    Nothing is copied (an Ordering_Node settles first, so a trim owed by one
    shard's push never lands on another shard's pool)."""
    chains, orders = [], []
    for mp in graph._all_pipes():
        chains.append(None if mp._chain is None else list(mp._chain.states))
        o = mp._ordering
        if o is not None:
            o.settle()
        orders.append(None if o is None else
                      (o._pending, o._pending_chan, o._wm_dev, o._next_id,
                       o._last_release_count))
    return {"chains": chains, "orders": orders, "exhausted": set(graph._exhausted)}


def _graph_install(graph, st: dict) -> None:
    for mp, ch, od in zip(graph._all_pipes(), st["chains"], st["orders"]):
        if mp._chain is not None:
            if ch is None:
                mp._chain.reset_states()  # a chain born after this capture
            else:
                mp._chain.states = list(ch)
        if od is None:
            mp._ordering = None           # recreated lazily, fresh
        else:
            o = mp._ordering
            if o is None:
                o = graph._ordering_of(mp)
            else:
                o.settle()                # the outgoing shard's trim
            (o._pending, o._pending_chan, o._wm_dev, o._next_id,
             o._last_release_count) = od
    graph._exhausted = set(st["exhausted"])


def _graph_blank(graph) -> dict:
    """A freshly initialized graph state set (a shard born mid-run)."""
    for mp in graph._all_pipes():
        if mp._chain is not None:
            mp._chain.reset_states()
        mp._ordering = None
    graph._exhausted = set()
    return _graph_capture(graph)


class _GraphShard(_ShardRecoveryBase):
    """The graph driver's shard unit: one key range over the whole DAG, with
    its own budget and backoff, quarantine keyed by (root pipe, position), a
    replay buffer of its sub-batches and root EOS events since its last
    commit, and its own pending bucket in every sink shim. A failure in its
    pushes restores and replays only this shard."""

    def __init__(self, idx: int, co, state: dict):
        self._init_recovery(idx, co)
        self.state = state                  # references (a capture)
        self.snap = None                    # host snapshot (set at the first commit)
        self.snap_tag = 0                   # committed batches at the last commit
        self.replay = []                    # ("batch", mp, pos, sub) | ("eos", mp)

    def offer_batch(self, mp, pos: int, sub) -> None:
        self.replay.append(("batch", mp, pos, sub))
        self._drive(len(self.replay) - 1)

    def offer_eos(self, mp) -> None:
        self.replay.append(("eos", mp))
        self._drive(len(self.replay) - 1)

    def _drive(self, start: int) -> None:
        g = self.co.graph
        _graph_install(g, self.state)
        self.co.select_shard(self.idx)
        i = start
        while i < len(self.replay):
            entry = self.replay[i]
            key = None
            try:
                if entry[0] == "eos":
                    g._exhaust(entry[1])
                    i += 1
                    continue
                _, mp, pos, sub = entry
                if sub is None:             # a quarantined slot
                    i += 1
                    continue
                key = (id(mp), pos)
                if self._quarantine_key == key:
                    self._quarantine_hit(pos, sub, f"sharded-graph:shard{self.idx}",
                                         graph=g.name)
                    self.replay[i] = ("batch", mp, pos, None)
                    i += 1
                    continue
                _faults.fire("shard.kill", shard=self.idx, pos=pos)
                _faults.call_with_timeout(lambda mp=mp, sub=sub: g._push(mp, sub),
                                          self.co.step_timeout,
                                          stage=f"shard{self.idx}.step")
                i += 1
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:      # noqa: BLE001 — the detection point
                self._on_failure(e, key)
                self.co.select_shard(self.idx)
                i = 0
        self.state = _graph_capture(g)
        self._finish_recovery_timing()

    def _restore_for_replay(self) -> None:
        _graph_restore(self.co.graph, self.snap)
        # the capture follows the restored state: a replay entered from
        # drain_supervised installs self.state first, and a stale capture
        # there would apply every buffered batch twice
        self.state = _graph_capture(self.co.graph)
        for sh in self.co.shims:
            sh.discard(shard=self.idx)

    def _count_restart(self) -> None:
        self.co.graph.supervised_restarts += 1

    def _replay_from(self):
        return self.snap_tag

    def _committed_tag(self):
        return self.snap_tag

    def _exhausted_message(self, key) -> str:
        return (f"graph shard {self.idx} failed {self.co.max_restarts + 1}x within one "
                f"checkpoint interval")

    def _journal_fields(self, key) -> dict:
        return {"graph": self.co.graph.name}

    def drain_supervised(self) -> None:
        """The final EOS drain (ordering flush, then every pipe's flush in
        topological order) under the shard-local recovery loop."""
        g = self.co.graph

        def drain_once():
            for mp in g._topo_order():
                if mp._ordering is not None:
                    for piece in g._chunks(mp._ordering.flush(),
                                           mp._ordering.last_release_count):
                        g._push(mp, piece)
                g._flush_pipe(mp)
        while True:
            _graph_install(g, self.state)
            self.co.select_shard(self.idx)
            try:
                _faults.call_with_timeout(drain_once, self.co.step_timeout,
                                          stage=f"shard{self.idx}.drain")
                self.state = _graph_capture(g)
                return
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:      # noqa: BLE001 — the detection point
                self._on_failure(e, None)
                self._drive(0)

    def commit(self, tag: int, snap) -> None:
        self.snap = snap
        self.snap_tag = tag
        n_interval = sum(int(e[3].count()) for e in self.replay
                         if e[0] == "batch" and e[3] is not None)
        self.occupancy_tuples += n_interval
        self.interval_tuples = n_interval
        self.replay.clear()
        self.budget = self.co.max_restarts


class _ShardedGraphRun:
    """The coordinator of the sharded graph driver (``run_graph_supervised``
    with ``shards`` > 1): the sources, cursors, commit barrier and re-sharding
    plan are global; every key range's failure domain is a
    :class:`_GraphShard`."""

    def __init__(self, graph, *, shards, reshard, checkpoint_every, max_restarts,
                 backoff_base, backoff_cap, dead_letter, poison_threshold, step_timeout,
                 dispatch, control=None, shard_key=None):
        self._shard_key = shard_key
        self._control = control
        self.graph = graph
        dcfg = _dispatch.DispatchConfig.resolve(dispatch if dispatch is not None
                                                else graph._dispatch_arg)
        if dcfg is not None and dcfg.k > 1:
            raise ValueError(
                "shards > 1 does not compose with scan dispatch (K > 1) on the "
                "supervised graph driver — drop dispatch= (WF115)")
        if any(getattr(op, "_tier_cfg", None) is not None for op in graph._operators):
            raise ValueError(
                "shard-local supervision (shards > 1) does not yet compose with tiered "
                "keyed state (shared per-op HostStore) — run tiered tables with shards=1")
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.dead_letter = dead_letter
        self.poison_threshold = max(1, int(poison_threshold))
        self.step_timeout = step_timeout
        self.assignment = ShardAssignment(int(shards))
        plan = ReshardPlan.resolve(reshard)
        if plan == "auto":
            raise ValueError("reshard='auto' is a pipeline-driver feature (the graph "
                             "driver takes an explicit ReshardPlan)")
        self.pending_plan = plan
        self._reshard_due = False
        self.reshard_count = 0
        self.shards = []
        self.shims = []

    def select_shard(self, idx) -> None:
        for sh in self.shims:
            sh.shard = idx

    def mute_shims(self, on: bool) -> None:
        for sh in self.shims:
            sh.mute = on

    def _splitter(self, assignment=None):
        return make_splitter(assignment or self.assignment, self._shard_key)

    def run(self):
        graph = self.graph
        _graph_trace_check(graph)
        if not graph._started:
            graph.start()
        if graph._monitor is not None:
            # the shard rows ride the graph's monitoring snapshots
            graph._monitor.registry.attach_shards(self.shard_report)
        adm = _supervised_admission(_graph_control(graph, self._control),
                                    graph.batch_size, "sharded-graph")
        root_idx = {id(mp): i for i, mp in enumerate(graph._roots)}
        pipes = graph._all_pipes()
        originals = {}
        for mp in pipes:
            if mp.sink is not None:
                originals[id(mp)] = mp.sink
                mp.sink = _CommitBufferSink(mp.sink)
        self.shims = [mp.sink for mp in pipes if id(mp) in originals]
        # shard 0 adopts the graph's fresh state, the others get blank sets
        base_state = _graph_capture(graph)
        self.shards = [_GraphShard(0, self, base_state)]
        for k in range(1, self.assignment.num_shards):
            self.shards.append(_GraphShard(k, self, _graph_blank(graph)))
        for s in self.shards:
            _graph_install(graph, s.state)
            s.snap = _graph_snapshot(graph)
        committed_pos = {id(mp): 0 for mp in graph._roots}
        committed_cursor = {id(mp): None for mp in graph._roots}
        snap_adm = adm.state() if adm is not None else None
        gbudget = self.max_restarts
        graph.supervised_restarts = 0
        rng = random.Random()               # wf-lint: allow[wall-clock] backoff jitter
        prev_sleep = self.backoff_base
        split = None

        def commit(pos):
            nonlocal committed_pos, committed_cursor, snap_adm, gbudget
            with _journal.span("checkpoint", graph=graph.name, shards=len(self.shards),
                               batches_committed=sum(pos.values()),
                               outputs_pending=sum(sh.pending_count() for sh in self.shims)):
                new_snaps = []
                for s in self.shards:
                    _graph_install(graph, s.state)
                    new_snaps.append(_graph_snapshot(graph))
                new_cursor = {id(mp): mp.source.cursor() for mp in graph._roots}
                new_adm = adm.state() if adm is not None else None
                # the commit point: pure assignments
                tag = sum(pos.values())
                for s, sn in zip(self.shards, new_snaps):
                    s.commit(tag, sn)
                committed_pos = dict(pos)
                committed_cursor = new_cursor
                snap_adm = new_adm
                gbudget = self.max_restarts
                for sh in self.shims:
                    sh.seal()
                for sh in self.shims:
                    sh.deliver()

        def barrier(pos):
            nonlocal split
            if (self.pending_plan is not None
                    and sum(pos.values()) >= self.pending_plan.at_pos):
                self._reshard_due = True
            if self._reshard_due:
                self._apply_reshard(self.pending_plan, committed_pos, commit, adm)
                self._reshard_due = False
                self.pending_plan = None
                split = self._splitter()

        try:
            while True:
                try:
                    if self._reshard_due:
                        self._apply_reshard(self.pending_plan, committed_pos, commit, adm)
                        self._reshard_due = False
                        self.pending_plan = None
                        split = None
                    if split is None:
                        split = self._splitter()
                    pos = dict(committed_pos)
                    iters = {id(mp): _reopen_source(mp.source, graph.batch_size,
                                                    pos[id(mp)], committed_cursor[id(mp)])
                             for mp in graph._roots}
                    for sh in self.shims:
                        sh.deliver()        # finish an interrupted delivery
                    # exhausted roots are global (a source's EOS at a position):
                    # the union of the shards' snapshots
                    done_roots = set()
                    for s in self.shards:
                        done_roots |= {pid for pid in s.snap["exhausted"]
                                       if pid in committed_pos}
                    live = [mp for mp in graph._roots if id(mp) not in done_roots]
                    since = 0
                    while live:
                        for mp in list(live):
                            _faults.fire("source.next", pos=pos[id(mp)])
                            try:
                                batch = next(iters[id(mp)])
                            except StopIteration:
                                live.remove(mp)
                                for s in self.shards:
                                    s.offer_eos(mp)
                                continue
                            _tracing.ingest(batch, pos[id(mp)], stream=root_idx[id(mp)])
                            if adm is not None and not adm.offer(
                                    batch, pos=pos[id(mp)], stream=root_idx[id(mp)]):
                                # shed (deterministic; commits stay on round
                                # boundaries)
                                pos[id(mp)] += 1
                                since += 1
                                continue
                            subs = split(batch)
                            for s, sub in zip(self.shards, subs):
                                _tracing.carry(batch, sub)
                                s.offer_batch(mp, pos[id(mp)], sub)
                            pos[id(mp)] += 1
                            since += 1
                        if since >= self.checkpoint_every:
                            commit(pos)
                            barrier(pos)
                            since = 0
                    for s in self.shards:
                        s.drain_supervised()
                    commit(pos)
                    if self.pending_plan is not None or self._reshard_due:
                        _journal.record("reshard", aborted=True, graph=graph.name,
                                        error="stream ended before the plan's at_pos "
                                              "barrier")
                    break
                except (KeyboardInterrupt, SystemExit):
                    raise
                except RestartExhausted:
                    raise
                except BaseException as e:  # noqa: BLE001 — the global detection point
                    if gbudget <= 0:
                        _journal.record("restart_exhausted", graph=graph.name,
                                        error=type(e).__name__)
                        raise RestartExhausted(
                            f"sharded graph run failed {self.max_restarts + 1}x within "
                            f"one checkpoint interval") from e
                    gbudget -= 1
                    graph.supervised_restarts += 1
                    _faults.bump("restarts")
                    _faults.join_abandoned_worker(e, self.step_timeout)
                    _abort_attempt()
                    with _restore_span(graph=graph.name, shards=len(self.shards),
                                       attempt=graph.supervised_restarts,
                                       error=type(e).__name__):
                        for s in self.shards:
                            _graph_restore(graph, s.snap)
                            s.state = _graph_capture(graph)
                            s.replay.clear()
                        for sh in self.shims:
                            sh.discard()
                        if adm is not None:
                            adm.set_state(snap_adm)
                    prev_sleep = _faults.backoff_sleep(
                        rng, prev_sleep, self.backoff_base, self.backoff_cap,
                        attempt=graph.supervised_restarts)
            for mp in pipes:
                if id(mp) in originals:
                    originals[id(mp)].consume(None)
            for mp in pipes:
                if mp._chain is not None:
                    mp._chain.sync_stats()
            for op in graph._operators:
                op.close()
            graph._ended = True
            graph._shard_report = self.shard_report()
            return self._merged_results()
        finally:
            for mp in pipes:
                if id(mp) in originals:
                    mp.sink = originals[id(mp)]
            if graph._tracer is not None:
                graph._tracer.finish()
            if graph._monitor is not None:
                graph._monitor.finish(graph)

    # -- live re-sharding -------------------------------------------------------------

    def _apply_reshard(self, plan, committed_pos, commit, adm=None) -> None:
        graph = self.graph
        old = self.assignment
        try:
            new = plan.apply_to(old)
        except ValueError as e:
            _journal.record("reshard", aborted=True, graph=graph.name, error=str(e))
            return
        if new == old:
            return
        tag = sum(committed_pos.values())
        with _journal.span("reshard", graph=graph.name, from_shards=old.num_shards,
                           to_shards=new.num_shards, moves=len(new.moves), at_pos=tag):
            # phase 1, drain: the committed snapshots are the seals here (the
            # graph driver checkpoints in memory); the site is walked a shard
            for s in self.shards:
                _faults.fire("reshard.handoff", shard=s.idx, at_pos=tag)
            # phase 2, re-admit
            affected = affected_shards(old, new)
            keep = {}
            if new.num_shards == old.num_shards:
                keep = {s.idx: s for s in self.shards if s.idx not in affected}
            rebuilt = [i for i in range(new.num_shards) if i not in keep]
            fresh = {i: _graph_blank(graph) for i in rebuilt}
            if rebuilt and tag > 0:
                fresh = self._replay_prefix(new, rebuilt, fresh, committed_pos, adm)
            prior = {s.idx: s for s in self.shards}
            units = []
            for i in range(new.num_shards):
                if i in keep:
                    units.append(keep[i])
                    continue
                u = _GraphShard(i, self, fresh[i])
                _graph_install(graph, u.state)
                u.snap = _graph_snapshot(graph)
                u.snap_tag = tag
                u.reshard_moves = prior[i].reshard_moves + 1 if i in prior else 1
                if i in prior:
                    u.occupancy_tuples = prior[i].occupancy_tuples
                    u.restarts = prior[i].restarts
                    u.dead_letters = prior[i].dead_letters
                units.append(u)
            self.shards = units
            self.assignment = new
            self.reshard_count += 1
            commit(dict(committed_pos))

    def _replay_prefix(self, new, rebuilt, fresh, committed_pos, adm=None):
        """Re-admission: the committed prefix of every root, in the original
        round-robin interleave (a fresh positional bucket re-deriving the
        shed pattern), through the new ownership into the rebuilt shards'
        states, sinks muted (the old layout committed those outputs)."""
        graph = self.graph
        split = self._splitter(new)
        radm = _supervised_admission(_graph_control(graph, self._control),
                                     graph.batch_size, "sharded-readmit")
        iters = {id(mp): mp.source.batches(graph.batch_size) for mp in graph._roots}
        rpos = {id(mp): 0 for mp in graph._roots}
        exhausted_at_commit = set()
        for s in self.shards:
            exhausted_at_commit |= {pid for pid in s.snap["exhausted"]
                                    if pid in committed_pos}
        self.mute_shims(True)
        try:
            live = [mp for mp in graph._roots
                    if committed_pos[id(mp)] > 0 or id(mp) in exhausted_at_commit]
            while live:
                for mp in list(live):
                    if rpos[id(mp)] >= committed_pos[id(mp)]:
                        if id(mp) in exhausted_at_commit:
                            for i in rebuilt:
                                _graph_install(graph, fresh[i])
                                graph._exhaust(mp)
                                fresh[i] = _graph_capture(graph)
                        live.remove(mp)
                        continue
                    try:
                        batch = next(iters[id(mp)])
                    except StopIteration:
                        live.remove(mp)
                        continue
                    p = rpos[id(mp)]
                    rpos[id(mp)] += 1
                    if radm is not None and not radm.offer(batch, pos=p):
                        continue
                    subs = split(batch)
                    for i in rebuilt:
                        _graph_install(graph, fresh[i])
                        try:
                            graph._push(mp, subs[i])
                            fresh[i] = _graph_capture(graph)
                        except (KeyboardInterrupt, SystemExit):
                            raise
                        except BaseException as e:  # noqa: BLE001 — poison under the
                            # new mask: quarantine here; fresh[i] keeps the capture
                            # from before the push, so the next install discards
                            # what the failed push left
                            _journal.record("dead_letter", at_batch=p, shard=i,
                                            during_reshard=True, graph=graph.name,
                                            error=type(e).__name__)
                            _faults.bump("dead_letters")
                            if self.dead_letter is not None:
                                self.dead_letter.put(subs[i], pos=p, error=e,
                                                     driver=f"sharded-readmit:shard{i}")
        finally:
            self.mute_shims(False)
        return fresh

    def _merged_results(self):
        """Every ReduceSink's shard partials combined with its own
        ``combine``."""
        pipes = self.graph._all_pipes()
        res = {}
        for j, mp in enumerate(pipes):
            if mp._chain is None:
                continue
            for i, op in enumerate(mp._chain.ops):
                if isinstance(op, ReduceSink):
                    acc = None
                    for s in self.shards:
                        st = s.state["chains"][j]
                        if st is None:      # the shard never pushed this pipe
                            continue
                        v = op.result(st[i])
                        acc = v if acc is None else tree_map(op.combine, acc, v)
                    if acc is not None:
                        res[op.name] = acc
        return res

    def shard_report(self) -> dict:
        return {s.idx: s.report() for s in self.shards}


__all__ = ["RestartExhausted", "SupervisedPipeline", "ShardSupervisor", "ShardedSupervisor",
           "run_graph_supervised"]

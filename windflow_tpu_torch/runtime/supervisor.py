"""Failure detection + recovery: supervised execution, unsharded.

Counterpart of the unsharded half of ``windflow_tpu/runtime/supervisor.py``.
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

Not ported, and refused by name: sharded supervision (``shards`` > 1 or
``WF_SHARDS`` > 1, ``reshard=``, ``shard_key=``, ``shard_range=``: ROADMAP
Queue 1 item 14), admission control and remediation (``control=``,
``WF_CONTROL``, ``remediation=``, ``WF_REMEDIATION``: item 15), tracing
(``trace=``) and monitoring-driven event time (item 16). Tiered keyed state
(``state/tiered.py``) is supervised as in the JAX package: a snapshot settles
the tiered operators first and keeps their cold tiers' manifests beside the
states; a restore rewinds the stores and discards the copies in flight
(replay re-derives the spills). The JAX
loop's tracing and device-health calls (span carry, ingest, abort, the
health ledger's pending note) belong to item 16 and are left out.
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
from ..device import resolve_device
from ..observability import journal as _journal
from ..operators.base import Basic_Operator
from ..operators.sink import Sink
from ..operators.source import SourceBase
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
    t0 = time.perf_counter()
    with _journal.span("restore", **fields):
        yield
    _faults.bump("recovery_seconds", round(time.perf_counter() - t0, 6))


# ------------------------------------------------------- refused by name

def _refuse(what: str, item: int) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def _env_on(var: str) -> bool:
    return os.environ.get(var, "").strip() not in ("", "0")


def _refuse_unported(*, shards=None, reshard=None, shard_key=None, shard_range=None,
                     control=None, remediation=None, trace=None) -> None:
    """Raise for every supervision feature the port does not have yet,
    naming its ROADMAP item, instead of running without it."""
    n = shards
    if n is None:
        raw = os.environ.get("WF_SHARDS", "").strip()
        n = int(raw) if raw else 1
    if int(n) < 0:
        raise ValueError(f"shards= must be >= 0, got {n}")
    if int(n) > 1:
        _refuse(f"shard-local supervision (shards={n})", 14)
    for arg, what in ((reshard, "reshard="), (shard_key, "shard_key="),
                      (shard_range, "shard_range=")):
        if arg is not None:
            _refuse(f"supervised {what} (sharded recovery)", 14)
    if control is not None or _env_on("WF_CONTROL"):
        _refuse("supervised control= / WF_CONTROL (admission control)", 15)
    if remediation is not None or _env_on("WF_REMEDIATION"):
        _refuse("supervised remediation= / WF_REMEDIATION", 15)
    if trace is not None:
        _refuse("supervised trace= (causal tracing)", 16)
    if _env_on("WF_MONITORING") and _env_on("WF_MONITORING_EVENT_TIME"):
        _refuse("monitoring-driven event time (WF_MONITORING_EVENT_TIME)", 16)


# --------------------------------------------------------- host copies

def _host_copy(x):
    """A tensor copied to the host (synchronous on the card: the copy waits
    for the work that wrote it, so an asynchronous CUDA error surfaces
    here); any other leaf as is."""
    return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x


def _device_copy(x, device):
    return x.to(device, copy=True) if isinstance(x, torch.Tensor) else x


def host_tree(tree):
    """``tree`` (a state, a batch) with every tensor copied to the host."""
    return None if tree is None else rebuild(tree, [_host_copy(x) for x in leaves(tree)])


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
        _refuse_unported(shards=shards, reshard=reshard, shard_key=shard_key,
                         shard_range=shard_range, control=control,
                         remediation=remediation, trace=trace)
        self.device = resolve_device(device)
        if source.device != self.device:
            raise ValueError(f"source {source.getName()!r} lives on {source.device} "
                             f"but the supervised pipeline runs on {self.device}")
        self.source = source
        self.sink = sink
        self.batch_size = int(batch_size or resolve_batch_hint(ops) or DEFAULT_BATCH_SIZE)
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
        self.chain = CompiledChain(list(ops), source.payload_spec(),
                                   batch_capacity=source.out_capacity(self.batch_size),
                                   device=self.device)
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
            _dispatch.refuse_k_tuner(cfg)
            if cfg.prewarm and cfg.k > 1 and self.chain.ops:
                cap = self.source.out_capacity(self.batch_size)
                for kk in range(2, min(cfg.k, self.checkpoint_every) + 1):
                    self.chain.warm_scan(kk, cap)
        self._dispatch = cfg
        self._started = True

    def run(self):
        """Drive the stream to EOS under supervision; returns
        ``chain.result()``."""
        self.start()
        injector = _faults.resolve(self._faults_arg)
        with _faults.activate(injector):
            return self._run()

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
        pending = []                          # outputs since last commit
        outbox = []                           # committed, not yet delivered
        budget = self.max_restarts
        # backoff jitter is timing only: it never touches replayed data
        rng = random.Random()
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
            p0 = positions[0]
            # a singleton takes the per-batch push (wrappers around
            # chain.push see every batch when dispatch is off)
            step = (lambda: [self.chain.push(group[0])] if len(group) == 1
                    else self.chain.push_many(group))
            outs = _faults.call_with_timeout(
                step, self.step_timeout, stage="chain.step",
                pre=lambda: _faults.fire("chain.step", pos=p0))
            for out in outs:
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
            nonlocal snap, snap_pos, snap_cursor, budget
            flush_acc()
            with _journal.span("checkpoint", at_batch=pos,
                               outputs_committed=len(pending)):
                # fallible work first: a failure here leaves the previous
                # commit intact (replay regenerates `pending`)
                new_snap = self._snapshot()   # host copies: faults surface here
                new_cursor = self.source.cursor()
                if self.spill_path:
                    from .checkpoint import save_chain
                    save_chain(self.chain, self.spill_path,
                               meta={"batches_done": pos}, keep=self.checkpoint_keep)
                # -- the commit point: pure assignments, cannot fail --
                snap, snap_pos, snap_cursor = new_snap, pos, new_cursor
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
                with _restore_span(at_batch=pos, replay_from=snap_pos,
                                   attempt=self.restarts, error=type(e).__name__):
                    self._restore(snap)
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


# ------------------------------------------------------------ graph level

class _CommitBufferSink:
    """Output-commit shim over a pipe's Sink during supervised graph
    execution: outputs are copied to the host at once (an asynchronous device
    fault surfaces before anything reaches the user callback) but delivered
    only at checkpoint commit. Committed outputs move to an ``outbox`` that
    survives restore and drains resumably."""

    def __init__(self, real):
        self.real = real
        self.pending = []                     # uncommitted (discarded on restore)
        self.outbox = []                      # committed, not yet delivered

    def consume(self, batch):
        if batch is None:
            return                # EOS: delivered by the supervisor at the end
        self.pending.append(host_tree(batch))

    def seal(self):
        self.outbox.extend(self.pending)
        self.pending = []

    def deliver(self):
        while self.outbox:
            _faults.fire("sink.consume", pending=len(self.outbox))
            self.real.consume(self.outbox[0])
            self.outbox.pop(0)

    def discard(self):
        self.pending = []                     # the outbox survives: committed


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
            "chan": _host_copy(o._pending_chan),
            "wm": _host_copy(o._wm_dev),
            "next_id": _host_copy(o._next_id)})
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
            # counts still owed sized a pool the restore replaces: drop them
            o._counts_pending = None
            o._pending = device_tree(od["pending"], dev)
            o._pending_chan = _device_copy(od["chan"], dev)
            o._wm_dev = _device_copy(od["wm"], dev)
            o._next_id = _device_copy(od["next_id"], dev)
            # the snapshot was taken settled, from the node's own sorted pool:
            # the sorted invariant holds without the JAX package's re-sort
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
    root batches a device program with count-based group boundaries only."""
    _refuse_unported(shards=shards, reshard=reshard, shard_key=shard_key,
                     shard_range=shard_range, control=control)
    injector = _faults.resolve(faults)
    with _faults.activate(injector):
        return _run_graph_supervised(
            graph, checkpoint_every=checkpoint_every, max_restarts=max_restarts,
            backoff_base=backoff_base, backoff_cap=backoff_cap,
            dead_letter=dead_letter, poison_threshold=poison_threshold,
            step_timeout=step_timeout, dispatch=dispatch)


def _run_graph_supervised(graph, *, checkpoint_every, max_restarts, backoff_base,
                          backoff_cap, dead_letter, poison_threshold, step_timeout,
                          dispatch=None):
    if not graph._started:
        graph.start()
    # scan dispatch (explicit dispatch= wins over the graph's own): batches
    # buffer in arrival order across all roots and flush together the moment
    # any root holds K; delivery keeps the round-robin interleave. Boundaries
    # are count-based, a pure function of the offer order, so a replay after
    # a restore re-forms the same groups.
    dcfg = (_dispatch.DispatchConfig.resolve(dispatch) if dispatch is not None
            else graph._dispatch)
    if dcfg is not None:
        _dispatch.refuse_k_tuner(dcfg)
    dk = dcfg.k if dcfg is not None and dcfg.k > 1 else 0
    buf = []                         # (mp, batch, pos) in arrival order
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
    budget = max_restarts
    graph.supervised_restarts = 0
    rng = random.Random()                     # backoff jitter: timing only
    prev_sleep = backoff_base
    poison_threshold = max(1, int(poison_threshold))
    fail_key = None                           # (pipe id, position) streak
    fail_streak = 0
    quarantine_key = None
    quarantine_err = None
    cur_key = None                            # batch being processed right now

    def commit(pos):
        nonlocal snap, committed_pos, committed_cursor, budget
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
            # the commit point: pure assignments
            snap = new_snap
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
            entries = [(b, p) for m, b, p in buf if m is mp2]
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
        for m, b, p in buf:
            cur_key = (id(m), p)      # delivery failure attribution
            out = next(outs[id(m)])
            # delivery (downstream pushes, ordering, sink consume) stays under
            # the step watchdog, like the per-batch path's whole-push wrapper
            _faults.call_with_timeout(lambda m=m, out=out: graph._deliver(m, out),
                                      step_timeout, stage="graph.step")
        buf.clear()
        buf_n.clear()
        cur_key = None

    def ingest(mp, batch, p):
        hi = degrade.get(id(mp))
        if hi is not None and p > hi:
            degrade.pop(id(mp))       # past the failed run: resume fusing
        # degrade is global while any root is inside a failed run's range:
        # per-batch ingest keeps the round-robin arrival order for every root
        if not dk or degrade:
            _faults.call_with_timeout(
                lambda: graph._push(mp, batch), step_timeout, stage="graph.step",
                pre=lambda: _faults.fire("chain.step", pos=p))
            return
        buf.append((mp, batch, p))
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
                            if since >= checkpoint_every:
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
                        ingest(mp, batch, pos[id(mp)])
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
                with _restore_span(graph=graph.name, attempt=graph.supervised_restarts,
                                   error=type(e).__name__):
                    _graph_restore(graph, snap)
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


__all__ = ["RestartExhausted", "SupervisedPipeline", "run_graph_supervised"]

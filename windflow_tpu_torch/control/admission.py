"""Admission control — token-bucket rate limiting + load shedding at ingest.

Counterpart of ``windflow_tpu/control/admission.py``: the same buckets,
policies, counters and journal records. A batch costs its capacity, so no
decision reads a device value.

The reference has no overload story beyond its bounded FastFlow rings (a full
ring blocks the producer); the TB window engine's only shedding is the
OLD-straggler drop behind the fired frontier (``wf/win_seqffat.hpp``). This
module makes overload a first-class, *measured* input: every source loop can
offer its batches to an :class:`AdmissionController` that either admits them
or sheds them per policy, with every decision counted
(``windflow_control_shed_*`` series) and journaled (``shed`` events).

Two bucket flavours share one duck interface (``tick()`` / ``try_take(n)`` /
``state()`` / ``set_state()``):

- :class:`TokenBucket` — wall-clock refill (``rate_tps`` tuples/second,
  ``burst`` cap). The live-driver form.
- :class:`PositionBucket` — refills a fixed quantum per *offered batch*.
  Deterministic: shed decisions become a pure function of stream position,
  which is what the supervised drivers need — checkpoint replay re-offers the
  same batches and must re-shed the same ones, so the bucket state is included
  in the supervisor's snapshot and restored with it.

Shed policies (batch granularity — tuple-level masking would cost a device
pass per batch on the admit path):

- ``drop_newest`` — the incoming batch is shed when tokens are insufficient
  (classic tail drop).
- ``drop_oldest_ts`` — up to ``hold_max`` batches are held back while the
  bucket refills; overflow sheds the *oldest held* batch (lowest ts, since
  sources emit in ts order) — the OLD-straggler stance: prefer fresh data,
  drop stale.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

from ..observability import journal as _journal
from . import _state


class TokenBucket:
    """Wall-clock token bucket: ``rate`` tokens/second, capacity ``burst``.
    ``clock`` is injectable (fake clocks in tests)."""

    # the wall-clock flavour is EXPLICITLY non-replayable — the supervised
    # drivers reject it (_supervised_admission); live drivers only
    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic):      # wf-lint: allow[wall-clock]
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = self.clock()
        if self._last is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float) -> bool:
        # a cost above the whole bucket could never be afforded — charge the
        # bucket's capacity instead of wedging (documented: size burst >= one
        # batch)
        n = min(float(n), self.burst)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def get_rate(self) -> float:
        return self.rate

    def set_rate(self, value: float) -> None:
        self.rate = float(value)

    def state(self) -> dict:
        return {"tokens": self.tokens}

    def set_state(self, st: dict) -> None:
        self.tokens = float(st["tokens"])
        self._last = None                     # restart the refill epoch


class PositionBucket:
    """Deterministic bucket: ``refill_per_batch`` tokens added per ``tick()``
    (one tick per offered batch). No clock — replay-stable by construction."""

    def __init__(self, refill_per_batch: float, burst: float):
        self.refill = float(refill_per_batch)
        self.burst = float(burst)
        self.tokens = float(burst)

    def tick(self) -> None:
        self.tokens = min(self.burst, self.tokens + self.refill)

    def try_take(self, n: float) -> bool:
        n = min(float(n), self.burst)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def get_rate(self) -> float:
        return self.refill

    def set_rate(self, value: float) -> None:
        self.refill = float(value)

    def state(self) -> dict:
        # NOTE deliberately tokens-only: the refill rate is config, not
        # accumulated state — remediation-scaled rates ride the snapshot's
        # "remediation" key instead (runtime/supervisor.py), so checkpoints
        # taken with remediation OFF stay byte-for-byte unchanged
        return {"tokens": self.tokens}

    def set_state(self, st: dict) -> None:
        self.tokens = float(st["tokens"])


class AdmissionController:
    """Offer/shed gate in front of a source loop.

    ``offer(batch)`` returns the list of batches to process *now* (empty when
    the offer was shed or held); ``drain()`` releases any held batches at EOS
    (the overload is over — a bounded ``hold_max`` tail is admitted rather
    than lost). Thread-safe: the PipeGraph threaded driver offers from several
    source threads through one shared controller.

    Cost model: one batch costs its *capacity* in tokens — the static shape,
    not the live-lane count, which would need a device sync per batch on the
    admit path. Document the distinction when sizing ``rate_tps``.
    """

    def __init__(self, bucket, policy: str = "drop_newest", *,
                 hold_max: int = 2, driver: str = "", lock=None):
        if policy not in ("drop_newest", "drop_oldest_ts"):
            raise ValueError(f"unknown shed policy {policy!r}")
        self.bucket = bucket
        self.policy = policy
        self.hold_max = max(0, int(hold_max))
        self.driver = driver
        self.held: deque = deque()           # wf-lint: guarded-by[_lock]
        self.admitted = 0                     # batches (per-controller, tests)
        self.shed = 0                         # batches
        #: tuple capacity the shed batches carried — the authoritative
        #: per-controller shed accounting (an empty offer() return is NOT a
        #: shed signal: drop_oldest_ts holds batches for a later drain).
        #: In-memory only — deliberately NOT in state(): the supervised
        #: checkpoint shape is pinned (test_remediation); callers that need
        #: restore-spanning totals track per-offer deltas of this counter
        #: (serving.tenants.TenantRegistry)
        self.shed_tuples = 0
        #: pass one shared lock to controllers sharing one bucket (a graph
        #: with several sources rate-limits total ingest through one bucket
        #: but needs a *per-source* holding cell, so held batches always
        #: re-enter their own source's queue)
        self._lock = lock if lock is not None else threading.Lock()

    # -- internals ----------------------------------------------------------

    def _cost(self, batch) -> int:
        return int(batch.capacity)

    def _shed(self, batch, pos, stream=None) -> None:
        cost = self._cost(batch)
        self.shed += 1
        self.shed_tuples += cost
        _state.bump("shed_batches")
        _state.bump("shed_tuples", cost)
        extra = {} if stream is None else {"stream": stream}
        _journal.record("shed", policy=self.policy, driver=self.driver,
                        pos=pos, tuples=cost, **extra)

    def _admit(self, batch) -> None:
        self.admitted += 1
        _state.bump("admitted_batches")
        _state.bump("admitted_tuples", self._cost(batch))

    # -- surface ------------------------------------------------------------

    def offer(self, batch, pos=None, stream=None) -> List:
        """Offer one source batch; returns the batches admitted right now.
        ``pos``/``stream`` are journal coordinates only (never part of the
        shed decision): the graph drivers pass the per-root offered position
        and the root index — the SAME coordinates causal tracing mints ids
        from, so ``wf_trace.py --report`` joins shed events to traced
        batches exactly."""
        with self._lock:
            self.bucket.tick()
            if self.policy == "drop_newest":
                if self.bucket.try_take(self._cost(batch)):
                    self._admit(batch)
                    return [batch]
                self._shed(batch, pos, stream)
                return []
            # drop_oldest_ts: FIFO holding cell, shed from the stale end
            self.held.append((batch, pos, stream))
            out = []
            while self.held and self.bucket.try_take(
                    self._cost(self.held[0][0])):
                b, _, _ = self.held.popleft()
                self._admit(b)
                out.append(b)
            while len(self.held) > self.hold_max:
                b, p, s = self.held.popleft()    # oldest ts first
                self._shed(b, p, s)
            return out

    def drain(self) -> List:
        """EOS: admit the bounded held tail (delayed, not shed)."""
        with self._lock:
            out = []
            while self.held:
                b, _, _ = self.held.popleft()
                self._admit(b)
                out.append(b)
            return out

    # -- remediation actuator surface ---------------------------------------

    def current_rate(self) -> float:
        with self._lock:
            return self.bucket.get_rate()

    def set_rate(self, value: float) -> None:
        """Restore/replay path: pin the bucket's refill rate outright (the
        remediation-scaled rate rides the supervisor snapshot's
        ``"remediation"`` key, not the bucket state)."""
        with self._lock:
            self.bucket.set_rate(value)
            _state.set_gauge("bucket_rate", float(value))

    def scale_rate(self, factor: float, floor: float = 1.0) -> dict:
        """The ``admission_rate`` remediation actuator: multiply the bucket's
        refill rate by ``factor`` (tighten: factor < 1), clamped at ``floor``.
        Takes the bucket lock, so a rate change is atomic w.r.t. a racing
        ``offer`` — held batches (drop_oldest_ts) are untouched; the next
        ``tick()`` simply refills at the new rate.  Returns the setpoint
        delta for the journal/ledger."""
        with self._lock:
            cur = float(self.bucket.get_rate())
            new = max(float(floor), cur * float(factor))
            self.bucket.set_rate(new)
            _state.set_gauge("bucket_rate", new)
            return {"rate": round(new, 3), "prev_rate": round(cur, 3)}

    # -- supervised snapshot/restore ---------------------------------------

    def state(self) -> dict:
        """Replay snapshot. Only the bucket: the supervised drivers restrict
        to ``drop_newest`` (no held data), so held batches never need to be
        serialized into a checkpoint."""
        with self._lock:
            return {"bucket": self.bucket.state(),
                    "admitted": self.admitted, "shed": self.shed}

    def set_state(self, st: dict) -> None:
        with self._lock:
            self.bucket.set_state(st["bucket"])
            self.admitted = int(st["admitted"])
            self.shed = int(st["shed"])
            self.held.clear()


def resolve_burst(cfg, base_capacity: int) -> float:
    """THE burst-sizing policy (default 4 base batches, floored at one batch
    so a single batch can always be afforded) — one definition shared by the
    live drivers and the supervised drivers' deterministic bucket."""
    return max(float(cfg.burst_tuples or 4 * base_capacity),
               float(base_capacity))


def bucket_from_config(cfg, base_capacity: int,
                       clock=time.monotonic):  # wf-lint: allow[wall-clock]
    """The bucket a ``ControlConfig`` asks for (None when admission is off or
    rate-unlimited). The wall-clock default only ever reaches the live
    drivers — the supervised path requires ``refill_per_batch`` and builds a
    clock-free :class:`PositionBucket`."""
    if cfg is None or not cfg.admission:
        return None
    burst = resolve_burst(cfg, base_capacity)
    if cfg.refill_per_batch is not None:
        _state.set_gauge("bucket_rate", float(cfg.refill_per_batch))
        return PositionBucket(cfg.refill_per_batch, burst)
    if cfg.rate_tps is not None:
        _state.set_gauge("bucket_rate", float(cfg.rate_tps))
        return TokenBucket(cfg.rate_tps, burst, clock=clock)
    return None                               # admission on, rate unlimited


def admission_from_config(cfg, base_capacity: int, *, driver: str = "",
                          clock=time.monotonic,  # wf-lint: allow[wall-clock]
                          ) -> Optional[AdmissionController]:
    """One controller over its own bucket (single-source drivers)."""
    bucket = bucket_from_config(cfg, base_capacity, clock=clock)
    if bucket is None:
        return None
    return AdmissionController(bucket, cfg.shed_policy,
                               hold_max=cfg.hold_max, driver=driver)


def admission_group(cfg, base_capacity: int, n: int, *, driver: str = "",
                    clock=time.monotonic,    # wf-lint: allow[wall-clock]
                    ) -> List[Optional[AdmissionController]]:
    """``n`` controllers sharing ONE bucket (and one lock): a multi-source
    graph rate-limits *total* ingest while each source keeps its own holding
    cell, so held batches always re-enter their own source's stream."""
    bucket = bucket_from_config(cfg, base_capacity, clock=clock)
    if bucket is None:
        return [None] * n
    lock = threading.Lock()
    return [AdmissionController(bucket, cfg.shed_policy,
                                hold_max=cfg.hold_max,
                                driver=f"{driver}[{i}]", lock=lock)
            for i in range(n)]

"""Deterministic fault injection and the supervision hardening primitives.

The port's own copy of ``windflow_tpu/runtime/faults.py`` (that module imports
no JAX, but the port imports nothing of the JAX package):

- :class:`FaultPlan` / :class:`FaultInjector`: a seeded, deterministic
  schedule of faults at named injection sites (:data:`SITES`). The
  threaded drivers take one as ``faults=`` (or from ``WF_FAULT_PLAN``:
  inline JSON or a path to a JSON file) and fire ``source.next``,
  ``queue.stall``, ``chain.step`` and ``sink.consume``;
  ``runtime/checkpoint.py`` fires ``checkpoint.save`` (torn writes
  included), ``checkpoint.load`` and ``reshard.handoff`` (the handoff
  seal); the sharded supervisors fire ``shard.kill`` before every per-shard
  push (``shard``, ``pos``) and ``reshard.handoff`` in an in-memory handoff
  (``shard``, ``at_pos``);
- :func:`call_with_timeout`: the step watchdog, a hung step becomes a
  :class:`WatchdogTimeout`;
- :func:`backoff_sleep`: exponential backoff with decorrelated jitter;
- :class:`DeadLetterQueue`: the poison-batch quarantine target;
- :func:`drain_queue_to_sentinel`: the failure path of the threaded drivers;
- process-wide recovery counters (:func:`bump`, :func:`counters`), named by
  ``observability/names.py::RECOVERY_COUNTERS``.

Every fire, watchdog timeout and backoff is journaled (``fault_injected``,
``watchdog_timeout``, ``backoff``) through the active event journal
(``observability/journal.py``), as the JAX package does. An injection site
costs one module-attribute load and a ``None`` check when no injector is
active.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..observability import journal as _journal
from ..observability.names import RECOVERY_COUNTERS

#: the named injection sites (``shard.kill`` and ``reshard.handoff``: the
#: sharded supervisors and the handoff seal)
SITES = ("source.next", "chain.step", "sink.consume",
         "checkpoint.save", "checkpoint.load", "queue.stall",
         "shard.kill", "reshard.handoff")

#: fault kinds: raise an InjectedFault / sleep stall_s / leave a half-written
#: checkpoint behind, then raise (torn write)
KINDS = ("error", "stall", "torn")


class InjectedFault(RuntimeError):
    """Raised at an injection site by an active :class:`FaultInjector`."""


class WatchdogTimeout(RuntimeError):
    """A step (or threaded stage) exceeded its watchdog timeout."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault. Matching conditions AND together:

    - ``at``: 1-based per-site occurrence indices;
    - ``where``: equality constraints on the call-site context (e.g.
      ``{"pos": 5}`` fires every time batch position 5 is processed);
    - ``p``: per-occurrence probability from the plan's seeded RNG.

    With none of the three, the spec fires on the first occurrence only.
    ``max_fires`` bounds total fires (default: unlimited for ``where``/``p``
    specs, ``len(at)`` for ``at`` specs, 1 otherwise)."""

    site: str
    kind: str = "error"
    at: Optional[Sequence[int]] = None
    where: Optional[Dict[str, Any]] = None
    p: float = 0.0
    stall_s: float = 0.05
    max_fires: Optional[int] = None
    message: str = ""

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(sites: {', '.join(SITES)})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(kinds: {', '.join(KINDS)})")
        if self.at is not None:
            self.at = tuple(int(a) for a in self.at)

    def _fire_bound(self) -> Optional[int]:
        if self.max_fires is not None:
            return int(self.max_fires)
        if self.at is not None:
            return len(self.at)
        if self.where is not None or self.p > 0.0:
            return None                      # unlimited
        return 1


class FaultPlan:
    """An ordered, seeded set of :class:`FaultSpec`, JSON round-trippable:
    ``{"seed": 7, "faults": [{"site": "chain.step", "at": [3]}, ...]}``."""

    def __init__(self, faults: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.faults = [f if isinstance(f, FaultSpec) else FaultSpec(**f)
                       for f in faults]
        self.seed = int(seed)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "faults": [{k: v for k, v in dataclasses.asdict(f).items()
                        if v not in (None, "", 0.0) or k in ("site", "kind")}
                       for f in self.faults]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        obj = json.loads(text)
        if isinstance(obj, list):            # bare fault list shorthand
            obj = {"faults": obj}
        return cls(obj.get("faults", ()), seed=obj.get("seed", 0))

    @classmethod
    def from_env(cls, var: str = "WF_FAULT_PLAN") -> Optional["FaultPlan"]:
        """``WF_FAULT_PLAN`` = inline JSON (starts with ``{``/``[``) or a path
        to a JSON file; empty or unset = no plan."""
        raw = os.environ.get(var, "").strip()
        if not raw:
            return None
        if raw[0] in "[{":
            return cls.from_json(raw)
        with open(raw) as f:
            return cls.from_json(f.read())


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at the injection sites.

    Deterministic: per-site occurrence counters and one ``random.Random``
    seeded per spec from ``plan.seed``. Thread-safe (the threaded drivers
    fire from several stage threads). ``fired`` records every fire:
    ``(site, occurrence, kind, ctx)``."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counts: Dict[str, int] = {}
        self.fired: List[Tuple[str, int, str, dict]] = []
        self._spec_fires = [0] * len(plan.faults)
        self._rngs = [random.Random(f"{plan.seed}/{i}/{s.site}")
                      for i, s in enumerate(plan.faults)]
        self._lock = threading.Lock()

    def decision(self, site: str, **ctx) -> Optional[FaultSpec]:
        """Count one occurrence of ``site`` and return the matching spec (or
        None) without acting on it: call sites with their own semantics
        (torn checkpoint writes) implement the fault themselves."""
        with self._lock:
            n = self.counts.get(site, 0) + 1
            self.counts[site] = n
            for i, spec in enumerate(self.plan.faults):
                if spec.site != site:
                    continue
                bound = spec._fire_bound()
                if bound is not None and self._spec_fires[i] >= bound:
                    continue
                if spec.at is not None and n not in spec.at:
                    continue
                if spec.where is not None and not all(
                        ctx.get(k) == v for k, v in spec.where.items()):
                    continue
                if spec.p > 0.0 and self._rngs[i].random() >= spec.p:
                    continue
                self._spec_fires[i] += 1
                self.fired.append((site, n, spec.kind, dict(ctx)))
                bump("faults_injected")
                _journal.record("fault_injected", site=site, occurrence=n,
                                kind=spec.kind, **ctx)
                return spec
        return None

    def fire(self, site: str, **ctx) -> None:
        """Count one occurrence and act on a match: ``error`` raises
        :class:`InjectedFault`, ``stall`` sleeps ``stall_s``, ``torn`` raises
        (sites that can leave a torn artifact use :meth:`decision`)."""
        spec = self.decision(site, **ctx)
        if spec is None:
            return
        if spec.kind == "stall":
            time.sleep(spec.stall_s)
            return
        with self._lock:
            occurrence = self.counts[site]
        raise InjectedFault(
            spec.message or f"injected {spec.kind} fault at {site} "
            f"(occurrence {occurrence}, ctx {ctx})")


# ------------------------------------------------------------- active injector

_active: Optional[FaultInjector] = None


def set_active(inj: Optional[FaultInjector]) -> None:
    global _active
    _active = inj


def get_active() -> Optional[FaultInjector]:
    return _active


def resolve(arg) -> Optional[FaultInjector]:
    """A driver's ``faults=`` argument normalized: None consults
    ``WF_FAULT_PLAN``; False forces off; a plan, an injector or a JSON
    string passes through."""
    if arg is False:
        return None
    if isinstance(arg, FaultInjector):
        return arg
    if isinstance(arg, FaultPlan):
        return FaultInjector(arg)
    if isinstance(arg, str):
        return FaultInjector(FaultPlan.from_json(arg))
    if arg is not None:
        raise TypeError(f"faults= takes a FaultPlan, a FaultInjector, a JSON string, "
                        f"None or False, got {type(arg).__name__}")
    plan = FaultPlan.from_env()
    return FaultInjector(plan) if plan is not None else None


@contextlib.contextmanager
def activate(inj: Optional[FaultInjector]):
    """Install ``inj`` as the active injector for the block; None leaves the
    current (possibly externally installed) injector untouched."""
    if inj is None:
        yield None
        return
    prev = get_active()
    set_active(inj)
    try:
        yield inj
    finally:
        set_active(prev)


def fire(site: str, **ctx) -> None:
    """Module-level injection site."""
    inj = _active
    if inj is not None:
        inj.fire(site, **ctx)


def decision(site: str, **ctx) -> Optional[FaultSpec]:
    inj = _active
    if inj is not None:
        return inj.decision(site, **ctx)
    return None


# --------------------------------------------------------- recovery counters

_counters: Dict[str, float] = {k: 0 for k in RECOVERY_COUNTERS}
_counters_lock = threading.Lock()


def bump(name: str, n: float = 1) -> None:
    """Increment a process-wide recovery counter."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, float]:
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        for k in list(_counters):
            _counters[k] = 0


# ------------------------------------------------------------- step watchdog

def call_with_timeout(fn, timeout: Optional[float], *, stage: str = "step", pre=None):
    """Run ``pre()`` (the injection point: stall faults sleep there), then
    ``fn()``, enforcing ``timeout`` seconds when set.

    With a timeout the call runs in a transient worker thread; if it does not
    finish in time the worker is abandoned (flagged so it will not run ``fn``
    after waking from a pre-step stall) and :class:`WatchdogTimeout` is
    raised, carrying the abandoned thread as ``.worker``: a caller that
    restores state afterwards joins it first (:func:`join_abandoned_worker`).
    A step hung inside the device cannot be interrupted, only detected.

    PyTorch keeps the current CUDA stream per thread: the worker enters the
    caller's current stream, so the step's kernels are ordered before
    whatever the caller queues on that stream next (a snapshot's copy to the
    host included)."""
    if not timeout:
        if pre is not None:
            pre()
        return fn()
    box: dict = {}
    abandoned = threading.Event()
    stream = _caller_stream()

    def worker():
        try:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                if pre is not None:
                    pre()
                if abandoned.is_set():
                    return                 # the watchdog gave up: leave state alone
                box["value"] = fn()
        except BaseException as e:         # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=worker, daemon=True, name=f"wf-watchdog-{stage}")
    t.start()
    t.join(timeout)
    if t.is_alive():
        abandoned.set()
        bump("watchdog_timeouts")
        _journal.record("watchdog_timeout", stage=stage, timeout_s=timeout)
        err = WatchdogTimeout(f"{stage} exceeded the {timeout}s watchdog timeout")
        err.worker = t
        raise err
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _caller_stream():
    """The calling thread's current CUDA stream, or None where CUDA is not
    in use (not available, or not initialized in this process)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_stream()
    return None


def join_abandoned_worker(exc, grace: Optional[float]) -> None:
    """Give the worker abandoned by a :class:`WatchdogTimeout` ``grace``
    seconds to finish before state is restored; no-op for other errors."""
    w = getattr(exc, "worker", None)
    if w is not None and grace:
        w.join(grace)


#: how long a failed stage keeps draining its input for the upstream's EOS
#: (the upstream's ``finally`` always sends one, so this bounds only a
#: producer thread that was killed)
DRAIN_TIMEOUT_S = 30.0


def drain_queue_to_sentinel(q, sentinel, timeout_s: float = DRAIN_TIMEOUT_S,
                            poll_s: float = 0.0005) -> bool:
    """Pop ``q``, dropping data items, until ``sentinel`` arrives: the failure
    path of the threaded drivers (a dead consumer drains its input ring so
    the upstream producer, blocked on a full ring, can finish and send its
    own EOS). Returns False on timeout."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ok, item = q.pop(spin=64, max_yields=0)
        if ok:
            if item is sentinel:
                return True
            continue
        time.sleep(poll_s)
    return False


# ------------------------------------------------- backoff with decorrelated jitter

def backoff_sleep(rng: random.Random, prev: float, base: float, cap: float, *,
                  attempt: int = 0) -> float:
    """One decorrelated-jitter backoff step: sleep ``min(cap, U(base,
    3*prev))`` and return the slept duration (feed it back as ``prev``).
    ``base <= 0`` or ``cap <= 0`` disables it (returns 0 without sleeping)."""
    if base <= 0 or cap <= 0:
        return 0.0
    s = min(cap, rng.uniform(base, max(base, prev * 3.0)))
    bump("backoff_sleeps")
    bump("backoff_seconds", s)
    _journal.record("backoff", sleep_s=round(s, 6), attempt=attempt)
    time.sleep(s)
    return s


# ------------------------------------------------------------ dead letters

class DeadLetterQueue:
    """Quarantine target for poison batches: the offending batch lands here
    (host copies, bounded by ``max_entries``) and the stream moves on.
    ``spill_path`` appends one JSON summary line per entry (ids and error,
    not the payload)."""

    def __init__(self, spill_path: Optional[str] = None, max_entries: int = 1024):
        self.spill_path = spill_path
        self.max_entries = int(max_entries)
        self.entries: List[dict] = []
        self.dropped = 0                   # entries evicted past max_entries
        self._lock = threading.Lock()

    def put(self, batch, *, pos, error=None, driver: str = "") -> dict:
        entry = {"pos": pos, "driver": driver, "wall": time.time(),
                 "error": (f"{type(error).__name__}: {error}"[:500]
                           if error is not None else None)}
        if batch is not None:
            try:
                host = batch.to_host()
                v = host["valid"]
                entry["n_valid"] = int(v.sum())
                entry["ids"] = host["id"][v][:32].tolist()
                entry["batch"] = host
            except Exception:              # noqa: BLE001 — never lose the record
                entry["n_valid"] = None
        with self._lock:
            self.entries.append(entry)
            if len(self.entries) > self.max_entries:
                self.entries.pop(0)
                self.dropped += 1
            if self.spill_path:
                summary = {k: v for k, v in entry.items() if k != "batch"}
                with open(self.spill_path, "a") as f:
                    f.write(json.dumps(summary, default=str) + "\n")
        return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self.entries)


__all__ = ["SITES", "KINDS", "InjectedFault", "WatchdogTimeout", "FaultSpec",
           "FaultPlan", "FaultInjector", "set_active", "get_active", "resolve",
           "activate", "fire", "decision", "bump", "counters", "reset_counters",
           "call_with_timeout", "join_abandoned_worker", "DRAIN_TIMEOUT_S",
           "drain_queue_to_sentinel", "backoff_sleep", "DeadLetterQueue"]

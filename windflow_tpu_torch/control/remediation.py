"""Self-driving remediation — close the loop from SLO PAGE to actuator.

Counterpart of ``windflow_tpu/control/remediation.py``: the same policy
grammar, evaluators, decisions and journal records (its error messages name
the JAX package's WF118 validator, as the JAX package's do). The live
:class:`RemediationEngine` consumes the SLO engine's verdicts
(``MonitoringConfig(slo=, remediation=)``): ``Pipeline`` binds
``admission_rate`` and ``autotune_reclimb``, ``ThreadedPipeline``
``admission_rate``, ``ServingRuntime`` ``tenant_rate``. The barrier mode runs
under the port's supervised drivers.

The SLO stack judges (OK->WARN->PAGE, multi-window burn rates,
incident bundles, fleet correlation) but never acts: every actuator the
system owns — admission shed rates (``admission.py``), autotuner capacity/K
re-climb (``autotune.py``), ``reshard="auto"`` (``runtime/supervisor.py``),
tiered hot capacity, ``recommend_delay(q)`` (``observability/event_time.py``)
— waits for a human.  This module is the wiring between them: a declarative
:class:`RemediationPolicy` maps burn signatures to actuator invocations,
rate-limited and damped exactly like the subsystems it drives.

Two evaluation modes share one policy grammar:

- **Live mode** (:class:`RemediationEngine`): subscribes to the SLO engine's
  per-tick verdicts on the Reporter thread (``SLOEngine.verdict_hook``).  On
  a PAGE it fires the matching action through a driver-*bound* actuator
  callable — ``Pipeline``/``ThreadedPipeline`` bind what they own (admission
  rate, tuner re-climb) in ``run()``; an action whose actuator the run never
  bound skips loudly (``remediation_skip`` reason ``unbound``) instead of
  guessing.  Wall-clock cooldown + max-actions budget (the incident-bundle
  rate-limit pattern) and no-improvement damping (the auto-reshard 0.9
  pattern) bound the blast radius.
- **Barrier mode** (:class:`BarrierRemediation`): supervised drivers cannot
  act on wall-clock verdicts — replay must re-derive byte-identical results.
  The barrier evaluator consumes only *committed deterministic signals*
  (PositionBucket shed ratios, per-shard interval counts — pure functions of
  stream position) at each commit barrier, counts consecutive violations
  against the action's ``target``/``window``, and its entire decision state
  is a JSON dict checkpointed beside the admission bucket — replay from any
  checkpoint re-derives the exact same actions at the exact same barriers.

Geometry-baked setpoints (tiered ``hot_capacity``, ``WindowSpec.delay``) are
fixed when a chain is built (its state sizes and its captured programs hold
them). Their actuators are therefore **advisory**: the recommendation is
journaled + gauged (``remediation_recommended_*``) for the next restart to
pick up, never applied to a running chain.

Everything is off by default behind ``remediation=`` / ``WF_REMEDIATION``
(the ``monitoring=``/``control=`` convention); config that cannot work is a
loud ``ValueError`` at construction, mirrored pre-run by the WF118
validator.  Stdlib only.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..observability import journal as _journal
from . import _state

#: engine-wide defaults (overridable via MonitoringConfig /
#: WF_REMEDIATION_COOLDOWN_S / WF_REMEDIATION_MAX_ACTIONS)
DEFAULT_COOLDOWN_S = 60.0
DEFAULT_MAX_ACTIONS = 8

#: no-improvement damping threshold — an action whose triggering metric has
#: not improved by >10% since it last fired is not helping and stops (the
#: ShardedSupervisor auto-reshard damping constant)
DAMP_RATIO = 0.9

#: every actuator a policy may name -> what firing it does.  THE registry the
#: WF118 validator and the policy constructor check actuator names against —
#: a typo'd actuator is a construction-time ValueError, not a silent no-op.
ACTUATORS = {
    "admission_rate":
        "scale the admission bucket refill rate by `factor` (clamped at "
        "`floor` tuples/interval) — shed harder at the ingest boundary",
    "autotune_reclimb":
        "un-converge the capacity/K autotuner so it re-explores its ladder "
        "(deferred past any settle blackout, actuated on the driver thread)",
    "reshard":
        "request a key-ownership reshard at the next commit barrier "
        "(sharded supervision; loses deterministically to a pending "
        "auto-reshard at the same barrier)",
    "hot_capacity":
        "recommend a larger tiered hot capacity (advisory: geometry is a "
        "traced constant — journaled + gauged for the next restart)",
    "widen_delay":
        "recommend a wider watermark delay from the lateness histogram "
        "(advisory: WindowSpec.delay is a traced constant)",
    "tenant_rate":
        "scale ONE tenant's admission bucket by `factor` (clamped at "
        "`floor`) — the serving plane resolves the firing SLO's tenant= "
        "label to its bucket, so a noisy tenant is shed without touching "
        "its neighbors' budgets (serving/runtime.py binds it)",
}

#: barrier-mode deterministic signal each actuator is evaluated on (None =
#: not barrier-actionable: the signal cannot be derived from committed state)
BARRIER_SIGNALS = {
    "admission_rate": "drop_ratio",   # interval shed/(shed+admitted)
    "reshard": "shard_skew",          # hot fraction: max/total of per-shard
    #                                   interval tuples (the governor's
    #                                   scale-free recommend_reshard signal)
}

#: gauges advisory actuators publish their recommendation under
ADVISORY_GAUGES = {
    "hot_capacity": "remediation_hot_capacity",
    "widen_delay": "remediation_recommended_delay",
}


# ------------------------------------------------------------ policy grammar

@dataclass(frozen=True)
class RemediationAction:
    """One burn-signature -> actuator mapping.

    ``slo`` names the :class:`~..observability.slo.SLOSpec` whose PAGE fires
    this action (live mode); ``target``/``window`` drive the barrier-mode
    evaluator instead (consecutive barriers the deterministic signal must
    exceed ``target``).  ``gate`` optionally conditions firing on a health
    gauge — ``"dispatch_ratio>=0.5"`` is how the default policy tells a
    dispatch-bound latency burn apart from a compute-bound one (the health
    ledger's disambiguator) before re-climbing the tuner."""

    name: str                 # unique ledger/journal handle
    slo: str                  # SLO spec name whose PAGE triggers the action
    actuator: str             # ACTUATORS key
    factor: float = 0.7       # multiplicative setpoint scale (rate actions)
    floor: float = 1.0        # lower clamp for scaled setpoints
    gate: str = ""            # optional "gauge>=value" / "gauge<=value"
    target: float = 0.05      # barrier mode: violation threshold
    window: int = 5           # barrier mode: consecutive violating barriers
    max_applies: int = 4      # per-action cap within one run


@dataclass(frozen=True)
class RemediationPolicy:
    """An ordered tuple of actions (evaluation order = declaration order)."""

    actions: Tuple[RemediationAction, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "actions", tuple(self.actions))
        probs = policy_problems(self)
        if probs:
            raise ValueError("invalid remediation policy: " + "; ".join(probs))


def default_policy() -> RemediationPolicy:
    """The ``remediation=True`` policy — actions over the default SLO specs
    (``observability/slo.py::default_specs``): shed harder on ``drop_ratio``
    burn, re-climb the tuner on dispatch-bound ``e2e_p99_ms`` burn."""
    return RemediationPolicy(actions=(
        RemediationAction(name="shed_harder", slo="drops",
                          actuator="admission_rate", factor=0.7, floor=1.0,
                          target=0.05, window=5),
        RemediationAction(name="reclimb_dispatch", slo="latency_e2e",
                          actuator="autotune_reclimb",
                          gate="dispatch_ratio>=0.5"),
    ))


def default_barrier_policy(*, admission: bool,
                           shards: int) -> RemediationPolicy:
    """The supervised ``remediation=True`` policy — only actions whose
    actuator the run actually OWNS (admission bucket on, shards > 1): shed
    harder on the interval shed ratio, split the hot shard on sustained
    skew.  A run owning neither is a loud ValueError (remediation armed
    with nothing to actuate would read as covered while nothing watches)."""
    actions = []
    if admission:
        actions.append(RemediationAction(
            name="shed_harder", slo="drops", actuator="admission_rate",
            factor=0.7, floor=1.0, target=0.05, window=5))
    if shards > 1:
        actions.append(RemediationAction(
            name="split_hot_shard", slo="shards", actuator="reshard",
            target=0.6, window=3, max_applies=2))
    if not actions:
        raise ValueError(
            "remediation=True under supervision, but the run owns no "
            "barrier actuator — enable deterministic admission control "
            "(ControlConfig(admission=True, refill_per_batch=...)) and/or "
            "sharding (shards > 1); the WF118 validator reports this "
            "pre-run")
    return RemediationPolicy(actions=tuple(actions))


def barrier_policy_problems(p: RemediationPolicy, *, admission: bool,
                            shards: int) -> List[str]:
    """Supervised-mode legality over and above :func:`policy_problems`:
    every action must be barrier-actionable (its actuator has a
    deterministic committed signal) AND owned by the run config — shared by
    the construction-time ValueError and the WF118 validator."""
    probs: List[str] = []
    for a in p.actions:
        if a.actuator not in BARRIER_SIGNALS:
            probs.append(
                f"action {a.name!r}: actuator {a.actuator!r} has no "
                f"deterministic barrier signal, so supervised replay could "
                f"not re-derive it (barrier-actionable: "
                f"{', '.join(sorted(BARRIER_SIGNALS))}; use the live "
                f"drivers' monitoring= remediation for the rest)")
        elif a.actuator == "admission_rate" and not admission:
            probs.append(
                f"action {a.name!r}: actuator 'admission_rate' but the run "
                f"has no admission controller — enable ControlConfig("
                f"admission=True, refill_per_batch=...)")
        elif a.actuator == "reshard" and shards <= 1:
            probs.append(
                f"action {a.name!r}: actuator 'reshard' but the run is not "
                f"sharded (shards= / WF_SHARDS)")
    return probs


def resolve_barrier_policy(arg, *, admission: bool,
                           shards: int) -> Optional[RemediationPolicy]:
    """The supervised drivers' ``remediation=`` / ``WF_REMEDIATION``
    resolution: ``True`` builds :func:`default_barrier_policy` from the
    actuators the run owns; an explicit policy must pass
    :func:`barrier_policy_problems` (loud ValueError, mirrored by WF118)."""
    if arg is None or arg is False or arg == "" or arg == "0":
        return None
    if arg is True or arg == "1" or arg == 1:
        return default_barrier_policy(admission=admission, shards=shards)
    policy = resolve_policy(arg)
    probs = barrier_policy_problems(policy, admission=admission,
                                    shards=shards)
    if probs:
        raise ValueError(
            "invalid supervised remediation policy (the WF118 validator "
            "reports this pre-run): " + "; ".join(probs))
    return policy


def _parse_gate(gate: str) -> Optional[Tuple[str, str, float]]:
    """``"dispatch_ratio>=0.5"`` -> ("dispatch_ratio", ">=", 0.5); None for
    the empty gate; ValueError for anything else."""
    if not gate:
        return None
    for op in (">=", "<="):
        if op in gate:
            lhs, _, rhs = gate.partition(op)
            try:
                return (lhs.strip(), op, float(rhs))
            except ValueError:
                break
    raise ValueError(f"unparseable remediation gate {gate!r} "
                     f"(expected '<gauge>>=<value>' or '<gauge><=<value>')")


def action_problems(a: RemediationAction,
                    spec_names: Optional[List[str]] = None) -> List[str]:
    """Legality problems with one action — shared verbatim by the
    construction-time ValueError and the WF118 pre-run validator (the
    ``slo.spec_problems`` discipline: one source of truth, two surfaces)."""
    probs: List[str] = []
    if not a.name or not str(a.name).strip():
        probs.append("action has an empty name")
        return probs
    if a.actuator not in ACTUATORS:
        probs.append(f"action {a.name!r}: unknown actuator {a.actuator!r} "
                     f"(known: {', '.join(sorted(ACTUATORS))})")
    if not a.slo or not str(a.slo).strip():
        probs.append(f"action {a.name!r}: empty slo name")
    elif spec_names is not None and a.slo not in spec_names:
        probs.append(f"action {a.name!r}: references SLO {a.slo!r} which is "
                     f"not among the configured specs "
                     f"({', '.join(spec_names) or 'none'})")
    if not (a.factor > 0):
        probs.append(f"action {a.name!r}: factor must be > 0, got {a.factor}")
    if a.window < 1:
        probs.append(f"action {a.name!r}: window must be >= 1, got {a.window}")
    if a.max_applies < 1:
        probs.append(f"action {a.name!r}: max_applies must be >= 1, "
                     f"got {a.max_applies}")
    try:
        _parse_gate(a.gate)
    except ValueError as e:
        probs.append(f"action {a.name!r}: {e}")
    return probs


def policy_problems(p: RemediationPolicy,
                    spec_names: Optional[List[str]] = None) -> List[str]:
    probs: List[str] = []
    if not p.actions:
        probs.append("policy has no actions")
    seen = set()
    for a in p.actions:
        if a.name in seen:
            probs.append(f"duplicate action name {a.name!r}")
        seen.add(a.name)
        probs.extend(action_problems(a, spec_names))
    return probs


def _action_from_dict(d: dict) -> RemediationAction:
    if not isinstance(d, dict):
        raise ValueError(f"remediation action must be a dict, got {type(d).__name__}")
    allowed = {f for f in RemediationAction.__dataclass_fields__}
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(f"unknown remediation action fields "
                         f"{sorted(unknown)} (allowed: {sorted(allowed)})")
    return RemediationAction(**d)


def resolve_policy(arg) -> Optional[RemediationPolicy]:
    """``remediation=`` / ``WF_REMEDIATION`` -> policy (None = off).

    Accepts: falsy / ``"0"`` (off), True / ``"1"`` (the default policy), a
    :class:`RemediationPolicy`, a list of actions/dicts, a dict with an
    ``"actions"`` key, a JSON file path, or inline JSON.  Malformed config
    is a loud ValueError — a policy that silently resolves to nothing would
    read as "remediation armed" while nothing watches the pager."""
    if arg is None or arg is False or arg == "" or arg == "0":
        return None
    if arg is True or arg == "1" or arg == 1:
        return default_policy()
    if isinstance(arg, RemediationPolicy):
        return arg
    if isinstance(arg, RemediationAction):
        return RemediationPolicy(actions=(arg,))
    if isinstance(arg, (list, tuple)):
        acts = tuple(a if isinstance(a, RemediationAction)
                     else _action_from_dict(a) for a in arg)
        return RemediationPolicy(actions=acts)
    if isinstance(arg, dict):
        if "actions" not in arg:
            raise ValueError("remediation dict must carry an 'actions' list")
        return resolve_policy(arg["actions"])
    if isinstance(arg, str):
        text = arg
        if os.path.exists(arg):
            with open(arg) as f:
                text = f.read()
        try:
            obj = json.loads(text)
        except ValueError:
            raise ValueError(
                f"WF_REMEDIATION / remediation= string {arg!r} is neither "
                f"'0'/'1', an existing JSON file path, nor inline JSON")
        return resolve_policy(obj)
    raise ValueError(f"cannot resolve remediation config from "
                     f"{type(arg).__name__}: {arg!r}")


# ------------------------------------------------------- live (reporter) mode

def _lookup_gauge(section, name: str) -> Optional[float]:
    """Max numeric value under key ``name`` anywhere inside a snapshot
    section — health gauges nest per device/stage and the gate cares about
    the worst edge (a single dispatch-bound stage names the fusion
    candidate), so shape-agnostic max is the right fold."""
    best: Optional[float] = None
    stack = [section]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            for k, v in node.items():
                if k == name and isinstance(v, (int, float)):
                    best = v if best is None else max(best, v)
                else:
                    stack.append(v)
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return best


class RemediationEngine:  # wf-lint: single-writer[reporter, driver]
    """Live-mode policy evaluator — runs inside the Reporter tick.

    Single-writer[reporter]: :meth:`on_verdicts` is called only from the SLO
    engine's ``verdict_hook`` (Reporter thread; the final ``stop()`` emit
    runs after join, the SLOEngine discipline).  Actuator *callables* bound
    via :meth:`bind` must themselves be safe to invoke from this thread —
    ``AdmissionController.scale_rate`` takes the bucket lock,
    ``CapacityAutotuner.request_reclimb`` sets an Event the driver loop
    consumes at a batch boundary."""

    def __init__(self, policy: RemediationPolicy, *,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 max_actions: int = DEFAULT_MAX_ACTIONS,
                 clock: Callable[[], float] = time.monotonic):
        if policy is None or not isinstance(policy, RemediationPolicy):
            raise ValueError("RemediationEngine requires a RemediationPolicy "
                             f"(got {type(policy).__name__}) — resolve with "
                             "remediation.resolve_policy first")
        if cooldown_s < 0:
            raise ValueError(f"remediation cooldown_s must be >= 0, "
                             f"got {cooldown_s}")
        if max_actions < 1:
            raise ValueError(f"remediation max_actions must be >= 1, "
                             f"got {max_actions}")
        self.policy = policy
        self.cooldown_s = float(cooldown_s)
        self.max_actions = int(max_actions)
        self.clock = clock
        self._bindings: Dict[str, Callable] = {}
        self.applied = 0
        self.skipped = 0
        self._last_apply_t: Optional[float] = None
        self._ledger = deque(maxlen=64)
        self._per = {a.name: {"applies": 0, "prev_burn": None,
                              "stopped": False, "last_skip": None}
                     for a in policy.actions}

    # -- driver surface ----------------------------------------------------

    def bind(self, actuator: str, fn: Callable) -> None:
        """Bind an actuator callable ``fn(action) -> dict`` (details for the
        journal/ledger).  Drivers bind only what the run actually owns."""
        if actuator not in ACTUATORS:
            raise ValueError(f"unknown actuator {actuator!r}")
        self._bindings[actuator] = fn

    def bound(self) -> List[str]:
        return sorted(self._bindings)

    # -- reporter-tick surface --------------------------------------------

    def on_verdicts(self, snap: dict) -> None:
        """One SLO tick's verdicts in; zero or more actuations out.  Folds
        the ``remediation`` snapshot section in place (after acting, so the
        section reflects this tick's ledger)."""
        slos = snap.get("slo") or {}
        for a in self.policy.actions:
            st = slos.get(a.slo)
            # the section rows carry both the state string and its numeric
            # code (slo.py::_SLOState.row) — PAGE is code 2
            if not isinstance(st, dict) or int(st.get("code", 0)) < 2:
                continue
            burn = float(st.get("burn_fast", 0.0))
            self._consider(a, burn, snap)
        snap["remediation"] = self.section()

    def _consider(self, a: RemediationAction, burn: float, snap: dict) -> None:
        per = self._per[a.name]
        reason = None
        if per["stopped"]:
            reason = "damped"
        elif per["applies"] >= a.max_applies:
            reason = "action_budget"
        elif self.applied >= self.max_actions:
            reason = "run_budget"
        elif (self._last_apply_t is not None
              and self.clock() - self._last_apply_t < self.cooldown_s):
            reason = "cooldown"
        elif (per["prev_burn"] is not None
              and burn >= DAMP_RATIO * per["prev_burn"]):
            # fired before and the burn has not improved by >10% — the
            # actuator is not helping this incident; stop re-firing it
            # (the auto-reshard damping pattern)
            per["stopped"] = True
            reason = "damped"
        else:
            gate = _parse_gate(a.gate)
            if gate is not None:
                g, op, v = gate
                cur = _lookup_gauge(snap.get("health") or {}, g)
                if cur is None:
                    reason = "gate_unobserved"
                elif not (cur >= v if op == ">=" else cur <= v):
                    reason = "gate"
        if (reason is None and a.actuator not in self._bindings
                and a.actuator not in ADVISORY_GAUGES):
            reason = "unbound"
        if reason is not None:
            self._skip(a, reason, burn)
            return
        try:
            if a.actuator in self._bindings:
                details = self._bindings[a.actuator](a) or {}
            else:
                details = self._advisory(a, snap)
                if details is None:
                    # nothing observable to scale a recommendation from
                    self._skip(a, "unobserved", burn)
                    return
        except Exception as e:  # noqa: BLE001 — an actuator that throws must
            # not kill the tick, but must not die silently either
            self._skip(a, f"actuator_error:{type(e).__name__}", burn)
            return
        self.applied += 1
        per["applies"] += 1
        per["prev_burn"] = burn
        per["last_skip"] = None
        self._last_apply_t = self.clock()
        _state.bump("remediation_actions")
        rec = dict(action=a.name, actuator=a.actuator, slo=a.slo,
                   burn=round(burn, 3), applied=True, **details)
        self._ledger.append(rec)
        _journal.record("remediation_apply", **rec)

    def _advisory(self, a: RemediationAction, snap: dict) -> Optional[dict]:
        """Advisory actuation — geometry-baked setpoints are traced
        constants (mutating them mid-run would retrace every cached
        executable: WF109), so the 'actuation' is the recommendation
        itself: published under the ``ADVISORY_GAUGES`` control gauge and
        journaled for the next restart to consume.  None when the snapshot
        carries nothing observable to recommend from."""
        if a.actuator == "hot_capacity":
            cur = _lookup_gauge(snap.get("control") or {}, "hot_capacity")
            if cur is None:
                return None
            # factor < 1 scales the setpoint UP for capacity-style knobs
            rec = max(float(a.floor), float(math.ceil(cur / a.factor)))
        else:                               # widen_delay
            # the lateness histogram's own advice (event_time.summarize):
            # the smallest delay covering q of observed lateness
            rec = _lookup_gauge(snap, "recommend_delay_p99")
            if rec is None:
                return None
        _state.set_gauge(ADVISORY_GAUGES[a.actuator], float(rec))
        return {"recommended": float(rec), "advisory": True}

    def _skip(self, a: RemediationAction, reason: str, burn: float) -> None:
        self.skipped += 1
        _state.bump("remediation_skips")
        per = self._per[a.name]
        if per["last_skip"] == reason:
            return  # journal only reason TRANSITIONS — a paging SLO in
            # cooldown would otherwise spam one skip per tick
        per["last_skip"] = reason
        rec = dict(action=a.name, actuator=a.actuator, slo=a.slo,
                   burn=round(burn, 3), applied=False, reason=reason)
        self._ledger.append(rec)
        _journal.record("remediation_skip", **rec)

    # -- observability surface --------------------------------------------

    def section(self) -> dict:
        """The ``remediation`` snapshot section (and the incident bundle's
        ``remediation.json`` payload)."""
        return {"enabled": True, "applied": self.applied,
                "skipped": self.skipped, "bound": self.bound(),
                "actions": [a.name for a in self.policy.actions],
                "ledger": list(self._ledger)}


# --------------------------------------------------- deterministic (barrier)

class BarrierRemediation:
    """Barrier-mode evaluator for supervised drivers.

    Pure function of (policy, committed signals, own checkpointed state) —
    no wall clock, no thread: the owning driver calls :meth:`on_barrier`
    at every commit barrier with signals derived from committed state
    (PositionBucket counters, per-shard interval tuples), applies the
    returned decisions itself in barrier order, and checkpoints
    :meth:`state` beside the admission bucket so replay re-derives the
    identical action sequence.  Cooldown is counted in *barriers*
    (``cooldown_barriers = max(1, round(cooldown_s))`` — the documented
    deterministic proxy for the wall-clock cooldown)."""

    def __init__(self, policy: RemediationPolicy, *,
                 cooldown_barriers: int = 60,
                 max_actions: int = DEFAULT_MAX_ACTIONS):
        if policy is None or not isinstance(policy, RemediationPolicy):
            raise ValueError("BarrierRemediation requires a RemediationPolicy")
        if cooldown_barriers < 1:
            raise ValueError(f"cooldown_barriers must be >= 1, "
                             f"got {cooldown_barriers}")
        if max_actions < 1:
            raise ValueError(f"max_actions must be >= 1, got {max_actions}")
        self.policy = policy
        self.cooldown_barriers = int(cooldown_barriers)
        self.max_actions = int(max_actions)
        #: actions this evaluator may fire — only actuators with a
        #: deterministic barrier signal; the rest are WF118's problem
        self.actions = tuple(a for a in policy.actions
                             if a.actuator in BARRIER_SIGNALS)
        # all below: wf-lint: single-writer[driver]
        self.applied = 0
        self._cool = 0
        self._per = {a.name: {"win": 0, "applies": 0, "prev": None,
                              "stopped": False} for a in self.actions}

    # -- checkpointed state ------------------------------------------------

    def state(self) -> dict:
        """JSON-able decision state — stored under the admission snapshot's
        ``"remediation"`` key, so a checkpoint taken mid-incident replays
        the remaining actions at the same barriers."""
        return {"applied": self.applied, "cool": self._cool,
                "per": {k: dict(v) for k, v in self._per.items()}}

    def set_state(self, st: dict) -> None:
        if not isinstance(st, dict):
            return
        self.applied = int(st.get("applied", 0))
        self._cool = int(st.get("cool", 0))
        per = st.get("per") or {}
        for name, mine in self._per.items():
            got = per.get(name)
            if isinstance(got, dict):
                mine.update({"win": int(got.get("win", 0)),
                             "applies": int(got.get("applies", 0)),
                             "prev": got.get("prev"),
                             "stopped": bool(got.get("stopped", False))})

    # -- barrier surface ---------------------------------------------------

    def on_barrier(self, pos: int, signals: dict) -> List[dict]:
        """Evaluate one committed barrier.  ``signals`` maps barrier-signal
        names (``BARRIER_SIGNALS`` values) to this interval's deterministic
        measurements; a missing signal leaves its actions' windows frozen.
        Returns the decisions to apply, in declaration order — the caller
        actuates and journals them (``remediation_apply`` with ``pos=``)."""
        if self._cool > 0:
            self._cool -= 1
        fired: List[dict] = []
        for a in self.actions:
            sig = BARRIER_SIGNALS[a.actuator]
            if sig not in signals:
                continue
            v = float(signals[sig])
            per = self._per[a.name]
            per["win"] = per["win"] + 1 if v > a.target else 0
            if per["win"] < a.window:
                continue
            if (per["stopped"] or per["applies"] >= a.max_applies
                    or self.applied >= self.max_actions or self._cool > 0):
                continue
            if per["prev"] is not None and v >= DAMP_RATIO * per["prev"]:
                per["stopped"] = True  # fired before, signal not improving
                fired.append(dict(action=a.name, actuator=a.actuator,
                                  slo=a.slo, pos=int(pos), value=round(v, 4),
                                  applied=False, reason="damped"))
                continue
            self.applied += 1
            per["applies"] += 1
            per["prev"] = v
            per["win"] = 0
            self._cool = self.cooldown_barriers
            fired.append(dict(action=a.name, actuator=a.actuator, slo=a.slo,
                              pos=int(pos), value=round(v, 4), applied=True,
                              factor=a.factor, floor=a.floor))
        return fired

"""SLO engine: burn-rate alerting, health states, incident bundles.

Counterpart of ``windflow_tpu/observability/slo.py``, a copy of it (that
module imports no JAX, but the port imports nothing of the JAX package):

- :class:`SLOSpec`: a declarative objective over a signal the metrics
  snapshots carry (``SIGNALS``, and the tenant-labelled ``TENANT_SIGNALS``
  of the serving plane), with a target, an error-budget ``objective`` and
  fast/slow multi-window burn-rate thresholds.
- :class:`SLOEngine`: a per-SLO OK -> WARN -> PAGE -> OK state machine
  evaluated once a Reporter tick (``observe(snap)`` folds an ``"slo"``
  section into the snapshot); ``slo_page``/``slo_recover`` journal records;
  on PAGE entry a rate-limited incident bundle under
  ``<out_dir>/incidents/<stamp>_<slo>/`` whose ``manifest.json`` is written
  last (the commit point). ``clock=`` replaces the cooldown's clock.
- :func:`evaluate_series`, :func:`list_incidents`,
  :func:`incidents_summary`: the offline readers.

The same signals, specs, records and bundle files as the JAX package, so
``scripts/wf_slo.py`` reads the port's artifacts. Host-side Reporter-thread
work only: operator state and kernels are unchanged either way. Stdlib only.
"""


from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from . import journal as _journal

#: health states, worst-last (the merge folds per-SLO state by code MAX)
STATE_OK, STATE_WARN, STATE_PAGE = "ok", "warn", "page"
_STATE_CODE = {STATE_OK: 0, STATE_WARN: 1, STATE_PAGE: 2}
_CODE_STATE = {v: k for k, v in _STATE_CODE.items()}

#: journal-tail lines captured into an incident bundle
_JOURNAL_TAIL_LINES = 256


def _atomic_write(path: str, data: str) -> None:
    """The Reporter's hardened write-then-rename discipline (unique tmp +
    fsync + ``os.replace``), duplicated here so the module stays loadable
    by file path without dragging ``reporter.py``/``metrics.py`` into the
    stdlib CLIs' synthetic package."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


# ----------------------------------------------------------------- signals
#
# Each signal is a pure function of (latest snapshot, previous snapshot) ->
# Optional[float]: None means "no observation this tick" (the sub-system is
# off or saw no traffic), which neither violates nor clears the SLO — the
# burn windows simply do not advance.  Counters are cumulative in the
# snapshots, so rate/ratio signals difference against the previous tick.


def _sig_e2e_p99_ms(snap, prev) -> Optional[float]:
    sec = snap.get("e2e_latency_us") or {}
    if "samples_tick" in sec:            # windowed form (metrics.py)
        if not sec["samples_tick"]:
            return None                  # no traffic this tick
        return float(sec.get("p99_tick", 0.0)) / 1e3
    if not sec.get("samples"):
        return None
    return float(sec.get("p99", 0.0)) / 1e3


def _sig_service_p99_ms(snap, prev) -> Optional[float]:
    vals = [row["service_time_us"]["p99"] for row in snap.get("operators", [])
            if (row.get("service_time_us") or {}).get("samples")]
    if not vals:
        return None
    return float(max(vals)) / 1e3


def _sig_watermark_lag(snap, prev) -> Optional[float]:
    """Event-time freshness: the widest arrived-but-unfired span over every
    operator carrying a frontier (event-time sections when the sub-toggle is
    on, the TB watermark gauge otherwise)."""
    vals = []
    for row in snap.get("operators", []):
        sec = row.get("event_time") or {}
        if "lag" in sec:
            vals.append(sec["lag"])
        elif (row.get("watermark") or {}).get("lag_ts") is not None:
            vals.append(row["watermark"]["lag_ts"])
    if not vals:
        return None
    return float(max(vals))


def _drop_total(snap) -> float:
    tot = float((snap.get("totals") or {}).get("tuples_dropped_old", 0))
    for row in snap.get("operators", []):
        for k, v in (row.get("counters") or {}).items():
            if k in ("overflow_drops", "match_drops", "arch_drops"):
                tot += v
    ctl = (snap.get("control") or {}).get("counters") or {}
    return tot + float(ctl.get("shed_tuples", 0))


def _offered_total(snap) -> float:
    ctl = (snap.get("control") or {}).get("counters") or {}
    off = float(ctl.get("admitted_tuples", 0)) + float(ctl.get("shed_tuples",
                                                               0))
    if off > 0:
        return off
    # no admission control in the run: the widest per-operator input count
    # is the honest stream-size stand-in (sources count their tuples there)
    vals = [row.get("inputs_received", 0) for row in snap.get("operators",
                                                              [])]
    return float(max(vals)) if vals else 0.0


def _sig_drop_ratio(snap, prev) -> Optional[float]:
    d1, o1 = _drop_total(snap), _offered_total(snap)
    d0, o0 = (_drop_total(prev), _offered_total(prev)) if prev else (0.0, 0.0)
    offered = o1 - o0
    if offered <= 0:
        return None                      # no traffic this tick
    return max(d1 - d0, 0.0) / offered


def _sig_recovery_s(snap, prev) -> Optional[float]:
    """Seconds spent inside supervisor/shard restore spans during this tick
    (the cumulative ``recovery_seconds`` counter the supervisors bump around
    every restore, differenced per tick)."""
    rec = snap.get("recovery")
    if rec is None or "recovery_seconds" not in rec:
        return None
    now = float(rec.get("recovery_seconds", 0.0))
    before = float(((prev or {}).get("recovery") or {})
                   .get("recovery_seconds", 0.0))
    return max(now - before, 0.0)


def _sig_hbm_headroom_pct(snap, prev) -> Optional[float]:
    vals = []
    for d in (snap.get("health") or {}).get("devices", []):
        head, limit = d.get("headroom_bytes"), d.get("bytes_limit")
        if head is not None and limit:
            vals.append(100.0 * head / limit)
    return min(vals) if vals else None


def _sig_retrace_rate(snap, prev) -> Optional[float]:
    comp = (snap.get("health") or {}).get("compile")
    if comp is None:
        return None
    now = float(comp.get("retraces_unexpected", 0))
    before = float((((prev or {}).get("health") or {}).get("compile") or {})
                   .get("retraces_unexpected", 0))
    return max(now - before, 0.0)


#: THE signal registry: name -> (extractor, default mode).  ``"max"``
#: violates when signal > target (latency, drops, lag); ``"min"`` when
#: signal < target (headroom).  An unknown name is a WF116 validator error.
SIGNALS: Dict[str, Tuple[Callable, str]] = {
    "e2e_p99_ms": (_sig_e2e_p99_ms, "max"),
    "service_p99_ms": (_sig_service_p99_ms, "max"),
    "watermark_lag": (_sig_watermark_lag, "max"),
    "drop_ratio": (_sig_drop_ratio, "max"),
    "recovery_s": (_sig_recovery_s, "max"),
    "hbm_headroom_pct": (_sig_hbm_headroom_pct, "min"),
    "retrace_rate": (_sig_retrace_rate, "max"),
}


def _tenant_row(snap, tenant: str) -> Optional[dict]:
    """One tenant's counter row from the serving section (``serving/
    tenants.py`` TenantRegistry.counters -> snapshot ``serving.tenants``)."""
    if snap is None:
        return None
    return ((snap.get("serving") or {}).get("tenants") or {}).get(tenant)


def _sig_tenant_drop_ratio(snap, prev, tenant: str) -> Optional[float]:
    """Per-tick shed fraction of ONE tenant's offered batches — the
    isolation signal: a noisy tenant's shedding moves ONLY the SLOs
    labelled with its id, a quiet neighbor's stays 0."""
    row = _tenant_row(snap, tenant)
    if row is None:
        return None
    prow = _tenant_row(prev, tenant) or {}
    offered = float(row.get("offered", 0)) - float(prow.get("offered", 0))
    if offered <= 0:
        return None                      # no traffic from this tenant
    shed = float(row.get("shed", 0)) - float(prow.get("shed", 0))
    return max(shed, 0.0) / offered


def _sig_tenant_shed_tuples(snap, prev, tenant: str) -> Optional[float]:
    """Tuples one tenant lost to shedding this tick (absolute pressure —
    the remediation gate's coordinate when ratios are too coarse)."""
    row = _tenant_row(snap, tenant)
    if row is None:
        return None
    prow = _tenant_row(prev, tenant) or {}
    return max(float(row.get("shed_tuples", 0))
               - float(prow.get("shed_tuples", 0)), 0.0)


def _sig_tenant_e2e_p99_ms(snap, prev, tenant: str) -> Optional[float]:
    """One tenant's wire-to-sink p99 over the LAST TICK's samples
    (``serving.tenants`` ``e2e_p99_tick_ms`` — the windowed form, the
    ``_sig_e2e_p99_ms`` discipline: a cumulative p99 could never recover
    below target once a stall pushed the whole-run percentile over it).
    None when the tenant sent no traffic this tick (or latency sampling is
    off), which neither violates nor clears — the burn windows hold."""
    row = _tenant_row(snap, tenant)
    if row is None:
        return None
    if "e2e_samples_tick" in row:
        if not row["e2e_samples_tick"]:
            return None                  # no traffic from this tenant
        return float(row.get("e2e_p99_tick_ms", 0.0))
    if not row.get("e2e_samples"):
        return None                      # latency never sampled
    return float(row.get("e2e_p99_ms", 0.0))


#: tenant-labelled signal family (the serving plane's label dimension):
#: name -> (extractor(snap, prev, tenant), default mode).  A spec using one
#: of these MUST carry ``tenant=`` (and a host signal must NOT) — enforced
#: by spec_problems (WF116) and cross-checked against the declared tenant
#: ids by the serving validator (WF119).
TENANT_SIGNALS: Dict[str, Tuple[Callable, str]] = {
    "tenant_drop_ratio": (_sig_tenant_drop_ratio, "max"),
    "tenant_shed_tuples": (_sig_tenant_shed_tuples, "max"),
    "tenant_e2e_p99_ms": (_sig_tenant_e2e_p99_ms, "max"),
}


# -------------------------------------------------------------------- specs


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over a snapshot signal.

    The error budget is ``1 - objective`` (the fraction of ticks allowed to
    violate ``target``).  Burn rate over a window = (violating fraction of
    the window) / budget, so burn 1.0 spends the budget exactly on pace and
    burn ``1/(1-objective)`` means EVERY tick violates.  The two windows
    implement the standard multi-window multi-burn discipline: WARN when the
    fast window burns >= ``warn_burn`` (a spike — worth a look, not a
    wake-up), PAGE only when BOTH windows burn >= ``page_burn`` (the spike
    is sustained)."""

    name: str
    signal: str
    target: float
    #: fraction of ticks that must meet the target (budget = 1 - objective)
    objective: float = 0.9
    #: window lengths in Reporter ticks over the snapshots.jsonl cadence
    fast_window: int = 5
    slow_window: int = 60
    warn_burn: float = 1.0
    page_burn: float = 2.0
    #: violation sense; None = the signal's default (SIGNALS)
    mode: Optional[str] = None
    #: tenant label (serving plane): REQUIRED for TENANT_SIGNALS — the
    #: extractor then reads this tenant's ``serving.tenants`` row only, so
    #: one noisy tenant pages its own SLO without touching its neighbors'
    #: budgets; must be None for host-level SIGNALS
    tenant: Optional[str] = None

    def resolved_mode(self) -> str:
        if self.mode is not None:
            return self.mode
        sig = SIGNALS.get(self.signal) or TENANT_SIGNALS.get(self.signal)
        return sig[1] if sig else "max"

    def violated(self, value: float) -> bool:
        if self.resolved_mode() == "min":
            return value < float(self.target)
        return value > float(self.target)

    def budget(self) -> float:
        return max(1.0 - float(self.objective), 1e-9)


def spec_problems(spec: SLOSpec) -> List[str]:
    """Every reason this spec cannot be honored — THE shared legality check
    of the engine constructor, the WF116 validator, and ``wf_lint
    --explain WF116``'s story.  Empty list = clean."""
    out = []
    if not spec.name or not str(spec.name).strip():
        out.append("spec has an empty name")
    if spec.signal not in SIGNALS and spec.signal not in TENANT_SIGNALS:
        out.append(f"unknown signal {spec.signal!r} — registered signals: "
                   f"{', '.join(sorted(SIGNALS))}; tenant signals: "
                   f"{', '.join(sorted(TENANT_SIGNALS))}")
    if spec.signal in TENANT_SIGNALS and spec.tenant is None:
        out.append(f"signal {spec.signal!r} is tenant-labelled but the spec "
                   f"carries no tenant= — the extractor needs ONE tenant's "
                   f"serving.tenants row to read")
    if spec.signal in SIGNALS and spec.tenant is not None:
        out.append(f"tenant={spec.tenant!r} on host-level signal "
                   f"{spec.signal!r} — host signals carry no tenant "
                   f"dimension (tenant signals: "
                   f"{', '.join(sorted(TENANT_SIGNALS))})")
    if int(spec.fast_window) < 1:
        out.append(f"fast_window must be >= 1, got {spec.fast_window}")
    if int(spec.fast_window) >= int(spec.slow_window):
        out.append(f"fast_window ({spec.fast_window}) must be < slow_window "
                   f"({spec.slow_window}) — the fast window detects the "
                   f"spike, the slow window confirms the sustained burn")
    if not (0.0 < float(spec.objective) < 1.0):
        out.append(f"objective must be in (0, 1), got {spec.objective}")
    if float(spec.warn_burn) <= 0 or float(spec.page_burn) <= 0:
        out.append("warn_burn/page_burn must be > 0")
    if float(spec.warn_burn) > float(spec.page_burn):
        out.append(f"warn_burn ({spec.warn_burn}) must be <= page_burn "
                   f"({spec.page_burn}) — WARN is the earlier threshold")
    if spec.mode is not None and spec.mode not in ("max", "min"):
        out.append(f"mode must be 'max' or 'min', got {spec.mode!r}")
    return out


def default_specs() -> List[SLOSpec]:
    """The ``slo=True`` / ``WF_SLO=1`` spec set: conservative defaults over
    every signal family the snapshots carry (signals whose sub-system is off
    simply never observe — their SLO idles at OK)."""
    return [
        SLOSpec("latency_e2e", "e2e_p99_ms", target=250.0),
        SLOSpec("freshness", "watermark_lag", target=1e6),
        SLOSpec("drops", "drop_ratio", target=0.01),
        SLOSpec("recovery", "recovery_s", target=1.0),
        SLOSpec("hbm_headroom", "hbm_headroom_pct", target=10.0),
        SLOSpec("retraces", "retrace_rate", target=0.0),
    ]


def _spec_from_dict(d: dict) -> SLOSpec:
    allowed = {f.name for f in dataclasses.fields(SLOSpec)}
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(f"unknown SLOSpec field(s) {sorted(unknown)} "
                         f"(allowed: {sorted(allowed)})")
    if "name" not in d or "signal" not in d or "target" not in d:
        raise ValueError(f"an SLO spec needs at least name/signal/target, "
                         f"got {sorted(d)}")
    return SLOSpec(**d)


def resolve_specs(slo) -> Optional[List[SLOSpec]]:
    """Normalize the ``MonitoringConfig.slo`` value (after its ``WF_SLO``
    env resolution) into a spec list: ``False``/``None``/``''``/``'0'`` =
    off (None), ``True``/``'1'`` = :func:`default_specs`, a list/tuple of
    ``SLOSpec``/dicts passes through, a string is inline JSON (when it
    starts with ``[``/``{``) or a JSON file path.  JSON top level: a list of
    spec dicts, or ``{"specs": [...]}``.  Raises ``ValueError`` on malformed
    input — surfaced pre-run as WF116."""
    if slo is None or slo is False:
        return None
    if slo is True:
        return default_specs()
    if isinstance(slo, str):
        s = slo.strip()
        if s in ("", "0"):
            return None
        if s == "1":
            return default_specs()
        if s.startswith("[") or s.startswith("{"):
            data = json.loads(s)
        else:
            with open(s) as f:
                data = json.load(f)
        if isinstance(data, dict):
            data = data.get("specs")
        if not isinstance(data, list):
            raise ValueError(f"SLO spec JSON must be a list of spec objects "
                             f"(or {{'specs': [...]}}), got "
                             f"{type(data).__name__}")
        return [_spec_from_dict(dict(d)) for d in data]
    if isinstance(slo, (list, tuple)):
        out = []
        for item in slo:
            if isinstance(item, SLOSpec):
                out.append(item)
            elif isinstance(item, dict):
                out.append(_spec_from_dict(dict(item)))
            else:
                raise ValueError(f"slo entries must be SLOSpec or dict, got "
                                 f"{type(item).__name__}")
        return out or None
    raise ValueError(f"slo= accepts None/bool/str/list, got "
                     f"{type(slo).__name__}")


# ------------------------------------------------------------- the engine


class _SLOState:
    """Per-SLO evaluation state: the violation window, the health state, and
    the bounded burn/state history the incident bundle snapshots."""

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        # newest-last violation booleans; the slow window bounds retention
        self.window: Deque[bool] = collections.deque(
            maxlen=int(spec.slow_window))
        self.state = STATE_OK
        self.pages = 0
        self.last_value: Optional[float] = None
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        #: (tick, value, burn_fast, burn_slow, state) — the burn timeline
        self.history: Deque[tuple] = collections.deque(
            maxlen=int(spec.slow_window))
        #: (tick, from_state, to_state) transitions, whole-run
        self.transitions: List[tuple] = []

    def _burn(self, w: int) -> float:
        vals = list(self.window)[-w:]
        # fixed denominator: a window that has not filled yet under-reports
        # (conservative — a 2-tick-old run cannot page off 2 samples)
        return round((sum(vals) / float(w)) / self.spec.budget(), 4)

    def row(self) -> dict:
        out = {"state": self.state, "code": _STATE_CODE[self.state],
               "burn_fast": self.burn_fast, "burn_slow": self.burn_slow,
               "signal": self.last_value, "target": self.spec.target,
               "pages": self.pages}
        if self.spec.tenant is not None:
            # the serving label dimension: wf_top's tenants panel and the
            # fleet fold join SLO state to tenant rows on this key
            out["tenant"] = self.spec.tenant
        return out


class SLOEngine:  # wf-lint: single-writer[reporter, driver]
    """Evaluates a spec set once per Reporter tick and owns incident
    capture.  Single-writer by construction (the class-level annotation's
    rationale): ``observe`` runs on the Reporter tick thread while the run
    is live, and on the driver thread only for the final ``stop()`` emit —
    which the Reporter issues strictly AFTER joining the tick thread (the
    ``Reporter.ticks`` discipline)."""

    def __init__(self, specs: Sequence[SLOSpec], out_dir: Optional[str],
                 cooldown_s: float = 60.0, max_incidents: int = 8,
                 journal_path: Optional[str] = None,
                 fingerprint: Optional[Callable[[], dict]] = None,
                 journal: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        specs = list(specs or [])
        if not specs:
            raise ValueError("SLOEngine needs at least one SLOSpec")
        problems = []
        seen = set()
        for s in specs:
            problems += [f"slo[{s.name}]: {p}" for p in spec_problems(s)]
            if s.name in seen:
                problems.append(f"slo[{s.name}]: duplicate SLO name")
            seen.add(s.name)
        if problems:
            raise ValueError("invalid SLO spec set (the validator reports "
                             "these as WF116 before the run): "
                             + "; ".join(problems))
        self.specs = specs
        self.out_dir = out_dir
        self.cooldown_s = float(cooldown_s)
        self.max_incidents = int(max_incidents)
        self.journal_path = journal_path
        self.fingerprint = fingerprint
        self.journal = bool(journal)
        self._clock = clock
        self._states = [_SLOState(s) for s in specs]
        self._prev: Optional[dict] = None
        self._tick = 0
        self.incidents_captured = 0
        self.incidents_suppressed = 0
        self._last_capture: Optional[float] = None
        #: when set (an EventJournal), transition events go to THIS journal
        #: instead of the process-global active one — the fleet aggregator
        #: runs an engine over the MERGED view inside a process that may
        #: also be a monitored host, and its fleet pages must land in the
        #: fleet events.jsonl, never the co-resident host's
        self.journal_sink = None
        #: per-tick verdict subscriber (``fn(snap)``), called AFTER the
        #: ``"slo"`` section is folded and BEFORE incident capture — the
        #: remediation engine (control/remediation.py) rides here, so the
        #: actions it takes on the triggering tick land inside the
        #: triggering bundle.  Same thread as observe (Reporter); a hook
        #: failure is recorded on the snapshot, never kills the tick
        self.verdict_hook = None
        #: the bound RemediationEngine (or None): duck-typed — incident
        #: capture asks it for ``section()`` to commit ``remediation.json``
        #: into every bundle before the manifest
        self.remediation = None
        #: profile-on-page hook (or None): ``fn(dir) -> dict`` run at
        #: capture time (``observability/profiling.py`` ProfileOnPage) —
        #: the returned summary (a capture manifest or a recorded
        #: ``profile_skipped`` reason) commits as ``profile.json`` BEFORE
        #: the bundle manifest, with the raw capture under ``<bundle>/
        #: profile/``.  Same verdict_hook wiring convention (Monitor binds
        #: it); same thread (Reporter tick); must never raise
        self.profiler = None
        self._incoming_slo = None

    # -- evaluation --------------------------------------------------------

    def observe(self, snap: dict) -> dict:
        """One tick: extract every signal, advance the burn windows, run the
        state machines, journal transitions, run the verdict hook, capture
        incidents on PAGE entry, and fold the ``"slo"`` section into
        ``snap`` (returned)."""
        self._tick += 1
        sec: Dict[str, dict] = {}
        paged = []
        #: the slo section as the snapshot ARRIVED (the merged host fold on
        #: a fleet aggregator — carries worst_host/pages_by_host).  Capture
        #: used to run before the ``snap["slo"] = sec`` fold and read it
        #: from snap directly; now that the verdict hook runs in between,
        #: subclasses (FleetSLOEngine.correlation) read it from here
        self._incoming_slo = snap.get("slo")
        for st in self._states:
            spec = st.spec
            if spec.signal in TENANT_SIGNALS:
                extractor, _mode = TENANT_SIGNALS[spec.signal]
                value = extractor(snap, self._prev, spec.tenant)
            else:
                extractor, _mode = SIGNALS[spec.signal]
                value = extractor(snap, self._prev)
            if value is not None:
                st.last_value = round(float(value), 6)
                st.window.append(spec.violated(value))
                st.burn_fast = st._burn(int(spec.fast_window))
                st.burn_slow = st._burn(int(spec.slow_window))
                if self._step_state(st, snap):
                    paged.append(st)
            st.history.append((self._tick, st.last_value, st.burn_fast,
                               st.burn_slow, st.state))
            sec[spec.name] = st.row()
        snap["slo"] = sec
        # verdict hook BEFORE capture: remediation acts on this tick's
        # verdicts first, so the bundle a PAGE is about to commit records
        # the actions the page itself triggered
        if self.verdict_hook is not None:
            try:
                self.verdict_hook(snap)
            except Exception as e:  # noqa: BLE001 — a broken hook must not
                # kill the tick, and must not die silently: the snapshot
                # carries the error (the slo_error convention)
                snap["remediation_error"] = f"{type(e).__name__}: {e}"
        for st in paged:
            self._maybe_capture(st, snap)
        self._prev = snap
        return snap

    def _step_state(self, st: _SLOState, snap: dict) -> bool:
        """Advance one SLO's state machine; returns True on PAGE entry (the
        caller captures the incident AFTER the verdict hook has run)."""
        spec = st.spec
        before = st.state
        if st.state == STATE_PAGE:
            # sticky until the FAST window is clean — recovery must be
            # recent, not merely diluted across the slow window
            if st.burn_fast < spec.warn_burn:
                st.state = STATE_OK
        else:
            if (st.burn_fast >= spec.page_burn
                    and st.burn_slow >= spec.page_burn):
                st.state = STATE_PAGE
            elif st.burn_fast >= spec.warn_burn:
                st.state = STATE_WARN
            else:
                st.state = STATE_OK
        if st.state == before:
            return False
        st.transitions.append((self._tick, before, st.state))
        if st.state == STATE_PAGE:
            st.pages += 1
            if self.journal:
                self._record("slo_page", slo=spec.name,
                             signal=spec.signal, value=st.last_value,
                             target=spec.target, burn_fast=st.burn_fast,
                             burn_slow=st.burn_slow, tick=self._tick)
            return True
        if st.state == STATE_OK and self.journal:
            self._record("slo_recover", slo=spec.name,
                         from_state=before, burn_fast=st.burn_fast,
                         burn_slow=st.burn_slow, tick=self._tick)
        return False

    def _record(self, name: str, **fields) -> None:
        if self.journal_sink is not None:
            self.journal_sink.event(name, **fields)
        else:
            _journal.record(name, **fields)

    def report(self) -> Dict[str, dict]:
        """Whole-run summary per SLO (the offline CLI's data model): the
        latest row plus the transition timeline, burn history, and the
        burning verdict (state != ok)."""
        out = {}
        for st in self._states:
            row = st.row()
            row["burning"] = st.state != STATE_OK
            row["transitions"] = [
                {"tick": t, "from": a, "to": b}
                for (t, a, b) in st.transitions]
            row["history"] = [
                {"tick": t, "value": v, "burn_fast": bf, "burn_slow": bs,
                 "state": s} for (t, v, bf, bs, s) in st.history]
            row["signal_name"] = st.spec.signal
            out[st.spec.name] = row
        return out

    # -- incident capture --------------------------------------------------

    def _maybe_capture(self, st: _SLOState, snap: dict) -> None:
        if self.out_dir is None:
            return
        now = self._clock()
        if self.incidents_captured >= self.max_incidents or (
                self._last_capture is not None
                and now - self._last_capture < self.cooldown_s):
            # rate limit: a restart storm re-paging every few ticks must not
            # bury the host under bundles — the journal still carries every
            # slo_page, so nothing is lost, only the forensics dedup'd
            self.incidents_suppressed += 1
            return
        try:
            self.capture_incident(st, snap)
        except OSError:
            return                        # disk trouble: never kill a tick
        self.incidents_captured += 1
        self._last_capture = now

    def capture_incident(self, st: _SLOState, snap: dict) -> str:
        """Write one forensic bundle for a paging SLO.  Every artifact goes
        through :func:`_atomic_write`; ``manifest.json`` lands LAST and is
        the commit point — a reader (``list_incidents``) treats a
        manifest-less directory as torn and never half-parses it."""
        stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime())
        name = f"{stamp}_t{self._tick}_{st.spec.name}"
        d = os.path.join(self.out_dir, "incidents", name)
        os.makedirs(d, exist_ok=True)
        files = []

        def put(fname: str, data: dict) -> None:
            _atomic_write(os.path.join(d, fname),
                          json.dumps(data, indent=1, sort_keys=True,
                                     default=str))
            files.append(fname)

        # the snapshot sections the post-mortem starts from
        put("sections.json", {
            "slo": snap.get("slo") or {k.spec.name: k.row()
                                       for k in self._states},
            "health": snap.get("health"),
            "shards": snap.get("shards"),
            "event_time": snap.get("event_time"),
            "e2e_latency_us": snap.get("e2e_latency_us"),
            "recovery": snap.get("recovery"),
            "queues": snap.get("queues"),
        })
        put("burn.json", {
            "slo": st.spec.name, "spec": dataclasses.asdict(st.spec),
            "timeline": [{"tick": t, "value": v, "burn_fast": bf,
                          "burn_slow": bs, "state": s}
                         for (t, v, bf, bs, s) in st.history],
            "transitions": [{"tick": t, "from": a, "to": b}
                            for (t, a, b) in st.transitions],
        })
        tail = self._journal_tail()
        if tail is not None:
            _atomic_write(os.path.join(d, "journal_tail.jsonl"), tail)
            files.append("journal_tail.jsonl")
        chrome = self._chrome_dump(tail)
        if chrome is not None:
            put("trace.json", chrome)
        put("config.json", self._config_fingerprint())
        if self.remediation is not None:
            # the action ledger as of THIS tick — the verdict hook ran
            # before capture, so the bundle records what the page triggered
            put("remediation.json", self.remediation.section())
        for fname, data in sorted(self._extra_bundle_files(st, snap).items()):
            put(fname, data)
        if self.profiler is not None:
            # profile-on-page: the bounded device capture (or its recorded
            # skip reason) commits BEFORE the manifest, so a committed
            # bundle either carries on-device evidence or says why not
            try:
                prof = self.profiler(os.path.join(d, "profile"))
            except Exception as e:  # noqa: BLE001 — forensics must never
                # kill the tick; ProfileOnPage already catches, this is the
                # belt for a user-supplied hook
                prof = {"profile_skipped": f"{type(e).__name__}: {e}"}
            put("profile.json", prof)
        # manifest LAST — the commit point
        _atomic_write(os.path.join(d, "manifest.json"), json.dumps({
            "schema": 1, "slo": st.spec.name, "signal": st.spec.signal,
            "state": st.state, "value": st.last_value,
            "target": st.spec.target, "burn_fast": st.burn_fast,
            "burn_slow": st.burn_slow, "tick": self._tick,
            "wall": time.time(), "files": files,
        }, indent=1, sort_keys=True))
        return d

    def _extra_bundle_files(self, st: _SLOState, snap: dict) -> dict:
        """Subclass hook: extra ``{filename: json-serializable}`` artifacts
        committed into the bundle BEFORE the manifest (so the manifest's
        ``files`` list covers them).  The base engine adds none; the fleet
        aggregator's engine adds ``correlation.json`` (which hosts paged in
        the same window — ``observability/fleet.py``)."""
        return {}

    def _journal_tail(self) -> Optional[str]:
        if not self.journal_path or not os.path.exists(self.journal_path):
            return None
        tail: Deque[str] = collections.deque(maxlen=_JOURNAL_TAIL_LINES)
        with open(self.journal_path) as f:
            for line in f:
                if line.endswith("\n"):   # a torn in-flight append is
                    tail.append(line)     # dropped, the loader convention
        return "".join(tail)

    def _chrome_dump(self, tail: Optional[str]) -> Optional[dict]:
        """Flight-recorder Chrome trace of the CURRENT ring, when a tracer
        is active (``Tracer.snapshot_chrome`` — the dump hook).  The journal
        events annotated onto the trace come from the already-read ``tail``
        window — the journal file is read ONCE per bundle and the parse is
        bounded by the same 256-line cap, so a paging tick on a service with
        hours of journal never stalls re-reading the whole file.  Lazy
        relative import: under the stdlib CLIs' synthetic package tracing is
        never loaded, and capture is never invoked there."""
        try:
            from . import tracing as _tracing
        except ImportError:
            return None
        tr = _tracing.get_active()
        if tr is None:
            return None
        try:
            jevents = None
            if tail:
                jevents = []
                for line in tail.splitlines():
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        jevents.append(json.loads(line))
                    except ValueError:
                        continue
            return tr.snapshot_chrome(journal_events=jevents)
        except Exception:   # noqa: BLE001 — forensics must never kill the
            return None     # reporter tick; the bundle just omits the trace

    def _config_fingerprint(self) -> dict:
        out = {"env": {k: v for k, v in sorted(os.environ.items())
                       if k.startswith("WF_")}}
        if self.fingerprint is not None:
            try:
                extra = self.fingerprint()
            except Exception:   # noqa: BLE001 — a half-built registry must
                extra = None    # not kill the capture; env still lands
            if extra:
                out.update(extra)
        return out


# ------------------------------------------------------ offline evaluation


def evaluate_series(specs: Sequence[SLOSpec],
                    series: Sequence[dict]) -> Dict[str, dict]:
    """Run the burn/state machine over a snapshot time series (the
    ``snapshots.jsonl`` semantics) without journaling or capturing —
    ``scripts/wf_slo.py``'s engine.  Input snapshots are not mutated."""
    eng = SLOEngine(specs, out_dir=None, journal=False)
    for snap in series:
        eng.observe(dict(snap))
    return eng.report()


def burning(report: Dict[str, dict]) -> List[str]:
    """Names of the SLOs whose FINAL state is not OK — the wf_slo.py
    exit-1 condition."""
    return sorted(n for n, row in report.items() if row.get("burning"))


# ------------------------------------------------------------ bundle reads


def list_incidents(mon_dir: str) -> Tuple[List[dict], List[str]]:
    """(committed bundles newest-last, torn directory names) under
    ``<mon_dir>/incidents``.  A bundle is its manifest plus ``path`` and a
    ``missing`` list of manifest-declared files that are absent/empty — the
    validation surface of ``wf_slo.py --json`` and the ``incidents``
    sections of ``wf_health.py``/``wf_state.py``."""
    root = os.path.join(mon_dir, "incidents")
    bundles, torn = [], []
    if not os.path.isdir(root):
        return bundles, torn
    for entry in sorted(os.listdir(root)):
        d = os.path.join(root, entry)
        if not os.path.isdir(d):
            continue
        mpath = os.path.join(d, "manifest.json")
        try:
            with open(mpath) as f:
                man = json.load(f)
        except (OSError, ValueError):
            torn.append(entry)            # crash mid-capture: manifest is
            continue                      # the commit point it never reached
        man = dict(man)
        man["path"] = d
        missing = []
        for fname in man.get("files", []):
            p = os.path.join(d, fname)
            if not os.path.exists(p) or os.path.getsize(p) == 0:
                missing.append(fname)
        man["missing"] = missing
        bundles.append(man)
    bundles.sort(key=lambda m: m.get("wall", 0.0))
    return bundles, torn


def incidents_summary(mon_dir: str) -> dict:
    """Compact cross-reference for the sibling CLIs: bundle count, torn
    count, and the newest bundle's path + triggering SLO."""
    bundles, torn = list_incidents(mon_dir)
    out: dict = {"count": len(bundles), "torn": len(torn)}
    if bundles:
        last = bundles[-1]
        out["last"] = {"path": last["path"], "slo": last.get("slo"),
                       "wall": last.get("wall"),
                       "state": last.get("state")}
    return out

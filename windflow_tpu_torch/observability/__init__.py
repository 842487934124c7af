"""Observability of the port: monitoring, event time, tracing, device health.

Counterpart of ``windflow_tpu/observability/``:

- :class:`MetricsRegistry` (``metrics.py``): graph-level aggregation of every
  ``Stats_Record``, latency histograms, watermark and queue-depth gauges,
  per-operator event-time sections, the ``health`` section; JSON snapshots
  and the Prometheus exposition.
- :class:`Reporter` (``reporter.py``): a daemon thread writing
  ``snapshot.json``, ``snapshots.jsonl`` and ``metrics.prom``.
- :class:`EventJournal` (``journal.py``): JSONL records and spans.
- ``topology.py``: dot and JSON export of the graph or pipeline.
- ``event_time.py``: lateness histograms in operator state.
- ``tracing.py``: per-batch causal tracing and the flight recorder.
- ``device_health.py``: memory, capture ledger and device-time split.

Everything is off by default and turned on per driver (``monitoring=``,
``trace=``) or process-wide::

    WF_MONITORING=1              # defaults: ./wf_monitoring, 1 s interval
    WF_MONITORING=/path/out      # same, custom output directory
    WF_MONITORING_INTERVAL=0.25  # reporter interval (seconds)
    WF_MONITORING_EVENT_TIME=1   # lateness histograms in operator state
    WF_MONITORING_HEALTH=1       # memory, capture ledger, device time
    WF_HEALTH_SAMPLE=N           # device-time split every Nth sampled push
    WF_SNAPSHOT_KEEP=500         # snapshots.jsonl keep-last-N retention
    WF_SLO=1                     # the SLO engine (slo.py): '1' default specs,
                                 # else a JSON path or inline JSON
    WF_SLO_COOLDOWN_S=60         # incident-bundle cooldown
    WF_SLO_MAX_INCIDENTS=8       # incident bundles a run
    WF_TELEMETRY=tcp://agg:9901  # fleet telemetry (fleet.py): '1' takes the
                                 # endpoint from WF_TELEMETRY_ENDPOINT
    WF_TELEMETRY_OUTBOX=64       # the agent's bounded outbox
    WF_TELEMETRY_HOST=name       # the host tag of its frames
    WF_REMEDIATION=1             # live remediation (control/remediation.py);
                                 # needs the SLO engine
    WF_PROFILE=1                 # profile-on-page (profiling.py); needs the
                                 # SLO engine

- ``slo.py``: the SLO engine, burn-rate alerting and incident bundles.
- ``profiling.py``: a bounded ``torch.profiler`` window in every bundle.
- ``fleet.py``: the telemetry agent and the fleet aggregator.

The validation errors are the JAX package's, word for word.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

from . import device_health, event_time, journal, names, profiling, tracing
from . import slo as slo_engine
from .journal import EventJournal, read_journal, set_active as set_journal
from .metrics import LogHistogram, MetricsRegistry
from .reporter import Reporter
from .topology import (graph_topology_dot, graph_topology_json,
                       pipeline_topology_dot, pipeline_topology_json,
                       topology_dot, topology_json)
from .tracing import TraceConfig, Tracer

__all__ = [
    "LogHistogram", "MetricsRegistry", "Reporter", "EventJournal",
    "MonitoringConfig", "Monitor", "journal", "names", "read_journal",
    "set_journal", "TraceConfig", "Tracer", "tracing", "event_time",
    "event_time_enabled", "device_health", "slo_engine", "profiling",
    "topology_dot", "topology_json", "graph_topology_dot",
    "graph_topology_json", "pipeline_topology_dot", "pipeline_topology_json",
]

@dataclasses.dataclass
class MonitoringConfig:
    """Resolved monitoring settings for one graph or pipeline run (the JAX
    package's fields; see its ``MonitoringConfig`` for each)."""

    out_dir: str = "wf_monitoring"
    interval_s: float = 1.0
    prometheus: bool = True
    journal: bool = True
    #: None: flush the journal per event; N: every N events
    journal_flush_interval: Optional[int] = None
    #: sample every Nth source batch for the end-to-end latency histogram
    e2e_sample_every: int = 4
    #: lateness histograms in operator state: resolved when a chain is
    #: built (it sizes state); off leaves state and launches unchanged, on
    #: changes the carried state only, never the results
    event_time: bool = False
    #: memory, capture ledger and sampled device-time split (host side)
    health: bool = False
    #: the device-time split on every Nth sampled service point (>= 1)
    health_sample: int = 1
    #: the SLO engine (``slo.py``): ``True`` (default specs), a list of
    #: ``SLOSpec``/dicts, or a JSON file path / inline JSON; evaluated in
    #: every Reporter tick, host side only
    slo: object = False
    #: seconds between incident bundles, and bundles a run
    slo_cooldown_s: float = 60.0
    slo_max_incidents: int = 8
    #: keep-last-N lines of snapshots.jsonl (None: unlimited)
    snapshot_keep: Optional[int] = None
    #: fleet telemetry (``fleet.py``): ``True`` (endpoint from
    #: ``WF_TELEMETRY_ENDPOINT``) or an endpoint string
    telemetry: object = False
    #: the telemetry agent's bounded drop-oldest outbox (>= 1)
    telemetry_outbox: int = 64
    #: live remediation (``control/remediation.py``) on the SLO verdicts:
    #: ``True`` (default policy), a policy or action list, or JSON; needs
    #: ``slo``
    remediation: object = False
    remediation_cooldown_s: float = 60.0
    remediation_max_actions: int = 8
    #: profile-on-page (``profiling.py``): ``True``, a ``ProfileConfig`` or
    #: ``False``; needs ``slo`` and a window below the reporter interval
    profile: object = False

    def should_sample_e2e(self, n: int) -> bool:
        """The e2e sampling policy of every driver: every Nth source batch,
        never batch #1 (its time is the first build, not latency)."""
        return n > 0 and n % self.e2e_sample_every == 0

    @classmethod
    def resolve(cls, monitoring: Union[None, bool, str, "MonitoringConfig"],
                ) -> Optional["MonitoringConfig"]:
        """Normalize ``monitoring=``: ``None`` consults ``WF_MONITORING``
        (``''``/``'0'`` off), ``False`` is off, ``True`` the defaults, a
        string the output directory, a config passes through; then the env
        overrides. None when monitoring is off."""
        if monitoring is False:
            return None
        if isinstance(monitoring, MonitoringConfig):
            cfg = monitoring
        elif isinstance(monitoring, str):
            cfg = cls(out_dir=monitoring)
        elif monitoring is True:
            cfg = cls()
        else:
            env = os.environ.get("WF_MONITORING", "")
            if env in ("", "0"):
                return None
            cfg = cls() if env == "1" else cls(out_dir=env)
        iv = os.environ.get("WF_MONITORING_INTERVAL")
        if iv:
            cfg = dataclasses.replace(cfg, interval_s=float(iv))
        et = os.environ.get("WF_MONITORING_EVENT_TIME")
        if et is not None and et != "":
            cfg = dataclasses.replace(cfg, event_time=et != "0")
        hv = os.environ.get("WF_MONITORING_HEALTH")
        if hv is not None and hv != "":
            cfg = dataclasses.replace(cfg, health=hv != "0")
        hs = os.environ.get("WF_HEALTH_SAMPLE", "")
        if hs:
            cfg = dataclasses.replace(cfg, health_sample=int(hs))
        sv = os.environ.get("WF_SLO")
        if sv is not None and sv != "":
            cfg = dataclasses.replace(
                cfg, slo=(False if sv == "0"
                          else (True if sv == "1" else sv)))
        sc = os.environ.get("WF_SLO_COOLDOWN_S", "")
        if sc:
            cfg = dataclasses.replace(cfg, slo_cooldown_s=float(sc))
        sm = os.environ.get("WF_SLO_MAX_INCIDENTS", "")
        if sm:
            cfg = dataclasses.replace(cfg, slo_max_incidents=int(sm))
        sk = os.environ.get("WF_SNAPSHOT_KEEP", "")
        if sk:
            cfg = dataclasses.replace(
                cfg, snapshot_keep=(int(sk) if sk != "0" else None))
        tv = os.environ.get("WF_TELEMETRY")
        if tv is not None and tv != "":
            cfg = dataclasses.replace(
                cfg, telemetry=(False if tv == "0"
                                else (True if tv == "1" else tv)))
        te = os.environ.get("WF_TELEMETRY_ENDPOINT", "")
        if te and cfg.telemetry is True:
            # '1' (kwarg or env) defers the address to the endpoint var;
            # an explicit endpoint string always wins
            cfg = dataclasses.replace(cfg, telemetry=te)
        tb = os.environ.get("WF_TELEMETRY_OUTBOX", "")
        if tb:
            cfg = dataclasses.replace(cfg, telemetry_outbox=int(tb))
        rv = os.environ.get("WF_REMEDIATION")
        if rv is not None and rv != "":
            cfg = dataclasses.replace(
                cfg, remediation=(False if rv == "0"
                                  else (True if rv == "1" else rv)))
        rc = os.environ.get("WF_REMEDIATION_COOLDOWN_S", "")
        if rc:
            cfg = dataclasses.replace(cfg, remediation_cooldown_s=float(rc))
        rm = os.environ.get("WF_REMEDIATION_MAX_ACTIONS", "")
        if rm:
            cfg = dataclasses.replace(cfg, remediation_max_actions=int(rm))
        from . import profiling as _profiling
        prof = _profiling.resolve_profile(
            cfg.profile if cfg.profile is not False else None)
        cfg = dataclasses.replace(cfg, profile=prof if prof else False)
        if cfg.profile is not False:
            probs = _profiling.profile_problems(
                cfg.profile,
                slo_on=cfg.slo not in (False, None, "", "0"),
                interval_s=cfg.interval_s)
            # profiler availability is a runtime concern (every capture
            # then records profile_skipped); the structural problems are
            # construction-time errors like WF118
            probs = [p for p in probs if "not importable" not in p]
            if probs:
                raise ValueError(
                    "invalid profile-on-page config (the validator "
                    "reports these as WF120 before the run): "
                    + "; ".join(probs))
        if cfg.remediation not in (False, None, "", "0"):
            if cfg.slo in (False, None, "", "0"):
                raise ValueError(
                    "remediation=/WF_REMEDIATION is on but the SLO engine "
                    "(slo=/WF_SLO) resolves off — remediation consumes SLO "
                    "verdicts, so there is nothing to act on (the validator "
                    "reports this as WF118 before the run)")
            if float(cfg.remediation_cooldown_s) < float(cfg.interval_s):
                raise ValueError(
                    f"remediation_cooldown_s/WF_REMEDIATION_COOLDOWN_S "
                    f"({cfg.remediation_cooldown_s}) must be >= the reporter "
                    f"interval ({cfg.interval_s}s) — a sub-tick cooldown "
                    f"cannot rate-limit anything (WF118 before the run)")
            if int(cfg.remediation_max_actions) < 1:
                raise ValueError(
                    f"remediation_max_actions/WF_REMEDIATION_MAX_ACTIONS "
                    f"must be >= 1, got {cfg.remediation_max_actions} "
                    f"(WF118 before the run)")
        if cfg.snapshot_keep is not None and int(cfg.snapshot_keep) < 1:
            raise ValueError(
                f"snapshot_keep/WF_SNAPSHOT_KEEP must be >= 1 (or unset "
                f"for unlimited), got {cfg.snapshot_keep}")
        if cfg.health and int(cfg.health_sample) < 1:
            raise ValueError(
                f"health_sample/WF_HEALTH_SAMPLE must be >= 1, got "
                f"{cfg.health_sample} (the validator reports this as WF113 "
                f"before the run)")
        return cfg


def _telemetry_host_tag() -> str:
    """The host tag telemetry frames carry (the aggregator's merge key):
    ``WF_TELEMETRY_HOST``, else ``host<rank>`` of an initialized
    ``torch.distributed`` group, else ``host0`` (one process, as the JAX
    package's ``jax.process_index()`` gives); the pid only when
    ``torch.distributed`` cannot be asked."""
    tag = os.environ.get("WF_TELEMETRY_HOST", "")
    if tag:
        return tag
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return f"host{dist.get_rank()}"
        return "host0"
    except Exception:  # noqa: BLE001 — a broken install: the pid is still
        return f"pid{os.getpid()}"          # unique on one box


def event_time_enabled(monitoring=None) -> bool:
    """Only the event-time sub-toggle of a ``monitoring=`` argument (off when
    monitoring itself is off): the chains call it at build time, because the
    histograms size operator state."""
    cfg = MonitoringConfig.resolve(monitoring)
    return bool(cfg is not None and cfg.event_time)


class Monitor:
    """Registry, reporter, journal and health ledger of one run, with the SLO
    engine, profile-on-page, the remediation engine and the telemetry agent
    when their sub-toggles are on (each refuses an unusable setting here,
    with the JAX package's error).
    ``start()`` starts the reporter thread and activates the journal and the
    ledger; ``finish(target)`` stops the reporter (a final snapshot), writes
    ``topology.dot``/``topology.json`` and closes the journal. ``finish`` is
    idempotent and runs in the drivers' ``finally``, so no thread outlives a
    failed run."""

    def __init__(self, config: MonitoringConfig, name: str = "pipegraph"):
        self.config = config
        os.makedirs(config.out_dir, exist_ok=True)
        self.health: Optional[device_health.HealthLedger] = (
            device_health.HealthLedger(sample_every=config.health_sample)
            if config.health else None)
        self.registry = MetricsRegistry(name, event_time=config.event_time,
                                        health_ledger=self.health)
        self.journal: Optional[EventJournal] = None
        journal_path = None
        if config.journal:
            journal_path = os.path.join(config.out_dir, "events.jsonl")
            self.journal = EventJournal(
                journal_path,
                flush_interval=config.journal_flush_interval)
        #: SLO engine (MonitoringConfig.slo): resolved here so a malformed
        #: spec set fails the run loudly at Monitor construction (the
        #: health_sample convention; validate() reports it as WF116
        #: pre-run), evaluated by the Reporter inside every tick
        self.slo: Optional[slo_engine.SLOEngine] = None
        specs = slo_engine.resolve_specs(config.slo)
        if specs:
            self.slo = slo_engine.SLOEngine(
                specs, out_dir=config.out_dir,
                cooldown_s=config.slo_cooldown_s,
                max_incidents=config.slo_max_incidents,
                journal_path=journal_path,
                fingerprint=self._config_fingerprint)
        #: profile-on-page (MonitoringConfig.profile): bound as the SLO
        #: engine's profiler hook so PAGE-entry incident captures commit a
        #: bounded device-profiler window (or its skip reason) into every
        #: bundle BEFORE the manifest.  Requires the SLO engine — profile
        #: on while slo resolves off is a construction-time ValueError
        #: (WF120 pre-run), mirroring remediation's WF118
        from . import profiling as _profiling
        prof_cfg = _profiling.resolve_profile(
            config.profile if config.profile is not False else None)
        if prof_cfg is not None:
            if self.slo is None:
                raise ValueError(
                    "profile=/WF_PROFILE is on but the SLO engine "
                    "(slo=/WF_SLO) is off — captures fire from PAGE entry "
                    "only, so there is nothing to trigger them (WF120 "
                    "before the run)")
            self.slo.profiler = _profiling.ProfileOnPage(prof_cfg)
        #: remediation engine (MonitoringConfig.remediation): resolved here
        #: so an unusable policy fails the run loudly at Monitor
        #: construction (the SLO-engine convention; validate() reports it
        #: as WF118 pre-run).  Subscribed to the SLO engine's per-tick
        #: verdicts; the drivers bind the actuators the run actually owns
        #: in run() (an unbound actuator skips loudly, never guesses)
        self.remediation = None
        from ..control import remediation as _remediation
        policy = _remediation.resolve_policy(config.remediation)
        if policy is not None:
            if self.slo is None:
                raise ValueError(
                    "remediation=/WF_REMEDIATION is on but the SLO engine "
                    "(slo=/WF_SLO) is off — remediation consumes SLO "
                    "verdicts (WF118 before the run)")
            probs = _remediation.policy_problems(
                policy, [s.name for s in specs])
            if probs:
                raise ValueError(
                    "invalid remediation policy (the validator reports "
                    "these as WF118 before the run): " + "; ".join(probs))
            self.remediation = _remediation.RemediationEngine(
                policy, cooldown_s=config.remediation_cooldown_s,
                max_actions=config.remediation_max_actions)
            self.slo.verdict_hook = self.remediation.on_verdicts
            self.slo.remediation = self.remediation
        #: fleet telemetry agent (MonitoringConfig.telemetry): constructed
        #: here so a missing/unparseable endpoint or an outbox < 1 fails
        #: the run loudly at Monitor construction (the SLO-engine
        #: convention; validate() reports it as WF117 pre-run).  The
        #: Reporter stamps its stats into every snapshot and offers the
        #: written snapshot after each tick — never blocking (fleet.py)
        self.telemetry = None
        if config.telemetry not in (False, None):
            from . import fleet
            endpoint = (config.telemetry
                        if isinstance(config.telemetry, str)
                        else os.environ.get("WF_TELEMETRY_ENDPOINT", ""))
            self.telemetry = fleet.TelemetryAgent(
                endpoint, host=_telemetry_host_tag(),
                out_dir=config.out_dir,
                outbox=config.telemetry_outbox,
                journal_path=journal_path, journal=self.journal)
        self.reporter = Reporter(self.registry, config.out_dir,
                                 interval_s=config.interval_s,
                                 prometheus=config.prometheus,
                                 slo_engine=self.slo,
                                 snapshot_keep=config.snapshot_keep,
                                 telemetry_agent=self.telemetry)
        self._finished = False

    def _config_fingerprint(self) -> dict:
        """Chain signatures for an incident bundle's config.json — WHICH
        compiled programs were live when the SLO paged (the TuningCache
        keying reused as provenance; the env half lives in slo.py)."""
        try:
            from ..control.autotune import chain_signature
        except ImportError:
            return {}
        sigs = []
        for ch in self.registry._iter_health_chains():
            try:
                sigs.append(chain_signature(ch.ops))
            except Exception:   # noqa: BLE001 — a half-built chain must not
                continue        # kill the incident capture
        return {"chain_signatures": sigs} if sigs else {}

    def start(self) -> None:
        if self.slo is not None and self.slo.profiler is not None:
            # profile-on-page captures on the Reporter's tick thread: the
            # process's first CUDA profiler session opens here, on the
            # thread that starts the Monitor (stats.profiler_init)
            from ..stats import profiler_init
            profiler_init()
        if self.journal is not None:
            set_journal(self.journal)
            self.journal.event("monitoring_start", graph=self.registry.name,
                               interval_s=self.config.interval_s)
        if self.health is not None:
            device_health.set_active(self.health)
        if self.telemetry is not None:
            self.telemetry.start()
        self.reporter.start()

    def finish(self, target=None) -> None:
        if self._finished:
            return
        self._finished = True
        try:
            self.reporter.stop(final=True)
            if target is not None:
                snap = self.registry.snapshot()
                with open(os.path.join(self.config.out_dir,
                                       "topology.dot"), "w") as f:
                    f.write(topology_dot(target, snap))
                with open(os.path.join(self.config.out_dir,
                                       "topology.json"), "w") as f:
                    json.dump(topology_json(target, snap), f, indent=1)
        finally:
            if self.telemetry is not None:
                # after reporter.stop: the final emit's frame gets its
                # best-effort flush window before the sender goes away
                self.telemetry.close()
            if (self.health is not None
                    and device_health.get_active() is self.health):
                device_health.set_active(None)
            if self.journal is not None:
                self.journal.event("monitoring_end",
                                   graph=self.registry.name)
                if journal.get_active() is self.journal:
                    set_journal(None)
                self.journal.close()

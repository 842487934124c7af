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

Not ported, and refused by name: the SLO engine (``slo=``, ``WF_SLO``),
profile-on-page (``profile=``, ``WF_PROFILE``) and fleet telemetry
(``telemetry=``, ``WF_TELEMETRY``) are ROADMAP Queue 1 item 16b. Live
remediation (``remediation=``, ``WF_REMEDIATION``) consumes the SLO
engine's verdicts: with ``slo`` off it raises the JAX package's
``ValueError``, with ``slo`` on the item-16b refusal comes first. The
supervised drivers' barrier remediation runs (``control/remediation.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

from . import device_health, event_time, journal, names, tracing
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
    "event_time_enabled", "device_health",
    "topology_dot", "topology_json", "graph_topology_dot",
    "graph_topology_json", "pipeline_topology_dot", "pipeline_topology_json",
]

#: sub-toggles of the JAX package's MonitoringConfig that the port refuses:
#: (field, env var, ROADMAP item)
_UNPORTED = (("slo", "WF_SLO", "16b"), ("profile", "WF_PROFILE", "16b"),
             ("telemetry", "WF_TELEMETRY", "16b"))


def _on(v) -> bool:
    return v not in (False, None, "", "0")


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
    #: keep-last-N lines of snapshots.jsonl (None: unlimited)
    snapshot_keep: Optional[int] = None
    #: refused: ROADMAP Queue 1 item 16b
    slo: object = False
    profile: object = False
    telemetry: object = False
    #: live remediation: needs ``slo`` (item 16b)
    remediation: object = False
    remediation_cooldown_s: float = 60.0
    remediation_max_actions: int = 8

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
        sk = os.environ.get("WF_SNAPSHOT_KEEP", "")
        if sk:
            cfg = dataclasses.replace(
                cfg, snapshot_keep=(int(sk) if sk != "0" else None))
        rv = os.environ.get("WF_REMEDIATION")
        if rv is not None and rv != "":
            cfg = dataclasses.replace(
                cfg, remediation=(False if rv == "0" else (True if rv == "1" else rv)))
        rc = os.environ.get("WF_REMEDIATION_COOLDOWN_S", "")
        if rc:
            cfg = dataclasses.replace(cfg, remediation_cooldown_s=float(rc))
        rm = os.environ.get("WF_REMEDIATION_MAX_ACTIONS", "")
        if rm:
            cfg = dataclasses.replace(cfg, remediation_max_actions=int(rm))
        for field, var, item in _UNPORTED:
            if _on(getattr(cfg, field)) or _on(os.environ.get(var, "")):
                raise NotImplementedError(
                    f"monitoring {field}= / {var} is not ported yet "
                    f"(ROADMAP Queue 1 item {item})")
        if _on(cfg.remediation):
            # with slo on, the item-16b refusal above came first
            raise ValueError(
                "remediation=/WF_REMEDIATION is on but the SLO engine "
                "(slo=/WF_SLO) resolves off — remediation consumes SLO "
                "verdicts, so there is nothing to act on (the validator "
                "reports this as WF118 before the run)")
        if cfg.snapshot_keep is not None and int(cfg.snapshot_keep) < 1:
            raise ValueError(
                f"snapshot_keep/WF_SNAPSHOT_KEEP must be >= 1 (or unset "
                f"for unlimited), got {cfg.snapshot_keep}")
        if cfg.health and int(cfg.health_sample) < 1:
            raise ValueError(
                f"health_sample/WF_HEALTH_SAMPLE must be >= 1, got "
                f"{cfg.health_sample}")
        return cfg


def event_time_enabled(monitoring=None) -> bool:
    """Only the event-time sub-toggle of a ``monitoring=`` argument (off when
    monitoring itself is off): the chains call it at build time, because the
    histograms size operator state."""
    cfg = MonitoringConfig.resolve(monitoring)
    return bool(cfg is not None and cfg.event_time)


class Monitor:
    """Registry, reporter, journal and health ledger of one run.
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
        if config.journal:
            self.journal = EventJournal(
                os.path.join(config.out_dir, "events.jsonl"),
                flush_interval=config.journal_flush_interval)
        self.reporter = Reporter(self.registry, config.out_dir,
                                 interval_s=config.interval_s,
                                 prometheus=config.prometheus,
                                 snapshot_keep=config.snapshot_keep)
        self._finished = False

    def start(self) -> None:
        if self.journal is not None:
            set_journal(self.journal)
            self.journal.event("monitoring_start", graph=self.registry.name,
                               interval_s=self.config.interval_s)
        if self.health is not None:
            device_health.set_active(self.health)
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
            if (self.health is not None
                    and device_health.get_active() is self.health):
                device_health.set_active(None)
            if self.journal is not None:
                self.journal.event("monitoring_end",
                                   graph=self.registry.name)
                if journal.get_active() is self.journal:
                    set_journal(None)
                self.journal.close()

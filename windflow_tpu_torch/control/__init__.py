"""Adaptive control plane: closed-loop micro-batch autotuning, backpressure,
load-shedding admission control and remediation.

Counterpart of ``windflow_tpu/control/``, with the same exports:

- ``autotune.py``: :class:`CapacityAutotuner`, a power-of-two capacity
  ladder hill-climbed on measured tuples/s, switching among programs made
  ready for each rung before the run (``CompiledChain.warm``), with a JSON
  :class:`TuningCache` keyed by (chain signature, payload spec, device kind)
  for warm starts; actuated by the ``Pipeline`` driver through a
  :class:`Rebatcher` at the ingest boundary. The same hill-climber tunes the
  scan-dispatch K (``runtime/dispatch.py``).
- ``governor.py``: :class:`BackpressureGovernor`, per-edge high/low
  watermarks over the native rings' depths; throttles the source loop and
  pauses the prefetch worker when a downstream stage falls behind. Actuated
  by ``ThreadedPipeline`` and the threaded ``PipeGraph`` driver.
- ``admission.py``: :class:`AdmissionController`, token-bucket rate limiting
  (:class:`TokenBucket` on the wall clock, :class:`PositionBucket` by stream
  position, replay-stable) and a shed policy at every driver's ingest.
- ``remediation.py``: policies mapping burn signatures to these actuators;
  the supervised drivers run its deterministic :class:`BarrierRemediation`
  at their commit barriers (``remediation=`` / ``WF_REMEDIATION``).

Everything is off by default and turned on per driver with ``control=``
(True, a dict of :class:`ControlConfig` fields, a config) or process-wide
with ``WF_CONTROL``. Every decision is counted (the snapshot's ``control``
section) and journaled (``shed``, ``throttle``, ``capacity_switch``,
``tuning_converged``, ``tuning_warm_start``, ``remediation_apply``, ...).
"""

from ._state import bump, counters, gauges, reset, set_gauge
from .admission import (AdmissionController, PositionBucket, TokenBucket,
                        admission_from_config, admission_group,
                        bucket_from_config)
from .autotune import (CapacityAutotuner, Rebatcher, TuningCache,
                       build_ladder, chain_signature, device_kind,
                       dispatch_tuning_key, payload_signature, tuning_key)
from .config import ControlConfig
from .governor import BackpressureGovernor, governor_from_config
from .remediation import (ACTUATORS, BarrierRemediation, RemediationAction,
                          RemediationEngine, RemediationPolicy,
                          barrier_policy_problems, default_barrier_policy,
                          default_policy, resolve_barrier_policy,
                          resolve_policy)

__all__ = [
    "ControlConfig", "AdmissionController", "TokenBucket", "PositionBucket",
    "BackpressureGovernor", "CapacityAutotuner", "Rebatcher", "TuningCache",
    "build_ladder", "chain_signature", "payload_signature", "device_kind",
    "tuning_key", "dispatch_tuning_key", "admission_from_config",
    "admission_group", "bucket_from_config", "governor_from_config",
    "RemediationAction", "RemediationPolicy", "RemediationEngine",
    "BarrierRemediation", "ACTUATORS", "default_policy", "resolve_policy",
    "default_barrier_policy", "resolve_barrier_policy",
    "barrier_policy_problems",
    "counters", "gauges", "reset", "bump", "set_gauge",
]

"""Multi-tenant admission — per-tenant token buckets over one serving run.

Counterpart of ``windflow_tpu/serving/tenants.py``, a copy over the port's
``control/admission.py``.

Every ingest frame carries a tenant label (``serving/framing.py``); this
module turns a declarative :class:`TenantSpec` set into one
:class:`~windflow_tpu_torch.control.admission.AdmissionController` per tenant, so
one noisy tenant is rate-limited/shed inside its OWN bucket while its
neighbors' budgets are untouched.  The per-tenant counters surface as the
snapshot's ``serving.tenants`` section (``names.py::TENANT_GAUGES``), the
SLO engine reads them through the tenant-labelled signal family
(``observability/slo.py::TENANT_SIGNALS``), and the fleet fold keeps them
per-tenant (``device_health.merge_snapshots``) — the whole isolation story
rides one label dimension end to end.

Bucket flavours follow the admission plane's replay discipline exactly:
``rate_tps`` builds a wall-clock :class:`TokenBucket` (live drivers only);
``refill_per_batch`` builds the deterministic :class:`PositionBucket`
supervised replay requires — a supervised serving run with a wall-clock
tenant bucket is a construction-time error here and WF119 pre-run.

``TenantSpec``/``resolve_tenants``/``tenant_problems`` are stdlib-only; only
:func:`build_registry` imports the control plane.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

#: shed policies a tenant may declare (the admission plane's registry;
#: duplicated as data so this module stays path-loadable without package
#: imports — control/admission.py raises on anything else anyway)
SHED_POLICIES = ("drop_newest", "drop_oldest_ts")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's admission contract.

    Exactly one of ``rate_tps`` (wall-clock tuples/second — live serving
    only) or ``refill_per_batch`` (deterministic tokens per offered batch —
    REQUIRED under supervision) may be set; neither means the tenant is
    rate-unlimited (counted, never shed).  ``burst`` defaults to the
    admission plane's burst-sizing policy (4 base batches)."""

    id: str
    rate_tps: Optional[float] = None
    refill_per_batch: Optional[float] = None
    burst: Optional[float] = None
    shed_policy: str = "drop_newest"


def tenant_problems(spec: TenantSpec) -> List[str]:
    """Every reason this tenant spec cannot be honored — THE shared legality
    check of :func:`build_registry`, the WF119 validator, and ``wf_lint
    --explain WF119``'s story.  Empty list = clean."""
    out = []
    if not spec.id or not str(spec.id).strip():
        out.append("tenant has an empty id")
    if spec.rate_tps is not None and spec.refill_per_batch is not None:
        out.append(f"tenant {spec.id!r}: rate_tps and refill_per_batch are "
                   f"mutually exclusive — one bucket per tenant, one refill "
                   f"law")
    for fname in ("rate_tps", "refill_per_batch", "burst"):
        v = getattr(spec, fname)
        if v is not None and not float(v) > 0:
            out.append(f"tenant {spec.id!r}: {fname} must be > 0, got {v}")
    if spec.shed_policy not in SHED_POLICIES:
        out.append(f"tenant {spec.id!r}: unknown shed policy "
                   f"{spec.shed_policy!r} (policies: "
                   f"{', '.join(SHED_POLICIES)})")
    return out


def _spec_from_dict(d: dict) -> TenantSpec:
    allowed = {f.name for f in dataclasses.fields(TenantSpec)}
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(f"unknown TenantSpec field(s) {sorted(unknown)} "
                         f"(allowed: {sorted(allowed)})")
    if "id" not in d:
        raise ValueError(f"a tenant spec needs at least an id, got "
                         f"{sorted(d)}")
    return TenantSpec(**d)


def resolve_tenants(tenants) -> Optional[List[TenantSpec]]:
    """Normalize a ``tenants=`` argument (after its ``WF_TENANTS`` env
    resolution): ``None``/``False``/``''``/``'0'`` = off (None), a
    list/tuple of ``TenantSpec``/dicts passes through, a string is inline
    JSON (when it starts with ``[``/``{``) or a JSON file path.  JSON top
    level: a list of tenant dicts, or ``{"tenants": [...]}``.  Raises
    ``ValueError`` on malformed input — surfaced pre-run as WF119."""
    if tenants is None or tenants is False:
        return None
    if isinstance(tenants, str):
        s = tenants.strip()
        if s in ("", "0"):
            return None
        if s.startswith("[") or s.startswith("{"):
            data = json.loads(s)
        else:
            with open(s) as f:
                data = json.load(f)
        if isinstance(data, dict):
            data = data.get("tenants")
        if not isinstance(data, list):
            raise ValueError(f"tenant JSON must be a list of tenant objects "
                             f"(or {{'tenants': [...]}}), got "
                             f"{type(data).__name__}")
        return [_spec_from_dict(dict(d)) for d in data]
    if isinstance(tenants, (list, tuple)):
        out = []
        for item in tenants:
            if isinstance(item, TenantSpec):
                out.append(item)
            elif isinstance(item, dict):
                out.append(_spec_from_dict(dict(item)))
            else:
                raise ValueError(f"tenants entries must be TenantSpec or "
                                 f"dict, got {type(item).__name__}")
        return out or None
    raise ValueError(f"tenants= accepts None/str/list, got "
                     f"{type(tenants).__name__}")


def registry_problems(specs: List[TenantSpec], *,
                      supervised: bool = False) -> List[str]:
    """Set-level legality: per-spec problems + duplicate ids + the
    supervised wall-clock rejection (the WF119 surface)."""
    out = []
    seen = set()
    for s in specs:
        out += [f"tenant[{s.id}]: {p}" for p in tenant_problems(s)]
        if s.id in seen:
            out.append(f"tenant[{s.id}]: duplicate tenant id — every "
                       f"counter/SLO/shed surface keys on it")
        seen.add(s.id)
        if supervised and s.rate_tps is not None:
            out.append(f"tenant[{s.id}]: wall-clock rate_tps under "
                       f"supervision — replay cannot re-derive clock-driven "
                       f"shed decisions; declare refill_per_batch instead "
                       f"(the PositionBucket discipline)")
    return out


class TenantRegistry:
    """Per-tenant admission controllers + the counters every plane reads.

    Built by :func:`build_registry`.  ``offer`` routes one batch through
    its tenant's controller (unknown tenants are admitted unlimited but
    counted — shedding traffic nobody declared a budget for would be a
    silent outage); ``counters`` renders the snapshot section;
    ``scale_rate`` is the per-tenant remediation actuator, and
    ``state``/``set_state`` ride the supervisor snapshot so replay re-sheds
    identically."""

    def __init__(self, specs: List[TenantSpec], controllers: Dict[str, object]):
        self.specs = list(specs)
        self._by_id = {s.id: s for s in specs}
        self._controllers = controllers         # tenant id -> controller|None
        # single-writer: the serving drive loop is one thread; the Reporter
        # only reads the ints (torn reads are fine for gauges)
        self._offered: Dict[str, int] = {s.id: 0 for s in specs}
        #: restore-spanning shed tuple totals, advanced by per-offer deltas
        #: of the controller's own shed ledger (ctl.shed_tuples) — NEVER by
        #: inferring shed from an empty offer() return, which conflates
        #: shed with held under drop_oldest_ts
        self._shed_tuples: Dict[str, int] = {s.id: 0 for s in specs}
        self.unknown_offered = 0

    @property
    def ids(self) -> List[str]:
        return [s.id for s in self.specs]

    def offer(self, tenant: str, batch, pos=None) -> list:
        ctl = self._controllers.get(tenant)
        if tenant not in self._by_id:
            self.unknown_offered += 1
            return [batch]
        self._offered[tenant] += 1
        if ctl is None:                         # declared, rate-unlimited
            return [batch]
        before = ctl.shed_tuples
        admitted = ctl.offer(batch, pos=pos, stream=tenant)
        # the controller's shed ledger is the only truth: an empty return
        # does NOT mean shed (drop_oldest_ts holds the batch for a later
        # offer()/drain() to admit), and a non-empty return may have shed
        # an older held batch
        self._shed_tuples[tenant] += ctl.shed_tuples - before
        return admitted

    def drain(self) -> list:
        out = []
        for ctl in self._controllers.values():
            if ctl is not None:
                out.extend(ctl.drain())
        return out

    def scale_rate(self, tenant: str, factor: float,
                   floor: float = 1.0) -> dict:
        """The ``tenant_rate`` remediation actuator: tighten ONE tenant's
        bucket, neighbors untouched (control/remediation.py binds here)."""
        ctl = self._controllers.get(tenant)
        if ctl is None:
            raise ValueError(f"tenant {tenant!r} has no rate bucket to "
                             f"scale (unknown id or rate-unlimited spec)")
        out = ctl.scale_rate(factor, floor)
        out["tenant"] = tenant
        return out

    def counters(self) -> Dict[str, dict]:
        """The ``serving.tenants`` snapshot rows (names.py::TENANT_GAUGES):
        offered/admitted/shed batch counts, shed tuple count, and the live
        bucket rate — everything the tenant SLO signals and the wf_top
        panel need."""
        out = {}
        for s in self.specs:
            ctl = self._controllers.get(s.id)
            row = {"offered": self._offered[s.id],
                   "admitted": (ctl.admitted if ctl is not None
                                else self._offered[s.id]),
                   "shed": ctl.shed if ctl is not None else 0,
                   "shed_tuples": self._shed_tuples[s.id]}
            if ctl is not None:
                row["rate"] = round(float(ctl.current_rate()), 3)
            out[s.id] = row
        return out

    # -- supervised snapshot/restore -----------------------------------

    def state(self) -> dict:
        # shed_tuples rides the registry (not the controller snapshot,
        # whose shape is pinned) — restored totals keep accumulating via
        # the per-offer delta discipline in offer()
        return {
            "tenants": {tid: ctl.state()
                        for tid, ctl in self._controllers.items()
                        if ctl is not None},
            "offered": dict(self._offered),
            "shed_tuples": dict(self._shed_tuples),
        }

    def set_state(self, st: dict) -> None:
        for tid, sub in (st.get("tenants") or {}).items():
            ctl = self._controllers.get(tid)
            if ctl is not None:
                ctl.set_state(sub)
        self._offered.update({k: int(v)
                              for k, v in (st.get("offered") or {}).items()})
        self._shed_tuples.update(
            {k: int(v) for k, v in (st.get("shed_tuples") or {}).items()})


def build_registry(tenants, base_capacity: int, *,
                   supervised: bool = False) -> Optional[TenantRegistry]:
    """Resolve + validate a tenant set and build its per-tenant controllers
    (None when tenants are off).  Raises ``ValueError`` on an unusable set
    — the validator reports the same problems as WF119 pre-run."""
    specs = resolve_tenants(tenants)
    if not specs:
        return None
    probs = registry_problems(specs, supervised=supervised)
    if probs:
        raise ValueError("invalid tenant set (the validator reports these "
                         "as WF119 before the run): " + "; ".join(probs))
    from ..control.admission import (AdmissionController, PositionBucket,
                                     TokenBucket)
    controllers: Dict[str, object] = {}
    for s in specs:
        burst = max(float(s.burst or 4 * base_capacity),
                    float(base_capacity))
        if s.refill_per_batch is not None:
            bucket = PositionBucket(s.refill_per_batch, burst)
        elif s.rate_tps is not None:
            bucket = TokenBucket(s.rate_tps, burst)
        else:
            controllers[s.id] = None            # declared, rate-unlimited
            continue
        controllers[s.id] = AdmissionController(
            bucket, s.shed_policy, driver=f"serving[{s.id}]")
    return TenantRegistry(specs, controllers)

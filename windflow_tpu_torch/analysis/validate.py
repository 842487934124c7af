"""Graph validator — Pillar 1 of the port's static-analysis layer.

Counterpart of ``windflow_tpu/analysis/validate.py``. Flows per-tuple specs
(meta tensors) through every operator of a built (but not yet run) driver —
``PipeGraph`` / ``Pipeline`` / ``ThreadedPipeline`` / ``SupervisedPipeline``
/ ``ServingRuntime`` / a raw ``CompiledChain`` — via the operators'
``out_spec`` probes, which run abstractly on the meta device
(``batch.abstract_spec``, the counterpart of ``jax.eval_shape``), and checks
the run configuration (fault plans, governor watermarks, admission control,
prefetch, dispatch, shards, monitoring, serving) against the invariants the
runtime otherwise only enforces mid-stream. Zero FLOPs, zero device access:
validating a chain built on the card launches no kernel and allocates no
memory there.

Standing differences from the JAX package: WF102 (a weak-typed payload
leaf) is registered but cannot fire, since torch has no weak types; WF109
names the captured CUDA graphs that still replay a stale kernel choice;
WF114's geometry warning names the port's kernels (K5's shared-memory
table); WF120 has no availability probe (the port's profiler is
``torch.profiler``, always importable).

Diagnostics carry stable codes (negative tests pin each one):

====== ========= =====================================================
code   severity  condition
====== ========= =====================================================
WF100  error     nothing to validate (graph without sources / empty)
WF101  error     operator rejects its input payload spec (chained spec
                 mismatch, bad split function, source spec failure)
WF102  warning   operator introduces a weak-typed payload leaf (Python
                 scalar promotion — a silent retrace hazard). Torch has
                 no weak types: registered, it cannot fire in the port
WF103  warn/err  fault-plan site unknown (error) or never threaded
                 through the chosen driver (warning — the fault would
                 silently never fire)
WF104  warning   backpressure watermarks degenerate against an edge's
                 ring capacity (resolved high >= capacity: throttle
                 can only trigger on a completely full ring; resolved
                 low >= high: the clamp forces low = high - 1)
WF105  error     admission control illegal under supervision (wall-
                 clock TokenBucket or a drop_oldest_ts holding cell —
                 shed decisions would not replay deterministically)
WF106  warning   prefetch depth exceeds the first ring's capacity
                 (prefetched batches pile up behind a full ring; the
                 governor's pause hook cannot help at that granularity)
WF107  warning   dangling branch: a pipe with no sink, no in-graph
                 ReduceSink, and no downstream edge — its output is
                 silently discarded
WF108  error     trace config illegal / non-deterministic under the
                 chosen driver (unparseable WF_TRACE/WF_TRACE_SAMPLE;
                 ``ids="sequence"`` under supervision — a replay after
                 restore would mint fresh ids and orphan every
                 exemplar and ring-edge flow)
WF109  warning   kernel impl recorded at resolution disagrees with the
                 current registry/env selection (``ops/registry.py``):
                 a captured CUDA graph keeps the kernels it was
                 captured with, so the toggle the operator thinks is
                 active is NOT what the replay runs — the diagnostic
                 names the graphs (a bench would silently measure the
                 same implementation twice)
WF111  error     join operator configuration the watermark machinery
                 cannot honor: an interval join with an empty match
                 window (lower > upper), bounds incompatible with the
                 configured watermark delay (upper + delay < 0 — the
                 eviction rule removes every in-window right tuple
                 before any left probe can arrive), or a two-input join
                 whose per-side event-time extractors resolve different
                 dtypes over the upstream pipes' specs (a silent
                 promotion inside every watermark compare)
WF112  error     session-window gap under a CB-only source: every
                 source feeding the session operator assigns no event
                 time (ts defaults to the arrival index), so the gap —
                 defined in event-time units — fires on arrival
                 positions instead
WF113  error     runtime-health config the run cannot honor: the
                 ``WF_MONITORING_HEALTH`` sub-toggle set while
                 monitoring itself resolves off (the ledger could
                 never activate — the run would silently produce no
                 health artifacts), or an illegal
                 ``WF_HEALTH_SAMPLE`` (non-integer / < 1)
WF116  error     SLO config the run cannot honor
                 (``observability/slo.py``): the ``WF_SLO`` sub-toggle
                 set while monitoring itself resolves off (the engine
                 could never evaluate — no burn-rate alerting, no
                 incident capture), a spec set that does not resolve
                 (malformed JSON / unreadable file / bad field), an
                 unknown signal name, or per-spec geometry the burn
                 math rejects (``fast_window >= slow_window``,
                 objective outside (0, 1), ``warn_burn > page_burn``)
WF117  error     telemetry config the run cannot honor
                 (``observability/fleet.py``): the ``WF_TELEMETRY``
                 sub-toggle set while monitoring itself resolves off
                 (the agent rides the Reporter tick — no frames could
                 ever stream), a telemetry endpoint that does not
                 parse (``tcp://HOST:PORT`` / ``unix:///path.sock``),
                 or an outbox capacity < 1 (cannot hold one frame)
WF118  error     remediation config the run cannot honor
                 (``control/remediation.py``): ``WF_REMEDIATION`` set
                 while monitoring itself resolves off (live mode rides
                 the SLO engine's Reporter-tick verdicts — no action
                 could ever fire), remediation on while the SLO engine
                 is off, a policy that does not resolve (unknown
                 actuator / unknown SLO name / unparseable gate), a
                 cooldown below the reporter tick, an action naming an
                 actuator the run config does not own (admission rate
                 without an admission bucket, autotune re-climb with
                 the tuner off, reshard under a live driver), or — on
                 the supervised drivers — an action whose actuator has
                 no deterministic barrier signal (replay could not
                 re-derive it)
WF119  error     serving config the run cannot honor
                 (``serving/config.py``): serving on (``serving=``/
                 ``WF_SERVE``) while monitoring itself resolves off
                 (tenant counters, per-tenant SLOs, and ``graph_swap``
                 spans all live in the monitoring snapshot/journal),
                 an endpoint that does not parse, a tenant set that
                 does not resolve / duplicate tenant ids, wall-clock
                 tenant buckets (``rate_tps``) under supervision (the
                 WF105 mirror — shed decisions would not replay),
                 ``replay`` < 1, ``swap_warm=False`` (the incoming
                 chain would compile inside the swap quiesce, stalling
                 live traffic), or an SLO spec whose ``tenant=`` label
                 names an undeclared tenant (the SLO idles at OK
                 forever)
WF120  error     profile-on-page config the run cannot honor
                 (``observability/profiling.py``): profiling on
                 (``profile=``/``WF_PROFILE``) while the SLO engine
                 resolves off (captures fire from PAGE entry only),
                 or a capture window that reaches the reporter
                 interval (the capture runs ON the Reporter tick
                 thread, so such a window stacks ticks)
WF114  warn/err  tiered keyed state (``windflow_tpu_torch/state``) combined
                 with a configuration its determinism/sizing contract
                 cannot honor: sequence-id tracing or wall-clock
                 admission under supervision (error — the ordered
                 re-admission callbacks must replay against an
                 identical admitted stream, the WF105/WF108 mirror); a
                 hot table that does not clear its per-batch admission
                 reserve (error — the zero-overflow-drop guarantee is
                 structurally broken); a hot table too large for K5's
                 shared-memory table (warning — ``ops/lookup.py::
                 JOIN_PROBE_SMEM_SLOTS``: the hot probe reads the
                 table through L2 instead, correct but slower; the
                 cold tier is read by ``cold_probe``, one thread a
                 lane, at any width)
WF110  warn/err  scan dispatch (K > 1) combined with a configuration
                 the fused launch cannot honor: an unresolvable
                 ``dispatch=``/``WF_DISPATCH`` (error);
                 ``ids="sequence"`` tracing or a wall-clock admission
                 bucket under supervision (error — the re-formed
                 groups of a replay would fuse different batches /
                 mint fresh ids, mirroring WF105/WF108); K exceeding
                 a ring's capacity (warning, the WF106 shape — a full
                 fused group can never be ring-resident, so the
                 consumer always flushes short on the linger)
WF115  warn/err  shard-local supervision (``shards=``/``WF_SHARDS``)
                 combined with a configuration its per-shard recovery
                 contract cannot honor: an unresolvable shard count or
                 re-sharding plan (error); scan dispatch K > 1 (error
                 — a fused group failure has no single shard's replay
                 extent); tiered keyed state (error — one process-wide
                 HostStore per operator, a shard restore could roll
                 back peers); wall-clock admission or sequence-id
                 tracing under sharded supervision (error, the
                 WF105/WF108 mirror); a re-sharding plan whose move
                 targets a nonexistent shard (error); more shards than
                 a keyed operator's key space (error — empty shards) /
                 an indivisible key space (warning — uneven ranges);
                 shard fault sites in a plan while shards resolve to 1
                 (warning — the specs could never fire)
====== ========= =====================================================

Usage::

    from windflow_tpu_torch.analysis import validate
    report = validate(graph, faults=plan, control=cfg)
    report.raise_if_errors()          # or: assert not report.errors
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional

from ..batch import Batch, abstract_spec, map_tuples, tree_leaves

# ---------------------------------------------------------------- reporting


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One validator finding: stable code, severity, operator path, message,
    and a fix hint (the shift-left counterpart of the runtime's mid-stream
    stack trace)."""

    code: str
    severity: str            # "error" | "warning"
    where: str               # operator path, e.g. "pipe[1].ops[2]:join"
    message: str
    hint: str = ""

    def render(self) -> str:
        s = f"{self.code} [{self.severity}] {self.where}: {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


class ValidationError(RuntimeError):
    """Raised by :meth:`ValidationReport.raise_if_errors`; carries the
    report as ``.report``."""

    def __init__(self, report: "ValidationReport"):
        super().__init__("graph validation failed:\n" + str(report))
        self.report = report


class ValidationReport:
    """All diagnostics of one :func:`validate` run."""

    def __init__(self, target: str):
        self.target = target
        self.diagnostics: List[Diagnostic] = []

    def add(self, code: str, severity: str, where: str, message: str,
            hint: str = "") -> None:
        self.diagnostics.append(Diagnostic(code, severity, where, message,
                                           hint))

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def raise_if_errors(self) -> "ValidationReport":
        if self.errors:
            raise ValidationError(self)
        return self

    def to_json(self) -> dict:
        return {"target": self.target,
                "diagnostics": [dataclasses.asdict(d)
                                for d in self.diagnostics]}

    def __str__(self) -> str:
        if not self.diagnostics:
            return f"{self.target}: clean"
        return "\n".join(d.render() for d in self.diagnostics)

    __repr__ = __str__


# ------------------------------------------------------------- spec flowing


def _payload_fields(spec) -> str:
    """Human rendering of a payload spec for WF101 hints."""
    try:
        shapes = ", ".join(f"{tuple(getattr(s, 'shape', ()))}:"
                           f"{str(getattr(s, 'dtype', '?')).replace('torch.', '')}"
                           for s in tree_leaves(spec))
        keys = list(spec) if isinstance(spec, dict) else type(spec).__name__
        return f"{keys!r} ({shapes})"
    except Exception:  # noqa: BLE001 — hint rendering must never mask WF101
        return repr(spec)


def _tuple_probe(fn, spec):
    """The per-tuple spec of ``fn(TupleRef)`` over payload ``spec``, evaluated
    abstractly (no device work): the JAX package's ``jax.eval_shape`` over a
    ``TupleRef`` of ``ShapeDtypeStruct`` leaves."""
    return abstract_spec(lambda dev: map_tuples(fn, Batch.empty(1, spec, dev)))


def _flow_ops(report, ops, in_spec, where_prefix: str,
              in_capacity: Optional[int]):
    """Flow ``in_spec`` through ``ops`` (binding geometry exactly as
    ``CompiledChain.__init__`` would, so budget-dependent ``out_spec``s — TB
    window archives — resolve). Returns ``(out_spec, out_capacity)``, both
    None after a WF101 (downstream of a broken operator nothing is
    knowable); capacity is None whenever ``in_capacity`` was."""
    spec, cap = in_spec, in_capacity
    for i, op in enumerate(ops):
        where = f"{where_prefix}.ops[{i}]:{op.getName()}"
        try:
            if cap is not None:
                op.bind_geometry(cap)
                cap = op.out_capacity(cap)
            out = op.out_spec(spec)
        except Exception as e:  # noqa: BLE001 — diagnosis IS the product here
            report.add(
                "WF101", "error", where,
                f"operator rejects its input payload spec: "
                f"{type(e).__name__}: {e}",
                hint=f"input payload spec here is {_payload_fields(spec)}; "
                     f"the upstream operator's output must match what "
                     f"{op.getName()!r}'s function destructures")
            return None, None
        spec = out
    return spec, cap


def _check_split(report, mp, out_spec, where: str) -> None:
    n = len(mp.split_branches)
    try:
        sel = _tuple_probe(mp.split_fn, out_spec)
    except Exception as e:  # noqa: BLE001 — diagnosis IS the product here
        report.add("WF101", "error", f"{where}.split",
                   f"split function rejects the pipe's output tuples: "
                   f"{type(e).__name__}: {e}",
                   hint=f"split fn receives TupleRef over payload "
                        f"{_payload_fields(out_spec)}")
        return
    shape = getattr(sel, "shape", None)
    shape = tuple(shape) if shape is not None else None
    if shape not in ((), (n,)):
        report.add(
            "WF101", "error", f"{where}.split",
            f"split function returns shape {shape}, expected a scalar "
            f"branch index or a multicast mask of shape ({n},) for "
            f"{n} branches")


def _has_reduce_sink(ops) -> bool:
    from ..operators.sink import ReduceSink
    return any(isinstance(op, ReduceSink) for op in ops)


# --------------------------------------------------------- config checking


#: fault-injection sites each driver actually threads (``runtime/threaded.py``
#: fires per stage; the supervisors fire around steps + checkpoint I/O; the
#: plain push drivers fire nothing)
DRIVER_SITES = {
    "pipeline": frozenset(),
    "graph": frozenset(),
    "graph-threaded": frozenset(),
    "threaded": frozenset({"source.next", "queue.stall", "chain.step",
                           "sink.consume"}),
    "supervised": frozenset({"source.next", "chain.step", "sink.consume",
                             "checkpoint.save", "checkpoint.load",
                             "shard.kill", "reshard.handoff"}),
}


def _check_faults(report, faults, driver: str) -> None:
    from ..runtime import faults as _faults
    if faults is None:
        try:
            plan = _faults.FaultPlan.from_env()
        except (ValueError, OSError) as e:
            report.add("WF103", "error", "faults",
                       f"WF_FAULT_PLAN does not parse: {e}")
            return
    elif isinstance(faults, _faults.FaultInjector):
        plan = faults.plan
    elif isinstance(faults, _faults.FaultPlan):
        plan = faults
    elif isinstance(faults, str):
        try:
            plan = _faults.FaultPlan.from_json(faults)
        except (ValueError, KeyError, TypeError) as e:
            report.add("WF103", "error", "faults",
                       f"fault plan does not parse: {type(e).__name__}: {e}",
                       hint="FaultPlan JSON is {\"seed\": n, \"faults\": "
                            "[{\"site\": ..., ...}]}; sites: "
                            + ", ".join(_faults.SITES))
            return
    else:
        plan = None
    if plan is None:
        return
    threaded = DRIVER_SITES.get(driver, frozenset())
    for i, spec in enumerate(plan.faults):
        if spec.site not in _faults.SITES:
            report.add("WF103", "error", f"faults[{i}]",
                       f"unknown fault site {spec.site!r} "
                       f"(sites: {', '.join(_faults.SITES)})")
        elif spec.site not in threaded:
            fired = (", ".join(sorted(threaded)) or
                     "(none — use the threaded or supervised drivers for "
                     "injection)")
            report.add(
                "WF103", "warning", f"faults[{i}]",
                f"fault site {spec.site!r} is never threaded through the "
                f"{driver!r} driver — the spec can never fire",
                hint=f"sites this driver fires: {fired}")


#: shard-only fault sites (warned as WF115 when a plan schedules them while
#: shards resolve to 1 — they could never fire, the WF103 shape)
_SHARD_SITES = frozenset({"shard.kill", "reshard.handoff"})


def _check_shards(report, shards_arg, reshard_arg, ops, cfg, trace,
                  stored_trace, dispatch, stored_dispatch, faults,
                  where: str, shard_key=None) -> None:
    """WF115: shard-local supervision (``runtime/supervisor.py``
    ``ShardedSupervisor``) against configurations its per-shard recovery /
    deterministic re-sharding contracts cannot honor."""
    from ..parallel.sharding import ReshardPlan, resolve_shards
    from ..runtime import faults as _faults
    if reshard_arg is None:
        # mirror the drivers: reshard=None consults WF_RESHARD — an
        # env-driven plan must get the same legality checks as an explicit
        # one (the resolve_shards parity rule)
        try:
            reshard_arg = ReshardPlan.resolve(None)
        except (ValueError, TypeError, KeyError) as e:
            report.add("WF115", "error", f"{where}:reshard",
                       f"WF_RESHARD does not parse: {e}",
                       hint="WF_RESHARD is an int shard count, JSON "
                            "{'at_pos', 'new_shards', 'moves'}, or 'auto'")
            reshard_arg = None
    try:
        n = resolve_shards(shards_arg)
    except (ValueError, TypeError) as e:
        report.add("WF115", "error", f"{where}:shards",
                   f"shard count does not resolve: {e}",
                   hint="shards= (or WF_SHARDS) must be an integer >= 1; "
                        "1/unset = single supervision domain")
        return
    # shard sites scheduled but sharding off: the WF103 can-never-fire shape
    plan = None
    if isinstance(faults, _faults.FaultInjector):
        plan = faults.plan
    elif isinstance(faults, _faults.FaultPlan):
        plan = faults
    elif faults is None:
        try:
            plan = _faults.FaultPlan.from_env()
        except (ValueError, OSError):
            plan = None                    # already a WF103 error
    if n <= 1:
        if plan is not None:
            for i, spec in enumerate(plan.faults):
                if spec.site in _SHARD_SITES:
                    report.add(
                        "WF115", "warning", f"faults[{i}]",
                        f"fault site {spec.site!r} is scheduled but shards "
                        f"resolve to 1 — the spec can never fire",
                        hint="pass shards=N (or WF_SHARDS=N) to run the "
                             "sharded supervisor, or drop the spec")
        if reshard_arg is not None and reshard_arg is not False:
            report.add("WF115", "warning", f"{where}:reshard",
                       "a reshard plan is configured but shards resolve to "
                       "1 — it can never apply",
                       hint="pass shards=N (or WF_SHARDS=N); re-sharding "
                            "runs only under sharded supervision")
        return
    # -- sharded: composition checks --------------------------------------
    from ..runtime.dispatch import DispatchConfig
    try:
        dcfg = (DispatchConfig.resolve(dispatch) if dispatch is not None
                else DispatchConfig.resolve(stored_dispatch))
    except (ValueError, TypeError):
        dcfg = None                        # already a WF110 error
    if dcfg is not None and dcfg.k > 1:
        report.add(
            "WF115", "error", f"{where}:shards",
            f"shards={n} does not compose with scan dispatch (K={dcfg.k}): "
            f"a fused group failure cannot be attributed to one shard's "
            f"replay extent",
            hint="drop dispatch=/WF_DISPATCH (per-shard pushes amortize "
                 "dispatch across shards already), or run shards=1")
    tiered = [op.getName() for op in ops
              if getattr(op, "_tier_cfg", None) is not None]
    if tiered:
        report.add(
            "WF115", "error", f"{where}:shards",
            f"shards={n} does not compose with tiered keyed state "
            f"({', '.join(tiered)}): the per-operator HostStore is one "
            f"process-wide cold tier, so a shard-local restore could roll "
            f"back a peer shard's spilled rows",
            hint="run tiered tables with shards=1, or size the hot tables "
                 "for the full key space and keep tiered= off")
    if cfg is not None and cfg.admission and cfg.refill_per_batch is None:
        report.add(
            "WF115", "error", f"{where}:shards",
            "wall-clock admission under SHARDED supervision: a shard-local "
            "replay must re-shed exactly what the failed attempt shed "
            "(the WF105 contract, per key range)",
            hint="use ControlConfig(refill_per_batch=...) — the "
                 "deterministic positional bucket")
    tcfg = _resolve_trace(trace, stored_trace)
    if tcfg is not None and getattr(tcfg, "ids", "position") != "position":
        report.add(
            "WF115", "error", f"{where}:shards",
            "sequence-id tracing under SHARDED supervision: a shard replay "
            "would mint fresh ids for its key range (the WF108 contract)",
            hint="use TraceConfig(ids='position') — the default")
    # a KeyBy re-keys the stream: ownership is computed at INGEST, so
    # without a shard_key= the re-keyed group scatters across shards and
    # every shard holds a partial (wrong) per-key state
    if shard_key is None:
        from ..operators.map import KeyBy
        rekeys = [op.getName() for op in ops if isinstance(op, KeyBy)]
        if rekeys:
            report.add(
                "WF115", "error", f"{where}:shards",
                f"shards={n} with a KeyBy re-key ({', '.join(rekeys)}) and "
                f"no shard_key=: ownership follows the ingest key, so a "
                f"re-keyed group's tuples scatter across shards (partial "
                f"per-key state, wrong results)",
                hint="pass shard_key=<the KeyBy's fn> (TupleRef -> key) so "
                     "ownership follows the key the state tables use")
    # per-key-range geometry: shards vs every keyed operator's key space
    for op in ops:
        nk = getattr(op, "num_keys", None)
        if not isinstance(nk, int) or nk <= 1:
            continue
        opw = f"{where}:{op.getName()}"
        if n > nk:
            report.add(
                "WF115", "error", opw,
                f"shards={n} exceeds the operator's key space "
                f"(num_keys={nk}): at least {n - nk} shard(s) own no keys "
                f"and can never make progress against their restart budget",
                hint=f"use shards <= {nk} (key ownership is key % shards)")
        elif nk % n:
            report.add(
                "WF115", "warning", opw,
                f"num_keys={nk} is not divisible by shards={n}: key ranges "
                f"are uneven (largest shard owns "
                f"{-(-nk // n)} keys, smallest {nk // n})",
                hint="a shard count dividing the key space balances load "
                     "(and matches any key-axis mesh sharding downstream)")
    # re-sharding plan legality (the nonexistent-shard check)
    if reshard_arg is not None and reshard_arg is not False:
        try:
            rplan = ReshardPlan.resolve(reshard_arg)
        except (ValueError, TypeError, KeyError) as e:
            report.add("WF115", "error", f"{where}:reshard",
                       f"reshard plan does not resolve: {e}",
                       hint="pass a ReshardPlan, dict {'at_pos', "
                            "'new_shards', 'moves'}, an int shard count, "
                            "or 'auto'")
            return
        if rplan == "auto" or rplan is None:
            return
        target_n = rplan.new_shards if rplan.new_shards is not None else n
        if target_n < 1:
            report.add("WF115", "error", f"{where}:reshard",
                       f"reshard plan requests new_shards={target_n} (< 1)",
                       hint="the target shard count must be >= 1")
            return
        for k, s in rplan.moves:
            if not (0 <= s < target_n):
                report.add(
                    "WF115", "error", f"{where}:reshard",
                    f"reshard plan moves key {k} to shard {s}, which does "
                    f"not exist in the target layout ({target_n} shards)",
                    hint=f"move targets must be in [0, {target_n})")


def _resolve_trace(trace, stored_trace):
    """Resolved TraceConfig honoring explicit-over-stored (the WF108
    resolution, shared with the WF115 sequence-id mirror)."""
    from ..observability import TraceConfig
    try:
        return (TraceConfig.resolve(trace) if trace is not None
                else TraceConfig.resolve(stored_trace))
    except (ValueError, TypeError):
        return None                        # already diagnosed as WF108


def _check_watermarks(report, cfg, edges) -> None:
    """``edges``: list of (label, capacity). Mirrors the resolution in
    ``control/governor.py::watch`` — warn where the resolved thresholds
    degenerate."""
    if cfg is None or not cfg.backpressure:
        return
    for label, cap in edges:
        hi = max(1, int(cap * cfg.high_watermark))
        lo_raw = int(cap * cfg.low_watermark)
        if hi >= cap:
            report.add(
                "WF104", "warning", f"edge[{label}]",
                f"resolved high watermark {hi} >= ring capacity {cap} "
                f"(high_watermark={cfg.high_watermark}): the governor can "
                f"only throttle once the ring is completely full, i.e. "
                f"after the producer already blocked inside push",
                hint="raise queue_capacity for this edge (capacity >= 2 "
                     "gives the watermark headroom) or lower high_watermark")
        elif lo_raw >= hi:
            report.add(
                "WF104", "warning", f"edge[{label}]",
                f"resolved low watermark {lo_raw} >= high watermark {hi} "
                f"on capacity {cap}; the runtime clamps low to {hi - 1}, "
                f"so the throttle releases after a single pop",
                hint="widen the high/low fraction gap or raise the edge's "
                     "queue_capacity so the fractions resolve distinctly")


def _check_admission(report, cfg, supervised: bool, where: str) -> None:
    if cfg is None or not cfg.admission:
        return
    if not supervised:
        return
    if cfg.refill_per_batch is None:
        report.add(
            "WF105", "error", where,
            "admission control under supervision uses the wall-clock "
            "TokenBucket (rate_tps) — a restore changes the refill "
            "timeline, so replayed shed decisions diverge from the "
            "original run and exactly-once delivery breaks",
            hint="use ControlConfig(refill_per_batch=...) — the positional "
                 "bucket makes shedding a pure function of stream position, "
                 "which the supervisor snapshots and restores")
    if cfg.shed_policy != "drop_newest":
        report.add(
            "WF105", "error", where,
            f"admission shed_policy={cfg.shed_policy!r} under supervision: "
            f"a drop_oldest_ts holding cell would have to be serialized "
            f"into every checkpoint",
            hint="supervised drivers support shed_policy='drop_newest' only")


def _check_trace(report, trace, stored_arg, supervised: bool) -> None:
    """WF108: the tracing mirror of :func:`_check_admission` — resolve the
    trace config exactly as the driver will (explicit ``trace=`` wins, else
    the object's stored ``trace=`` argument / ``WF_TRACE``) and reject
    configurations the supervised drivers would refuse mid-run."""
    from ..observability.tracing import TraceConfig
    try:
        cfg = TraceConfig.resolve(trace if trace is not None else stored_arg)
    except (ValueError, TypeError) as e:
        report.add("WF108", "error", "trace",
                   f"trace config does not resolve: {type(e).__name__}: {e}",
                   hint="trace= accepts None/bool/out-dir string/TraceConfig;"
                        " WF_TRACE_SAMPLE must be a positive integer")
        return
    if cfg is None:
        return
    if supervised and cfg.ids != "position":
        report.add(
            "WF108", "error", "trace",
            f"trace ids={cfg.ids!r} under supervision: sequence ids come "
            f"from a process-global counter, so a replay after a restore "
            f"mints fresh ids — every exemplar and ring-edge flow recorded "
            f"before the failure dangles",
            hint="use TraceConfig(ids='position') (the default) — ids become "
                 "a pure function of (run_id, stream, position), the same "
                 "replay-determinism contract as the admission "
                 "PositionBucket")


def _check_health(report, stored_monitoring) -> None:
    """WF113: the runtime-health mirror of WF108 — resolve the monitoring
    config exactly as the driver will (the object's stored ``monitoring=``
    argument / ``WF_MONITORING``) and reject health configurations the run
    cannot honor before it starts."""
    import os
    from ..observability import MonitoringConfig
    try:
        cfg = MonitoringConfig.resolve(stored_monitoring)
    except (ValueError, TypeError) as e:
        report.add(
            "WF113", "error", "monitoring.health",
            f"monitoring/health config does not resolve: "
            f"{type(e).__name__}: {e}",
            hint="WF_HEALTH_SAMPLE must be a positive integer "
                 "(MonitoringConfig.health_sample >= 1)")
        return
    if cfg is None:
        env = os.environ.get("WF_MONITORING_HEALTH", "")
        if env not in ("", "0"):
            report.add(
                "WF113", "error", "monitoring.health",
                "WF_MONITORING_HEALTH is set but monitoring itself resolves "
                "off — the health ledger can never activate, so the run "
                "would silently produce no HBM/compile/device-time "
                "artifacts",
                hint="enable monitoring alongside the sub-toggle: "
                     "WF_MONITORING=1 (or monitoring=/MonitoringConfig("
                     "health=True) on the driver)")


def _check_slo(report, stored_monitoring) -> None:
    """WF116: the SLO mirror of WF113 — resolve the monitoring config
    exactly as the Monitor will and reject SLO configurations the engine
    cannot honor before the run starts (the engine itself raises the same
    problems at Monitor construction; this surfaces them pre-run with the
    operator-path/hint shape)."""
    import os
    from ..observability import MonitoringConfig
    from ..observability import slo as _slo
    try:
        cfg = MonitoringConfig.resolve(stored_monitoring)
    except (ValueError, TypeError):
        return                          # already diagnosed as WF113
    if cfg is None:
        env = os.environ.get("WF_SLO", "")
        if env not in ("", "0"):
            report.add(
                "WF116", "error", "monitoring.slo",
                "WF_SLO is set but monitoring itself resolves off — the "
                "SLO engine can never evaluate, so burn-rate alerting and "
                "incident capture are silently disabled",
                hint="enable monitoring alongside the sub-toggle: "
                     "WF_MONITORING=1 (or monitoring=/MonitoringConfig("
                     "slo=...) on the driver)")
        return
    try:
        specs = _slo.resolve_specs(cfg.slo)
    except (ValueError, TypeError, OSError) as e:
        report.add(
            "WF116", "error", "monitoring.slo",
            f"SLO spec set does not resolve: {type(e).__name__}: {e}",
            hint="slo=/WF_SLO accept True/'1' (default specs), a list of "
                 "slo.SLOSpec/dicts, or a JSON file path / inline JSON "
                 "(a list of {name,signal,target,...} objects)")
        return
    if not specs:
        return
    seen = set()
    for spec in specs:
        where = f"slo[{spec.name}]"
        for prob in _slo.spec_problems(spec):
            report.add(
                "WF116", "error", where, prob,
                hint=f"registered signals: {', '.join(sorted(_slo.SIGNALS))}"
                     f"; the burn windows are Reporter ticks — the fast "
                     f"window detects the spike, the slow one confirms the "
                     f"sustained burn (fast < slow)")
        if spec.name in seen:
            report.add("WF116", "error", where,
                       "duplicate SLO name — the snapshot/Prometheus "
                       "surface keys per-SLO rows by name",
                       hint="give every SLOSpec a unique name")
        seen.add(spec.name)


def _check_telemetry(report, stored_monitoring) -> None:
    """WF117: the telemetry mirror of WF116 — resolve the monitoring config
    exactly as the Monitor will and reject telemetry configurations the
    agent cannot honor before the run starts (the TelemetryAgent raises the
    same problems at Monitor construction; this surfaces them pre-run with
    the operator-path/hint shape)."""
    import os
    from ..observability import MonitoringConfig
    try:
        cfg = MonitoringConfig.resolve(stored_monitoring)
    except (ValueError, TypeError):
        return                          # already diagnosed as WF113
    if cfg is None:
        env = os.environ.get("WF_TELEMETRY", "")
        if env not in ("", "0"):
            report.add(
                "WF117", "error", "monitoring.telemetry",
                "WF_TELEMETRY is set but monitoring itself resolves off — "
                "the telemetry agent rides the Reporter tick, so no frames "
                "can ever stream to the fleet aggregator",
                hint="enable monitoring alongside the sub-toggle: "
                     "WF_MONITORING=1 (or monitoring=/MonitoringConfig("
                     "telemetry=...) on the driver)")
        return
    if cfg.telemetry in (False, None):
        return
    # the plane is on: the endpoint must parse and the outbox must hold
    # at least one frame (fleet.py raises the identical ValueErrors at
    # Monitor construction — WF117 is the pre-run surface of those)
    from ..observability import fleet as _fleet
    endpoint = (cfg.telemetry if isinstance(cfg.telemetry, str)
                else os.environ.get("WF_TELEMETRY_ENDPOINT", ""))
    try:
        _fleet.parse_endpoint(endpoint)
    except ValueError as e:
        report.add(
            "WF117", "error", "monitoring.telemetry",
            f"telemetry endpoint does not parse: {e}",
            hint="telemetry='tcp://HOST:PORT' / 'unix:///path.sock' (or "
                 "telemetry=True + WF_TELEMETRY_ENDPOINT); the aggregator "
                 "side is scripts/wf_fleet.py serve --listen <endpoint>")
    if int(cfg.telemetry_outbox) < 1:
        report.add(
            "WF117", "error", "monitoring.telemetry",
            f"telemetry_outbox={cfg.telemetry_outbox} cannot hold a single "
            "frame — the agent's drop-oldest outbox needs capacity >= 1",
            hint="telemetry_outbox/WF_TELEMETRY_OUTBOX must be a positive "
                 "integer (default 64 ticks of backlog)")


def _check_remediation(report, stored_monitoring, control_cfg) -> None:
    """WF118: the remediation mirror of WF116 — resolve the monitoring
    config exactly as the Monitor will and reject remediation policies the
    run cannot honor before it starts (the MonitoringConfig/Monitor raise
    the same problems loudly at construction; this surfaces them pre-run
    with the operator-path/hint shape).  Live-driver surface: ownership is
    checked against the CONTROL config — an action naming an actuator whose
    subsystem is off could only ever skip, never act."""
    import os
    from ..control import remediation as _remediation
    from ..observability import MonitoringConfig
    from ..observability import slo as _slo
    try:
        cfg = MonitoringConfig.resolve(stored_monitoring)
    except (ValueError, TypeError) as e:
        if "remediation" in str(e).lower():
            report.add(
                "WF118", "error", "monitoring.remediation",
                f"monitoring/remediation config does not resolve: "
                f"{type(e).__name__}: {e}",
                hint="remediation requires the SLO engine (slo=/WF_SLO), a "
                     "cooldown >= the reporter interval, and "
                     "max_actions >= 1")
        return                          # otherwise WF113's diagnosis
    if cfg is None:
        env = os.environ.get("WF_REMEDIATION", "")
        if env not in ("", "0"):
            report.add(
                "WF118", "error", "monitoring.remediation",
                "WF_REMEDIATION is set but monitoring itself resolves off — "
                "the remediation engine rides the SLO engine's Reporter-tick "
                "verdicts, so no action could ever fire",
                hint="enable monitoring alongside the sub-toggle: "
                     "WF_MONITORING=1 (or monitoring=/MonitoringConfig("
                     "remediation=...) on the driver); note the supervised "
                     "drivers consume WF_REMEDIATION directly (barrier "
                     "mode) and need no monitoring")
        return
    try:
        policy = _remediation.resolve_policy(cfg.remediation)
    except (ValueError, TypeError) as e:
        report.add(
            "WF118", "error", "monitoring.remediation",
            f"remediation policy does not resolve: {type(e).__name__}: {e}",
            hint="remediation=/WF_REMEDIATION accept True/'1' (the default "
                 "policy), a RemediationPolicy, a list of actions/dicts, a "
                 "JSON file path, or inline JSON (actions = {name, slo, "
                 "actuator, ...})")
        return
    if policy is None:
        return
    try:
        spec_names = [s.name for s in (_slo.resolve_specs(cfg.slo) or [])]
    except (ValueError, TypeError, OSError):
        spec_names = None               # already diagnosed as WF116
    for prob in _remediation.policy_problems(policy, spec_names or None):
        report.add(
            "WF118", "error", "monitoring.remediation", prob,
            hint=f"actuators: {', '.join(sorted(_remediation.ACTUATORS))}; "
                 f"every action's slo must name a configured SLOSpec")
    # ownership: an actuator whose owning subsystem the control config has
    # off can only ever skip (reason 'unbound') — reject it pre-run
    for a in policy.actions:
        where = f"remediation[{a.name}]"
        if a.actuator == "admission_rate" and (
                control_cfg is None or not control_cfg.admission):
            report.add(
                "WF118", "error", where,
                "actuator 'admission_rate' but the run has no admission "
                "controller — the action could only ever skip as 'unbound'",
                hint="enable ControlConfig(admission=True, ...) (control=/"
                     "WF_CONTROL) alongside the policy, or drop the action")
        elif a.actuator == "autotune_reclimb" and (
                control_cfg is None or not control_cfg.autotune):
            report.add(
                "WF118", "error", where,
                "actuator 'autotune_reclimb' but the autotuner is off — "
                "the action could only ever skip as 'unbound'",
                hint="enable ControlConfig(autotune=True) (the Pipeline "
                     "driver's capacity ladder), or drop the action")
        elif a.actuator == "reshard":
            report.add(
                "WF118", "error", where,
                "actuator 'reshard' under a live driver — re-sharding is "
                "the sharded supervisor's barrier actuator, never bound by "
                "the live drivers",
                hint="run SupervisedPipeline(shards=N, remediation=...) for "
                     "remediation-driven resharding, or drop the action")


def _check_remediation_supervised(report, sp) -> None:
    """WF118 (barrier surface): re-resolve the supervised driver's
    ``remediation=``/``WF_REMEDIATION`` argument exactly as its constructor
    does — every action must be barrier-actionable AND owned by the run
    config (deterministic admission bucket / shards > 1)."""
    import os
    from ..control import remediation as _remediation
    arg = getattr(sp, "_remediation_arg", None)
    if arg is None:
        arg = os.environ.get("WF_REMEDIATION")
    try:
        policy = _remediation.resolve_barrier_policy(
            arg, admission=getattr(sp, "_admission", None) is not None,
            shards=getattr(sp, "_shards", 1))
    except (ValueError, TypeError) as e:
        report.add(
            "WF118", "error", "supervised.remediation",
            f"supervised remediation config cannot work: "
            f"{type(e).__name__}: {e}",
            hint="barrier mode fires only actuators with deterministic "
                 "committed signals: 'admission_rate' (needs ControlConfig("
                 "admission=True, refill_per_batch=...)) and 'reshard' "
                 "(needs shards > 1); use the live drivers' monitoring= "
                 "remediation for the rest")
        return
    if policy is None:
        return
    cool = os.environ.get("WF_REMEDIATION_COOLDOWN_S", "")
    if cool:
        try:
            ok = float(cool) >= 0
        except ValueError:
            ok = False
        if not ok:
            report.add(
                "WF118", "error", "supervised.remediation",
                f"WF_REMEDIATION_COOLDOWN_S={cool!r} does not parse as a "
                f"non-negative number",
                hint="barrier mode rounds the cooldown to whole barriers "
                     "(>= 1)")
    maxa = os.environ.get("WF_REMEDIATION_MAX_ACTIONS", "")
    if maxa:
        try:
            ok = int(maxa) >= 1
        except ValueError:
            ok = False
        if not ok:
            report.add(
                "WF118", "error", "supervised.remediation",
                f"WF_REMEDIATION_MAX_ACTIONS={maxa!r} must be an integer "
                f">= 1",
                hint="the per-run action budget bounds remediation blast "
                     "radius, like slo_max_incidents bounds bundles")


def _check_serving(report, stored_serving, stored_monitoring,
                   supervised) -> None:
    """WF119: the serving mirror of WF116/117 — resolve the serving config
    exactly as ``ServingRuntime`` will (``serving=`` argument, else
    ``WF_SERVE``/``WF_SERVE_ENDPOINT``/``WF_TENANTS``) and reject
    configurations the serving plane cannot honor before the run starts
    (the runtime raises the same problems at construction; this surfaces
    them pre-run with the operator-path/hint shape)."""
    from ..serving.config import ServingConfig, serving_problems
    try:
        cfg = ServingConfig.resolve(stored_serving)
    except (ValueError, TypeError, OSError) as e:
        report.add(
            "WF119", "error", "serving",
            f"serving config does not resolve: {type(e).__name__}: {e}",
            hint="serving=/WF_SERVE accept True/'1' (defaults), an endpoint "
                 "string ('tcp://HOST:PORT' / 'unix:///path.sock'), a "
                 "ServingConfig/dict, a JSON file path, or inline JSON "
                 "({endpoint, tenants, swap_warm, replay})")
        return
    if cfg is None:
        return
    slo_specs = None
    try:
        from ..observability import MonitoringConfig
        from ..observability import slo as _slo
        mcfg = MonitoringConfig.resolve(stored_monitoring)
        if mcfg is not None:
            slo_specs = _slo.resolve_specs(mcfg.slo)
    except (ValueError, TypeError, OSError):
        slo_specs = None                # already diagnosed as WF113/WF116
    for prob in serving_problems(cfg, monitoring=stored_monitoring,
                                 supervised=supervised,
                                 slo_specs=slo_specs):
        report.add(
            "WF119", "error", "serving", prob,
            hint="the serving plane rides monitoring for per-tenant SLOs "
                 "and remediation: tenant ids must be unique, supervised "
                 "buckets deterministic (refill_per_batch, not rate_tps), "
                 "swaps warmed (swap_warm=True), and every slo tenant= "
                 "label a declared tenant id")


def _check_profile(report, stored_monitoring) -> None:
    """WF120: the profile-on-page mirror of WF118 — resolve the monitoring
    config exactly as the Monitor will and reject profile configurations
    the capture path cannot honor before the run starts (the
    MonitoringConfig/Monitor raise the structural problems at
    construction; WF120 is the pre-run surface of those)."""
    import os
    from ..observability import MonitoringConfig
    from ..observability import profiling as _profiling
    try:
        cfg = MonitoringConfig.resolve(stored_monitoring)
    except (ValueError, TypeError) as e:
        if "profile" in str(e).lower():
            report.add(
                "WF120", "error", "monitoring.profile",
                f"monitoring/profile config does not resolve: "
                f"{type(e).__name__}: {e}",
                hint="profile-on-page requires the SLO engine (slo=/WF_SLO) "
                     "and a capture window below the reporter interval "
                     "(WF_PROFILE_WINDOW_MS < WF_MONITORING_INTERVAL)")
        return                          # otherwise WF113's diagnosis
    if cfg is None:
        env = os.environ.get("WF_PROFILE", "")
        if env not in ("", "0"):
            report.add(
                "WF120", "error", "monitoring.profile",
                "WF_PROFILE is set but monitoring itself resolves off — "
                "profile-on-page rides the SLO engine's incident capture, "
                "so no profiler window could ever open",
                hint="enable monitoring alongside the sub-toggle: "
                     "WF_MONITORING=1 WF_SLO=1 (or monitoring=/"
                     "MonitoringConfig(slo=..., profile=...) on the driver)")
        return
    try:
        prof = _profiling.resolve_profile(
            cfg.profile if cfg.profile is not False else None)
    except (ValueError, TypeError) as e:
        report.add(
            "WF120", "error", "monitoring.profile",
            f"profile config does not resolve: {type(e).__name__}: {e}",
            hint="profile=/WF_PROFILE accept True/'1' (defaults) or a "
                 "profiling.ProfileConfig; WF_PROFILE_WINDOW_MS must be a "
                 "positive number, WF_PROFILE_MAX_CAPTURES an integer >= 1")
        return
    for prob in _profiling.profile_problems(
            prof, slo_on=cfg.slo not in (False, None, "", "0"),
            interval_s=cfg.interval_s):
        report.add(
            "WF120", "error", "monitoring.profile", prob,
            hint="captures fire from PAGE entry on the Reporter tick "
                 "thread through the ONE stats.xprof_trace session guard; "
                 "see observability/profiling.py")


def _check_kernel_records(report) -> None:
    """WF109: compare every kernel-impl choice the registry recorded against
    what it would resolve to NOW (env/tuning-cache as of this call). A
    disagreement means a CUDA graph captured in this process replays an
    impl the current configuration no longer selects (the registry names
    those graphs) — the A/B-measured-the-same-impl-twice footgun."""
    from ..ops import registry as _registry
    for rec in _registry.stale_selections():
        graphs = rec.get("graphs")
        held = (f"the captured CUDA graph(s) {', '.join(graphs)} keep "
                f"replaying {rec['recorded']!r}" if graphs else
                f"a graph captured before the change would keep replaying "
                f"{rec['recorded']!r}")
        report.add(
            "WF109", "warning",
            f"kernel[{rec['kernel']}]",
            f"impl {rec['recorded']!r} was resolved for spec "
            f"{rec['spec_key']!r} on {rec['device']} but the registry now "
            f"selects {rec['current']!r} — {held} (a CUDA graph keeps the "
            f"kernels it captured, not the env)",
            hint="re-capture (a fresh chain or process), pass impl= "
                 "explicitly, or revert the WF_KERNEL_IMPL/alias/tuning-"
                 "cache change; docs/ENV_FLAGS.md lists when each flag is "
                 "read")


def _check_prefetch(report, prefetch: int, first_edge) -> None:
    if not prefetch or first_edge is None:
        return
    label, cap = first_edge
    if prefetch > cap:
        report.add(
            "WF106", "warning", f"edge[{label}]",
            f"prefetch depth {prefetch} exceeds the first ring's capacity "
            f"{cap}: up to {prefetch - cap} prefetched (H2D-transferred) "
            f"batches pile up behind a full ring where the governor's "
            f"pause hook cannot reach them",
            hint="size prefetch <= the src edge's queue_capacity")


def _check_dispatch(report, dispatch, stored_arg, cfg, trace, stored_trace,
                    supervised: bool, edges=None) -> None:
    """WF110: scan dispatch (``runtime/dispatch.py``) against configurations
    the K-fused launch cannot honor — resolved exactly as the driver will
    (explicit ``dispatch=`` wins, else the object's stored argument /
    ``WF_DISPATCH``), the WF105/WF108 convention."""
    from ..runtime.dispatch import DispatchConfig
    try:
        dcfg = DispatchConfig.resolve(dispatch if dispatch is not None
                                      else stored_arg)
    except (ValueError, TypeError, OSError) as e:
        report.add("WF110", "error", "dispatch",
                   f"dispatch config does not resolve: "
                   f"{type(e).__name__}: {e}",
                   hint="dispatch= accepts None/bool/int K/dict/"
                        "DispatchConfig; WF_DISPATCH_K must be a positive "
                        "integer")
        return
    if dcfg is None or dcfg.k <= 1:
        return
    if supervised:
        from ..observability.tracing import TraceConfig
        try:
            tcfg = TraceConfig.resolve(trace if trace is not None
                                       else stored_trace)
        except (ValueError, TypeError):
            tcfg = None                # already diagnosed as WF108
        if tcfg is not None and tcfg.ids != "position":
            report.add(
                "WF110", "error", "dispatch",
                f"dispatch k={dcfg.k} with trace ids={tcfg.ids!r} under "
                f"supervision: per-batch spans are synthesized from each "
                f"fused launch, and sequence ids come from a process-global "
                f"counter — a replay after restore re-forms the groups but "
                f"mints fresh ids for them, orphaning every exemplar "
                f"recorded before the failure",
                hint="use TraceConfig(ids='position') (the default) so span "
                     "ids are a pure function of stream position, the same "
                     "contract the accumulator's count-based flush follows")
        if (cfg is not None and cfg.admission
                and cfg.refill_per_batch is None):
            report.add(
                "WF110", "error", "dispatch",
                f"dispatch k={dcfg.k} with wall-clock admission (rate_tps) "
                f"under supervision: group boundaries are count-based so "
                f"replay re-forms them, but the wall-clock refill timeline "
                f"shifts on restore — the re-formed groups would fuse "
                f"DIFFERENT batches than the original run",
                hint="use ControlConfig(refill_per_batch=...) — positional "
                     "admission keeps the admitted stream (and therefore "
                     "every fused group) a pure function of position")
    for label, cap in (edges or []):
        if dcfg.k > cap:
            report.add(
                "WF110", "warning", f"edge[{label}]",
                f"dispatch k={dcfg.k} exceeds ring capacity {cap}: a full "
                f"fused group can never be resident in the ring at once, so "
                f"the consumer flushes short on the linger nearly every "
                f"group — the (K, capacity) executable is traced and warmed "
                f"but rarely runs at full K",
                hint="size queue_capacity >= dispatch k (room for one full "
                     "group) or lower k for this topology")


def _check_tiered(report, ops, cfg, trace, stored_trace,
                  supervised: bool, where_prefix: str) -> None:
    """WF114: tiered keyed state (``windflow_tpu_torch/state``) against
    configurations its determinism/sizing contract cannot honor.

    - **error** — tiered state under supervision with sequence-id tracing
      or a wall-clock admission bucket (the WF105/WF108 mirror): the
      ordered re-admission callbacks replay in stream order, but a shifted
      shed pattern / fresh trace ids would desynchronize the replayed
      miss sequence from the failed attempt's host-store mutations.
    - **error** — a tiered table whose hot capacity does not clear its
      per-batch admission reserve (batch keys + parked pending keys): the
      zero-overflow-drop guarantee is structurally broken, every batch
      thrashes the whole table through the spill path.
    - **warning** — a hot table that K5 (the join probe) cannot hold in
      one block's shared memory (``ops/lookup.py::JOIN_PROBE_SMEM_SLOTS``
      slots, ``next_pow2(2K)`` a table): the hot probe reads the table
      through L2 (correct, slower). The cold tier's ``cold_probe`` runs
      one thread a lane and has no geometry limit.
    """
    from ..operators.join import StreamTableJoin
    from ..operators.rank import Distinct
    from ..ops.lookup import JOIN_PROBE_SMEM_SLOTS
    tiered = [(i, op, op._tier_cfg) for i, op in enumerate(ops)
              if getattr(op, "_tier_cfg", None) is not None]
    if not tiered:
        return
    if supervised:
        from ..observability.tracing import TraceConfig
        try:
            tcfg = TraceConfig.resolve(trace if trace is not None
                                       else stored_trace)
        except (ValueError, TypeError):
            tcfg = None                # already diagnosed as WF108
        if tcfg is not None and tcfg.ids != "position":
            report.add(
                "WF114", "error", f"{where_prefix}:tiered",
                f"tiered state with trace ids={tcfg.ids!r} under "
                f"supervision: the spill/readmit protocol replays the "
                f"ordered host callbacks by stream position, but sequence "
                f"ids are minted from a process counter — a replay after "
                f"restore would walk a different id timeline than the "
                f"host-store mutations it re-derives",
                hint="use TraceConfig(ids='position') (the default), the "
                     "same contract supervised tracing itself requires")
        if (cfg is not None and cfg.admission
                and cfg.refill_per_batch is None):
            report.add(
                "WF114", "error", f"{where_prefix}:tiered",
                "tiered state with wall-clock admission (rate_tps) under "
                "supervision: eviction/re-admission decisions are a pure "
                "function of the admitted stream, and a wall-clock refill "
                "timeline shifts on restore — replay would re-derive "
                "DIFFERENT tier assignments than the failed attempt spilled",
                hint="use ControlConfig(refill_per_batch=...) so the "
                     "admitted stream — and every tier decision — is a "
                     "pure function of position")
    for i, op, tc in tiered:
        where = f"{where_prefix}.ops[{i}]:{op.getName()}"
        cap = getattr(op, "_cap_resolved", None) \
            or getattr(op, "_cap", None) or getattr(op, "_pending", None)
        pending = getattr(op, "_pending_resolved", None)
        if cap is None:
            continue                    # not geometry-bound yet
        hot = int(tc.hot_capacity
                  or getattr(op, "_slots", None)
                  or getattr(op, "num_slots", 0) or 0)
        reserve = int(cap) + int(pending or 0)
        if hot and pending is not None and hot <= reserve:
            report.add(
                "WF114", "error", where,
                f"tiered hot capacity {hot} <= per-batch admission reserve "
                f"{reserve} (batch capacity {cap} + pending ring "
                f"{pending}): the miss-resolution pass can need a fresh "
                f"slot for every resolved key, so the zero-overflow-drop "
                f"guarantee is structurally broken and every batch "
                f"thrashes the whole table through the spill path",
                hint="raise num_slots/TierConfig.hot_capacity above "
                     "batch + pending (the resolve width), or shrink the "
                     "batch")
        elif hot and pending is None and hot <= int(cap):
            report.add(
                "WF114", "error", where,
                f"tiered hot capacity {hot} <= batch capacity {cap}: one "
                f"batch of distinct keys can oversubscribe the hot "
                f"directory — those lanes drop (counted overflow_drops)",
                hint="raise num_keys/TierConfig.hot_capacity above the "
                     "batch capacity")
        slots = 1 << max(1, (2 * hot - 1).bit_length()) if hot else 0
        if isinstance(op, (StreamTableJoin, Distinct)) \
                and slots > JOIN_PROBE_SMEM_SLOTS:
            report.add(
                "WF114", "warning", where,
                f"tiered hot table of {hot} rows hashes into {slots} probe "
                f"slots, beyond K5's shared-memory table "
                f"(ops/lookup.py::JOIN_PROBE_SMEM_SLOTS = "
                f"{JOIN_PROBE_SMEM_SLOTS}): the hot probe reads the table "
                f"through L2 — correct, but the shared-memory win silently "
                f"disappears",
                hint=f"keep the hot capacity at or below "
                     f"{JOIN_PROBE_SMEM_SLOTS // 2} rows so K5 holds it in "
                     f"shared memory; the cold tier absorbs the rest")


def _feeding_sources(mp) -> list:
    """Every source transitively feeding a graph pipe (through merges and
    split parents) — the WF112 session/event-time check needs to know
    whether ANY upstream assigns event time."""
    out, seen = [], set()

    def visit(p):
        if id(p) in seen:
            return
        seen.add(id(p))
        if p.source is not None:
            out.append(p.source)
        for up in p.merge_inputs:
            visit(up)
        if p._dataflow_parent is not None:
            visit(p._dataflow_parent)
    visit(mp)
    return out


def _check_stream_ops(report, ops, in_spec, where_prefix: str,
                      sources=()) -> None:
    """WF111/WF112: join/session operator configuration against the
    watermark machinery — spec-level only, zero device work."""
    from ..operators.join import IntervalJoin
    from ..operators.session import SessionWindow
    from ..operators.source import DeviceSource
    spec = in_spec
    for i, op in enumerate(ops):
        where = f"{where_prefix}.ops[{i}]:{op.getName()}"
        if isinstance(op, IntervalJoin):
            if op.lower > op.upper:
                report.add(
                    "WF111", "error", where,
                    f"interval-join match window is empty: lower "
                    f"{op.lower} > upper {op.upper} — no pair can ever "
                    f"satisfy r.ts - l.ts in [lower, upper]",
                    hint="swap the bounds (lower <= upper); [0, W] matches "
                         "rights up to W ticks after their left")
            elif op.upper + op.delay < 0:
                report.add(
                    "WF111", "error", where,
                    f"interval-join bounds are incompatible with the "
                    f"configured watermark delay: upper {op.upper} + delay "
                    f"{op.delay} < 0, so the eviction rule (keep r.ts >= "
                    f"wm - delay + lower) removes every in-window right "
                    f"tuple before any left probe can arrive",
                    hint="raise delay to at least -upper (the lateness the "
                         "backward-looking window implies), or widen upper")
            if ((op.ts_l is not None or op.ts_r is not None)
                    and spec is not None):
                from ..batch import CTRL_DTYPE
                try:
                    dl = (_tuple_probe(op.ts_l, spec).dtype
                          if op.ts_l is not None else CTRL_DTYPE)
                    dr = (_tuple_probe(op.ts_r, spec).dtype
                          if op.ts_r is not None else CTRL_DTYPE)
                except Exception as e:  # noqa: BLE001 — surfaced as WF111
                    report.add("WF111", "error", where,
                               f"event-time extractor rejects the upstream "
                               f"payload spec: {type(e).__name__}: {e}")
                else:
                    if dl != dr:
                        report.add(
                            "WF111", "error", where,
                            f"the two join inputs disagree on timestamp "
                            f"dtype: left extractor resolves {dl}, right "
                            f"resolves {dr} — every watermark compare "
                            f"would silently promote one side",
                            hint="cast both extractors to one dtype "
                                 "(int32 event time is the control-field "
                                 "contract)")
        spec_attr = getattr(op, "spec", None)
        if (isinstance(op, SessionWindow)
                or getattr(spec_attr, "is_session", False)):
            from ..operators.source import RecordSource

            def _no_event_time(s):
                # ts defaults to the arrival index: DeviceSource without a
                # ts_fn, RecordSource without a ts_field. GeneratorSource
                # items MAY carry (payload, key, ts) triples — unknowable
                # statically, so it never triggers the diagnostic.
                if isinstance(s, RecordSource):
                    return s.ts_field is None
                if isinstance(s, DeviceSource):
                    return s.ts_fn is None
                return False
            if sources and all(_no_event_time(s) for s in sources):
                report.add(
                    "WF112", "error", where,
                    f"session gap ({spec_attr.gap if spec_attr else '?'}) "
                    f"under a CB-only source: every source feeding this "
                    f"operator assigns no event time (ts defaults to the "
                    f"tuple index), so the gap — an event-time quantity — "
                    f"would fire on arrival positions",
                    hint="give the source a ts_fn (DeviceSource) / ts "
                         "column (GeneratorSource ts triple, RecordSource "
                         "ts_field) carrying real event time")
        try:
            spec = op.out_spec(spec) if spec is not None else None
        except Exception:  # noqa: BLE001 — already diagnosed as WF101
            spec = None


def _resolve_control(explicit, stored):
    from ..control import ControlConfig
    if explicit is not None:
        return ControlConfig.resolve(explicit)
    return stored


# -------------------------------------------------------------- validators


def _source_spec(report, source, where: str) -> Optional[Any]:
    """Source ``payload_spec()`` with the WF101 check — the one
    implementation every driver validator goes through. None on failure."""
    try:
        spec = source.payload_spec()
    except Exception as e:  # noqa: BLE001 — diagnosis IS the product here
        report.add("WF101", "error", where,
                   f"source payload_spec() fails: {type(e).__name__}: {e}")
        return None
    return spec


def _validate_chain_ops(report, ops, in_spec, in_cap, where: str,
                        sink=None) -> Optional[Any]:
    out, _cap = _flow_ops(report, ops, in_spec, where, in_cap)
    if sink is None and not _has_reduce_sink(ops):
        report.add(
            "WF107", "warning", where,
            "no sink and no in-graph ReduceSink: every output batch is "
            "computed, transferred, and discarded",
            hint="add a Sink/ReduceSink, or drop the dead tail of the chain")
    return out


def _validate_pipeline(report, p, faults, control, supervised,
                       trace=None, dispatch=None) -> None:
    cfg = _resolve_control(control, getattr(p, "_control", None))
    in_spec = _source_spec(report, p.source, f"source:{p.source.getName()}")
    if in_spec is None:
        return
    # the chain's operators were geometry-bound at construction — flow the
    # specs only (binding again with a validator-chosen capacity could skew
    # budget-derived archive sizes)
    _validate_chain_ops(report, p.chain.ops, in_spec, None, "pipeline",
                        sink=p.sink)
    _check_stream_ops(report, p.chain.ops, in_spec, "pipeline", [p.source])
    _check_tiered(report, p.chain.ops, cfg, trace,
                  getattr(p, "_trace_arg", None), supervised, "pipeline")
    _check_faults(report, faults, "supervised" if supervised else "pipeline")
    _check_admission(report, cfg, supervised, "control.admission")
    _check_trace(report, trace, getattr(p, "_trace_arg", None), supervised)
    _check_health(report, getattr(p, "_monitoring_arg", None))
    _check_slo(report, getattr(p, "_monitoring_arg", None))
    _check_telemetry(report, getattr(p, "_monitoring_arg", None))
    _check_profile(report, getattr(p, "_monitoring_arg", None))
    _check_remediation(report, getattr(p, "_monitoring_arg", None), cfg)
    _check_serving(report, getattr(p, "_serving_arg", None),
                   getattr(p, "_monitoring_arg", None), supervised)
    _check_dispatch(report, dispatch, getattr(p, "_dispatch_arg", None), cfg,
                    trace, getattr(p, "_trace_arg", None), supervised)


def _validate_supervised(report, sp, faults, control, trace=None,
                         dispatch=None, shards=None, reshard=None,
                         shard_key=None) -> None:
    cfg = _resolve_control(control, getattr(sp, "_control", None))
    in_spec = _source_spec(report, sp.source,
                           f"source:{sp.source.getName()}")
    if in_spec is None:
        return
    _validate_chain_ops(report, sp.chain.ops, in_spec, None, "supervised",
                        sink=sp.sink)
    _check_stream_ops(report, sp.chain.ops, in_spec, "supervised",
                      [sp.source])
    _check_tiered(report, sp.chain.ops, cfg, trace,
                  getattr(sp, "_trace_arg", None), True, "supervised")
    _check_faults(report, faults if faults is not None
                  else getattr(sp, "_faults_arg", None), "supervised")
    _check_admission(report, cfg, True, "control.admission")
    _check_trace(report, trace, getattr(sp, "_trace_arg", None), True)
    _check_health(report, getattr(sp, "_monitoring_arg", None))
    _check_slo(report, getattr(sp, "_monitoring_arg", None))
    _check_telemetry(report, getattr(sp, "_monitoring_arg", None))
    _check_profile(report, getattr(sp, "_monitoring_arg", None))
    _check_remediation_supervised(report, sp)
    _check_serving(report, getattr(sp, "_serving_arg", None),
                   getattr(sp, "_monitoring_arg", None), True)
    _check_dispatch(report, dispatch, getattr(sp, "_dispatch_arg", None),
                    cfg, trace, getattr(sp, "_trace_arg", None), True)
    _check_shards(report,
                  shards if shards is not None
                  else getattr(sp, "_shards", None),
                  reshard if reshard is not None
                  else getattr(sp, "_reshard_arg", None),
                  sp.chain.ops, cfg, trace, getattr(sp, "_trace_arg", None),
                  dispatch, getattr(sp, "_dispatch_arg", None),
                  faults if faults is not None
                  else getattr(sp, "_faults_arg", None), "supervised",
                  shard_key=(shard_key if shard_key is not None
                             else getattr(sp, "_shard_key", None)))


def _validate_threaded(report, tp, faults, control, supervised,
                       trace=None, dispatch=None) -> None:
    cfg = _resolve_control(control, getattr(tp, "_control", None))
    spec = _source_spec(report, tp.source,
                        f"source:{tp.source.getName()}")
    if spec is None:
        return
    wf114_sup_done = False
    for i, chain in enumerate(tp.chains):
        # capacity None: segment chains were geometry-bound at construction
        _check_stream_ops(report, chain.ops, spec, f"seg{i}", [tp.source])
        # supervised-combination findings emit once, from the FIRST segment
        # that actually has tiered ops (the graph-driver convention)
        has_tiered = any(getattr(op, "_tier_cfg", None) is not None
                         for op in chain.ops)
        _check_tiered(report, chain.ops, cfg, trace,
                      getattr(tp, "_trace_arg", None),
                      supervised and has_tiered and not wf114_sup_done,
                      f"seg{i}")
        wf114_sup_done = wf114_sup_done or has_tiered
        spec, _cap = _flow_ops(report, chain.ops, spec, f"seg{i}", None)
        if spec is None:
            break
    if tp.sink is None and not any(_has_reduce_sink(c.ops)
                                   for c in tp.chains):
        report.add("WF107", "warning", "threaded",
                   "no sink and no in-graph ReduceSink: the final ring's "
                   "batches are popped and discarded",
                   hint="add a Sink/ReduceSink, or drop the dead tail")
    edges = [(name, tp.edge_capacities[name]) for name in tp.edge_names]
    _check_watermarks(report, cfg, edges)
    _check_prefetch(report, getattr(tp, "prefetch", 0),
                    edges[0] if edges else None)
    _check_faults(report, faults if faults is not None
                  else getattr(tp, "_faults_arg", None), "threaded")
    _check_admission(report, cfg, supervised, "control.admission")
    _check_trace(report, trace, getattr(tp, "_trace_arg", None), supervised)
    _check_health(report, getattr(tp, "_monitoring_arg", None))
    _check_slo(report, getattr(tp, "_monitoring_arg", None))
    _check_telemetry(report, getattr(tp, "_monitoring_arg", None))
    _check_profile(report, getattr(tp, "_monitoring_arg", None))
    _check_remediation(report, getattr(tp, "_monitoring_arg", None), cfg)
    _check_serving(report, getattr(tp, "_serving_arg", None),
                   getattr(tp, "_monitoring_arg", None), supervised)
    _check_dispatch(report, dispatch, getattr(tp, "_dispatch_arg", None),
                    cfg, trace, getattr(tp, "_trace_arg", None), supervised,
                    edges=edges)


def _graph_edges(g):
    """(label, capacity) per dataflow edge — resolved over the SAME
    enumeration the threaded driver builds rings from
    (``PipeGraph._iter_edges``), so the checks can never drift onto edges
    the driver does not create."""
    from ..runtime.threaded import resolve_edge_capacity
    return [(label, resolve_edge_capacity(g.queue_capacity, label, index))
            for _prod, _dst, label, index in g._iter_edges()]


def _check_graph_edges(report, g, cfg) -> None:
    """Resolve every threaded-driver edge capacity the way the driver will —
    an illegal per-edge capacity (<1, bad dict/callable) is a WF104 error
    *now* instead of a ValueError mid-``run(threaded=True)``."""
    try:
        edges = _graph_edges(g)
    except Exception as e:  # noqa: BLE001 — diagnosis IS the product here
        report.add("WF104", "error", "queue_capacity",
                   f"edge capacity resolution fails: "
                   f"{type(e).__name__}: {e}",
                   hint="queue_capacity must resolve every edge to an int "
                        ">= 1 (one int, a dict keyed by edge label/index, "
                        "or a callable (label, index) -> int)")
        return
    _check_watermarks(report, cfg, edges)


def _validate_graph(report, g, faults, control, supervised,
                    threaded, trace=None, dispatch=None, shards=None,
                    reshard=None, shard_key=None) -> None:
    from ..basic import DEFAULT_BATCH_SIZE
    from ..control import ControlConfig
    from ..runtime.pipeline import resolve_batch_hint
    if not g._roots:
        report.add("WF100", "error", "graph",
                   "PipeGraph has no sources — nothing will run",
                   hint="add_source(...) before validating/running")
        return
    stored = g._control
    if stored is None:
        stored = ControlConfig.resolve(g._control_arg)
    cfg = _resolve_control(control, stored)
    batch = (g.batch_size if g.batch_size is not None
             else (resolve_batch_hint(g._operators) or DEFAULT_BATCH_SIZE))
    pipes = g._all_pipes()
    pipe_idx = {id(p): i for i, p in enumerate(pipes)}
    out_specs, out_caps = {}, {}
    wf114_sup_done = False
    for mp in g._topo_order():
        where = f"pipe[{pipe_idx[id(mp)]}]"
        if mp.source is not None:
            in_spec = _source_spec(
                report, mp.source,
                f"{where}.source:{mp.source.getName()}")
            if in_spec is None:
                continue
            in_cap = getattr(mp.source, "out_capacity",
                             lambda b: b)(batch)
        elif mp.merge_inputs:
            specs = [out_specs.get(id(p)) for p in mp.merge_inputs]
            if any(s is None for s in specs):
                continue               # upstream already diagnosed
            in_spec = specs[0]         # merge() checked compatibility
            in_cap = batch             # merged releases re-chunk to batch
        else:
            parent = mp._dataflow_parent
            in_spec = out_specs.get(id(parent))
            in_cap = out_caps.get(id(parent))
            if in_spec is None:
                continue               # upstream already diagnosed
        _check_stream_ops(report, mp.ops, in_spec, where,
                          _feeding_sources(mp))
        # supervised-combination findings emit once (first tiered pipe);
        # the per-op geometry findings emit per pipe
        has_tiered = any(getattr(op, "_tier_cfg", None) is not None
                         for op in mp.ops)
        _check_tiered(report, mp.ops, cfg, trace,
                      getattr(g, "_trace_arg", None),
                      supervised and has_tiered and not wf114_sup_done,
                      where)
        wf114_sup_done = wf114_sup_done or has_tiered
        out, out_cap = _flow_ops(report, mp.ops, in_spec, where, in_cap)
        out_specs[id(mp)] = out
        if out_cap is not None:
            out_caps[id(mp)] = out_cap
        if mp.split_fn is not None and out is not None:
            _check_split(report, mp, out, where)
        if (mp.sink is None and not mp.split_branches
                and not mp._outputs_to and mp.split_fn is None
                and not _has_reduce_sink(mp.ops)):
            report.add(
                "WF107", "warning", where,
                "leaf pipe has no sink, no in-graph ReduceSink, and no "
                "downstream edge — its output batches are discarded",
                hint="add a sink to this branch (or merge it into a pipe "
                     "that has one)")
    if threaded:
        # ring edges exist only under run(threaded=True) — the push driver
        # never resolves queue_capacity, so these checks would be spurious
        _check_graph_edges(report, g, cfg)
    driver = ("supervised" if supervised
              else ("graph-threaded" if threaded else "graph"))
    _check_faults(report, faults, driver)
    _check_admission(report, cfg, supervised, "control.admission")
    _check_trace(report, trace, getattr(g, "_trace_arg", None), supervised)
    _check_health(report, getattr(g, "_monitoring_arg", None))
    _check_slo(report, getattr(g, "_monitoring_arg", None))
    _check_telemetry(report, getattr(g, "_monitoring_arg", None))
    _check_profile(report, getattr(g, "_monitoring_arg", None))
    _check_remediation(report, getattr(g, "_monitoring_arg", None), cfg)
    _check_serving(report, getattr(g, "_serving_arg", None),
                   getattr(g, "_monitoring_arg", None), supervised)
    dedges = None
    if threaded:
        try:
            dedges = _graph_edges(g)
        except Exception:  # noqa: BLE001 — already a WF104 error above
            dedges = None
    _check_dispatch(report, dispatch, getattr(g, "_dispatch_arg", None),
                    cfg, trace, getattr(g, "_trace_arg", None), supervised,
                    edges=dedges)
    if supervised:
        # run unconditionally: shards=None consults WF_SHARDS inside
        # _check_shards (the run_graph_supervised resolution) — an
        # env-driven sharded run must get the same WF115 coverage as an
        # explicit one
        _check_shards(report, shards, reshard, g._operators, cfg, trace,
                      getattr(g, "_trace_arg", None), dispatch,
                      getattr(g, "_dispatch_arg", None), faults, "graph",
                      shard_key=shard_key)


def _validate_compiled_chain(report, chain, faults, control,
                             supervised, trace=None) -> None:
    _flow_ops(report, chain.ops, chain.specs[0], "chain", None)
    _check_faults(report, faults, "supervised" if supervised else "pipeline")
    from ..control import ControlConfig
    _check_admission(report, ControlConfig.resolve(control)
                     if control is not None else None,
                     supervised, "control.admission")
    if trace is not None:
        _check_trace(report, trace, None, supervised)


def _check_progcheck(report, obj, progcheck, dispatch, supervised,
                     shards) -> None:
    """WF300-WF305: trace the driver's built-but-not-run step/scan
    programs (``analysis/progcheck.py`` — zero FLOPs, zero device) and
    append the device-program findings, baseline-suppressed like the CLI.

    Gated by the ``progcheck=`` kwarg, else ``WF_PROGCHECK`` (default on,
    ``'0'`` disables).  Skipped when the report already carries errors
    (tracing a graph whose specs do not even flow would only bury the real
    diagnosis under a TypeError), and NEVER fatal: a trace failure means
    the dynamic path will surface it with full context."""
    if progcheck is None:
        progcheck = os.environ.get("WF_PROGCHECK", "1") not in ("", "0")
    if not progcheck or not report.ok:
        return
    try:
        from . import progcheck as pc
        from ..runtime.dispatch import DispatchConfig
        chains = []
        if getattr(obj, "chain", None) is not None:
            chains.append(("chain", obj.chain))
        elif getattr(obj, "chains", None):
            chains += [(f"seg{i}", c) for i, c in enumerate(obj.chains)]
        elif getattr(obj, "ops", None) is not None \
                and getattr(obj, "specs", None) is not None:
            chains.append(("chain", obj))        # a raw CompiledChain
        if not chains:
            return
        dcfg = DispatchConfig.resolve(
            dispatch if dispatch is not None
            else getattr(obj, "_dispatch_arg", None))
        k = dcfg.k if dcfg is not None else 1
        from ..parallel.sharding import resolve_shards
        n_shards = resolve_shards(shards if shards is not None
                                  else getattr(obj, "_shards", None)) or 1
        programs = []
        for label, chain in chains:
            programs += pc.chain_programs(
                chain, k=k, shards=n_shards,
                replay=bool(supervised), target=label)
        findings = pc.analyze_programs(programs)
        counts, _problems = pc.load_baseline(pc.baseline_path())
        for f in pc.apply_baseline(findings, counts):
            report.add(f.code, f.severity, f.path, f.message)
    except Exception:  # noqa: BLE001 — analysis must never block validation
        return


def _validate_serving_runtime(report, rt, faults, control, trace=None,
                              dispatch=None) -> None:
    """A ServingRuntime is a Pipeline to the spec-flow checks, plus the
    WF119 serving checks over its ALREADY-resolved config (construction
    raised on fatal problems; the report re-derives them for tooling) and
    a spec-flow pass over every registered swap-candidate graph — a swap
    target that cannot type-check against the source would otherwise fail
    mid-run, inside the cutover quiesce."""
    cfg = _resolve_control(control, None)
    in_spec = _source_spec(report, rt.source,
                           f"source:{rt.source.getName()}")
    if in_spec is None:
        return
    _validate_chain_ops(report, rt.chain.ops, in_spec, None, "serving",
                        sink=rt.sink)
    _check_stream_ops(report, rt.chain.ops, in_spec, "serving", [rt.source])
    for label, g_ops in getattr(rt, "_graphs", {}).items():
        _flow_ops(report, g_ops, in_spec, f"serving.graph[{label}]", None)
    _check_faults(report, faults,
                  "supervised" if rt._supervised else "pipeline")
    _check_trace(report, trace, None, rt._supervised)
    _check_health(report, rt._monitoring_arg)
    _check_slo(report, rt._monitoring_arg)
    _check_telemetry(report, rt._monitoring_arg)
    _check_profile(report, rt._monitoring_arg)
    _check_remediation(report, rt._monitoring_arg, cfg)
    _check_serving(report, rt.config, rt._monitoring_arg, rt._supervised)


# ------------------------------------------------------------------ public


def validate(obj, *, faults=None, control=None, supervised: bool = None,
             threaded: bool = False, trace=None, dispatch=None,
             shards=None, reshard=None, shard_key=None,
             progcheck: bool = None) -> ValidationReport:
    """Validate a built-but-not-run driver object; returns a
    :class:`ValidationReport` (never raises on findings — call
    ``.raise_if_errors()`` to gate).

    ``obj``: a ``PipeGraph``, ``Pipeline``, ``ThreadedPipeline``,
    ``SupervisedPipeline``, ``ServingRuntime``, or raw ``CompiledChain``.

    ``faults``: a ``FaultPlan``/``FaultInjector``/JSON string to check
    against the sites the chosen driver actually threads; ``None`` consults
    ``WF_FAULT_PLAN`` (mirroring the drivers).

    ``control``: a ``ControlConfig``/dict/bool overriding the object's own
    stored control config for the configuration checks.

    ``supervised``: declare that the object will run under supervision
    (``run_supervised`` / ``run_graph_supervised``); inferred True for a
    ``SupervisedPipeline``. ``threaded``: a ``PipeGraph`` destined for
    ``run(threaded=True)`` (enables the ring-edge checks).

    ``trace``: a ``TraceConfig``/bool/out-dir overriding the object's own
    stored ``trace=`` argument for the WF108 determinism checks; ``None``
    consults the stored argument and ``WF_TRACE`` (mirroring the drivers).

    ``dispatch``: a ``DispatchConfig``/bool/int K/dict overriding the
    object's own stored ``dispatch=`` argument for the WF110 scan-dispatch
    checks; ``None`` consults the stored argument and ``WF_DISPATCH``
    (mirroring the drivers).

    ``shards``/``reshard``/``shard_key``: the shard count, re-sharding
    plan, and ownership-key override destined for the sharded supervisors,
    for the WF115 checks — a ``SupervisedPipeline`` consults its own
    stored arguments when these are None; for a ``PipeGraph`` pass the
    values you will pass to ``run_supervised`` (with ``supervised=True``;
    ``shards=None`` consults ``WF_SHARDS``, mirroring the driver).

    ``progcheck``: run the device-program analyzer (WF300-WF305,
    ``analysis/progcheck.py``) over the object's built-but-not-run
    step/scan programs under the resolved dispatch K / shard / supervision
    config; ``None`` consults ``WF_PROGCHECK`` (default on, ``'0'``
    disables). Skipped when the report already has errors."""
    from ..runtime.pipegraph import PipeGraph
    from ..runtime.pipeline import CompiledChain, Pipeline
    from ..runtime.supervisor import SupervisedPipeline
    from ..runtime.threaded import ThreadedPipeline
    from ..serving.runtime import ServingRuntime

    if isinstance(obj, ServingRuntime):
        report = ValidationReport("ServingRuntime")
        _validate_serving_runtime(report, obj, faults, control,
                                  trace, dispatch)
    elif isinstance(obj, PipeGraph):
        report = ValidationReport(f"PipeGraph({obj.name!r})")
        _validate_graph(report, obj, faults, control, bool(supervised),
                        threaded, trace, dispatch, shards, reshard,
                        shard_key)
    elif isinstance(obj, SupervisedPipeline):
        report = ValidationReport("SupervisedPipeline")
        _validate_supervised(report, obj, faults, control, trace, dispatch,
                             shards, reshard, shard_key)
    elif isinstance(obj, ThreadedPipeline):
        report = ValidationReport("ThreadedPipeline")
        _validate_threaded(report, obj, faults, control, bool(supervised),
                           trace, dispatch)
    elif isinstance(obj, Pipeline):
        report = ValidationReport("Pipeline")
        _validate_pipeline(report, obj, faults, control, bool(supervised),
                           trace, dispatch)
    elif isinstance(obj, CompiledChain):
        report = ValidationReport("CompiledChain")
        _validate_compiled_chain(report, obj, faults, control,
                                 bool(supervised), trace)
    else:
        report = ValidationReport(type(obj).__name__)
        report.add("WF100", "error", "target",
                   f"cannot validate a {type(obj).__name__}; expected "
                   f"PipeGraph, Pipeline, ThreadedPipeline, "
                   f"SupervisedPipeline, ServingRuntime, or CompiledChain")
        return report
    _check_kernel_records(report)
    _check_progcheck(report, obj, progcheck, dispatch,
                     supervised if supervised is not None
                     else isinstance(obj, SupervisedPipeline),
                     shards)
    return report

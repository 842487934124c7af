"""Hermetic perf gate — Pillar 3 of the port's static-analysis layer.

Counterpart of ``windflow_tpu/analysis/perfgate.py``. The JAX gate pins
XLA's logical cost model of each workload step, AOT-lowered on the CPU
backend; the port pins the logical cost of each workload's step traced over
fake tensors (``make_fx(..., tracing_mode="fake")``, the progcheck trace),
so the gate runs on the CPU with zero device access. Two instruments:

1. **Logical cost pins.** For each workload (``WORKLOAD_CAPACITY``'s six,
   the K-step program ``ysb_scan_k8`` and the shard splitter
   ``reshard_pack``): the aten op count of the traced step, the bytes its
   ops read and write (the ``nbytes`` of every tensor operand and result,
   summed over the ops) and its FLOPs
   (``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
   and convolution ops; the streaming chains have none). The numbers are
   deterministic for a given tree and torch version (the baseline records
   the version), so a change that bloats a step (a gather that became a
   loop, an extra copy, a dtype promotion) fails the gate the day it lands.

   Ratchet-down semantics, as in the JAX package: cost ABOVE the pin
   (beyond ``rtol``) is a **regression**; cost BELOW it a **stale pin**
   (bank it with ``--update-baseline``). A workload without a pin, a pin
   without a workload and a capacity or K change also fail.

2. **Proxy microbenchmarks.** Every kernel family of
   ``observability/names.py::KERNELS`` (and ``PERF_PROXY_FAMILIES``) is
   timed, min of reps: on the CPU its plain version, on the card its hand
   kernel. Advisory: compared against the baseline only under
   ``--strict-proxy``.

CLI: ``python -m windflow_tpu_torch.analysis.perfgate`` (exit 0 clean / 1
findings / 2 internal error). Baseline override: ``WF_PERFGATE_BASELINE``
or ``--baseline``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: default location of the pinned baseline (checked in, ratchet-down)
BASELINE_REL = os.path.join("windflow_tpu_torch", "analysis", "perfgate_baseline.json")
#: relative tolerance around a cost pin: above = regression, below = stale
DEFAULT_RTOL = 0.02
#: advisory proxy-microbench regression factor (strict mode only)
PROXY_FACTOR = 3.0
#: the pinned metrics of a workload row
METRICS = ("aten_ops", "flops", "bytes_accessed")

#: trace capacities per workload (the JAX gate's)
WORKLOAD_CAPACITY = {"ysb": 2048, "mp_matrix": 1024,
                     "nexmark_join": 512, "nexmark_session": 512,
                     "nexmark_topn": 512,
                     # the tiered-state miss -> readmit -> reprobe round: the
                     # q3 join chain with tiered= on (resolve, probe fallback,
                     # eviction; the cold read is the cold_probe kernel's)
                     "tiered_probe_miss": 512}

#: scan-dispatch workloads: (base workload, K) — the K-step program
#: (``CompiledChain._k_steps``, the body ``push_many`` captures) pinned
#: beside the per-batch step
SCAN_WORKLOADS = {"ysb_scan_k8": ("ysb", 8)}

#: reshard_pack pin geometry: one batch split into N masked per-shard
#: sub-batches (``parallel/sharding.py::make_splitter``, the only per-batch
#: program the sharded supervisors add)
RESHARD_PACK_CAPACITY = 2048
RESHARD_PACK_SHARDS = 4

_CPU = "cpu"


# ------------------------------------------------------------- workloads


def _build_ysb():
    """The YSB chain as the JAX gate builds it, at the gate capacity, with
    its device-cursor step (``benchmarks/__init__.py::device_cursor_step``)."""
    from ..benchmarks import device_cursor_step, ysb
    from ..runtime.pipeline import CompiledChain
    cap = WORKLOAD_CAPACITY["ysb"]
    panes_per_batch = cap // (ysb.EVENTS_PER_TICK * ysb.WIN_LEN) + 1
    src = ysb.make_source(total=16 * cap, device=_CPU)
    ops = ysb.make_ops(pane_capacity=2 * panes_per_batch + 2,
                       max_wins=panes_per_batch + 64, device=_CPU)
    chain = CompiledChain(ops, src.payload_spec(), batch_capacity=cap,
                          event_time=False, device=_CPU)
    return chain, device_cursor_step(chain, src, cap), cap


def _build_mp_matrix():
    """A representative mp-matrix chain: stateless map/filter ahead of a
    keyed TB FFAT window (the fold path the segment/histogram kernels
    serve)."""
    from ..basic import win_type_t
    from ..benchmarks import device_cursor_step
    from ..operators import DeviceSource, Filter, Key_FFAT, Map, WindowSpec
    from ..runtime.pipeline import CompiledChain
    cap = WORKLOAD_CAPACITY["mp_matrix"]
    src = DeviceSource(lambda i: {"v": ((i * 13) % 23).float()}, total=16 * cap,
                       num_keys=8, device=_CPU)
    ops = [Map(lambda t: {"v": t.v + 1.0}, device=_CPU),
           Filter(lambda t: t.v > 2.0, device=_CPU),
           Key_FFAT(lambda t: t.v, torch.add, spec=WindowSpec(40, 20, win_type_t.TB),
                    num_keys=8, device=_CPU)]
    chain = CompiledChain(ops, src.payload_spec(), batch_capacity=cap,
                          event_time=False, device=_CPU)
    return chain, device_cursor_step(chain, src, cap), cap


def _build_nexmark(query: str, cap: int, **kw):
    """One Nexmark query chain at the gate capacity."""
    from ..benchmarks import device_cursor_step
    from ..nexmark import make_query
    from ..runtime.pipeline import CompiledChain
    src, ops = make_query(query, 16 * cap, device=_CPU, **kw)
    chain = CompiledChain(ops, src.payload_spec(), batch_capacity=cap,
                          event_time=False, device=_CPU)
    return chain, device_cursor_step(chain, src, cap), cap


def _build_nexmark_join():
    return _build_nexmark("q3_enrich_join", WORKLOAD_CAPACITY["nexmark_join"])


def _build_nexmark_session():
    return _build_nexmark("q5_session", WORKLOAD_CAPACITY["nexmark_session"])


def _build_nexmark_topn():
    return _build_nexmark("q6_topn", WORKLOAD_CAPACITY["nexmark_topn"])


def _build_tiered_probe_miss():
    """The q3 join chain with tiered state ON at a 100x key space, its hot
    capacity clearing the admission reserve (WF114's sizing rule)."""
    cap = WORKLOAD_CAPACITY["tiered_probe_miss"]
    return _build_nexmark("q3_enrich_join", cap, n_auctions=100 * 16, num_slots=2048,
                          tiered=dict())


WORKLOADS: Dict[str, Callable] = {
    "ysb": _build_ysb,
    "mp_matrix": _build_mp_matrix,
    "nexmark_join": _build_nexmark_join,
    "nexmark_session": _build_nexmark_session,
    "nexmark_topn": _build_nexmark_topn,
    "tiered_probe_miss": _build_tiered_probe_miss,
}


# ------------------------------------------------------------ cost model


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    return 0


def _node_value(gm, node):
    if node.op == "get_attr":
        return getattr(gm, node.target, None)
    return node.meta.get("val")


def _flops(gm) -> int:
    """FLOPs of one run of ``gm`` over fresh fake inputs of its placeholders'
    shapes (``FlopCounterMode``: matrix and convolution ops)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    vals = [n.meta.get("val") for n in gm.graph.nodes if n.op == "placeholder"]
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        ins = [torch.empty_strided(tuple(v.shape), tuple(v.stride()), dtype=v.dtype,
                                   device=v.device) if isinstance(v, torch.Tensor) else v
               for v in vals]
        with FlopCounterMode(display=False) as fc:
            gm(*ins)
    return int(fc.get_total_flops())


def graph_cost(gm) -> Dict[str, float]:
    """Logical cost of one traced program: aten ops, bytes read and written
    (tensor operands and results of every op) and FLOPs."""
    ops = nbytes = 0
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        ops += 1
        nbytes += sum(_nbytes(_node_value(gm, a)) for a in node.all_input_nodes)
        nbytes += _nbytes(node.meta.get("val"))
    return {"aten_ops": float(ops), "flops": float(_flops(gm)),
            "bytes_accessed": float(nbytes)}


def _trace_step(step, chain, cap):
    """The device-cursor step ``(states, cur) -> ...`` traced over fake
    tensors (``progcheck._trace``)."""
    from ..batch import CTRL_DTYPE
    from .progcheck import _trace
    cur = torch.zeros((), dtype=CTRL_DTYPE, device=chain.device)
    gm, _seen = _trace(lambda tree: step(*tree), (tuple(chain.states), cur), chain.device)
    return gm


def workload_cost(name: str) -> Dict[str, float]:
    """The logical cost of one gate workload's full step (source framing +
    chain), traced with zero execution."""
    chain, step, cap = WORKLOADS[name]()
    out = graph_cost(_trace_step(step, chain, cap))
    out["capacity"] = cap
    return out


def chain_step_cost(name: str) -> Dict[str, float]:
    """Cost of ONE chain-only batch step (no source framing) — the
    denominator of the scan amortization check."""
    from .progcheck import trace_step
    chain, _, cap = WORKLOADS[name]()
    out = graph_cost(trace_step(chain, cap)[0])
    out["capacity"] = cap
    return out


def workload_scan_cost(name: str) -> Dict[str, float]:
    """Cost of the K-step program for one ``SCAN_WORKLOADS`` entry: the K
    batches of a stacked ``[K, C, ...]`` batch through the chain
    (``CompiledChain._k_steps``). Torch traces the K bodies unrolled, so
    the program costs about K times the chain step (the JAX cost model
    counts a ``lax.scan`` body once)."""
    from .progcheck import trace_scan
    base, k = SCAN_WORKLOADS[name]
    chain, _, cap = WORKLOADS[base]()
    out = graph_cost(trace_scan(chain, k, cap)[0])
    out["capacity"] = cap
    out["k"] = k
    return out


def reshard_pack_cost() -> Dict[str, float]:
    """Cost of the shard splitter at the pinned geometry. The pin guards the
    claim that sharding's per-batch overhead is ONE masked split."""
    from ..batch import Batch
    from ..parallel.sharding import ShardAssignment, make_splitter
    from .progcheck import _fake_batch, _trace
    cap = RESHARD_PACK_CAPACITY
    split = make_splitter(ShardAssignment(RESHARD_PACK_SHARDS))
    spec = {"v": torch.empty((), dtype=torch.float32, device="meta")}
    b = _fake_batch(cap, spec, torch.device(_CPU))
    gm, _seen = _trace(lambda tree: split(Batch(*tree)),
                       (b.key, b.id, b.ts, b.payload, b.valid), torch.device(_CPU))
    out = graph_cost(gm)
    out["capacity"] = cap
    out["shards"] = RESHARD_PACK_SHARDS
    return out


def stage_costs(chain, capacity: int) -> List[dict]:
    """Per-operator logical costs of a built chain: each op's ``apply``
    traced in isolation with the chain's own specs, capacities flowed
    through ``out_capacity``. A stage whose trace stops at a host read
    reports ``error`` instead."""
    from .progcheck import trace_ops
    parts, reads, _k = trace_ops(chain, capacity)
    why = dict(reads)
    out, cap = [], capacity
    for (label, gm), op in zip(parts, chain.ops):
        row = {"op": op.getName(), "capacity": int(cap) if cap else None}
        if gm is None:
            row["error"] = f"host read: {why.get(label)}"
        else:
            row.update(graph_cost(gm))
        out.append(row)
        cap = op.out_capacity(cap) if cap is not None else None
    return out


# --------------------------------------------------------- proxy benches


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _bench_one(fn, *args, reps: int = 3, device=_CPU) -> float:
    """Min-of-reps wall time of ``fn(*args)`` (one warm call first)."""
    fn(*args)
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def proxy_microbench(reps: int = 3, device=_CPU) -> Dict[str, dict]:
    """Timings of every kernel family (the JAX gate's shapes): the plain
    versions on the CPU, the hand kernels on the card. Keyed by
    ``names.py::KERNELS`` and ``PERF_PROXY_FAMILIES``, so a family without a
    row fails the gate's coverage check."""
    import numpy as np
    from ..ops.bitonic import merge_network
    from ..ops.histogram import keyed_pane_histogram
    from ..ops.lookup import (join_probe, join_table_init, join_table_probe,
                              join_table_tier_evict, join_table_tier_init,
                              join_table_upsert, table_lookup)
    from ..ops.segment import segment_fold
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out: Dict[str, dict] = {}

    def row(name, elems, fn, *args):
        out[name] = {"elems": elems,
                     "seconds": _bench_one(fn, *args, reps=reps, device=dev)}

    C, K, P = 8192, 100, 256
    key = t(rng.integers(0, K, C).astype(np.int32))
    pane = t((np.arange(C) // 200).astype(np.int32))
    ok = t(rng.random(C) < 0.9)
    row("histogram", C, lambda a, b, c: keyed_pane_histogram(a, b, c, K, P), key, pane, ok)

    KT, CT = 1000, 8192
    table = t(rng.integers(0, 1 << 12, KT).astype(np.int32))
    idx = t(rng.integers(0, KT, CT).astype(np.int32))
    row("lookup", CT, lambda a, b: table_lookup(a, b, traced=True), table, idx)

    n = 8192
    prim = t(rng.integers(0, 1 << 20, n).astype(np.int32))
    zero = torch.zeros((n,), dtype=torch.int32, device=dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    row("ordering_merge", n, merge_network, prim, zero, zero, iota)

    S = 512
    vals = t(rng.integers(-100, 100, C).astype(np.int32))
    seg = t(rng.integers(0, S, C).astype(np.int32))
    row("segment_fold", C, lambda v, s, o: segment_fold(v, s, o, S), vals, seg, ok)

    KJ = 512
    tk = t(rng.permutation(1 << 16)[:KJ].astype(np.int32))
    tv = t(rng.integers(0, 1 << 12, KJ).astype(np.int32))
    probe = t(rng.integers(0, 1 << 16, C).astype(np.int32))
    row("join_probe", C, join_probe, tk, tv, probe, ok)

    # join: one full versioned-JoinTable step — upsert then probe through
    # the registry's join_probe kernel
    CJ, KJ2, PJ = 1024, 256, 2048
    vspec = {"v": torch.empty((), dtype=torch.int32, device="meta")}
    jt = join_table_init(KJ2, PJ, vspec, dev)
    jk = t(rng.integers(0, KJ2, CJ).astype(np.int32))
    jv = {"v": t(rng.integers(0, 1 << 20, CJ).astype(np.int32))}
    jts = t(np.arange(CJ, dtype=np.int32))
    jok = t(rng.random(CJ) < 0.5)

    def join_step(st):
        st = join_table_upsert(st, jk, jv, jts, jts, jok, delay=0)
        v, hit = join_table_probe(st, jk, ~jok)
        return st, v["v"], hit
    row("join", CJ, join_step, jt)

    # spill: the tiered-state eviction/pack path over a fully loaded table
    KT2, ST2 = 2048, 1024
    ts0 = join_table_tier_init(join_table_init(KT2, 8, vspec, dev), ST2, vspec)
    ts0["key"] = t(rng.permutation(1 << 20)[:KT2].astype(np.int32))
    ts0["used"] = torch.ones((KT2,), dtype=torch.bool, device=dev)
    ts0["lap"] = t(rng.integers(0, 1 << 16, KT2).astype(np.int32))
    ts0["tick"] = torch.tensor(1 << 16, dtype=torch.int32, device=dev)
    row("spill", KT2, lambda s: join_table_tier_evict(s, KT2 // 2), ts0)

    # dispatch: K batches through ONE push_many (the runtime/dispatch.py hot
    # path; a captured graph replay on the card), launch counts alongside
    KD, CD = 8, 1024
    chain_d, group = _dispatch_chain(KD, CD, dev)
    chain_d.warm_scan(KD, CD)                   # build/capture outside the timing
    row("dispatch", KD * CD, chain_d.push_many, group)
    out["dispatch"].update(dispatch_launch_counts(k=KD, capacity=CD, device=dev))

    # shard: the sharded supervisors' key-ownership splitter
    from ..batch import Batch
    from ..parallel.sharding import ShardAssignment, make_splitter
    CS, NS = 8192, 4
    sb = Batch.of({"v": rng.random(CS).astype(np.float32)},
                  key=rng.integers(0, 64, CS).astype(np.int32), device=dev)
    row("shard", CS, make_splitter(ShardAssignment(NS)), sb)

    for r in out.values():
        r["ns_per_elem"] = round(r.pop("seconds") / r["elems"] * 1e9, 3)
    return out


def _dispatch_chain(k: int, capacity: int, device=_CPU):
    """A tiny stateless map+filter chain + exactly ``k`` capacity-C batches
    for the dispatch proxy/count instruments."""
    from ..operators import DeviceSource, Filter, Map
    from ..runtime.pipeline import CompiledChain
    src = DeviceSource(lambda i: {"v": (i % 97).float()}, total=k * capacity,
                       num_keys=8, device=device)
    ops = [Map(lambda t: {"v": t.v * 2.0 + 1.0}, device=device),
           Filter(lambda t: t.v > 3.0, device=device)]
    chain = CompiledChain(ops, src.payload_spec(), batch_capacity=capacity,
                          event_time=False, device=device)
    return chain, list(src.batches(capacity))


class _AtenCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def dispatch_launch_counts(k: int = 8, capacity: int = 1024,
                           n_batches: Optional[int] = None, device=_CPU) -> Dict[str, int]:
    """What the dispatch path launches for ``n_batches`` batches driven
    through a ``MicrobatchAccumulator(k)`` + ``push_many`` (tail drained
    short, the driver shape): ``launches``, the fused programs run (one
    per group: ``ceil(batches / k)``, where the per-batch path pays
    ``batches``), and per device what those are — ``aten_ops`` dispatched
    eagerly on the CPU, ``replays`` of captured CUDA graphs on the card."""
    from ..runtime.dispatch import MicrobatchAccumulator
    n = int(n_batches) if n_batches else 2 * k + max(1, k // 2)
    dev = torch.device(device)
    chain, batches = _dispatch_chain(n, capacity, dev)
    if dev.type == "cuda":
        for kk in range(2, k + 1):
            chain.warm_scan(kk, capacity)     # capture outside the count
    groups = 0
    fused0 = chain._fused_count
    acc = MicrobatchAccumulator(k)
    counter = _AtenCounter() if dev.type != "cuda" else None
    with counter if counter is not None else contextlib.nullcontext():
        for b in batches:
            for group in acc.feed(b):
                chain.push_many(group)
                groups += 1
        tail = acc.drain()
        if tail:
            chain.push_many(tail)
            groups += 1
    row = {"k": int(k), "batches": len(batches), "launches": groups}
    if counter is not None:
        row["aten_ops"] = counter.n
    else:
        row["replays"] = chain._fused_count - fused0
    return row


# --------------------------------------------------------------- baseline


def baseline_path(root: str = ".") -> str:
    override = os.environ.get("WF_PERFGATE_BASELINE", "")
    if override:
        return override if os.path.isabs(override) else os.path.join(root, override)
    return os.path.join(root, BASELINE_REL)


def load_baseline(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def save_baseline(path: str, report: dict) -> None:
    payload = {
        "comment": "hermetic perf-gate pins of the port (logical cost of each "
                   "workload step traced over fake tensors: aten ops, bytes "
                   "read and written, FLOPs; proxy rows are advisory). "
                   "Regenerate with python -m windflow_tpu_torch.analysis."
                   "perfgate --update-baseline after an INTENTIONAL cost "
                   "change — the gate ratchets down: improvements must be "
                   "banked here or they fail as stale pins.",
        "torch": torch.__version__,
        "workloads": report["workloads"],
        "proxy": report.get("proxy", {}),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")


def measure(skip_proxy: bool = False, reps: int = 3, device=_CPU) -> dict:
    """The gate's current measurement: cost pins for every workload (+
    advisory proxy timings on ``device``)."""
    report = {"workloads": {name: workload_cost(name) for name in WORKLOADS}}
    for name in SCAN_WORKLOADS:
        report["workloads"][name] = workload_scan_cost(name)
    report["workloads"]["reshard_pack"] = reshard_pack_cost()
    if not skip_proxy:
        report["proxy"] = proxy_microbench(reps=reps, device=device)
    return report


def compare(current: dict, baseline: Optional[dict],
            rtol: float = DEFAULT_RTOL, strict_proxy: bool = False,
            proxy_factor: float = PROXY_FACTOR) -> List[dict]:
    """Findings between a measurement and the pinned baseline (empty =
    clean). Kinds: ``regression`` / ``stale-pin`` / ``unpinned`` /
    ``stale-workload`` / ``capacity-drift`` / ``proxy-regression`` /
    ``proxy-coverage`` — the JAX package's semantics, over the port's
    metrics (a metric a row lacks is not compared)."""
    out: List[dict] = []
    if baseline is None:
        for name in current["workloads"]:
            out.append({"kind": "unpinned", "workload": name,
                        "message": f"workload {name!r} has no baseline — "
                                   f"run --update-baseline to pin it"})
        return out
    pinned = baseline.get("workloads", {})
    for name, cur in current["workloads"].items():
        pin = pinned.get(name)
        if pin is None:
            out.append({"kind": "unpinned", "workload": name,
                        "message": f"workload {name!r} has no baseline pin "
                                   f"— run --update-baseline"})
            continue
        if int(pin.get("capacity", -1)) != int(cur.get("capacity", -2)):
            out.append({"kind": "capacity-drift", "workload": name,
                        "message": f"{name}: gate capacity changed "
                                   f"({pin.get('capacity')} -> "
                                   f"{cur.get('capacity')}); costs are not "
                                   f"comparable — re-pin with "
                                   f"--update-baseline"})
            continue
        if int(pin.get("k", 1)) != int(cur.get("k", 1)):
            out.append({"kind": "capacity-drift", "workload": name,
                        "message": f"{name}: scan dispatch K changed "
                                   f"({pin.get('k', 1)} -> "
                                   f"{cur.get('k', 1)}); costs are not "
                                   f"comparable — re-pin with "
                                   f"--update-baseline"})
            continue
        for metric in METRICS:
            c, p = float(cur.get(metric, 0.0)), float(pin.get(metric, 0.0))
            if p <= 0.0:
                continue
            if c > p * (1.0 + rtol):
                out.append({
                    "kind": "regression", "workload": name, "metric": metric,
                    "current": c, "pinned": p,
                    "message": f"{name}.{metric} regressed: {c:.4g} vs "
                               f"pinned {p:.4g} (+{(c / p - 1) * 100:.1f}%, "
                               f"rtol {rtol:g}) — the traced step got more "
                               f"expensive"})
            elif c < p * (1.0 - rtol):
                out.append({
                    "kind": "stale-pin", "workload": name, "metric": metric,
                    "current": c, "pinned": p,
                    "message": f"{name}.{metric} improved: {c:.4g} vs "
                               f"pinned {p:.4g} "
                               f"({(1 - c / p) * 100:.1f}% below) — bank it "
                               f"with --update-baseline (ratchet-down: the "
                               f"gate must guard the better number)"})
    for name in pinned:
        if name not in current["workloads"]:
            out.append({"kind": "stale-workload", "workload": name,
                        "message": f"baseline pins workload {name!r} which "
                                   f"the gate no longer measures — remove "
                                   f"via --update-baseline"})
    if "proxy" in current:
        from ..observability.names import KERNELS, PERF_PROXY_FAMILIES
        for k in KERNELS + PERF_PROXY_FAMILIES:
            if k not in current["proxy"]:
                out.append({"kind": "proxy-coverage", "workload": k,
                            "message": f"family {k!r} (names.py::KERNELS / "
                                       f"PERF_PROXY_FAMILIES) has no proxy "
                                       f"microbenchmark"})
        if strict_proxy:
            for k, cur in current["proxy"].items():
                pin = baseline.get("proxy", {}).get(k)
                if not pin:
                    continue
                c, p = float(cur["ns_per_elem"]), float(pin["ns_per_elem"])
                if p > 0 and c > p * proxy_factor:
                    out.append({
                        "kind": "proxy-regression", "workload": k,
                        "current": c, "pinned": p,
                        "message": f"proxy {k}: {c:g} ns/elem vs pinned "
                                   f"{p:g} (>{proxy_factor:g}x)"})
    return out


def run_gate(root: str = ".", rtol: float = DEFAULT_RTOL,
             skip_proxy: bool = False, strict_proxy: bool = False,
             reps: int = 3) -> Tuple[dict, List[dict]]:
    """Measure + compare against the resolved baseline. Returns
    ``(measurement report, findings)`` — empty findings = gate clean."""
    path = baseline_path(root)
    if os.environ.get("WF_PERFGATE_BASELINE", "") and not os.path.exists(path):
        # an EXPLICIT override pointing nowhere must fail loudly (exit 2)
        raise FileNotFoundError(
            f"WF_PERFGATE_BASELINE points at a missing baseline: {path}")
    current = measure(skip_proxy=skip_proxy, reps=reps)
    return current, compare(current, load_baseline(path), rtol=rtol,
                            strict_proxy=strict_proxy)


# --------------------------------------------------------------- the CLI


def main(argv=None) -> int:
    """``python -m windflow_tpu_torch.analysis.perfgate``: the flags and
    exit codes of the JAX package's ``scripts/wf_perfgate.py`` (0 clean, 1
    findings, 2 internal error or an explicit baseline that is missing)."""
    import argparse
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(
        prog="python -m windflow_tpu_torch.analysis.perfgate",
        description="the port's hermetic perf gate (logical cost pins of the "
                    "traced steps + proxy microbenchmarks)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help="baseline file overriding analysis/perfgate_baseline.json "
                         "(WF_PERFGATE_BASELINE env does the same)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current measurement and exit 0")
    ap.add_argument("--rtol", type=float, default=None,
                    help="relative tolerance around each cost pin (default 0.02)")
    ap.add_argument("--skip-proxy", action="store_true",
                    help="skip the proxy microbenchmarks (cost pins only)")
    ap.add_argument("--strict-proxy", action="store_true",
                    help="fail on proxy timings beyond the advisory factor")
    ap.add_argument("--reps", type=int, default=3,
                    help="proxy microbenchmark repetitions (min taken)")
    args = ap.parse_args(argv)
    try:
        if args.baseline:
            os.environ["WF_PERFGATE_BASELINE"] = os.path.abspath(args.baseline)
        bpath = baseline_path(repo)
        if args.update_baseline:
            report = measure(skip_proxy=args.skip_proxy, reps=args.reps)
            save_baseline(bpath, report)
            print(f"perfgate: pinned {len(report['workloads'])} workload(s) to {bpath}")
            return 0
        report, findings = run_gate(
            repo, rtol=args.rtol if args.rtol is not None else DEFAULT_RTOL,
            skip_proxy=args.skip_proxy, strict_proxy=args.strict_proxy, reps=args.reps)
    except Exception as e:  # noqa: BLE001 — a broken gate must exit 2,
        #                     never masquerade as clean (0) or dirty (1)
        print(f"perfgate: internal error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps({"report": report, "findings": findings}, indent=1))
    else:
        for w, row in sorted(report["workloads"].items()):
            print(f"{w}@{row['capacity']}: aten_ops={row['aten_ops']:.6g} "
                  f"flops={row['flops']:.6g} bytes={row['bytes_accessed']:.6g}")
        for k, row in sorted(report.get("proxy", {}).items()):
            print(f"proxy {k}: {row['ns_per_elem']:g} ns/elem ({row['elems']} elems)")
        for x in findings:
            print(f"FINDING [{x['kind']}] {x['message']}")
        print(f"perfgate: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

"""Chaos sweep: run N seeded fault plans through all four drivers and report
any divergence from the fault-free baseline.

Counterpart of the JAX package's ``scripts/chaos_sweep.py``, with the same
flags, defaults, printed lines and exit codes, plus ``--device`` (default
``cuda``). For each seed a probabilistic FaultPlan (errors on source.next /
chain.step / sink.consume for the supervised drivers, stalls on queue.stall
for the threaded driver) is injected through ``runtime/faults.py``; the
run's outputs must be byte-identical to the fault-free oracle (exactly-once
under injection). Exit code 0 = no divergence, 1 = at least one.

The drivers: the supervised ``Pipeline`` (a TB ``Win_Seq``), the supervised
``PipeGraph`` over a merge of two sources with a DEFAULT merge (``graph``)
and a DETERMINISTIC one (``graph_det``, whose Ordering_Node reads its
``[n_released, n_kept]`` counts back asynchronously), and the threaded
driver (two ``Map`` segments).

--controller additionally runs every driver with the adaptive control plane
active (deterministic positional admission on the supervised drivers — shed
decisions are part of the replayed stream, so faulted runs must still match
the fault-free controlled baseline byte-for-byte; backpressure governor on
the threaded driver).

--dispatch K runs every CHAOS run with scan dispatch (K-step CUDA-graph
replays on the card) while the fault-free baselines stay per-batch.

--shards N runs the supervised drivers through the shard-local supervision
layer (N ShardSupervisor units) and widens each seed's plan with shard-kill
and torn reshard-handoff injection; the baselines stay unsharded. The
sharded pipeline run also crosses a live N -> 2N reshard. (--shards
excludes --dispatch: WF115.)

--remediate: the supervised pipeline runs (baseline AND chaos) carry barrier
remediation with deterministic positional admission, and one live threaded
leg under queue.stall chaos rides the loop OK -> PAGE -> shed_harder ->
recovery back to OK, its incident bundle recording the actions.

--serve runs ONLY the serving legs (one per seed): a ServingRuntime fed two
tenants over a loopback socket, with a seeded peer kill mid-stream, garbage
bytes, a full re-send on reconnect and a live hot swap to a twin graph; the
outputs must equal a RecordSource oracle fed the same chunks.

    python -m windflow_tpu_torch.scripts.chaos_sweep --seeds 5 --total 400
    python -m windflow_tpu_torch.scripts.chaos_sweep --seeds 5 --dispatch 4
    python -m windflow_tpu_torch.scripts.chaos_sweep --seeds 5 --shards 4
    python -m windflow_tpu_torch.scripts.chaos_sweep --seeds 3 --serve --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

import windflow_tpu_torch as wt
from windflow_tpu_torch.basic import Mode, win_type_t
from windflow_tpu_torch.control import ControlConfig
from windflow_tpu_torch.device import resolve_device
from windflow_tpu_torch.runtime import faults as faults_mod
from windflow_tpu_torch.runtime.faults import FaultInjector, FaultPlan, FaultSpec
from windflow_tpu_torch.runtime.pipegraph import PipeGraph
from windflow_tpu_torch.runtime.supervisor import SupervisedPipeline
from windflow_tpu_torch.runtime.threaded import ThreadedPipeline

#: the drivers, in the order they run
DRIVERS = ("pipeline", "graph", "graph_det", "threaded")
#: drivers that route through the sharded supervisors under --shards
SHARDED_DRIVERS = {"pipeline", "graph", "graph_det"}


def sup_control(batch):
    # deterministic positional bucket: ~80% admitted, replay-stable
    return ControlConfig(autotune=False, backpressure=False, admission=True,
                         refill_per_batch=0.8 * batch, burst_tuples=2 * batch)


def thr_control():
    # governor only: throttling delays, never drops — results must not change
    return ControlConfig(autotune=False, backpressure=True,
                         high_watermark=0.5, low_watermark=0.25)


def collect(acc):
    def cb(view):
        if view is None:
            return
        acc.extend(zip(view["key"].tolist(), view["id"].tolist(),
                       view["payload"].tolist()))
    return cb


def run_pipeline(total, batch, faults=None, controller=False, dispatch=False,
                 shards=0, remediate=False, device=None):
    dev = resolve_device(device)
    got = []
    src = wt.Source(lambda i: {"v": (i % 13).float()}, total=total, num_keys=4,
                    device=dev)
    op = wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(10, 10, win_type_t.TB),
                    num_keys=4, device=dev)
    SupervisedPipeline(src, [op], wt.Sink(collect(got), device=dev), batch_size=batch,
                       checkpoint_every=3, max_restarts=8,
                       backoff_base=0.001, backoff_cap=0.01,
                       faults=faults, dispatch=dispatch,
                       shards=shards or 1,
                       # sharded runs also cross a live N -> 2N reshard at
                       # the first barrier past 1/3 of the stream
                       reshard=({"new_shards": shards * 2,
                                 "at_pos": max(1, total // batch // 3)}
                                if shards else False),
                       # --remediate: barrier remediation over the owned
                       # actuators; decisions are replayed state, so byte
                       # identity against the remediated baseline holds
                       remediation=True if remediate else None,
                       control=(sup_control(batch)
                                if (controller or remediate) else False),
                       device=dev).run()
    return sorted(got)


def run_graph(total, batch, faults=None, controller=False, dispatch=False,
              mode=None, shards=0, device=None):
    dev = resolve_device(device)
    got = []
    g = PipeGraph("sweep", batch_size=batch, mode=mode or Mode.DEFAULT,
                  dispatch=dispatch, device=dev)
    a = g.add_source(wt.Source(lambda i: {"v": (i % 9).float()}, total=total,
                               num_keys=3, name="a", device=dev))
    b = g.add_source(wt.Source(lambda i: {"v": (i % 7).float()}, total=total // 2,
                               num_keys=3, name="b", device=dev))
    (a.merge(b)
     .add(wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(12, 12, win_type_t.CB),
                     num_keys=3, device=dev))
     .add_sink(wt.Sink(collect(got), device=dev)))
    g.run_supervised(checkpoint_every=3, max_restarts=8,
                     backoff_base=0.001, backoff_cap=0.01, faults=faults,
                     shards=shards or 1,
                     # hermetic: a caller's WF_RESHARD must not diverge the
                     # graph runs from the unsharded baselines
                     reshard=False,
                     control=sup_control(batch) if controller else False)
    return sorted(got)


def run_graph_det(total, batch, faults=None, controller=False, dispatch=False,
                  shards=0, device=None):
    # DETERMINISTIC merge: every root push drives the Ordering_Node's async
    # [n_released, n_kept] readback under chaos
    return run_graph(total, batch, faults=faults, controller=controller,
                     dispatch=dispatch, mode=Mode.DETERMINISTIC, shards=shards,
                     device=device)


def run_threaded(total, batch, faults=None, controller=False, dispatch=False,
                 device=None):
    dev = resolve_device(device)
    got = []
    src = wt.Source(lambda i: {"v": i.float()}, total=total, device=dev)
    ThreadedPipeline(src, [[wt.Map(lambda t: {"v": t.v * 3}, device=dev)],
                           [wt.Map(lambda t: {"v": t.v + 1}, device=dev)]],
                     wt.Sink(lambda v: got.extend(
                         zip(v["id"].tolist(), v["payload"]["v"].tolist()))
                         if v is not None else None, device=dev),
                     batch_size=batch, pin=False, heartbeat_timeout=0.25,
                     faults=faults, dispatch=dispatch,
                     control=thr_control() if controller else False,
                     device=dev).run()
    return sorted(got)


RUNNERS = {"pipeline": run_pipeline, "graph": run_graph, "graph_det": run_graph_det,
           "threaded": run_threaded}


def run_closed_loop(seed, device=None):
    """The --remediate acceptance: a live threaded run under queue.stall
    chaos rides the loop OK -> PAGE (a latency burn) -> shed_harder
    actuation -> recovery back to OK, with the incident bundle recording
    the actions the page triggered. The admission rate stays far above the
    source's, so it also asserts zero loss. Returns (problems, n_applies,
    n_faults)."""
    from windflow_tpu_torch.control import RemediationAction, RemediationPolicy
    from windflow_tpu_torch.observability import MonitoringConfig

    dev = resolve_device(device)
    mon_dir = tempfile.mkdtemp(prefix="wf_chaos_remediate_")
    batch, total = 32, 6000
    got = []

    def sink(view):
        # host-side pacing: ~4 ms a batch keeps the run alive long past the
        # bounded stall burst, so the burn windows decay over clean ticks
        if view is not None:
            got.extend(view["id"].tolist())
        time.sleep(0.004)

    # shed_harder's actuation is real (the setpoint halves, journaled,
    # gauged) but the rate stays far above the source's: nothing is shed
    policy = RemediationPolicy((RemediationAction(
        name="shed_harder", slo="latency", actuator="admission_rate",
        factor=0.5, floor=1.0, window=2, max_applies=2),))
    mon = MonitoringConfig(
        slo=json.dumps([{"name": "latency", "signal": "e2e_p99_ms",
                         "target": 150.0, "objective": 0.5,
                         "fast_window": 2, "slow_window": 4,
                         "warn_burn": 0.5, "page_burn": 1.0}]),
        remediation=policy, interval_s=0.05, remediation_cooldown_s=0.05,
        out_dir=mon_dir)
    # a bounded burst of queue stalls (each holds a ring op ~0.5 s) blows the
    # per-tick e2e p99 past target; max_fires bounds the incident
    inj = FaultInjector(FaultPlan([FaultSpec("queue.stall", kind="stall", p=0.25,
                                             stall_s=0.5, max_fires=4)], seed=seed))
    src = wt.Source(lambda i: {"v": (i % 13).float()}, total=total, num_keys=4,
                    device=dev)
    ThreadedPipeline(src, [[wt.Map(lambda t: {"v": t.v + 1.0}, device=dev)]],
                     wt.Sink(sink, device=dev),
                     batch_size=batch, pin=False, heartbeat_timeout=0.25,
                     faults=inj,
                     control=ControlConfig(autotune=False, backpressure=False,
                                           admission=True, rate_tps=1e9),
                     monitoring=mon, device=dev).run()

    snaps = [json.loads(line)
             for line in open(os.path.join(mon_dir, "snapshots.jsonl"))]
    events = [json.loads(line)
              for line in open(os.path.join(mon_dir, "events.jsonl"))]
    applies = [e for e in events if e.get("event") == "remediation_apply"]
    paged = any((s.get("slo") or {}).get("latency", {}).get("state") == "page"
                for s in snaps)
    final = (snaps[-1].get("slo") or {}).get("latency", {}).get("state")
    inc_dir = os.path.join(mon_dir, "incidents")
    bundles = sorted(os.listdir(inc_dir)) if os.path.isdir(inc_dir) else []
    with_rem = [b for b in bundles
                if os.path.exists(os.path.join(inc_dir, b, "remediation.json"))]
    problems = []
    if not paged:
        problems.append("the latency SLO never paged")
    if not applies:
        problems.append("no remediation_apply journaled")
    if final != "ok":
        problems.append(f"final state {final!r} — did not recover to ok")
    if not bundles:
        problems.append("no incident bundle captured for the page")
    elif not with_rem:
        problems.append("no incident bundle recorded remediation.json")
    if sorted(got) != list(range(total)):
        problems.append(f"tuple loss: {len(got)}/{total} delivered")
    shutil.rmtree(mon_dir, ignore_errors=True)
    return problems, len(applies), len(inj.fired)


def run_serve_loop(seed, total=2000, chunk=50, device=None):
    """The --serve acceptance: a ServingRuntime fed two tenants over a
    loopback socket, with a seeded mid-stream peer kill (abrupt close),
    garbage injection, a full re-send on reconnect (the dedup overlap) and a
    live hot swap to a registered twin graph; the outputs must equal a
    RecordSource oracle over the same chunks. Returns (problems, counters)."""
    from windflow_tpu_torch.serving import RecordClient, ServingRuntime, SocketSource

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    dt = np.dtype([("key", np.int32), ("ts", np.int64), ("v", np.float32)])
    recs = np.zeros(total, dtype=dt)
    recs["key"] = rng.randint(0, 8, total)
    recs["ts"] = np.arange(total)
    recs["v"] = rng.rand(total).astype(np.float32)
    chunks = [recs[i:i + chunk] for i in range(0, total, chunk)]
    # even chunks ride tenant "a", odd ones "b" — both unlimited, so the
    # identity covers the multi-tenant path with zero shedding
    tenant_of = ["a" if i % 2 == 0 else "b" for i in range(len(chunks))]

    def make_ops():
        return [wt.Map(lambda t: {"v": t.v * 2.0 + 1.0}, device=dev)]

    def collect_out(acc):
        def cb(view):
            if view is not None:
                acc.extend(zip(view["id"].tolist(), view["payload"]["v"].tolist()))
        return cb

    # oracle: the same chunks through a plain RecordSource pipeline
    oracle = []
    wt.Pipeline(wt.RecordSource(lambda: iter(chunks), dt, key_field="key",
                                ts_field="ts", num_keys=8, device=dev),
                make_ops(), wt.Sink(collect_out(oracle), device=dev),
                batch_size=chunk, device=dev).run()

    mon_dir = tempfile.mkdtemp(prefix="wf_chaos_serve_")
    got = []
    src = SocketSource("tcp://127.0.0.1:0", dt, key_field="key", ts_field="ts",
                       num_keys=8, replay=len(chunks) + 8, device=dev)
    rt = ServingRuntime(src, make_ops(), wt.Sink(collect_out(got), device=dev),
                        batch_size=chunk, serving={"tenants": [{"id": "a"}, {"id": "b"}]},
                        monitoring=mon_dir, device=dev)
    rt.register_graph("twin", make_ops())
    src.start()                      # bind now: the client needs the port
    thread = rt.run_background()

    def decoded_stable():
        # let the ingest side drain a killed connection's kernel buffer
        # before the overlap re-send, so chunk admission order stays the
        # wire send order (the id-identity precondition)
        last = -1
        for _ in range(100):
            cur = src.frames_decoded + src.frames_torn + src.frames_dup
            if cur == last:
                return
            last = cur
            time.sleep(0.05)

    client = RecordClient(src.endpoint)
    kill_at = int(rng.randint(len(chunks) // 4, 3 * len(chunks) // 4))
    swap_at = kill_at // 2           # always before the kill: the swap frame
    #                                  must survive the peer death
    sent = {}                        # tenant -> [(seq, chunk_bytes)]
    for i, c in enumerate(chunks[:kill_at]):
        t = tenant_of[i]
        seq = client.send(c.tobytes(), tenant=t)
        sent.setdefault(t, []).append((seq, c.tobytes()))
        if i == swap_at:
            client.send_swap("twin")
    client.send_garbage(b"TORN BYTES IN FLIGHT " * 3)
    client.kill()                    # abrupt peer death, no EOS
    decoded_stable()
    client.reconnect()
    # no ack channel: re-send everything already sent (original seqs); the
    # server drops the overlap as dup and admits only what the kill lost
    for t, frames in sent.items():
        for seq, blob in frames:
            client.send(blob, tenant=t, seq=seq)
    for i in range(kill_at, len(chunks)):
        client.send(chunks[i].tobytes(), tenant=tenant_of[i])
    client.send_eos("a")             # default eos policy: first eos ends it
    client.close()
    thread.join(timeout=60.0)

    problems = []
    if thread.is_alive():
        problems.append("serving drive thread did not reach EOS")
    if rt.background_error is not None:
        problems.append(f"serving run raised {type(rt.background_error).__name__}: "
                        f"{rt.background_error}")
    if sorted(got) != sorted(oracle):
        missing = set(map(tuple, oracle)) - set(map(tuple, got))
        extra = set(map(tuple, got)) - set(map(tuple, oracle))
        problems.append(f"DIVERGED from the RecordSource oracle: "
                        f"missing={len(missing)} extra={len(extra)}")
    if src.frames_torn < 1:
        problems.append("no torn frame — the garbage/kill injection never "
                        "exercised resync")
    if src.frames_dup < 1:
        problems.append("no duplicate frame — the reconnect overlap never "
                        "exercised dedup")
    if rt.swaps_applied != 1:
        problems.append(f"swaps_applied={rt.swaps_applied}, want 1 (the "
                        f"wire-driven hot swap)")
    if rt.graph_label != "twin":
        problems.append(f"live graph is {rt.graph_label!r}, want 'twin'")
    try:
        with open(os.path.join(mon_dir, "snapshot.json")) as f:
            snap = json.load(f)
        srv = snap.get("serving") or {}
        if srv.get("graph") != "twin":
            problems.append("snapshot serving.graph did not record the swap")
        tenants = srv.get("tenants") or {}
        for t in ("a", "b"):
            if t not in tenants:
                problems.append(f"snapshot serving.tenants missing {t!r}")
            elif tenants[t].get("shed", 0):
                problems.append(f"tenant {t!r} shed {tenants[t]['shed']} batch(es) — "
                                f"unlimited tenants must never shed")
    except (OSError, ValueError) as e:
        problems.append(f"cannot read the serving snapshot: {e}")
    counters = {"torn": src.frames_torn, "dup": src.frames_dup,
                "decoded": src.frames_decoded, "kill_at": kill_at}
    src.close()
    shutil.rmtree(mon_dir, ignore_errors=True)
    return problems, counters


def plan_for(seed, threaded=False, shards=0):
    if threaded:
        # the threaded driver has no replay machinery: stalls only (delay,
        # never drop) — the watchdog must notice, results must not change
        return FaultPlan([FaultSpec("queue.stall", kind="stall", p=0.15,
                                    stall_s=0.4)], seed=seed)
    specs = [FaultSpec("source.next", p=0.06),
             FaultSpec("chain.step", p=0.08),
             FaultSpec("sink.consume", p=0.10)]
    if shards:
        # shard-local drills: random shard step kills (each recovers by
        # replaying only that shard's key range) and a torn handoff against
        # the mid-stream live reshard (the seal is discarded and the move
        # re-derived at the same barrier)
        specs += [FaultSpec("shard.kill", p=0.05),
                  FaultSpec("reshard.handoff", kind="torn", p=0.25, max_fires=1)]
    return FaultPlan(specs, seed=seed)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--total", type=int, default=400)
    ap.add_argument("--batch", type=int, default=40)
    ap.add_argument("--controller", action="store_true",
                    help="run every driver with the adaptive control plane "
                    "active (admission/backpressure; baselines use the same "
                    "controller, so shedding must stay deterministic)")
    ap.add_argument("--dispatch", type=int, default=0, metavar="K",
                    help="run every CHAOS run with scan dispatch (K-step graph "
                    "replays on the card) while the baselines stay per-batch — "
                    "the fused path must match the per-batch fault-free oracle "
                    "byte-for-byte")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="run the supervised drivers (pipeline + graph) "
                    "through N-way shard-local supervision (plus a live "
                    "N->2N reshard on the pipeline driver) with shard-kill "
                    "and torn-handoff injection added to each seed's plan; "
                    "baselines stay unsharded")
    ap.add_argument("--remediate", action="store_true",
                    help="supervised pipeline runs (baselines AND chaos) "
                    "carry barrier remediation + deterministic admission "
                    "(byte-identity must still hold), plus one live "
                    "threaded closed-loop leg under queue.stall asserting "
                    "OK -> PAGE -> actuate -> recovery to OK with the "
                    "incident bundle recording the actions")
    ap.add_argument("--serve", action="store_true",
                    help="run ONLY the serving closed-loop legs (one per "
                    "seed): two tenants over a loopback socket, a seeded "
                    "peer kill mid-stream + garbage + reconnect overlap + a "
                    "live graph hot-swap — outputs must equal a RecordSource "
                    "oracle (zero loss, torn frames resync'd, overlap deduped)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; cpu runs every "
                    "kernel's plain PyTorch version)")
    return ap


def warm(batch, device) -> None:
    """On the card: build every kernel and run the threaded driver once, so
    no first-use build or CUDA set-up lands inside a heartbeat window of a
    measured run."""
    if device.type != "cuda":
        return
    from windflow_tpu_torch.ops import cuda
    cuda.build_all()
    run_threaded(2 * batch, batch, device=device)


def serve_sweep(args, device) -> int:
    failures = 0
    for seed in range(args.seeds):
        t0 = time.time()
        problems, ctr = run_serve_loop(seed, device=device)
        ok = not problems
        print(f"[seed {seed}] serve: kill@chunk {ctr['kill_at']}, "
              f"{ctr['decoded']} decoded / {ctr['torn']} torn / "
              f"{ctr['dup']} dup, {'OK' if ok else 'FAILED'} "
              f"({time.time() - t0:.1f}s)", flush=True)
        for p in problems:
            print(f"            {p}")
        failures += bool(problems)
    if failures:
        print(f"FAIL: {failures} divergent serving run(s)")
        return 1
    print("PASS: all serving chaos runs byte-identical to the RecordSource oracle")
    return 0


def sweep(args, device) -> dict:
    """The fault-free baselines, then every seed through every driver.
    Returns ``{"baselines": {driver: rows}, "fired": {driver: [faults a
    seed]}, "divergences": n}`` after printing the run's lines."""
    baselines, fired = {}, {name: [] for name in DRIVERS}
    for name in DRIVERS:
        t0 = time.time()
        kw = {"remediate": True} if (args.remediate and name == "pipeline") else {}
        baselines[name] = RUNNERS[name](args.total, args.batch, controller=args.controller,
                                        device=device, **kw)
        print(f"[baseline] {name}: {len(baselines[name])} results "
              f"({time.time() - t0:.1f}s)", flush=True)

    divergences = 0
    for seed in range(args.seeds):
        for name in DRIVERS:
            n_shards = args.shards if name in SHARDED_DRIVERS else 0
            inj = FaultInjector(plan_for(seed, threaded=(name == "threaded"),
                                         shards=n_shards))
            t0 = time.time()
            try:
                kw = {"shards": n_shards} if n_shards else {}
                if args.remediate and name == "pipeline":
                    kw["remediate"] = True
                out = RUNNERS[name](args.total, args.batch, faults=inj,
                                    controller=args.controller,
                                    dispatch=args.dispatch,   # 0 = off
                                    device=device, **kw)
            except Exception as e:          # noqa: BLE001 — reported, counted
                print(f"[seed {seed}] {name}: RUN FAILED {type(e).__name__}: "
                      f"{e} ({len(inj.fired)} faults injected)", flush=True)
                fired[name].append(len(inj.fired))
                divergences += 1
                continue
            fired[name].append(len(inj.fired))
            ok = out == baselines[name]
            print(f"[seed {seed}] {name}: {len(inj.fired)} faults injected, "
                  f"{'OK' if ok else 'DIVERGED'} ({time.time() - t0:.1f}s)", flush=True)
            if not ok:
                divergences += 1
                missing = set(baselines[name]) - set(out)
                extra = set(out) - set(baselines[name])
                print(f"            missing={len(missing)} extra={len(extra)}")
    if args.remediate:
        t0 = time.time()
        problems, n_applies, n_faults = run_closed_loop(seed=0, device=device)
        ok = not problems
        print(f"[closed-loop] threaded: {n_faults} faults injected, "
              f"{n_applies} remediation action(s), "
              f"{'OK' if ok else 'FAILED'} ({time.time() - t0:.1f}s)", flush=True)
        if not ok:
            for p in problems:
                print(f"            {p}")
            divergences += 1
    return {"baselines": baselines, "fired": fired, "divergences": divergences}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.shards and args.dispatch and not args.serve:
        ap.error("--shards excludes --dispatch on the supervised drivers "
                 "(WF115: a fused group failure has no single shard's "
                 "replay extent)")
    device = resolve_device(args.device)
    warm(args.batch, device)
    if args.serve:
        return serve_sweep(args, device)
    res = sweep(args, device)
    print(f"\ncounters: {faults_mod.counters()}")
    if res["divergences"]:
        print(f"FAIL: {res['divergences']} divergent run(s)")
        return 1
    print("PASS: all chaos runs byte-identical to the fault-free baselines")
    return 0


if __name__ == "__main__":
    sys.exit(main())

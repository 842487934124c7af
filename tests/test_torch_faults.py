"""The port's fault injection (``windflow_tpu_torch/runtime/faults.py``), on the CPU.

Mirrors the cases of the JAX package's ``tests/test_faults.py``: the plan's
JSON and environment forms, site and kind validation, the seeded
probability, the decorrelated backoff, the ``checkpoint.load`` site, the
SupervisedPipeline chaos cases (every site exactly once, the windowed sites,
the watchdog, poison quarantine, a torn checkpoint and its lineage, the
journal of a chaos run, an unreadable position that exhausts) and both
threaded cases (a stall delays rows without dropping any and the watchdog
names the stage; a failing segment drains its upstream and closes
everything); the graph-supervised cases are in
``tests/test_torch_graph_supervisor.py``. Also:
``ThreadedPipeline(faults=)`` fires its four sites with the JAX package's
``stage``/``pos`` context, the same plan fires at the same occurrences as
in the JAX package's ThreadedPipeline, and the step watchdog and dead-letter
queue work on the port's batches.
"""

import json
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.runtime import faults as jfaults
from windflow_tpu_torch.runtime import faults as faults_mod
from windflow_tpu_torch.runtime.faults import (DeadLetterQueue, FaultInjector,
                                               FaultPlan, FaultSpec, InjectedFault)

CPU = {"device": "cpu"}
DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _clean_faults():
    faults_mod.set_active(None)
    faults_mod.reset_counters()
    yield
    faults_mod.set_active(None)


def collect(acc):
    def cb(view):
        if view is None:
            return
        acc.extend(zip(view["id"].tolist(), np.asarray(view["payload"]["v"]).tolist()))
    return cb


def build_threaded(sink_cb, **kw):
    src = wt.Source(lambda i: {"v": i.float()}, total=480, **CPU)
    return wt.ThreadedPipeline(
        src, [[wt.Map(lambda t: {"v": t.v * 3}, **CPU)],
              [wt.Map(lambda t: {"v": t.v + 1}, **CPU)]],
        wt.Sink(sink_cb, **CPU), batch_size=16, pin=False, **CPU, **kw)


def within_deadline(fn):
    box = {}

    def body():
        try:
            box["result"] = fn()
        except BaseException as e:      # noqa: BLE001 — raised in the test
            box["error"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(DEADLINE_S)
    if t.is_alive():
        pytest.fail(f"driver still running after {DEADLINE_S} s (a hang)")
    if "error" in box:
        raise box["error"]
    return box.get("result")


# ---------------------------------------------------------------- plan basics

def test_plan_json_roundtrip_and_env(tmp_path, monkeypatch):
    plan = FaultPlan([FaultSpec("chain.step", at=[3]),
                      FaultSpec("queue.stall", kind="stall", stall_s=0.2,
                                where={"stage": "seg0"})], seed=11)
    clone = FaultPlan.from_json(plan.to_json())
    assert clone.seed == 11
    assert [f.site for f in clone.faults] == ["chain.step", "queue.stall"]
    assert clone.faults[0].at == (3,)
    assert clone.faults[1].where == {"stage": "seg0"}
    # the same JSON as the JAX package's
    assert plan.to_json() == jfaults.FaultPlan(
        [jfaults.FaultSpec("chain.step", at=[3]),
         jfaults.FaultSpec("queue.stall", kind="stall", stall_s=0.2,
                           where={"stage": "seg0"})], seed=11).to_json()
    monkeypatch.setenv("WF_FAULT_PLAN", plan.to_json())
    assert [f.site for f in FaultPlan.from_env().faults] == [f.site for f in plan.faults]
    p = tmp_path / "plan.json"
    p.write_text(plan.to_json())
    monkeypatch.setenv("WF_FAULT_PLAN", str(p))
    assert FaultPlan.from_env().seed == 11
    monkeypatch.setenv("WF_FAULT_PLAN", "")
    assert FaultPlan.from_env() is None


def test_unknown_site_and_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("not.a.site")
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("chain.step", kind="meteor")
    assert faults_mod.SITES == jfaults.SITES and faults_mod.KINDS == jfaults.KINDS


def _occurrences(inj_cls, plan):
    inj = inj_cls(plan)
    fired = []
    for i in range(200):
        try:
            inj.fire("chain.step", pos=i)
        except (InjectedFault, jfaults.InjectedFault):
            fired.append(i)
    return fired


def test_seeded_probability_is_deterministic_and_matches_jax():
    plan = FaultPlan([FaultSpec("chain.step", p=0.3, max_fires=None)], seed=7)
    a = _occurrences(FaultInjector, plan)
    assert a == _occurrences(FaultInjector, FaultPlan.from_json(plan.to_json()))
    assert 20 < len(a) < 120
    assert a != _occurrences(FaultInjector, FaultPlan([FaultSpec("chain.step", p=0.3)],
                                                      seed=8))
    assert a == _occurrences(jfaults.FaultInjector,
                             jfaults.FaultPlan.from_json(plan.to_json()))


def test_backoff_decorrelated_jitter_bounds():
    rng = random.Random(3)
    prev, seen = 0.001, []
    for i in range(5):
        prev = faults_mod.backoff_sleep(rng, prev, 0.001, 0.01, attempt=i)
        seen.append(prev)
    assert all(0.001 <= s <= 0.01 for s in seen)
    ctr = faults_mod.counters()
    assert ctr["backoff_sleeps"] == 5
    assert abs(ctr["backoff_seconds"] - sum(seen)) < 1e-9
    assert faults_mod.backoff_sleep(rng, 1.0, 0.0, 1.0) == 0.0
    # the same draws as the JAX package's
    rng2 = random.Random(3)
    prev2 = 0.001
    for i, s in enumerate(seen):
        prev2 = jfaults.backoff_sleep(rng2, prev2, 0.001, 0.01, attempt=i)
        assert prev2 == s


def test_recovery_counters_match_the_jax_registry():
    from windflow_tpu.observability.names import RECOVERY_COUNTERS
    from windflow_tpu_torch.observability import names
    assert names.RECOVERY_COUNTERS == RECOVERY_COUNTERS
    assert set(faults_mod.counters()) == set(RECOVERY_COUNTERS)


def test_checkpoint_load_site_fires(tmp_path):
    from windflow_tpu_torch.runtime.checkpoint import load_chain, save_chain
    src = wt.Source(lambda i: {"v": i.float()}, total=64, **CPU)
    chain = wt.CompiledChain([wt.Map(lambda t: {"v": t.v * 2}, **CPU)], src.payload_spec(),
                             batch_capacity=16, **CPU)
    save_chain(chain, str(tmp_path / "c.npz"))
    plan = FaultPlan([FaultSpec("checkpoint.load", at=[1])])
    with faults_mod.activate(FaultInjector(plan)):
        with pytest.raises(InjectedFault):
            load_chain(chain, str(tmp_path / "c.npz"))
        assert load_chain(chain, str(tmp_path / "c.npz")) == {}   # fired once only
    assert faults_mod.counters()["faults_injected"] == 1


# ------------------------------------------------- SupervisedPipeline chaos

TOTAL, BATCH, K = 200, 25, 4


def build_map(sink_cb, **kw):
    src = wt.Source(lambda i: {"v": (i % 13).float()}, total=TOTAL, num_keys=K, **CPU)
    return wt.SupervisedPipeline(src, [wt.Map(lambda t: {"v": t.v * 2}, **CPU)],
                                 wt.Sink(sink_cb, **CPU), batch_size=BATCH,
                                 backoff_base=0.001, backoff_cap=0.02, **CPU, **kw)


def build_win(rows, **kw):
    src = wt.Source(lambda i: {"v": (i % 13).float()}, total=TOTAL, num_keys=K, **CPU)
    op = wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(10, 10, wt.win_type_t.TB),
                    num_keys=K, **CPU)

    def cb(view):
        if view is None:
            return
        rows.extend(zip(view["key"].tolist(), view["id"].tolist(),
                        np.asarray(view["payload"]).tolist()))
    return wt.SupervisedPipeline(src, [op], wt.Sink(cb, **CPU), batch_size=BATCH,
                                 backoff_base=0.001, backoff_cap=0.02, **CPU, **kw)


def test_pipeline_chaos_every_site_exactly_once(tmp_path):
    oracle = []
    build_map(collect(oracle)).run()
    got = []
    plan = FaultPlan([FaultSpec("source.next", at=[3]), FaultSpec("chain.step", at=[6]),
                      FaultSpec("sink.consume", at=[2]),
                      FaultSpec("checkpoint.save", at=[3])], seed=1)
    inj = FaultInjector(plan)
    p = build_map(collect(got), checkpoint_every=2, max_restarts=2,
                  spill_path=str(tmp_path / "ckpt.npz"), faults=inj)
    p.run()
    assert got == oracle, "results lost/duplicated under chaos"
    assert {s for s, *_ in inj.fired} == {"source.next", "chain.step", "sink.consume",
                                          "checkpoint.save"}
    assert p.restarts == 4
    assert faults_mod.counters()["faults_injected"] == 4


def test_pipeline_chaos_windowed_sites_fired():
    oracle = []
    build_win(oracle).run()
    got = []
    inj = FaultInjector(FaultPlan([FaultSpec("source.next", at=[5]),
                                   FaultSpec("chain.step", at=[2, 9])], seed=2))
    p = build_win(got, checkpoint_every=3, max_restarts=3, faults=inj)
    p.run()
    assert got == oracle
    assert {s for s, *_ in inj.fired} == {"source.next", "chain.step"}
    assert len(inj.fired) == 3 and p.restarts == 3


def test_pipeline_watchdog_converts_hang_into_recovery():
    oracle = []
    build_map(collect(oracle)).run()
    got = []
    plan = FaultPlan([FaultSpec("chain.step", kind="stall", at=[4], stall_s=0.6)])
    p = build_map(collect(got), checkpoint_every=2, max_restarts=2, step_timeout=0.15,
                  faults=plan)
    p.run()
    assert got == oracle
    assert p.restarts == 1
    assert faults_mod.counters()["watchdog_timeouts"] == 1


def test_pipeline_poison_batch_quarantined_not_exhausted(tmp_path):
    oracle = []
    build_map(collect(oracle)).run()
    got = []
    spill = str(tmp_path / "dead.jsonl")
    dlq = DeadLetterQueue(spill_path=spill)
    plan = FaultPlan([FaultSpec("chain.step", where={"pos": 5})])
    p = build_map(collect(got), checkpoint_every=4, max_restarts=3, dead_letter=dlq,
                  poison_threshold=3, faults=plan)
    p.run()                                  # must not raise RestartExhausted
    poisoned = set(range(5 * BATCH, 6 * BATCH))
    assert got == [t for t in oracle if t[0] not in poisoned]
    assert len(dlq) == 1
    entry = dlq.entries[0]
    assert entry["pos"] == 5 and entry["n_valid"] == BATCH
    assert entry["ids"][0] == 5 * BATCH
    assert "InjectedFault" in entry["error"]
    with open(spill) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    assert len(lines) == 1 and lines[0]["pos"] == 5
    assert faults_mod.counters()["dead_letters"] == 1


def test_pipeline_torn_checkpoint_retried_and_lineage_restores(tmp_path):
    from windflow_tpu_torch.runtime.checkpoint import _read_manifest, manifest_path
    oracle = []
    build_win(oracle).run()
    got = []
    spill = str(tmp_path / "lineage.npz")
    plan = FaultPlan([FaultSpec("checkpoint.save", kind="torn", at=[2])])
    p = build_win(got, checkpoint_every=3, max_restarts=2, spill_path=spill,
                  checkpoint_keep=3, faults=plan)
    p.run()
    assert got == oracle
    assert p.restarts == 1                   # the torn write was retried
    q = build_win([])
    meta = wt.load_chain(q.chain, spill)
    assert meta["batches_done"] == TOTAL // BATCH
    man = _read_manifest(manifest_path(spill))
    assert man is not None and 1 <= len(man["entries"]) <= 3


def test_chaos_run_is_journaled(tmp_path):
    from windflow_tpu_torch.observability import EventJournal, read_journal, set_journal
    path = str(tmp_path / "events.jsonl")
    j = EventJournal(path)
    set_journal(j)
    try:
        got = []
        plan = FaultPlan([FaultSpec("chain.step", at=[3]),
                          FaultSpec("chain.step", where={"pos": 6})])
        p = build_map(collect(got), checkpoint_every=4, max_restarts=3,
                      dead_letter=DeadLetterQueue(), poison_threshold=3, faults=plan)
        p.run()
    finally:
        set_journal(None)
        j.close()
    events = read_journal(path)
    assert {"fault_injected", "restore", "checkpoint", "backoff",
            "dead_letter"} <= {e["event"] for e in events}
    injected = [e for e in events if e["event"] == "fault_injected"]
    assert all(e["site"] == "chain.step" for e in injected)
    restores = [e for e in events if e["event"] == "restore" and e.get("phase") == "end"]
    assert len(restores) == p.restarts
    assert faults_mod.counters()["recovery_seconds"] > 0


def test_unreadable_position_exhausts_instead_of_livelocking():
    """A quarantined position whose read fails on every replay exhausts the
    budget loudly (only the arming failure is free)."""
    def factory():
        def gen():
            for s in range(0, 400, 50):
                if s == 100:                 # chunk 2 unreadable, every replay
                    raise ValueError("corrupt record at offset 100")
                ids = np.arange(s, s + 50, dtype=np.int32)
                yield ({"v": (ids % 13).astype(np.float32)}, ids % 4, ids)
        return gen()

    src = wt.GeneratorSource(factory, {"v": np.zeros((), np.float32)}, **CPU)
    p = wt.SupervisedPipeline(src, [wt.Map(lambda t: {"v": t.v}, **CPU)],
                              wt.Sink(lambda v: None, **CPU), batch_size=50,
                              checkpoint_every=2, max_restarts=2,
                              dead_letter=DeadLetterQueue(), poison_threshold=2,
                              backoff_base=0.0, **CPU)
    with pytest.raises(wt.RestartExhausted) as ei:
        p.run()
    assert isinstance(ei.value.__cause__, ValueError)
    assert p.restarts <= 2 + 2 + 1, "restart loop must be bounded"


# --------------------------------------------------------- threaded chaos

def test_threaded_stall_detected_results_identical():
    oracle = []
    within_deadline(build_threaded(collect(oracle)).run)
    got = []
    plan = FaultPlan([FaultSpec("queue.stall", kind="stall", stall_s=0.4,
                                where={"stage": "seg0", "pos": 3})])
    tp = build_threaded(collect(got), heartbeat_timeout=0.1, faults=plan)
    within_deadline(tp.run)
    assert sorted(got) == sorted(oracle), "a stall must delay, never drop"
    assert got == oracle                     # one chain of rings keeps the order
    assert "seg0" in tp.watchdog_stale
    assert faults_mod.counters()["watchdog_timeouts"] >= 1


def test_threaded_failing_segment_drains_upstream_and_closes():
    closed = []
    got = []
    tp = build_threaded(collect(got), queue_capacity=2,
                        faults=FaultPlan([FaultSpec("chain.step",
                                                    where={"stage": "seg0", "pos": 1})]))
    tp.source.close = lambda: closed.append("source")
    tp.sink.close = lambda: closed.append("sink")
    with pytest.raises(InjectedFault):
        within_deadline(tp.run)
    assert closed == ["source", "sink"], "close skipped on the failure path"


def _threaded_fires(pkg, plan):
    """Every fire of a stall-only plan at all four sites, in each package's
    ThreadedPipeline: {(site, ctx)}, and the per-site occurrence counts."""
    if pkg == "jax":
        src = wf.Source(lambda i: {"v": i.astype(jnp.float32)}, total=96)
        tp = wf.ThreadedPipeline(src, [[wf.Map(lambda t: {"v": t.v * 3})],
                                       [wf.Map(lambda t: {"v": t.v + 1})]],
                                 wf.Sink(lambda v: None), batch_size=16, pin=False)
        inj = jfaults.FaultInjector(jfaults.FaultPlan.from_json(plan.to_json()))
    else:
        src = wt.Source(lambda i: {"v": i.float()}, total=96, **CPU)
        tp = wt.ThreadedPipeline(src, [[wt.Map(lambda t: {"v": t.v * 3}, **CPU)],
                                       [wt.Map(lambda t: {"v": t.v + 1}, **CPU)]],
                                 wt.Sink(lambda v: None, **CPU), batch_size=16, pin=False,
                                 **CPU)
        inj = FaultInjector(plan)
    tp._faults_arg = inj
    within_deadline(tp.run)
    return ({(site, tuple(sorted(ctx.items()))) for site, _n, _k, ctx in inj.fired},
            dict(inj.counts))


def test_threaded_fires_the_four_sites_as_jax():
    plan = FaultPlan([FaultSpec(s, kind="stall", stall_s=0.001, where={"pos": 2},
                                max_fires=None)
                      for s in ("source.next", "queue.stall", "chain.step",
                                "sink.consume")])
    fired, counts = _threaded_fires("port", plan)
    assert fired == {("source.next", (("pos", 2), ("stage", "source"))),
                     ("queue.stall", (("pos", 2), ("stage", "seg0"))),
                     ("queue.stall", (("pos", 2), ("stage", "seg1"))),
                     ("chain.step", (("pos", 2), ("stage", "seg0"))),
                     ("chain.step", (("pos", 2), ("stage", "seg1"))),
                     ("sink.consume", (("pos", 2), ("stage", "sink")))}
    # 6 batches: the source's 6, two segments' 6 each, the sink's 6
    assert counts == {"source.next": 6, "queue.stall": 12, "chain.step": 12,
                      "sink.consume": 6}
    assert (fired, counts) == _threaded_fires("jax", plan)


def test_threaded_plan_from_env(monkeypatch):
    plan = FaultPlan([FaultSpec("sink.consume", at=[2])])
    monkeypatch.setenv("WF_FAULT_PLAN", plan.to_json())
    with pytest.raises(InjectedFault):
        within_deadline(build_threaded(lambda v: None).run)
    monkeypatch.setenv("WF_FAULT_PLAN", "")
    got = []
    within_deadline(build_threaded(collect(got), faults=False).run)
    assert len(got) == 480


def test_faults_argument_type_is_checked():
    with pytest.raises(TypeError, match="faults="):
        faults_mod.resolve(object())


# ------------------------------------------------ watchdog and dead letters

def test_call_with_timeout_converts_a_hang():
    with pytest.raises(faults_mod.WatchdogTimeout) as ei:
        faults_mod.call_with_timeout(lambda: 1, 0.05, stage="step",
                                     pre=lambda: threading.Event().wait(0.5))
    faults_mod.join_abandoned_worker(ei.value, 2.0)
    assert not ei.value.worker.is_alive()
    assert faults_mod.counters()["watchdog_timeouts"] == 1
    assert faults_mod.call_with_timeout(lambda: 7, 1.0) == 7
    assert faults_mod.call_with_timeout(lambda: 8, None) == 8


def test_dead_letter_queue_keeps_a_port_batch(tmp_path):
    spill = tmp_path / "dlq.jsonl"
    dlq = DeadLetterQueue(spill_path=str(spill), max_entries=1)
    b = wt.Batch.of({"v": torch.arange(4, dtype=torch.int32)},
                    id=torch.arange(10, 14, dtype=torch.int32),
                    valid=torch.tensor([True, False, True, True]), **CPU)
    e = dlq.put(b, pos=3, error=ValueError("poison"), driver="threaded")
    assert e["n_valid"] == 3 and e["ids"] == [10, 12, 13]
    dlq.put(None, pos=4)
    assert len(dlq) == 1 and dlq.dropped == 1
    assert len(spill.read_text().splitlines()) == 2

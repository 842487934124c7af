"""The port's supervised PipeGraph (``PipeGraph.run_supervised``), on the CPU.

Mirrors every case of the JAX package's ``tests/test_graph_supervisor.py``
and the graph-supervised cases of ``tests/test_faults.py``, then holds the
port against the JAX package's ``run_graph_supervised`` on a DETERMINISTIC
split/merge graph with a count-based window: one seeded ``FaultPlan``, at
dispatch off and K = 3. Byte for byte: every sink's rows in delivery order,
``supervised_restarts``, the dead-letter positions, the recovery counters
(all but ``backoff_seconds``) and the journal records without their timing
fields.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import Mode as JMode
from windflow_tpu.basic import win_type_t as jwin
from windflow_tpu.observability import journal as jjournal
from windflow_tpu.runtime import faults as jfaults
from windflow_tpu.runtime.pipegraph import PipeGraph as JPipeGraph
from windflow_tpu_torch.basic import Mode, win_type_t
from windflow_tpu_torch.observability import journal as tjournal
from windflow_tpu_torch.runtime import faults as faults_mod
from windflow_tpu_torch.runtime.faults import (DeadLetterQueue, FaultInjector, FaultPlan,
                                               FaultSpec)
from windflow_tpu_torch.runtime.supervisor import RestartExhausted

CPU = {"device": "cpu"}
TOTAL, K = 360, 3
TIMING = ("t", "wall", "dur_s", "service_s")


@pytest.fixture(autouse=True)
def _clean_faults():
    for m in (faults_mod, jfaults):
        m.set_active(None)
        m.reset_counters()
    yield
    for m in (faults_mod, jfaults):
        m.set_active(None)


def build(win_sink, plain_sink, mode=Mode.DEFAULT, total=TOTAL, batch=40):
    g = wt.PipeGraph("sup", batch_size=batch, mode=mode, **CPU)
    a = g.add_source(wt.Source(lambda i: {"v": (i % 9).float()}, total=total,
                               num_keys=K, name="a", **CPU))
    b = g.add_source(wt.Source(lambda i: {"v": (i % 7).float()}, total=total // 2,
                               num_keys=K, name="b", ts_fn=lambda i: i * 2, **CPU))
    m = a.merge(b).split(lambda t: t.v % 2 == 0, 2)
    (m.select(1).add(wt.Win_Seq(lambda wid, it: it.sum("v"),
                                wt.WindowSpec(12, 12, win_type_t.CB), num_keys=K, **CPU))
     .add_sink(wt.Sink(win_sink, **CPU)))
    m.select(0).add_sink(wt.Sink(plain_sink, **CPU))
    return g


def collectors():
    wins, plains = [], []

    def win_cb(view):
        if view is None:
            return
        wins.extend(zip(view["key"].tolist(), view["id"].tolist(),
                        np.asarray(view["payload"]).tolist()))

    def plain_cb(view):
        if view is None:
            return
        plains.extend(zip(view["id"].tolist(), np.asarray(view["payload"]["v"]).tolist()))
    return wins, plains, win_cb, plain_cb


def collect(acc):
    def cb(view):
        if view is None:
            return
        acc.extend(zip(view["id"].tolist(), np.asarray(view["payload"]["v"]).tolist()))
    return cb


def collect3(acc):
    def cb(view):
        if view is None:
            return
        acc.extend(zip(view["key"].tolist(), view["id"].tolist(),
                       np.asarray(view["payload"]).tolist()))
    return cb


def inject_failures(g, fail_at):
    orig = g._push
    n = {"c": 0}
    remaining = sorted(fail_at)

    def flaky(mp, batch):
        n["c"] += 1
        if remaining and n["c"] == remaining[0]:
            remaining.pop(0)
            raise RuntimeError(f"injected device fault at push #{n['c']}")
        return orig(mp, batch)
    g._push = flaky


# --------------------------------------------- mirrored test_graph_supervisor

def test_supervised_graph_no_failure_matches_plain():
    w0, p0, wc0, pc0 = collectors()
    build(wc0, pc0).run()
    w1, p1, wc1, pc1 = collectors()
    build(wc1, pc1).run_supervised(checkpoint_every=3)
    assert sorted(w1) == sorted(w0) and sorted(p1) == sorted(p0)
    assert len(w0) > 0 and len(p0) > 0


def test_supervised_graph_recovers_exactly_once():
    w0, p0, wc0, pc0 = collectors()
    build(wc0, pc0).run()
    w1, p1, wc1, pc1 = collectors()
    g = build(wc1, pc1)
    inject_failures(g, fail_at=[4, 9, 15])
    g.run_supervised(checkpoint_every=3, max_restarts=3, backoff_base=0.0)
    assert g.supervised_restarts == 3
    assert sorted(w1) == sorted(w0)
    assert sorted(p1) == sorted(p0)


def test_supervised_graph_budget_exhaustion():
    w, p, wc, pc = collectors()
    g = build(wc, pc)
    inject_failures(g, fail_at=[2, 3, 4, 5, 6])
    with pytest.raises(RestartExhausted):
        g.run_supervised(checkpoint_every=100, max_restarts=3, backoff_base=0.0)


def test_supervised_deterministic_merge_recovers():
    """DETERMINISTIC mode under supervision: the Ordering_Node's pool,
    watermarks and renumbering counter snapshot and restore across failures;
    the rows equal the unsupervised run's in delivery order."""
    def build_det(sink_cb):
        g = wt.PipeGraph("sup_det", batch_size=30, mode=Mode.DETERMINISTIC, **CPU)
        a = g.add_source(wt.Source(lambda i: {"v": (i % 5).float()}, total=120,
                                   num_keys=2, name="a", ts_fn=lambda i: 2 * i, **CPU))
        b = g.add_source(wt.Source(lambda i: {"v": (i % 7).float()}, total=120,
                                   num_keys=2, name="b", ts_fn=lambda i: 2 * i + 1, **CPU))
        (a.merge(b)
         .add(wt.Win_Seq(lambda wid, it: it.sum("v"),
                         wt.WindowSpec(30, 30, win_type_t.TB, delay=60), num_keys=2,
                         **CPU))
         .add_sink(wt.Sink(sink_cb, **CPU)))
        return g

    plain = []
    build_det(collect3(plain)).run()
    sup = []
    g = build_det(collect3(sup))
    inject_failures(g, fail_at=[3, 7])
    g.run_supervised(checkpoint_every=2, max_restarts=3, backoff_base=0.0)
    assert g.supervised_restarts == 2
    assert sorted(sup) == sorted(plain) and len(plain) > 0


def test_shims_uninstalled_even_when_recovery_fails():
    w, p, wc, pc = collectors()
    g = build(wc, pc)
    sinks_before = [mp.sink for mp in g._all_pipes() if mp.sink is not None]
    inject_failures(g, fail_at=[2, 3, 4, 5, 6])
    with pytest.raises(RestartExhausted) as ei:
        g.run_supervised(checkpoint_every=100, max_restarts=3, backoff_base=0.0)
    assert isinstance(ei.value.__cause__, RuntimeError)
    sinks_after = [mp.sink for mp in g._all_pipes() if mp.sink is not None]
    assert sinks_after == sinks_before
    assert all(isinstance(s, wt.Sink) for s in sinks_after)


# ------------------------------------- mirrored graph cases of test_faults

def test_graph_chaos_every_site_exactly_once():
    w0, p0, wc0, pc0 = collectors()
    build(wc0, pc0, total=240).run()
    w1, p1, wc1, pc1 = collectors()
    g = build(wc1, pc1, total=240)
    inj = FaultInjector(FaultPlan([FaultSpec("source.next", at=[5]),
                                   FaultSpec("chain.step", at=[9]),
                                   FaultSpec("sink.consume", at=[2])], seed=4))
    g.run_supervised(checkpoint_every=3, max_restarts=2, backoff_base=0.001,
                     backoff_cap=0.02, faults=inj)
    assert g.supervised_restarts == 3
    assert sorted(w1) == sorted(w0) and sorted(p1) == sorted(p0)
    assert {s for s, *_ in inj.fired} == {"source.next", "chain.step", "sink.consume"}
    assert faults_mod.counters()["backoff_sleeps"] >= 3


def _one_pipe(sink_cb, name, fn, total=300, bs=30):
    g = wt.PipeGraph(name, batch_size=bs, **CPU)
    g.add_source(wt.Source(lambda i: {"v": i.float()}, total=total, **CPU)) \
        .add(wt.Map(fn, **CPU)).add_sink(wt.Sink(sink_cb, **CPU))
    return g


def test_graph_poison_batch_dead_lettered():
    bs = 30
    oracle = []
    _one_pipe(collect(oracle), "poison", lambda t: {"v": t.v + 1}).run()
    got = []
    dlq = DeadLetterQueue()
    g = _one_pipe(collect(got), "poison", lambda t: {"v": t.v + 1})
    g.run_supervised(checkpoint_every=4, max_restarts=3, backoff_base=0.0,
                     dead_letter=dlq, poison_threshold=3,
                     faults=FaultPlan([FaultSpec("chain.step", where={"pos": 4})]))
    poisoned = set(range(4 * bs, 5 * bs))
    assert sorted(got) == sorted(t for t in oracle if t[0] not in poisoned)
    assert len(dlq) == 1 and dlq.entries[0]["pos"] == 4
    assert g.supervised_restarts == 3


def test_graph_watchdog_step_timeout_recovers():
    oracle = []
    _one_pipe(collect(oracle), "wdg", lambda t: {"v": t.v * 5}).run()
    got = []
    g = _one_pipe(collect(got), "wdg", lambda t: {"v": t.v * 5})
    # the stall dwarfs the timeout; a slow-machine spurious trip is recovered
    # like any fault, hence the >= asserts
    g.run_supervised(checkpoint_every=3, max_restarts=3, backoff_base=0.001,
                     backoff_cap=0.02, step_timeout=1.0,
                     faults=FaultPlan([FaultSpec("chain.step", kind="stall", at=[6],
                                                 stall_s=2.0)]))
    assert g.supervised_restarts >= 1
    assert sorted(got) == sorted(oracle)
    assert faults_mod.counters()["watchdog_timeouts"] >= 1


def test_graph_unported_supervision_raises_by_name(monkeypatch):
    """Sharding runs on the graph driver (item 14's single-card half), a
    multi-host ``shard_range=`` is refused as in the JAX package, and the
    control plane runs: ``control=True`` (admission off) gives the plain
    rows, the wall-clock bucket is refused as in the JAX package."""
    got = []
    g = _one_pipe(collect(got), "refuse", lambda t: {"v": t.v})
    g.run_supervised(shards=2, backoff_base=0.0)
    assert sorted(g._shard_report) == [0, 1] and got
    g = _one_pipe(collect([]), "refuse", lambda t: {"v": t.v})
    with pytest.raises(ValueError, match="shard_range"):
        g.run_supervised(shard_range=(0, 1))
    ctl = []
    g = _one_pipe(collect(ctl), "refuse", lambda t: {"v": t.v})
    g.run_supervised(control=True, backoff_base=0.0)
    assert sorted(ctl) == sorted(got)
    g = _one_pipe(collect([]), "refuse", lambda t: {"v": t.v})
    with pytest.raises(ValueError, match="refill_per_batch"):
        g.run_supervised(control={"admission": True, "rate_tps": 100.0})
    monkeypatch.setenv("WF_SHARDS", "2")
    g = _one_pipe(collect([]), "refuse", lambda t: {"v": t.v})
    g.run_supervised(backoff_base=0.0)
    assert sorted(g._shard_report) == [0, 1]


# ------------------------------------------------ parity with the JAX package

def _graph(pkg, views_w, views_p, dispatch):
    """A DETERMINISTIC two-source merge, split by parity, a CB Win_Seq on one
    branch and a plain sink on the other, in either package."""
    def cb(acc):
        return lambda v: acc.append(v) if v is not None else None
    if pkg == "jax":
        g = JPipeGraph("par", batch_size=32, mode=JMode.DETERMINISTIC, dispatch=dispatch)
        a = g.add_source(wf.Source(lambda i: {"v": (i % 9).astype(jnp.float32)},
                                   total=256, num_keys=K, name="a", ts_fn=lambda i: 2 * i))
        b = g.add_source(wf.Source(lambda i: {"v": (i % 7).astype(jnp.float32)},
                                   total=192, num_keys=K, name="b",
                                   ts_fn=lambda i: 2 * i + 1))
        m = a.merge(b).split(lambda t: (t.v % 2 == 0).astype(jnp.int32), 2)
        m.select(1).add(wf.Win_Seq(lambda wid, it: it.sum("v"), wf.WindowSpec(12, 12, jwin.CB),
                                   num_keys=K)).add_sink(wf.Sink(cb(views_w)))
        m.select(0).add_sink(wf.Sink(cb(views_p)))
        return g
    g = wt.PipeGraph("par", batch_size=32, mode=Mode.DETERMINISTIC, dispatch=dispatch, **CPU)
    a = g.add_source(wt.Source(lambda i: {"v": (i % 9).float()}, total=256, num_keys=K,
                               name="a", ts_fn=lambda i: 2 * i, **CPU))
    b = g.add_source(wt.Source(lambda i: {"v": (i % 7).float()}, total=192, num_keys=K,
                               name="b", ts_fn=lambda i: 2 * i + 1, **CPU))
    m = a.merge(b).split(lambda t: (t.v % 2 == 0).int(), 2)
    m.select(1).add(wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(12, 12, win_type_t.CB),
                               num_keys=K, **CPU)).add_sink(wt.Sink(cb(views_w), **CPU))
    m.select(0).add_sink(wt.Sink(cb(views_p), **CPU))
    return g


def view_bytes(views):
    out = []
    for v in views:
        for f in ("key", "id", "ts"):
            a = np.asarray(v[f])
            out.append((f, a.dtype.str, a.shape, a.tobytes()))
        leaves = v["payload"] if isinstance(v["payload"], dict) else {"": v["payload"]}
        for f in sorted(leaves):
            a = np.asarray(leaves[f])
            out.append((f, a.dtype.str, a.shape, a.tobytes()))
    return out


def seeded_plan(seed: int) -> str:
    """One FaultPlan JSON from a numpy seed: a chain.step error, a
    sink.consume error and a source.next error at seeded occurrences, and
    poison at position 6, which only root a reaches (b has 6 batches) and
    which heads a group at K = 3 too (a fused group fires ``chain.step`` at
    its head)."""
    rng = np.random.default_rng(seed)
    return FaultPlan([FaultSpec("chain.step", at=[int(rng.integers(2, 8))]),
                      FaultSpec("sink.consume", at=[int(rng.integers(1, 5))]),
                      FaultSpec("source.next", at=[int(rng.integers(3, 12))]),
                      FaultSpec("chain.step", where={"pos": 6}, max_fires=3)],
                     seed=seed).to_json()


@pytest.mark.parametrize("dispatch", [False, 3])
def test_graph_matches_jax_under_a_seeded_plan(tmp_path, dispatch):
    plan = seeded_plan(3)
    res = {}
    for pkg in ("jax", "port"):
        vw, vp = [], []
        g = _graph(pkg, vw, vp, dispatch)
        jr, fm = (jjournal, jfaults) if pkg == "jax" else (tjournal, faults_mod)
        dlq = fm.DeadLetterQueue()
        path = str(tmp_path / f"{pkg}.jsonl")
        j = jr.EventJournal(path)
        jr.set_active(j)
        try:
            g.run_supervised(checkpoint_every=3, max_restarts=4, backoff_base=0.0,
                             dead_letter=dlq, poison_threshold=3,
                             faults=fm.FaultPlan.from_json(plan))
        finally:
            jr.set_active(None)
            j.close()
        ctr = {k: v for k, v in fm.counters().items() if k != "backoff_seconds"}
        ctr["recovery_seconds"] = ctr["recovery_seconds"] > 0
        recs = [{k: v for k, v in r.items() if k not in TIMING}
                for r in tjournal.read_journal(path)]
        res[pkg] = (view_bytes(vw), view_bytes(vp), g.supervised_restarts,
                    [e["pos"] for e in dlq.entries], ctr, recs)
        fm.reset_counters()
    assert res["port"][0] == res["jax"][0] and len(res["port"][0]) > 0
    assert res["port"][1] == res["jax"][1] and len(res["port"][1]) > 0
    assert res["port"][2:] == res["jax"][2:]
    assert res["port"][2] >= 3 and len(res["port"][3]) == 1


def test_graph_restore_resorts_an_unsorted_pool(monkeypatch):
    """The supervised graph restore calls ``Ordering_Node.resort_pending``,
    as the JAX package's does: checkpoints whose Ordering_Node pool was
    written unsorted (here every snapshot's pool reversed, as another
    writer might hold it) restore to the merged stream of the unsupervised
    run, in its delivery order."""
    import torch

    from windflow_tpu_torch.runtime import supervisor as tsup

    def build_det(sink_cb):
        g = wt.PipeGraph("sup_resort", batch_size=30, mode=Mode.DETERMINISTIC, **CPU)
        a = g.add_source(wt.Source(lambda i: {"v": (i % 5).float()}, total=150,
                                   num_keys=2, name="a", ts_fn=lambda i: 2 * i, **CPU))
        b = g.add_source(wt.Source(lambda i: {"v": (i % 7).float()}, total=90,
                                   num_keys=2, name="b", ts_fn=lambda i: 3 * i + 1, **CPU))
        a.merge(b).add_sink(wt.Sink(sink_cb, **CPU))
        return g

    real = tsup._graph_snapshot
    reversed_pools = []

    def unsorted_snapshot(graph):
        snap = real(graph)
        for od in snap["orders"]:
            if od is not None and od["pending"] is not None:
                rev = torch.arange(od["pending"].capacity - 1, -1, -1)
                od["pending"] = od["pending"].take(rev)
                od["chan"] = od["chan"].index_select(0, rev)
                reversed_pools.append(int(od["pending"].valid.sum()))
        return snap

    def collect(acc):
        def cb(view):
            if view is not None:
                acc.extend(zip(view["key"].tolist(), view["id"].tolist(),
                               view["ts"].tolist(), view["payload"]["v"].tolist()))
        return cb

    plain = []
    build_det(collect(plain)).run()
    monkeypatch.setattr(tsup, "_graph_snapshot", unsorted_snapshot)
    sup = []
    g = build_det(collect(sup))
    inject_failures(g, fail_at=[4, 9])
    g.run_supervised(checkpoint_every=2, max_restarts=3, backoff_base=0.0)
    assert g.supervised_restarts == 2
    assert any(n > 1 for n in reversed_pools)     # restores met unsorted pools
    assert sup == plain and len(plain) == 240

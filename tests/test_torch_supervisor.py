"""The port's supervised pipeline (``windflow_tpu_torch/runtime/supervisor.py``), on the CPU.

Mirrors every case of the JAX package's ``tests/test_supervisor.py`` on the
port, then holds the port against the JAX package's ``SupervisedPipeline``:
one seeded ``FaultPlan`` (its JSON loaded in both packages), the same
stream and operators, at dispatch off and K = 3. Byte for byte: the
delivered rows in delivery order, ``restarts``, the dead-letter positions,
the recovery counters (all but ``backoff_seconds``, which is timing) and the
journal records once their timing fields are dropped. Also: the snapshot is
a copy and a restore builds fresh tensors every time, and every unported
supervision feature raises naming its ROADMAP item.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import win_type_t as jwin
from windflow_tpu.observability import journal as jjournal
from windflow_tpu.runtime import faults as jfaults
from windflow_tpu.runtime import supervisor as jsup
from windflow_tpu_torch.basic import win_type_t
from windflow_tpu_torch.observability import journal as tjournal
from windflow_tpu_torch.runtime import faults as faults_mod
from windflow_tpu_torch.runtime.supervisor import (RestartExhausted, SupervisedPipeline,
                                                   _reopen_source)

CPU = {"device": "cpu"}
TOTAL, K = 400, 4

#: timing fields of a record
TIMING = ("t", "wall", "dur_s", "service_s")


@pytest.fixture(autouse=True)
def _clean_faults():
    for m in (faults_mod, jfaults):
        m.set_active(None)
        m.reset_counters()
    yield
    for m in (faults_mod, jfaults):
        m.set_active(None)


def build(sink_cb, **kw):
    src = wt.Source(lambda i: {"v": (i % 13).float()}, total=TOTAL, num_keys=K, **CPU)
    op = wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(10, 10, win_type_t.TB),
                    num_keys=K, **CPU)
    return SupervisedPipeline(src, [op], wt.Sink(sink_cb, **CPU), batch_size=50, **CPU,
                              **kw)


def collect(results):
    def cb(view):
        if view is None:
            return
        results.extend(zip(view["key"].tolist(), view["id"].tolist(),
                           np.asarray(view["payload"]).tolist()))
    return cb


class Flaky:
    """Wraps chain.push to raise on chosen push-call indices, once each."""

    def __init__(self, chain, fail_at):
        self.inner = chain.push
        self.count = 0
        self.fail_at = sorted(fail_at)

    def __call__(self, batch):
        self.count += 1
        if self.fail_at and self.count == self.fail_at[0]:
            self.fail_at.pop(0)
            raise RuntimeError(f"injected device fault at push #{self.count}")
        return self.inner(batch)


# ------------------------------------------------- mirrored test_supervisor

def test_no_failure_matches_plain_pipeline():
    plain, sup = [], []
    wt.Pipeline(wt.Source(lambda i: {"v": (i % 13).float()}, total=TOTAL, num_keys=K,
                          **CPU),
                [wt.Win_Seq(lambda wid, it: it.sum("v"),
                            wt.WindowSpec(10, 10, win_type_t.TB), num_keys=K, **CPU)],
                wt.Sink(collect(plain), **CPU), batch_size=50, **CPU).run()
    build(collect(sup)).run()
    assert sup == plain and len(plain) > 0


@pytest.mark.parametrize("fail_at", [[2], [3, 7], [1, 2, 3]])
def test_recovers_with_exactly_once_delivery(fail_at):
    oracle = []
    build(collect(oracle)).run()
    got = []
    p = build(collect(got), checkpoint_every=3, max_restarts=5, backoff_base=0.0)
    p.chain.push = Flaky(p.chain, fail_at)
    p.run()
    assert p.restarts == len(fail_at)
    assert got == oracle, "results lost or duplicated on recovery"


def test_restart_budget_exhausts_on_permanent_failure():
    p = build(collect([]), checkpoint_every=4, max_restarts=2, backoff_base=0.0)

    def always_fail(batch):
        raise RuntimeError("permanent fault")
    p.chain.push = always_fail
    with pytest.raises(RestartExhausted):
        p.run()


def test_seekable_recovery_is_o1_not_replay():
    """A restart resumes the DeviceSource at the committed cursor: the
    re-open regenerates only the batches after the commit."""
    oracle = []
    build(collect(oracle)).run()
    got = []
    p = build(collect(got), checkpoint_every=2, max_restarts=3, backoff_base=0.0)
    made = []
    orig_batches = p.source.batches

    def counting_batches(batch_size, cursor=None):
        made.append(0)
        for b in orig_batches(batch_size, cursor=cursor):
            made[-1] += 1
            yield b
    p.source.batches = counting_batches
    p.chain.push = Flaky(p.chain, [7])        # fail late: committed pos 6
    p.run()
    assert p.restarts == 1
    assert got == oracle
    assert len(made) == 2
    assert made[1] == 2, f"re-open replayed {made[1]} batches (expected 2)"


def test_seekable_recovery_generator_source_cursor_factory():
    """A GeneratorSource whose factory takes ``from_batch`` is re-opened at
    the committed chunk, with progressive ids exact."""
    opens = []

    def factory(from_batch=0):
        opens.append(from_batch)

        def gen():
            for s in range(from_batch * 50, TOTAL, 50):
                ids = np.arange(s, s + 50, dtype=np.int32)
                yield ({"v": (ids % 13).astype(np.float32)}, ids % K, ids)
        return gen()

    def mk(sink_cb, **kw):
        src = wt.GeneratorSource(factory, {"v": np.zeros((), np.float32)}, **CPU)
        op = wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(10, 10, win_type_t.TB),
                        num_keys=K, **CPU)
        return SupervisedPipeline(src, [op], wt.Sink(sink_cb, **CPU), batch_size=50,
                                  backoff_base=0.0, **CPU, **kw)

    oracle = []
    mk(collect(oracle)).run()
    opens.clear()
    got = []
    p = mk(collect(got), checkpoint_every=2, max_restarts=3)
    p.chain.push = Flaky(p.chain, [7])
    p.run()
    assert p.restarts == 1
    assert got == oracle
    assert opens == [0, 6], opens


def test_spill_checkpoint_written(tmp_path):
    path = str(tmp_path / "sup_ckpt.npz")
    p = build(collect([]), checkpoint_every=2, spill_path=path)
    p.run()
    data = np.load(path)
    assert "__meta__" in data


def test_budget_refills_on_commit_progress():
    """max_restarts bounds failures per checkpoint interval: three faults in
    three intervals recover with a budget of one."""
    oracle = []
    build(collect(oracle)).run()
    got = []
    p = build(collect(got), checkpoint_every=2, max_restarts=1, backoff_base=0.0)
    p.chain.push = Flaky(p.chain, [2, 6, 10])
    p.run()
    assert p.restarts == 3
    assert got == oracle


def test_restart_exhausted_carries_cause():
    p = build(collect([]), checkpoint_every=4, max_restarts=1, backoff_base=0.0)
    boom = RuntimeError("the real device fault")

    def always_fail(batch):
        raise boom
    p.chain.push = always_fail
    with pytest.raises(RestartExhausted) as ei:
        p.run()
    assert ei.value.__cause__ is boom


def test_reopen_source_fast_forwards_pre_cursor_signature():
    class Legacy:
        def __init__(self):
            self.opens = 0

        def batches(self, batch_size):
            self.opens += 1
            for i in range(8):
                yield i

    src = Legacy()
    it = _reopen_source(src, 50, 3, cursor={"batch": 3})
    assert next(it) == 3 and src.opens == 1


def test_reopen_source_genuine_typeerror_propagates():
    class Buggy:
        def batches(self, batch_size, cursor=None):
            raise TypeError("genuine bug inside the source")
            yield  # pragma: no cover

    with pytest.raises(TypeError, match="genuine bug"):
        it = _reopen_source(Buggy(), 50, 3, cursor={"batch": 3})
        next(it)


# ------------------------------------------------------ the card's rules

def test_snapshot_copies_and_restore_rebuilds():
    """The snapshot holds host copies (a later in-place write to the chain's
    state does not reach it), and each restore builds fresh tensors and
    fresh state objects, so one snapshot restores twice."""
    p = build(collect([]))
    batch = next(p.source.batches(50))
    p.chain.push(batch)
    snap = p._snapshot()
    ring = p.chain.states[0].arch_payload["v"]
    saved = snap[0][0].arch_payload["v"].clone()
    ring.add_(1.0)                        # the rings are updated in place
    assert torch.equal(snap[0][0].arch_payload["v"], saved)
    p._restore(snap)
    first = p.chain.states[0]
    p.chain.push(batch)                   # consumes the restored state
    p._restore(snap)
    second = p.chain.states[0]
    assert second is not first
    assert second.arch_payload["v"].data_ptr() != first.arch_payload["v"].data_ptr()
    assert torch.equal(second.arch_payload["v"], saved)
    p.chain.push(batch)                   # a fresh state, not marked consumed
    assert snap[1] is None                # an untiered chain has no cold tiers


@pytest.mark.parametrize("kw, env, item", [
    ({"reshard": "auto"}, {}, 15), ({"shards": 2, "reshard": "auto"}, {}, 15),
    ({}, {"WF_SHARDS": "2", "WF_RESHARD": "auto"}, 15),
    ({"control": True}, {}, 15), ({}, {"WF_CONTROL": "1"}, 15),
    ({"remediation": "barrier"}, {}, 15), ({}, {"WF_REMEDIATION": "1"}, 15),
    ({"trace": True}, {}, None),
    ({}, {"WF_MONITORING": "1", "WF_MONITORING_EVENT_TIME": "1"}, None),
])
def test_unported_supervision_raises_by_name(monkeypatch, tmp_path, kw, env, item):
    """Item 15's options raise naming it; tracing and monitoring-driven event
    time (item 16, ported) run and give the plain run's rows."""
    monkeypatch.chdir(tmp_path)            # WF_MONITORING=1 / trace=True dirs
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
            build(collect([]), **kw)
        return
    got, want = [], []
    sp = build(collect(got), **kw)
    sp.run()
    for k in env:
        monkeypatch.delenv(k)
    build(collect(want)).run()
    assert sorted(got) == sorted(want) and got
    if "trace" in kw:
        assert os.path.exists(tmp_path / "wf_trace" / "flight.jsonl")
    else:
        assert sp.chain.event_time


@pytest.mark.parametrize("kw, env", [
    ({"shards": 2}, {}), ({}, {"WF_SHARDS": "2"}),
    ({"shards": 2, "shard_key": lambda t: t.key}, {}),
    ({"shards": 2, "shard_range": (0, 2)}, {}),
])
def test_sharding_options_run(monkeypatch, kw, env):
    """Item 14's single-card half: shards=, WF_SHARDS, shard_key= and an
    explicit shard_range= run and give the unsharded rows."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    p = build(collect(got), backoff_base=0.0, **kw)
    p.run()
    assert sorted(p.shard_report()) == [0, 1]
    for k in env:
        monkeypatch.delenv(k)
    want = []
    build(collect(want), backoff_base=0.0).run()
    assert sorted(got) == sorted(want)


def test_tiered_state_raises_by_name():
    """The interval join's tiered archive builds (item 13b); a tiered chain
    under sharded supervision raises as in the JAX package (a ValueError:
    the per-op host store is one cold tier for every shard)."""
    assert wt.IntervalJoin(lambda t: t.side == 1, 0, 4, tiered=True, **CPU)._tier_cfg
    src = wt.Source(lambda i: {"v": i}, total=10, **CPU)
    with pytest.raises(ValueError, match="tiered keyed state"):
        wt.SupervisedPipeline(src, [wt.SessionWindow(lambda t: t.v, wt.WindowSpec.session(2),
                                                     tiered=True, **CPU)],
                              None, shards=2, **CPU)


# ------------------------------------------------ parity with the JAX package

def _views(acc):
    def cb(view):
        if view is not None:
            acc.append(view)
    return cb


def view_bytes(views):
    """Every field of every delivered view, in delivery order, as (dtype,
    shape, bytes)."""
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


def journal_records(path):
    """The journal's records without their timing fields."""
    return [{k: v for k, v in r.items() if k not in TIMING}
            for r in tjournal.read_journal(path)]


def seeded_plan(seed: int, poison: bool) -> str:
    """One FaultPlan JSON from a numpy seed: two chain.step errors, a
    sink.consume error and a source.next error at seeded occurrences, or
    (``poison``) a batch position that fails every attempt plus a seeded
    chain.step error. The poison position is a multiple of 3: the head of a
    group at K = 3 with checkpoints every 3 batches (a fused group fires
    ``chain.step`` at its head)."""
    rng = np.random.default_rng(seed)
    steps = sorted(int(x) for x in rng.choice(np.arange(1, 9), 2, replace=False))
    if poison:
        faults = [faults_mod.FaultSpec("chain.step", where={"pos": int(rng.choice([3, 6]))}),
                  faults_mod.FaultSpec("chain.step", at=[steps[0]])]
    else:
        faults = [faults_mod.FaultSpec("chain.step", at=steps),
                  faults_mod.FaultSpec("sink.consume", at=[int(rng.integers(1, 6))]),
                  faults_mod.FaultSpec("source.next", at=[int(rng.integers(2, 9))])]
    return faults_mod.FaultPlan(faults, seed=seed).to_json()


def run_both(tmp_path, plan_json, dispatch, dead_letter, **kw):
    """The same stream, operators and plan through the JAX package's and the
    port's SupervisedPipeline; returns {pkg: (views, restarts, dlq positions,
    counters, journal records)}."""
    res = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.jsonl")
        views = []
        dlq = (jfaults if pkg == "jax" else faults_mod).DeadLetterQueue() \
            if dead_letter else None
        if pkg == "jax":
            src = wf.Source(lambda i: {"v": (i % 13).astype(jnp.float32)},
                            total=TOTAL, num_keys=K)
            ops = [wf.Win_Seq(lambda wid, it: it.sum("v"), wf.WindowSpec(10, 10, jwin.TB),
                              num_keys=K)]
            p = jsup.SupervisedPipeline(
                src, ops, wf.Sink(_views(views)), batch_size=50, dispatch=dispatch,
                dead_letter=dlq, backoff_base=0.0,
                faults=jfaults.FaultPlan.from_json(plan_json), **kw)
            journal, counters = jjournal, jfaults
        else:
            p = build(_views(views), dispatch=dispatch, dead_letter=dlq, backoff_base=0.0,
                      faults=faults_mod.FaultPlan.from_json(plan_json), **kw)
            journal, counters = tjournal, faults_mod
        j = journal.EventJournal(path)
        journal.set_active(j)
        try:
            p.run()
        finally:
            journal.set_active(None)
            j.close()
        ctr = {k: v for k, v in counters.counters().items() if k != "backoff_seconds"}
        ctr["recovery_seconds"] = ctr["recovery_seconds"] > 0
        res[pkg] = (view_bytes(views), p.restarts,
                    [e["pos"] for e in dlq.entries] if dlq is not None else None,
                    ctr, journal_records(path))
    return res


@pytest.mark.parametrize("dispatch", [False, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_under_a_seeded_plan(tmp_path, seed, dispatch):
    res = run_both(tmp_path, seeded_plan(seed, poison=False), dispatch, False,
                   checkpoint_every=4, max_restarts=4)
    jv, jr, _, jc, jj = res["jax"]
    tv, tr, _, tc, tj = res["port"]
    assert tr == jr and tr >= 2
    assert tv == jv and len(tv) > 0
    assert tc == jc
    assert tj == jj
    assert {r["event"] for r in tj} >= {"checkpoint", "restore", "fault_injected"}


@pytest.mark.parametrize("dispatch", [False, 3])
def test_poison_quarantine_matches_jax(tmp_path, dispatch):
    res = run_both(tmp_path, seeded_plan(5, poison=True), dispatch, True,
                   checkpoint_every=3, max_restarts=3, poison_threshold=3)
    jv, jr, jd, jc, jj = res["jax"]
    tv, tr, td, tc, tj = res["port"]
    assert td == jd and len(td) == 1
    assert tr == jr and tv == jv and tc == jc and tj == jj
    assert "dead_letter" in {r["event"] for r in tj}

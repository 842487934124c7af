"""Shard-local supervision in the port (``windflow_tpu_torch/parallel/
sharding.py``, the sharded half of ``runtime/supervisor.py``, the sharded
checkpoints and handoffs of ``runtime/checkpoint.py``), on the CPU, against
the JAX package.

Mirrors the cases of the JAX package's ``tests/test_sharded_supervisor.py``
that need no control plane, metrics, validator or multi-host helper: key
ownership and the splitter; shard counts 1 and 4, a live 4 -> 8 reshard and a
targeted move giving the unsharded rows; a killed shard, a plan past EOS, a
local restart budget, a poison sub-batch (also across a reshard), a global
fault, a torn handoff and a checkpoint failing mid-handoff. Each runs through
both packages' ``SupervisedPipeline`` with the same stream and fault plan:
the sink rows, restarts, shard reports, dead letters, recovery counters and
journal records must be the JAX package's. Sharded checkpoint files written
by either package load in the other, with the per-shard lineage fallback and
the manifest checks. Then explicit ``shard_range=`` slices, the composition
refusals (dispatch K, tiered state), the Nexmark queries at shards 4 (and a
live reshard) against the unsharded run, and the graph driver's sharded runs
(``run_supervised(shards=)``) against the JAX package's.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import Mode as JMode
from windflow_tpu.basic import win_type_t as jwin
from windflow_tpu.observability import journal as jjournal
from windflow_tpu.parallel import sharding as jsh
from windflow_tpu.runtime import checkpoint as jck
from windflow_tpu.runtime import faults as jfaults
from windflow_tpu.runtime import supervisor as jsup
from windflow_tpu_torch.basic import Mode, win_type_t
from windflow_tpu_torch.observability import journal as tjournal
from windflow_tpu_torch.parallel.sharding import (ReshardPlan, ShardAssignment,
                                                  affected_shards, make_splitter,
                                                  resolve_shards)
from windflow_tpu_torch.runtime import checkpoint as tck
from windflow_tpu_torch.runtime import faults as faults_mod
from windflow_tpu_torch.runtime.checkpoint import flatten_with_paths
from windflow_tpu_torch.runtime.supervisor import RestartExhausted, _fresh_states

CPU = {"device": "cpu"}
TOTAL, K = 400, 4
TIMING = ("t", "wall", "dur_s", "service_s")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("WF_SHARDS", "WF_RESHARD", "WF_STATE_TIERED"):
        monkeypatch.delenv(var, raising=False)
    for m in (faults_mod, jfaults):
        m.set_active(None)
        m.reset_counters()
    yield
    for m in (faults_mod, jfaults):
        m.set_active(None)


def collect(results):
    def cb(view):
        if view is None:
            return
        results.extend(zip(np.asarray(view["key"]).tolist(), np.asarray(view["id"]).tolist(),
                           np.asarray(view["payload"]).tolist()))
    return cb


def jbuild(sink_cb, **kw):
    src = wf.Source(lambda i: {"v": (i % 13).astype(jnp.float32)}, total=TOTAL, num_keys=K)
    op = wf.Win_Seq(lambda wid, it: it.sum("v"), wf.WindowSpec(10, 10, jwin.TB), num_keys=K)
    return jsup.SupervisedPipeline(src, [op], wf.Sink(sink_cb), batch_size=50,
                                   backoff_base=0.0, **kw)


def tbuild(sink_cb, **kw):
    src = wt.Source(lambda i: {"v": (i % 13).float()}, total=TOTAL, num_keys=K, **CPU)
    op = wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(10, 10, win_type_t.TB),
                    num_keys=K, **CPU)
    return wt.SupervisedPipeline(src, [op], wt.Sink(sink_cb, **CPU), batch_size=50,
                                 backoff_base=0.0, **CPU, **kw)


def run_port(**kw):
    got = []
    p = tbuild(collect(got), **kw)
    p.run()
    return sorted(got), p


def journal_records(journal, path, pkg_dir=None):
    """The records without timing fields; a checkpoint path under the run's
    own directory is made relative, and a ``checkpoint.save`` fire's
    occurrence is dropped (the shard saves fan out over a thread pool, so
    their order is not fixed in either package)."""
    out = []
    for r in journal.read_journal(path):
        r = {k: v for k, v in r.items() if k not in TIMING}
        if pkg_dir is not None and isinstance(r.get("path"), str):
            r["path"] = os.path.relpath(r["path"], pkg_dir)
        if r.get("site") == "checkpoint.save":
            r.pop("occurrence", None)
        out.append(r)
    return out


def report(p):
    return {k: {f: v for f, v in r.items() if f != "last_recovery_s"}
            for k, r in p.shard_report().items()}


def run_both(tmp_path, plan=None, dead_letter=False, spill=None, **kw):
    """The same stream, operator and fault plan through both packages'
    SupervisedPipeline with an event journal; returns {pkg: (rows,
    restarts, shard report, dead letters, counters, journal records)}."""
    res = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.jsonl")
        rows = []
        fm = jfaults if pkg == "jax" else faults_mod
        dlq = fm.DeadLetterQueue() if dead_letter else None
        extra = dict(kw)
        if plan is not None:
            extra["faults"] = fm.FaultInjector(fm.FaultPlan(
                [fm.FaultSpec(**spec) for spec in plan(tmp_path / pkg)], seed=1))
        if spill is not None:
            os.makedirs(tmp_path / pkg, exist_ok=True)
            extra["spill_path"] = str(tmp_path / pkg / spill)
        p = (jbuild if pkg == "jax" else tbuild)(collect(rows), dead_letter=dlq, **extra)
        journal = jjournal if pkg == "jax" else tjournal
        j = journal.EventJournal(path)
        journal.set_active(j)
        try:
            p.run()
        finally:
            journal.set_active(None)
            j.close()
        ctr = {k: v for k, v in fm.counters().items() if k != "backoff_seconds"}
        ctr["recovery_seconds"] = ctr["recovery_seconds"] > 0
        res[pkg] = (sorted(rows), p.restarts, report(p),
                    [(e["pos"], e["driver"]) for e in dlq.entries] if dlq else None,
                    ctr, journal_records(journal, path, str(tmp_path / pkg)))
        fm.reset_counters()
    return res


# -------------------------------------------------------------------- assignment

def test_assignment_owner_and_moves():
    a = ShardAssignment(4)
    assert [a.owner(k) for k in range(8)] == [0, 1, 2, 3, 0, 1, 2, 3]
    m = ShardAssignment(4, ((5, 0), (2, 3)))
    assert m.owner(5) == 0 and m.owner(2) == 3 and m.owner(6) == 2
    assert ShardAssignment.from_meta(m.to_meta()) == m
    assert m.to_meta() == jsh.ShardAssignment(4, ((5, 0), (2, 3))).to_meta()
    with pytest.raises(ValueError, match="nonexistent shard"):
        ShardAssignment(4, ((1, 7),))
    with pytest.raises(ValueError, match="more than one move"):
        ShardAssignment(4, ((3, 1), (3, 2)))
    # floored modulo, as jnp's %: negative keys own shards in [0, N)
    keys = np.arange(-20, 20, dtype=np.int32)
    got = m.owner_of(torch.from_numpy(keys)).numpy()
    want = np.asarray(jsh.ShardAssignment(4, ((5, 0), (2, 3))).owner_of(jnp.asarray(keys)))
    assert np.array_equal(got, want)


def test_doubling_splits_each_shard_in_two():
    a4, a8 = ShardAssignment(4), ShardAssignment(8)
    for k in range(64):
        assert a8.owner(k) % 4 == a4.owner(k)


def test_split_covers_input_exactly():
    key = (np.arange(32, dtype=np.int32) * 7 % 11)
    valid = np.arange(32) % 5 != 0
    tb = wt.Batch(key=torch.from_numpy(key), id=torch.arange(32, dtype=torch.int32),
                  ts=torch.zeros(32, dtype=torch.int32),
                  payload={"v": torch.arange(32, dtype=torch.float32)},
                  valid=torch.from_numpy(valid))
    jb = wf.Batch.of({"v": jnp.arange(32, dtype=jnp.float32)}, key=jnp.asarray(key),
                     valid=jnp.asarray(valid))
    subs = ShardAssignment(3).split(tb)
    jsubs = jsh.ShardAssignment(3).split(jb)
    masks = np.stack([s.valid.numpy() for s in subs])
    assert (masks.sum(axis=0) == valid.astype(int)).all()
    assert np.array_equal(masks, np.stack([np.asarray(s.valid) for s in jsubs]))
    for s in subs:
        assert torch.equal(s.key, tb.key)
    # a derived ownership key (the shard_key convention)
    own = make_splitter(ShardAssignment(3), lambda t: t.data["v"].to(torch.int32))(tb)
    assert [int(s.valid.sum()) for s in own] == [int((valid & (np.arange(32) % 3 == r)).sum())
                                                  for r in range(3)]


def test_affected_shards():
    a4 = ShardAssignment(4)
    assert affected_shards(a4, ShardAssignment(8)) == set(range(8))
    moved = ShardAssignment(4, ((5, 0),))
    assert affected_shards(a4, moved) == {0, 1}
    assert affected_shards(moved, moved) == set()


def test_resolve_shards_and_plan(monkeypatch):
    assert resolve_shards(None) == 1
    monkeypatch.setenv("WF_SHARDS", "4")
    assert resolve_shards(None) == 4
    monkeypatch.setenv("WF_SHARDS", "0")
    assert resolve_shards(None) == 1
    assert resolve_shards(0) == 1
    with pytest.raises(ValueError):
        resolve_shards(-2)
    monkeypatch.setenv("WF_RESHARD", "8")
    assert ReshardPlan.resolve(None).new_shards == 8
    assert ReshardPlan.resolve('{"at_pos": 3, "moves": [[5, 0]]}').moves == ((5, 0),)
    assert ReshardPlan.resolve("auto") == "auto"
    assert ReshardPlan.resolve(False) is None
    plan = ReshardPlan(new_shards=8, moves=((3, 1),), at_pos=4)
    jplan = jsh.ReshardPlan(new_shards=8, moves=((3, 1),), at_pos=4)
    assert plan.apply_to(ShardAssignment(4)).to_meta() == \
        jplan.apply_to(jsh.ShardAssignment(4)).to_meta()


# --------------------------------------------------- the pipeline driver vs JAX

def _kill(where, fires=None):
    return lambda _d: [dict(site="shard.kill", where=where, max_fires=fires)]


SCENARIOS = {
    "off": dict(kw={}),
    "shards4": dict(kw=dict(shards=4, checkpoint_every=3)),
    "live_reshard_4_to_8": dict(kw=dict(shards=4, checkpoint_every=3,
                                        reshard={"new_shards": 8, "at_pos": 4})),
    "targeted_move": dict(kw=dict(shards=4, checkpoint_every=3,
                                  reshard={"moves": [[3, 0]], "at_pos": 4})),
    "kill_one_of_four": dict(kw=dict(shards=4, checkpoint_every=3, max_restarts=4),
                             plan=_kill({"shard": 2}, 2)),
    "plan_past_eos": dict(kw=dict(shards=2, checkpoint_every=3,
                                  reshard={"new_shards": 4, "at_pos": 10_000})),
    "poison_quarantine": dict(kw=dict(shards=4, checkpoint_every=3, max_restarts=6,
                                      poison_threshold=2),
                              plan=_kill({"shard": 1, "pos": 3}), dead_letter=True),
    "poison_survives_reshard": dict(kw=dict(shards=4, checkpoint_every=3, max_restarts=6,
                                            poison_threshold=2,
                                            reshard={"new_shards": 8, "at_pos": 5}),
                                    plan=_kill({"shard": 1, "pos": 3}), dead_letter=True),
    "global_fault": dict(kw=dict(shards=4, checkpoint_every=3, max_restarts=3),
                         plan=lambda _d: [dict(site="source.next", at=[5])]),
    "torn_handoff": dict(kw=dict(shards=4, checkpoint_every=2, max_restarts=4,
                                 reshard={"new_shards": 8, "at_pos": 3}),
                         plan=lambda _d: [dict(site="reshard.handoff", kind="torn",
                                               max_fires=1)], spill="ck.npz"),
    "checkpoint_mid_handoff": dict(
        kw=dict(shards=4, checkpoint_every=2, max_restarts=4,
                reshard={"new_shards": 8, "at_pos": 3}),
        plan=lambda d: [dict(site="checkpoint.save",
                             where={"path": str(d / "ck.shard5.npz")}, max_fires=1)],
        spill="ck.npz"),
}


@pytest.fixture(scope="module")
def oracle():
    return run_port()[0]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipeline_scenario_matches_jax(tmp_path, oracle, name):
    sc = SCENARIOS[name]
    res = run_both(tmp_path, plan=sc.get("plan"), dead_letter=sc.get("dead_letter", False),
                   spill=sc.get("spill"), **sc["kw"])
    jrows, jrest, jrep, jdlq, jctr, jrec = res["jax"]
    trows, trest, trep, tdlq, tctr, trec = res["port"]
    assert trows == jrows
    assert (trest, trep, tdlq, tctr) == (jrest, jrep, jdlq, jctr)
    assert trec == jrec
    if sc.get("dead_letter"):
        lost = set(oracle) - set(trows)
        assert lost and not set(trows) - set(oracle)
        assert {k % 4 for k, _i, _v in lost} == {1}
    else:
        assert trows == oracle
    if name == "kill_one_of_four":
        assert trep[2]["restarts"] == 2 and all(trep[k]["restarts"] == 0 for k in (0, 1, 3))
        assert [r["shard"] for r in trec if r["event"] == "shard_restore"] == [2, 2]
        assert not [r for r in trec if r["event"] == "restore"]
    if name == "plan_past_eos":
        ev = [r for r in trec if r["event"] == "reshard"]
        assert ev and ev[-1].get("aborted") and "stream ended" in ev[-1]["error"]
    if sc.get("spill"):
        assert len(trep) == 8
        assert not glob.glob(str(tmp_path / "port" / "ck.handoff*")), "seal debris left"


def test_shard_restart_budget_exhausts_locally():
    plan = faults_mod.FaultPlan([faults_mod.FaultSpec("shard.kill", where={"shard": 1})])
    with pytest.raises(RestartExhausted, match="shard 1"):
        run_port(shards=2, checkpoint_every=4, max_restarts=1, faults=plan)


def test_env_shards_runs_sharded(monkeypatch, oracle):
    monkeypatch.setenv("WF_SHARDS", "4")
    got, p = run_port(checkpoint_every=3)
    assert got == oracle and sorted(p.shard_report()) == [0, 1, 2, 3]
    monkeypatch.setenv("WF_SHARDS", "0")
    got, p = run_port()
    assert got == oracle and p.shard_report() == {}


def test_shard_key_follows_rekeyed_stream():
    """A KeyBy re-key under sharding: ownership follows the KeyBy's key
    (``shard_key=``), and the rows are the unsharded run's."""
    def mk(**kw):
        src = wt.Source(lambda i: {"u": (i * 3 % 7).to(torch.int32), "v": (i % 13).float()},
                        total=TOTAL, num_keys=16, **CPU)
        ops = [wt.KeyBy(lambda t: t.u, 7, **CPU),
               wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(10, 10, win_type_t.TB),
                          num_keys=7, **CPU)]
        got = []
        wt.SupervisedPipeline(src, ops, wt.Sink(collect(got), **CPU), batch_size=50,
                              backoff_base=0.0, **CPU, **kw).run()
        return sorted(got)
    assert mk(shards=4, checkpoint_every=3, shard_key=lambda t: t.data["u"]) == mk()


# ---------------------------------------------------------- shard_range slices

def test_shard_range_slices_union_is_exact(oracle):
    a, _pa = run_port(shards=4, shard_range=(0, 2))
    b, _pb = run_port(shards=4, shard_range=(2, 4))
    assert sorted(a + b) == oracle and a and b
    c, pc = run_port(shards=2, shard_range=(2, 2))         # a surplus host
    assert c == [] and pc.shard_report() == {}


def test_multihost_slice_helper_raises_by_name():
    from windflow_tpu_torch.parallel import multihost
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        multihost.process_shard_slice(4)


def test_shard_range_guards():
    with pytest.raises(ValueError, match="shard_range"):
        tbuild(lambda v: None, shard_range=(0, 1))
    with pytest.raises(ValueError, match="shard_range"):
        run_port(shards=4, shard_range=(0, 2), reshard={"new_shards": 8, "at_pos": 2})


def test_empty_slice_reduce_sink_returns_identity():
    src = wt.Source(lambda i: {"v": (i % 13).float()}, total=100, num_keys=4, **CPU)
    p = wt.SupervisedPipeline(src, [wt.ReduceSink(lambda t: t.v, name="total", **CPU)],
                              None, batch_size=50, backoff_base=0.0, shards=2,
                              shard_range=(2, 2), **CPU)
    assert float(p.run()["total"]) == 0.0


@pytest.mark.parametrize("shards", [1, 3])
def test_reduce_sink_partials_combine(shards):
    src = wt.Source(lambda i: {"v": (i % 13).float()}, total=300, num_keys=5, **CPU)
    p = wt.SupervisedPipeline(src, [wt.ReduceSink(lambda t: t.v, name="total", **CPU)],
                              None, batch_size=50, backoff_base=0.0, shards=shards, **CPU)
    assert float(p.run()["total"]) == float(sum(i % 13 for i in range(300)))


# ----------------------------------------------------------------- refusals

def test_shards_refuse_dispatch_and_tiered_state():
    with pytest.raises(ValueError, match="scan dispatch"):
        run_port(shards=4, dispatch=4)
    src = wt.Source(lambda i: {"v": i}, total=10, **CPU)
    with pytest.raises(ValueError, match="tiered keyed state"):
        wt.SupervisedPipeline(src, [wt.SessionWindow(lambda t: t.v, wt.WindowSpec.session(2),
                                                     tiered=True, **CPU)],
                              None, shards=2, **CPU)
    # the JAX package refuses the same two
    with pytest.raises(ValueError, match="scan dispatch"):
        jbuild(lambda v: None, shards=4, dispatch=4).run()


# ----------------------------------------------------------- sharded checkpoints

def _leaves(states):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for st in states for _p, x in flatten_with_paths(st)]


def _jleaves(states):
    return [np.asarray(x) for st in states for x in jax.tree.leaves(st)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sharded_checkpoint_files_load_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "ck.npz")
    build = tbuild if writer == "port" else jbuild
    p = build(lambda v: None, shards=4, checkpoint_every=2, spill_path=path,
              checkpoint_keep=3)
    p.run()
    for k in range(4):
        assert os.path.exists(tck.manifest_path(tck.shard_stem(path, k)))
    tstates, tlayout, tmeta = tck.load_sharded(_fresh_states(tbuild(None).chain), path)
    jstates, jlayout, jmeta = jck.load_sharded(jsup._fresh_states(jbuild(None).chain), path)
    assert sorted(tstates) == sorted(jstates) == [0, 1, 2, 3]
    assert tlayout == jlayout == {"num_shards": 4, "moves": []}
    assert tmeta == jmeta and tmeta["batches_done"] == TOTAL // 50
    for k in range(4):
        a, b = _leaves(tstates[k]), _jleaves(jstates[k])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    snaps = [s.snap for s in p._sharded.shards]
    for k in range(4):
        want = _leaves(snaps[k]) if writer == "port" else _jleaves(snaps[k])
        for x, y in zip(_leaves(tstates[k]), want):
            assert x.tobytes() == y.tobytes()


def test_per_shard_lineage_fallback(tmp_path):
    path = str(tmp_path / "ck.npz")
    p = tbuild(lambda v: None, shards=4, checkpoint_every=2, spill_path=path,
               checkpoint_keep=3)
    p.run()
    man = tck._read_manifest(tck.manifest_path(tck.shard_stem(path, 2)))
    with open(os.path.join(str(tmp_path), man["entries"][-1]["file"]), "wb") as f:
        f.write(b"torn!")
    states, _layout, _meta = tck.load_sharded(_fresh_states(p.chain), path)
    assert sorted(states) == [0, 1, 2, 3]      # shard 2 fell back, the others did not


def test_sharded_manifest_checks(tmp_path):
    with pytest.raises(tck.CheckpointCorrupt, match="manifest"):
        tck.load_sharded([], str(tmp_path / "none.npz"))
    # keep=1 and the manifest one commit behind its shard files
    path = str(tmp_path / "g1.npz")
    p = tbuild(lambda v: None, shards=2, checkpoint_every=4, spill_path=path)
    p.run()
    man_file = str(tmp_path / "g1.shards.json")
    with open(man_file) as f:
        stale = f.read().replace('"batches_done": 8', '"batches_done": 4')
    with open(man_file, "w") as f:
        f.write(stale)
    with pytest.raises(tck.CheckpointCorrupt, match="AHEAD"):
        tck.load_sharded(_fresh_states(p.chain), path)


def test_slice_manifests_merge_and_a_missing_slice_is_loud(tmp_path):
    path = str(tmp_path / "fleet.npz")
    pa = tbuild(lambda v: None, shards=4, shard_range=(0, 2), checkpoint_every=2,
                spill_path=path)
    pa.run()
    tbuild(lambda v: None, shards=4, shard_range=(2, 4), checkpoint_every=2,
           spill_path=path).run()
    tmpl = _fresh_states(pa.chain)
    states, layout, _meta = tck.load_sharded(tmpl, path)
    assert sorted(states) == [0, 1, 2, 3] and layout["num_shards"] == 4
    # the JAX package merges the port's per-slice manifests too
    jstates, _l, _m = jck.load_sharded(jsup._fresh_states(jbuild(None).chain), path)
    assert sorted(jstates) == [0, 1, 2, 3]
    os.unlink(str(tmp_path / "fleet.shards.s2-3.json"))
    for k in (2, 3):
        for f in glob.glob(str(tmp_path / f"fleet.shard{k}*")):
            os.unlink(f)
    with pytest.raises(tck.CheckpointCorrupt, match=r"\[2, 3\] missing"):
        tck.load_sharded(tmpl, path)


def test_handoff_seal_and_discard(tmp_path):
    path = str(tmp_path / "h.npz")
    p = tbuild(lambda v: None, shards=2)
    states = [_fresh_states(p.chain), _fresh_states(p.chain)]
    files = tck.seal_handoff(states, path, layout={"num_shards": 2, "moves": []}, at_pos=3)
    assert [os.path.basename(f) for f in files] == ["h.handoff0.npz", "h.handoff1.npz"]
    # the seal is the JAX package's file: its arrays and meta read there
    data = np.load(files[1])
    assert {"op0_leaf0", "__meta__"} <= set(data.files)
    assert tck.discard_handoffs(path) == ["h.handoff0.npz", "h.handoff1.npz"]
    assert jck.discard_handoffs(path) == []


# --------------------------------------------------------------------- nexmark

def _nexmark_rows(name, view):
    if name == "q6_topn":
        return list(zip(view["key"].tolist(), view["payload"]["rank"].tolist(),
                        view["id"].tolist(), view["payload"]["score"].tolist()))
    leaves = view["payload"] if isinstance(view["payload"], dict) else {"p": view["payload"]}
    flat = []
    for k in sorted(leaves):
        v = leaves[k]
        if isinstance(v, dict):
            flat += [v[kk].tolist() for kk in sorted(v)]
        else:
            flat.append(v.tolist())
    return list(zip(view["key"].tolist(), view["id"].tolist(), *flat))


def _run_nexmark(name, **kw):
    from windflow_tpu_torch.nexmark import make_query
    src, ops = make_query(name, TOTAL, **CPU)
    rows = []
    final = {}

    def cb(view):
        if view is None:
            return
        r = _nexmark_rows(name, view)
        if name == "q6_topn":
            for k, rank, i, sc in r:
                final[(k, rank)] = (i, sc)
        else:
            rows.extend(r)
    key_fn = (lambda t: t.data["bidder"]) if name == "q5_session" else None
    wt.SupervisedPipeline(src, ops, wt.Sink(cb, **CPU), batch_size=50, checkpoint_every=3,
                          backoff_base=0.0, shard_key=key_fn, **CPU, **kw).run()
    if name == "q6_topn":
        return sorted((k, r, i, s) for (k, r), (i, s) in final.items())
    return sorted(rows)


@pytest.mark.parametrize("name, reshard", [
    ("q3_enrich_join", None), ("q5_session", None), ("q6_topn", None),
    ("q7_distinct", None), ("q4_interval_join", None),
    ("q3_enrich_join", {"new_shards": 8, "at_pos": 4}),
    ("q5_session", {"new_shards": 8, "at_pos": 4})])
def test_nexmark_shard_count_invariance(name, reshard):
    base = _run_nexmark(name)
    assert base
    assert _run_nexmark(name, shards=4, reshard=reshard) == base


# ------------------------------------------------------------ the graph driver

def _tgraph(shards=1, faults=None, reshard=None, mode=Mode.DEFAULT):
    got = []
    g = wt.PipeGraph("shtest", batch_size=20, mode=mode, **CPU)
    a = g.add_source(wt.Source(lambda i: {"v": (i % 9).float()}, total=200, num_keys=3,
                               name="a", **CPU))
    b = g.add_source(wt.Source(lambda i: {"v": (i % 7).float()}, total=100, num_keys=3,
                               name="b", **CPU))
    (a.merge(b)
     .add(wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(12, 12, win_type_t.CB),
                     num_keys=3, **CPU))
     .add_sink(wt.Sink(collect(got), **CPU)))
    g.run_supervised(checkpoint_every=3, max_restarts=6, backoff_base=0.0,
                     backoff_cap=0.01, faults=faults, shards=shards, reshard=reshard)
    return sorted(got), g


def _jgraph(shards=1, faults=None, reshard=None, mode=JMode.DEFAULT):
    got = []
    g = wf.PipeGraph("shtest", batch_size=20, mode=mode)
    a = g.add_source(wf.Source(lambda i: {"v": (i % 9).astype(jnp.float32)}, total=200,
                               num_keys=3, name="a"))
    b = g.add_source(wf.Source(lambda i: {"v": (i % 7).astype(jnp.float32)}, total=100,
                               num_keys=3, name="b"))
    (a.merge(b)
     .add(wf.Win_Seq(lambda wid, it: it.sum("v"), wf.WindowSpec(12, 12, jwin.CB),
                     num_keys=3))
     .add_sink(wf.Sink(collect(got))))
    g.run_supervised(checkpoint_every=3, max_restarts=6, backoff_base=0.0,
                     backoff_cap=0.01, faults=faults, shards=shards, reshard=reshard)
    return sorted(got), g


def _greport(g):
    return {k: {f: v for f, v in r.items() if f != "last_recovery_s"}
            for k, r in g._shard_report.items()}


@pytest.mark.parametrize("case", ["shards3", "kill", "deterministic", "live_reshard"])
def test_graph_sharded_matches_jax(case):
    kw = {"shards3": dict(shards=3), "kill": dict(shards=3),
          "deterministic": dict(shards=2), "live_reshard": dict(
              shards=2, reshard={"new_shards": 4, "at_pos": 3})}[case]
    tkw, jkw = dict(kw), dict(kw)
    if case == "kill":
        tkw["faults"] = faults_mod.FaultInjector(faults_mod.FaultPlan(
            [faults_mod.FaultSpec("shard.kill", where={"shard": 1}, max_fires=2)], seed=3))
        jkw["faults"] = jfaults.FaultInjector(jfaults.FaultPlan(
            [jfaults.FaultSpec("shard.kill", where={"shard": 1}, max_fires=2)], seed=3))
    if case == "deterministic":
        tkw["mode"], jkw["mode"] = Mode.DETERMINISTIC, JMode.DETERMINISTIC
    base, _ = _tgraph(mode=tkw.get("mode", Mode.DEFAULT))
    got, g = _tgraph(**tkw)
    jgot, jg = _jgraph(**jkw)
    assert got == base == jgot
    assert _greport(g) == _greport(jg)
    assert g.supervised_restarts == jg.supervised_restarts
    if case == "kill":
        assert g._shard_report[1]["restarts"] == 2 and g._shard_report[0]["restarts"] == 0


def test_graph_drain_failure_recovers_without_double_apply():
    def run(shards, fail_drain=False):
        g = wt.PipeGraph("drain", batch_size=20, **CPU)
        mp = g.add_source(wt.Source(lambda i: {"v": (i % 13).float()}, total=190,
                                    num_keys=4, name="s", **CPU))
        mp.add(wt.Map(lambda t: {"v": t.v * 2.0}, **CPU))
        mp.add(wt.ReduceSink(lambda t: t.v, name="total", **CPU))
        if fail_drain:
            orig = g._topo_order
            hits = {"n": 0}

            def flaky():
                hits["n"] += 1
                if hits["n"] == 1:
                    raise RuntimeError("injected drain fault")
                return orig()
            g._topo_order = flaky
        res = g.run_supervised(checkpoint_every=3, max_restarts=4, backoff_base=0.0,
                               shards=shards)
        return float(res["total"])
    oracle = run(1)
    assert run(2) == oracle
    assert run(2, fail_drain=True) == oracle


def test_graph_driver_refusals(monkeypatch):
    def g():
        gr = wt.PipeGraph("r", batch_size=20, **CPU)
        gr.add_source(wt.Source(lambda i: {"v": (i % 9).float()}, total=40, num_keys=3,
                                **CPU)).add_sink(wt.Sink(lambda v: None, **CPU))
        return gr
    with pytest.raises(ValueError, match="shard_range"):
        g().run_supervised(shards=2, shard_range=(0, 1))
    with pytest.raises(ValueError, match="pipeline-driver feature"):
        g().run_supervised(shards=2, reshard="auto")
    with pytest.raises(ValueError, match="scan dispatch"):
        g().run_supervised(shards=2, dispatch=3)
    monkeypatch.setenv("WF_SHARDS", "2")
    gr = g()
    gr.run_supervised(backoff_base=0.0)
    assert sorted(gr._shard_report) == [0, 1]


def test_shard_and_stage_gauges_match_jax():
    from windflow_tpu.observability import names as jnames
    from windflow_tpu_torch.observability import names as tnames
    assert tnames.SHARD_GAUGES == jnames.SHARD_GAUGES
    assert tnames.STAGE_GAUGES == jnames.STAGE_GAUGES
    _got, p = run_port(shards=2)
    assert all(tuple(r) == tnames.SHARD_GAUGES for r in p.shard_report().values())

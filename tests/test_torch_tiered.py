"""Tiered keyed state in the port (``windflow_tpu_torch/state``), on the CPU.

Mirrors the JAX package's ``tests/test_tiered_state.py``: with ``tiered=``
on, a tiny hot table gives the rows of an untiered table big enough for the
whole key space, on the plain, threaded, supervised and graph-supervised
drivers and at scan dispatch K; no movement when the table fits; Nexmark
q3, q5, q6 and q7 tiered on and off; Distinct, TopN and SessionWindow;
checkpoints mid-spill under seeded fault plans. Then against the JAX package
run on the CPU with the same seeded streams: sink rows, final states (bytes,
dtypes, tree paths), store manifests, counters and the journal's ``spill``/
``readmit`` records; checkpoint files carrying ``tier*`` arrays resumed
across the two packages both ways; F14 (``WF_STATE_TIERED`` and
``WF_STATE_HOT_CAPACITY`` build the JAX package's state keys); and
``bench.py``'s tiered row at a small batch. The interval join's archive tier
(ROADMAP Queue 1 item 13b) still raises.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.nexmark import make_query as jmake
from windflow_tpu.runtime import checkpoint as jck
from windflow_tpu.runtime.faults import FaultPlan as JFaultPlan
from windflow_tpu.runtime.faults import FaultSpec as JFaultSpec
from windflow_tpu.state import TierConfig as JTierConfig
from windflow_tpu_torch.nexmark import make_query as tmake
from windflow_tpu_torch.batch import jax_leaves
from windflow_tpu_torch.runtime import checkpoint as tck
from windflow_tpu_torch.runtime import faults as faults_mod
from windflow_tpu_torch.runtime.checkpoint import flatten_with_paths
from windflow_tpu_torch.runtime.faults import FaultPlan, FaultSpec
from windflow_tpu_torch.state import TierConfig

CPU = {"device": "cpu"}
DEADLINE_S = 60.0

# a spill-forcing stream-table join workload (the JAX test's): 300 keys
# through a hot table that clears the admission reserve (batch 50 + pending
# 100) but holds a fraction of the key space
N_KEYS, TOTAL, BATCH = 300, 1000, 50
HOT = 192


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("WF_STATE_TIERED", raising=False)
    monkeypatch.delenv("WF_STATE_HOT_CAPACITY", raising=False)
    faults_mod.set_active(None)
    yield
    faults_mod.set_active(None)
    wt.observability.set_journal(None)


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


# ------------------------------------------------------------------ the workload

def tsrc():
    def gen(i):
        is_def = i < N_KEYS
        k = torch.where(is_def, i, (i * 2477) % N_KEYS)
        return {"side": torch.where(is_def, 1, 0).to(torch.int32),
                "k": k.to(torch.int32),
                "cat": torch.where(is_def, (i * 13) % 7, 0).to(torch.int32)}
    return wt.DeviceSource(gen, total=TOTAL,
                           key_fn=lambda i: torch.where(i < N_KEYS, i, (i * 2477) % N_KEYS),
                           ts_fn=lambda i: i // 8, **CPU)


def jsrc():
    def gen(i):
        is_def = i < N_KEYS
        k = jnp.where(is_def, i, (i * 2477) % N_KEYS)
        return {"side": jnp.where(is_def, 1, 0).astype(jnp.int32),
                "k": k.astype(jnp.int32),
                "cat": jnp.where(is_def, (i * 13) % 7, 0).astype(jnp.int32)}
    return wf.DeviceSource(gen, total=TOTAL,
                           key_fn=lambda i: jnp.where(i < N_KEYS, i, (i * 2477) % N_KEYS),
                           ts_fn=lambda i: i // 8)


def tstj(slots, tiered):
    return wt.StreamTableJoin(lambda t: t.side == 1, lambda t: t.k,
                              lambda t: {"category": t.cat}, num_slots=slots,
                              tiered=tiered, **CPU)


def jstj(slots, tiered):
    return wf.StreamTableJoin(lambda t: t.side == 1, lambda t: t.k,
                              lambda t: {"category": t.cat}, num_slots=slots,
                              tiered=tiered)


def rows_into(rows):
    def cb(v):
        if v is None:
            return
        flat = [np.asarray(leaf).tolist() for leaf in jax_leaves(v["payload"])]
        rows.extend(zip(np.asarray(v["key"]).tolist(), np.asarray(v["id"]).tolist(),
                        np.asarray(v["ts"]).tolist(), *flat))
    return cb


def run_port(op, driver="plain", src=None, faults=None, ckpt=2, dispatch=None,
             batch=BATCH):
    src = src or tsrc()
    rows = []
    sink = wt.Sink(rows_into(rows), **CPU)
    hard = dict(max_restarts=8, backoff_base=0.0, backoff_cap=0.01, faults=faults)
    if driver == "plain":
        pipe = wt.Pipeline(src, [op], sink, batch_size=batch, dispatch=dispatch, **CPU)
        within_deadline(pipe.run)
        return rows, pipe.chain
    if driver == "threaded":
        tp = wt.ThreadedPipeline(src, [[op]], sink, batch_size=batch, pin=False,
                                 dispatch=dispatch, **CPU)
        within_deadline(tp.run)
        return rows, tp.chains[0]
    if driver == "supervised":
        sp = wt.SupervisedPipeline(src, [op], sink, batch_size=batch, checkpoint_every=ckpt,
                                   dispatch=dispatch, **hard, **CPU)
        within_deadline(sp.run)
        return rows, sp.chain
    g = wt.PipeGraph(batch_size=batch, **CPU)
    mp = g.add_source(src)
    mp.add(op)
    mp.add_sink(sink)
    within_deadline(lambda: g.run_supervised(checkpoint_every=ckpt, dispatch=dispatch,
                                             **hard))
    return rows, mp._chain


def run_jax(op, driver="plain", src=None, faults=None, ckpt=2, batch=BATCH):
    src = src or jsrc()
    rows = []
    sink = wf.Sink(rows_into(rows))
    if driver == "plain":
        pipe = wf.Pipeline(src, [op], sink, batch_size=batch)
        pipe.run()
        return rows, pipe.chain
    sp = wf.SupervisedPipeline(src, [op], sink, batch_size=batch, checkpoint_every=ckpt,
                               max_restarts=8, backoff_base=0.0, backoff_cap=0.01,
                               faults=faults)
    sp.run()
    return rows, sp.chain


def jax_paths(tree):
    kl, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(leaf)) for p, leaf in kl]


def assert_states_equal(tstate, jstate, what):
    g = [(p, np.asarray(leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf))
         for p, leaf in flatten_with_paths(tstate)]
    w = jax_paths(jstate)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, p)
        assert a.tobytes() == b.tobytes(), (what, p)


def assert_tiers_equal(tchain, jchain, what):
    """Settled states, store manifests and counters of two chains' tiers."""
    tchain.tier_settle()
    jchain.tier_settle()
    for tst, jst in zip(tchain.states, jchain.states):
        assert_states_equal(tst, jst, what)
    tm, jm = tchain.tier_manifests(), jchain.tier_manifests()
    assert sorted(tm) == sorted(jm), what
    for k in jm:
        assert tm[k].dtype == jm[k].dtype and np.array_equal(tm[k], jm[k]), (what, k)
    for top, jop in zip(tchain.ops, jchain.ops):
        for tt, jt in zip(top.tier_controllers(), jop.tier_controllers()):
            assert tt.counters() == jt.counters(), what


# ------------------------------------------------------------ F14 and the config

def _specs():
    t = {k: torch.empty((), dtype=torch.int32, device="meta") for k in ("side", "k", "cat")}
    j = {k: jax.ShapeDtypeStruct((), jnp.int32) for k in ("side", "k", "cat")}
    return t, j


def _op_pairs():
    return [
        (lambda: tstj(64, None), lambda: jstj(64, None)),
        (lambda: wt.Distinct(lambda t: t.k, num_slots=64, **CPU),
         lambda: wf.Distinct(lambda t: t.k, num_slots=64)),
        (lambda: wt.TopN(lambda t: t.k, 2, num_keys=32, **CPU),
         lambda: wf.TopN(lambda t: t.k, 2, num_keys=32)),
        (lambda: wt.SessionWindow(lambda t: {"n": t.k}, wt.WindowSpec.session(3),
                                  num_keys=32, **CPU),
         lambda: wf.SessionWindow(lambda t: {"n": t.k}, wf.WindowSpec.session(3),
                                  num_keys=32)),
    ]


@pytest.mark.parametrize("env", [{}, {"WF_STATE_TIERED": "1"},
                                 {"WF_STATE_TIERED": "1", "WF_STATE_HOT_CAPACITY": "48"},
                                 {"WF_STATE_TIERED": '{"outbox": 40}'}])
def test_f14_env_builds_the_jax_packages_state(monkeypatch, env):
    """F14: ``tiered=None`` reads ``WF_STATE_TIERED`` and
    ``WF_STATE_HOT_CAPACITY`` as the JAX package does, so both packages build
    the same state (keys, paths, shapes, dtypes, values) and so the same
    checkpoint files; an IntervalJoin refuses the setting by name."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tspec, jspec = _specs()
    for mk_t, mk_j in _op_pairs():
        top, jop = mk_t(), mk_j()
        top.bind_geometry(BATCH)
        jop.bind_geometry(BATCH)
        assert_states_equal(top.init_state(tspec), jop.init_state(jspec),
                            f"{type(top).__name__} {env}")
        assert bool(top.tier_controllers()) == bool(jop.tier_controllers())
    if env:
        with pytest.raises(NotImplementedError, match="Queue 1 item 13b"):
            wt.IntervalJoin(lambda t: t.side == 1, 0, 4, **CPU)


def test_env_resolution(monkeypatch):
    assert TierConfig.resolve(None) is None
    assert TierConfig.resolve(False) is None
    monkeypatch.setenv("WF_STATE_TIERED", "0")
    assert TierConfig.resolve(None) is None
    monkeypatch.setenv("WF_STATE_TIERED", "1")
    assert TierConfig.resolve(None) == TierConfig()
    monkeypatch.setenv("WF_STATE_TIERED", '{"readmit_rows": 4}')
    assert TierConfig.resolve(None).readmit_rows == 4
    monkeypatch.setenv("WF_STATE_HOT_CAPACITY", "4096")
    assert TierConfig.resolve(None).hot_capacity == 4096
    assert TierConfig.resolve(True).hot_capacity == 4096
    assert (vars(TierConfig.resolve(dict(ttl=5))) == vars(JTierConfig.resolve(dict(ttl=5))))
    monkeypatch.setenv("WF_STATE_TIERED", "not-a-config")
    with pytest.raises(ValueError):
        TierConfig.resolve(None)
    with pytest.raises(ValueError):
        TierConfig(hot_capacity=1)


def test_tiered_off_state_pytree_unchanged():
    tspec, _ = _specs()
    st = tstj(64, None).init_state(tspec)
    assert set(st) == {"key", "val", "ver", "vid", "vseq", "used", "pkey", "pval", "pts",
                       "pid", "pseq", "pok", "wm", "seq", "version", "dropped"}
    s = wt.SessionWindow(lambda t: {"n": t.k}, wt.WindowSpec.session(3), num_keys=32, **CPU)
    assert "hkey" not in s.init_state(tspec)
    t = wt.TopN(lambda t: t.k, 2, num_keys=32, **CPU)
    assert set(t.init_state(tspec)) == {"score", "tid", "evict", "eos"}
    assert not t.tier_controllers()


# ------------------------ tiny hot table == big untiered table (every driver)

@pytest.mark.parametrize("driver", ["plain", "threaded", "supervised", "graph-supervised"])
def test_tiered_equals_untiered_big_table_all_drivers(driver):
    ref, _ = run_port(tstj(4096, None), driver)
    op = tstj(HOT, dict())
    got, _ = run_port(op, driver)
    assert got == ref
    assert op._tier.store.counters()["state_spills"] > 0
    assert op._tier.store.key_count() > 0


def test_tiered_zero_movement_when_hot_table_fits():
    ref, _ = run_port(tstj(4096, None))
    op = tstj(4096, dict())
    got, _ = run_port(op)
    assert got == ref
    c = op._tier.store.counters()
    assert c["state_spills"] == 0 and c["state_readmits"] == 0


@pytest.mark.parametrize("driver", ["plain", "supervised"])
def test_tiered_join_equals_jax(driver):
    """Rows, settled states, store manifests and counters equal the JAX
    package's tiered run (the supervised run snapshots every 2 batches)."""
    trows, tchain = run_port(tstj(HOT, dict()), driver)
    jrows, jchain = run_jax(jstj(HOT, dict()), driver)
    assert trows == jrows
    assert_tiers_equal(tchain, jchain, driver)


@pytest.mark.parametrize("driver", ["plain", "threaded", "supervised"])
def test_tiered_dispatch_equals_per_batch(driver):
    """Scan dispatch (K = 3: one maintenance point a group) gives the rows of
    the per-batch run, with spills flowing."""
    ref, _ = run_port(tstj(HOT, dict()), driver)
    got, gchain = run_port(tstj(HOT, dict()), driver, dispatch=3)
    assert got == ref
    assert gchain.ops[0]._tier.store.counters()["state_spills"] > 0


def test_warm_up_step_probes_uncounted(monkeypatch):
    """``warm_scan``'s eager warm-up step runs on the live states, its
    results dropped: its cold-tier probes run under the stores'
    ``uncounted()``, while a push's probes count."""
    op = tstj(HOT, dict())
    pipe = wt.Pipeline(tsrc(), [op], wt.Sink(lambda v: None, **CPU), batch_size=BATCH, **CPU)
    depth = []
    inner = op._tier.lookup
    monkeypatch.setattr(op._tier, "lookup",
                        lambda k, w: depth.append(op._tier.store._uncounted) or inner(k, w))
    pipe.chain.push(pipe.source.make_batch(0, BATCH))
    pipe.chain.warm_scan(3, BATCH)
    assert depth == [0, 1]
    pipe.chain.push(pipe.source.make_batch(BATCH, BATCH))
    assert depth == [0, 1, 0] and op._tier.store._uncounted == 0


# ----------------------------------------------- chaos: checkpoint mid-spill

def test_chaos_checkpoint_mid_spill_byte_identical():
    """chain.step faults while spills are in flight (a checkpoint every 2
    batches): the restore discards the copies in flight, replay re-derives
    them; rows equal the fault-free run and the JAX package's chaos run,
    and so do the stores and counters."""
    ref, _ = run_port(tstj(4096, None), "supervised")
    op = tstj(HOT, dict())
    chaos, tchain = run_port(op, "supervised",
                             faults=FaultPlan([FaultSpec(site="chain.step", at=(2, 7, 11))]))
    assert chaos == ref
    assert op._tier.store.counters()["state_spills"] > 0
    jrows, jchain = run_jax(jstj(HOT, dict()), "supervised",
                            faults=JFaultPlan([JFaultSpec(site="chain.step", at=(2, 7, 11))]))
    assert jrows == chaos
    assert_tiers_equal(tchain, jchain, "chaos")


def test_chaos_graph_driver_mid_spill():
    ref, _ = run_port(tstj(4096, None), "graph-supervised")
    op = tstj(HOT, dict())
    chaos, _ = run_port(op, "graph-supervised",
                        faults=FaultPlan([FaultSpec(site="chain.step", at=(3, 9))]))
    assert chaos == ref
    assert op._tier.store.counters()["state_spills"] > 0


def test_chaos_at_dispatch_k():
    """Faults at group heads of a K = 2 supervised run (a checkpoint every 2
    batches), tiered: the fault-free rows."""
    ref, _ = run_port(tstj(4096, None), "supervised")
    got, _ = run_port(tstj(HOT, dict()), "supervised", dispatch=2,
                      faults=FaultPlan([FaultSpec(site="chain.step",
                                                  where={"pos": p}, max_fires=1)
                                        for p in (4, 10)]))
    assert got == ref


# ---------------------------------------------------- Nexmark and the other ops

def _nexmark_port(name, tiered, total=600, batch=50, **kw):
    src, ops = tmake(name, total, tiered=tiered, **kw, **CPU)
    rows = []
    pipe = wt.Pipeline(src, ops, wt.Sink(rows_into(rows), **CPU), batch_size=batch, **CPU)
    pipe.run()
    return rows, pipe.chain


@pytest.mark.parametrize("name, hot", [("q3_enrich_join", 256), ("q5_session", 256),
                                       ("q6_topn", 256), ("q7_distinct", 256)])
def test_nexmark_query_tiered_on_off_identical(name, hot):
    """Tiered on and off as sets of rows (the slot directories emit in
    admission order), the hot capacity covering the key space (the JAX
    test's cases)."""
    off, _ = _nexmark_port(name, None)
    on, _ = _nexmark_port(name, dict(hot_capacity=hot))
    assert sorted(on) == sorted(off)


@pytest.mark.parametrize("name, hot", [("q3_enrich_join", 160), ("q5_session", 6),
                                       ("q6_topn", 12), ("q7_distinct", 12)])
def test_nexmark_query_tiered_equals_jax(name, hot):
    """A hot capacity below the query's key space: rows in emission order,
    settled states, manifests and counters equal the JAX package's."""
    trows, tchain = _nexmark_port(name, dict(hot_capacity=hot))
    jsrc_, jops = jmake(name, 600, tiered=dict(hot_capacity=hot))
    jrows = []
    jpipe = wf.Pipeline(jsrc_, jops, wf.Sink(rows_into(jrows)), batch_size=50)
    jpipe.run()
    assert trows == jrows
    assert_tiers_equal(tchain, jpipe.chain, name)
    assert tchain.ops[-1]._tier.store.counters()["state_spills"] > 0


def test_interval_join_tiered_raises_13b():
    with pytest.raises(NotImplementedError, match="Queue 1 item 13b"):
        tmake("q4_interval_join", 100, tiered=dict(), **CPU)


def _distinct_src(total=4096):
    return wt.DeviceSource(lambda i: {"v": ((i * 2477) % 700).to(torch.int32)},
                           total=total, key_fn=lambda i: (i * 2477) % 700,
                           ts_fn=lambda i: i // 8, **CPU)


def test_distinct_tiered_equals_big_table():
    ref, _ = run_port(wt.Distinct(lambda t: t.v, num_slots=4096, **CPU),
                      src=_distinct_src(), batch=256)
    op = wt.Distinct(lambda t: t.v, num_slots=512, tiered=dict(), **CPU)
    got, _ = run_port(op, src=_distinct_src(), batch=256)
    assert got == ref
    assert op._tier.store.counters()["state_spills"] > 0


def test_topn_tiered_final_leaderboards_match():
    def run(slots, tiered):
        src = wt.DeviceSource(lambda i: {"price": ((i * 7919) % 997).to(torch.int32)},
                              total=2048, key_fn=lambda i: (i * 2477) % 700,
                              ts_fn=lambda i: i // 8, **CPU)
        op = wt.TopN(lambda t: t.price, 3, num_keys=slots, tiered=tiered, **CPU)
        rows, _ = run_port(op, src=src, batch=256)
        final = {(k, r): (i, s) for k, i, _ts, r, s in rows}
        return final, op
    ref, _ = run(1024, None)
    got, op = run(400, dict())
    assert got == ref
    assert op._tier.store.counters()["state_spills"] > 0


def test_session_tiered_equals_big_table():
    def run(slots, tiered):
        src = wt.DeviceSource(
            lambda i: {"v": torch.ones_like(i)}, total=2048,
            key_fn=lambda i: (i % 37) * 17 + (i // 37) % 25 + ((i // 641) * 40) % 600,
            ts_fn=lambda i: i // 4, **CPU)
        op = wt.SessionWindow(lambda t: {"n": torch.ones((), dtype=torch.int32)},
                              wt.WindowSpec.session(3, delay=2), num_keys=slots,
                              tiered=tiered, **CPU)
        rows, _ = run_port(op, src=src, batch=256)
        return sorted(rows), op
    ref, _ = run(2048, None)
    got, op = run(300, dict())
    assert got == ref
    assert op._tier.store.counters()["state_spills"] > 0


def test_ttl_compaction_retires_cold_rows_like_jax():
    """Builds spread through the stream: cold rows older than the TTL retire
    on the maintenance cadence, counted as the JAX package counts them."""
    def tgen(i):
        is_def = (i % 4) == 0
        return {"side": is_def.to(torch.int32),
                "k": torch.where(is_def, (i // 4) % 500, ((i // 8) + i % 3) % 500).to(torch.int32),
                "cat": (i % 7).to(torch.int32)}

    def jgen(i):
        is_def = (i % 4) == 0
        return {"side": is_def.astype(jnp.int32),
                "k": jnp.where(is_def, (i // 4) % 500, ((i // 8) + i % 3) % 500).astype(jnp.int32),
                "cat": (i % 7).astype(jnp.int32)}
    tier = dict(ttl=200, compact_every=4)
    top = tstj(256, tier)
    trows, tchain = run_port(top, src=wt.DeviceSource(
        tgen, total=3000, key_fn=lambda i: i % 500, ts_fn=lambda i: i // 4, **CPU), batch=64)
    jop = jstj(256, tier)
    jrows, jchain = run_jax(jop, src=wf.DeviceSource(
        jgen, total=3000, key_fn=lambda i: i % 500, ts_fn=lambda i: i // 4), batch=64)
    assert trows == jrows
    c = top._tier.store.counters()
    assert c["state_spills"] > 0 and c["state_compactions"] > 0
    assert_tiers_equal(tchain, jchain, "ttl")


# ------------------------------------------------------------ checkpoints

def _chains(tiered=dict(), slots=HOT):
    tc = wt.CompiledChain([tstj(slots, tiered)], tsrc().payload_spec(),
                          batch_capacity=BATCH, **CPU)
    jc = wf.CompiledChain([jstj(slots, tiered)], jsrc().payload_spec(), batch_capacity=BATCH)
    return tc, jc


def _host(outs):
    rows = []
    for o in outs:
        v = np.asarray(o.valid)
        rows.extend(zip(np.asarray(o.key)[v].tolist(), np.asarray(o.id)[v].tolist(),
                        np.asarray(o.payload["category"])[v].tolist()))
    return rows


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_with_cold_tier_resumes_across_packages(tmp_path, direction):
    """Half the stream in one package, ``save_chain`` (the tier* arrays of
    the settled store beside the states), ``load_chain`` into the other, the
    rest there: the rows of an uninterrupted JAX run, and the same final
    stores."""
    tb, jb = list(tsrc().batches(BATCH)), list(jsrc().batches(BATCH))
    half = len(jb) // 2
    _, jref = _chains()
    want = _host([jref.push(b) for b in jb])
    tc, jc = _chains()
    path = str(tmp_path / "ck.npz")
    if direction == "jax_to_port":
        first = _host([jc.push(b) for b in jb[:half]])
        jck.save_chain(jc, path)
        assert any(k.startswith("tier0_0_") for k in np.load(path).files)
        tck.load_chain(tc, path)
        rest = _host([tc.push(b) for b in tb[half:]])
        done = tc
    else:
        first = _host([tc.push(b) for b in tb[:half]])
        tck.save_chain(tc, path)
        assert any(k.startswith("tier0_0_") for k in np.load(path).files)
        jck.load_chain(jc, path)
        rest = _host([jc.push(b) for b in jb[half:]])
        done = jc
    assert first + rest == want
    for ctl, ref in zip(done.ops[0].tier_controllers(), jref.ops[0].tier_controllers()):
        done.tier_settle()
        jref.tier_settle()
        man, rman = ctl.manifest(), ref.manifest()
        for k in rman:
            assert np.array_equal(man[k], rman[k]), k


def test_pre_tiering_checkpoint_restores_into_tiered_chain(tmp_path):
    tc, _ = _chains(tiered=None)
    tc.push(next(tsrc().batches(BATCH)))
    path = str(tmp_path / "old.npz")
    tck.save_chain(tc, path)
    assert not [k for k in np.load(path).files if k.startswith("tier")]
    t2, _ = _chains()
    tck.load_chain(t2, path)
    for f in ("key", "used", "ver", "wm", "version", "dropped"):
        assert torch.equal(tc.states[0][f], t2.states[0][f]), f
    assert int(t2.states[0]["ocnt"]) == 0 and int(t2.states[0]["spills"]) == 0
    assert t2.ops[0]._tier.store.key_count() == 0


def test_legacy_positional_checkpoint_refused_for_tiered_chain(tmp_path):
    """A file without leaf paths cannot restore into a tiered chain (KeyError,
    as in the JAX package); it still restores into an untiered one."""
    tc, _ = _chains(tiered=None)
    tc.push(next(tsrc().batches(BATCH)))
    arrays = tck._flatten(tc.states)
    path = str(tmp_path / "legacy.npz")
    tck._atomic_write(path, tck._to_npz_bytes(arrays, {tck._META_SHA: tck._digest_map(arrays)}))
    t2, _ = _chains()
    with pytest.raises(KeyError, match="tiered state"):
        tck.load_chain(t2, path)
    t3, _ = _chains(tiered=None)
    tck.load_chain(t3, path)
    for (_, a), (_, b) in zip(flatten_with_paths(tc.states), flatten_with_paths(t3.states)):
        assert torch.equal(a, b)


# ------------------------------------------------------ journal and the bench

def test_journal_spill_and_readmit_records_equal_jax(tmp_path):
    """The ``spill``/``readmit`` records of a tiered run, record for record
    (``t``/``wall`` aside), equal the JAX package's."""
    from windflow_tpu.observability import journal as jj
    recs = {}
    for pkg, (mod, path) in {"port": (wt.observability, tmp_path / "t.jsonl"),
                             "jax": (jj, tmp_path / "j.jsonl")}.items():
        j = mod.EventJournal(str(path))
        mod.set_journal(j) if pkg == "port" else jj.set_active(j)
        try:
            if pkg == "port":
                run_port(tstj(HOT, dict()))
            else:
                run_jax(jstj(HOT, dict()))
        finally:
            mod.set_journal(None) if pkg == "port" else jj.set_active(None)
            j.close()
        with open(path) as f:
            recs[pkg] = [{k: v for k, v in json.loads(line).items() if k not in ("t", "wall")}
                         for line in f if json.loads(line)["event"] in ("spill", "readmit")]
    assert recs["port"] == recs["jax"]
    assert {r["event"] for r in recs["port"]} == {"spill", "readmit"}


def test_bench_tiered_row_equals_bench_py():
    """``benchmarks/tiered.py`` at batch 16 gives ``bench.py``'s
    ``_bench_nexmark_tiered_100x`` fields (all but the times) and no
    overflow drop."""
    import bench
    from windflow_tpu_torch.benchmarks.tiered import bench_nexmark_tiered_100x
    got = bench_nexmark_tiered_100x(16, 4, **CPU)
    want = bench._bench_nexmark_tiered_100x(16, 4)
    times = ("tps", "step_s", "p99_step_s")
    assert {k: v for k, v in got.items() if k not in times} == \
        {k: v for k, v in want.items() if k not in times}
    assert got["overflow_drops"] == 0 and got["cold_keys"] > got["hot_capacity"]

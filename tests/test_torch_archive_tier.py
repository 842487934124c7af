"""The interval join's archive tier in the port (``IntervalJoin(tiered=)``,
``state/tiered.py::ArchiveTier``, ``ops/cold_probe.py::cold_fetch``), on the
CPU, against the JAX package.

Mirrors ``test_interval_join_tiered_recovers_ring_overwrites`` and q4 in
``test_nexmark_query_tiered_on_off_identical`` of the JAX package's
``tests/test_tiered_state.py``: a tiny ring with a cold tier gives the rows of
an untiered ring big enough never to overwrite a live row, and the tiny
untiered ring loses rows. The same seeded stream goes batch by batch through
a tiered IntervalJoin chain of each package: the output batches and the
states (outboxes, ``spills``, ``readmits``) byte for byte after every push,
the store manifests and counters at the end, and checkpoint files with the
IntervalJoin's ``tier*`` arrays resumed across the two packages both ways.
Then the rows through every driver of the port (dispatch K, threaded,
PipeGraph, supervised with a seeded fault plan, graph-supervised), and the
plain version of ``cold_fetch`` against the JAX store's ``fetch_multi``
after appends and compactions (a key's middle rows retired), with the
``readmit_rows`` truncation.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.runtime import checkpoint as jck
from windflow_tpu.state.host_store import HostStore as JHostStore
from windflow_tpu_torch.batch import jax_leaves
from windflow_tpu_torch.nexmark import make_query as tmake
from windflow_tpu_torch.ops.cold_probe import cold_fetch, cold_fetch_plain
from windflow_tpu_torch.runtime import checkpoint as tck
from windflow_tpu_torch.runtime import faults as faults_mod
from windflow_tpu_torch.runtime.checkpoint import flatten_with_paths
from windflow_tpu_torch.runtime.faults import FaultPlan, FaultSpec
from windflow_tpu_torch.state import HostStore

CPU = {"device": "cpu"}
DEADLINE_S = 60.0
#: the JAX test's ring-overwrite workload: opens every 8 events, ts = i // 8,
#: a window of 300 ticks over 64 keys, a ring of one batch
TOTAL, BATCH, WINDOW, KEYS = 4096, 256, 300, 64
SMALL, BIG = 256, 8192


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("WF_STATE_TIERED", raising=False)
    monkeypatch.delenv("WF_STATE_HOT_CAPACITY", raising=False)
    faults_mod.set_active(None)
    yield
    faults_mod.set_active(None)


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

def _emit(l, r):
    return {"lid": l.id, "rid": r.id}


def jsrc(total=TOTAL):
    def gen(i):
        is_open = (i % 8) == 0
        a = jnp.where(is_open, (i // 8) % KEYS, (i * 2477) % KEYS)
        return {"side": jnp.where(is_open, 1, 0).astype(jnp.int32), "a": a.astype(jnp.int32)}

    def key(i):
        return jnp.where((i % 8) == 0, (i // 8) % KEYS, (i * 2477) % KEYS)
    return wf.DeviceSource(gen, total=total, key_fn=key, ts_fn=lambda i: i // 8)


def tsrc(total=TOTAL, name="ring"):
    def gen(i):
        is_open = (i % 8) == 0
        a = torch.where(is_open, (i // 8) % KEYS, (i * 2477) % KEYS)
        return {"side": is_open.to(torch.int32), "a": a.to(torch.int32)}

    def key(i):
        return torch.where((i % 8) == 0, (i // 8) % KEYS, (i * 2477) % KEYS)
    return wt.DeviceSource(gen, total=total, key_fn=key, ts_fn=lambda i: i // 8, name=name,
                           **CPU)


def jop(archive, tiered):
    return wf.IntervalJoin(lambda t: t.side == 1, 0, WINDOW, archive=archive,
                           max_matches=96, tiered=tiered, emit=_emit)


def top(archive, tiered):
    return wt.IntervalJoin(lambda t: t.side == 1, 0, WINDOW, archive=archive,
                           max_matches=96, tiered=tiered, emit=_emit, **CPU)


def pairs_into(rows):
    def cb(v):
        if v is None:
            return
        rows.extend(zip(np.asarray(v["payload"]["lid"]).tolist(),
                        np.asarray(v["payload"]["rid"]).tolist()))
    return cb


def batch_pairs(b):
    m = np.asarray(b.valid)
    return list(zip(np.asarray(b.payload["lid"])[m].tolist(),
                    np.asarray(b.payload["rid"])[m].tolist()))


def run_port(archive, tiered, driver="plain", faults=None):
    rows = []
    op = top(archive, tiered)
    sink = wt.Sink(pairs_into(rows), **CPU)
    src = tsrc()
    if driver in ("plain", "dispatch"):
        wt.Pipeline(src, [op], sink, batch_size=BATCH, dispatch=4 if driver == "dispatch"
                    else None, **CPU).run()
    elif driver == "threaded":
        within_deadline(lambda: wt.ThreadedPipeline(src, [[op]], sink, batch_size=BATCH,
                                                    pin=False, **CPU).run())
    elif driver == "supervised":
        sp = wt.SupervisedPipeline(src, [op], sink, batch_size=BATCH, checkpoint_every=3,
                                   faults=faults, backoff_base=0.0, dispatch=2, **CPU)
        sp.run()
        assert sp.restarts == (1 if faults else 0)
    else:
        g = wt.PipeGraph("ring", batch_size=BATCH, **CPU)
        g.add_source(src).add(op).add_sink(sink)
        if driver == "graph":
            g.run()
        elif driver == "graph_threaded":
            within_deadline(lambda: g.run(threaded=True))
        else:
            g.run_supervised(checkpoint_every=3, faults=faults, backoff_base=0.0)
            assert g.supervised_restarts == (1 if faults else 0)
    return sorted(rows), op


def assert_states_equal(tstate, jstate, what):
    import jax
    g = [(p, np.asarray(leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf))
         for p, leaf in flatten_with_paths(tstate)]
    kl, _ = jax.tree_util.tree_flatten_with_path(jstate)
    w = [(jax.tree_util.keystr(p), np.asarray(leaf)) for p, leaf in kl]
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, p)
        assert a.tobytes() == b.tobytes(), (what, p)


def assert_stores_equal(tchain, jchain, what):
    tm, jm = tchain.tier_manifests(), jchain.tier_manifests()
    assert sorted(tm) == sorted(jm) and tm, what
    for k in jm:
        assert tm[k].dtype == jm[k].dtype and np.array_equal(tm[k], jm[k]), (what, k)
    for tt, jt in zip(tchain.ops[0].tier_controllers(), jchain.ops[0].tier_controllers()):
        assert tt.counters() == jt.counters(), what


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """A tiered chain of each package over the same batches, states compared
    after every push; both checkpointed half way (a save settles the tiers,
    so both save at the same batch) and the files kept. Returns the port's
    rows (each batch's), the two chains and the two files."""
    d = tmp_path_factory.mktemp("archive")
    jb = list(jsrc().batches(BATCH))
    tb = list(tsrc().batches(BATCH))
    jc = wf.CompiledChain([jop(SMALL, dict())], jsrc().payload_spec(), batch_capacity=BATCH)
    tc = wt.CompiledChain([top(SMALL, dict())], tsrc().payload_spec(), batch_capacity=BATCH,
                          **CPU)
    assert_states_equal(tc.states[0], jc.states[0], "init")
    half = len(tb) // 2
    rows = []
    files = {}
    for s, (j, t) in enumerate(zip(jb, tb)):
        if s == half:
            files["jax"] = jck.save_chain(jc, str(d / "jax"), meta={"done": s})
            files["port"] = tck.save_chain(tc, str(d / "port"), meta={"done": s})
            assert_states_equal(tc.states[0], jc.states[0], "saved")
        jo, to = jc.push(j), tc.push(t)
        assert batch_pairs(to) == batch_pairs(jo), s
        assert_states_equal(tc.states[0], jc.states[0], f"state {s}")
        rows.append(batch_pairs(to))
    tc.sync_stats()
    jc.sync_stats()
    assert_states_equal(tc.states[0], jc.states[0], "settled")
    assert_stores_equal(tc, jc, "end")
    return {"rows": rows, "tc": tc, "jc": jc, "jb": jb, "tb": tb, "half": half,
            "files": files}


@pytest.fixture(scope="module")
def reference():
    """Rows of the untiered big ring (nothing overwritten) and of the untiered
    small ring (rows lost), through the port (their parity with the JAX
    package is tests/test_torch_interval_session.py's)."""
    return run_port(BIG, None)[0], run_port(SMALL, None)[0]


# ------------------------------------------------------------ rows and states

def test_interval_join_tiered_recovers_ring_overwrites(lockstep, reference):
    ref, lost = reference
    got = sorted(r for b in lockstep["rows"] for r in b)
    assert got == ref
    assert len(lost) < len(ref)
    op = lockstep["tc"].ops[0]
    counters = op.stage_counters()
    assert counters["state_spills"] > 0 and counters["arch_drops"] == 0
    assert counters["state_spills"] == op._tier_l.store.counters()["state_spills"] \
        + op._tier_r.store.counters()["state_spills"]
    assert counters["state_readmits"] == int(lockstep["jc"].states[0]["readmits"])
    assert counters["tier_cold_keys"] == op._tier_l.store.key_count() \
        + op._tier_r.store.key_count()


@pytest.mark.parametrize("driver", ["plain", "dispatch", "threaded", "graph",
                                    "graph_threaded", "supervised", "graph_supervised"])
def test_drivers_give_the_reference_rows(reference, lockstep, driver):
    got, op = run_port(SMALL, dict(), driver)
    assert got == reference[0], driver
    # the spilled rows and their order do not depend on the driver
    tm = {f"{i}": t.manifest() for i, t in enumerate(op.tier_controllers())}
    jm = {f"{i}": t.manifest() for i, t in enumerate(lockstep["jc"].ops[0].tier_controllers())}
    for i in jm:
        for k in jm[i]:
            assert np.array_equal(tm[i][k], jm[i][k]), (driver, i, k)


@pytest.mark.parametrize("driver", ["supervised", "graph_supervised"])
def test_seeded_fault_plan_gives_the_reference_rows(reference, driver):
    plan = FaultPlan([FaultSpec("chain.step", where={"pos": 9}, max_fires=1)], seed=3)
    got, op = run_port(SMALL, dict(), driver, faults=plan)
    assert got == reference[0]
    assert sum(t.counters()["state_spills"] for t in op.tier_controllers()) > 0


def test_q4_tiered_on_off_identical():
    """q4 in the JAX test's tiered on/off matrix: the same rows (its window
    keeps few rows live), and the JAX package's tiered q4 rows."""
    from windflow_tpu.nexmark import make_query as jmake

    def rows_of(views):
        out = []
        for v in views:
            if v is None:
                continue
            flat = [np.asarray(leaf).tolist() for leaf in jax_leaves(v["payload"])]
            out.extend(zip(np.asarray(v["key"]).tolist(), np.asarray(v["id"]).tolist(),
                           np.asarray(v["ts"]).tolist(), *flat))
        return sorted(out)
    runs = {}
    for tiered in (None, dict(hot_capacity=256)):
        views = []
        src, ops = tmake("q4_interval_join", 400, tiered=tiered, **CPU)
        wt.Pipeline(src, ops, wt.Sink(views.append, **CPU), batch_size=50, **CPU).run()
        runs[tiered is None] = rows_of(views)
    views = []
    src, ops = jmake("q4_interval_join", 400, tiered=dict(hot_capacity=256))
    wf.Pipeline(src, ops, wf.Sink(views.append), batch_size=50).run()
    assert runs[True] == runs[False] == rows_of(views)


# --------------------------------------------------------------- checkpoints

def test_checkpoint_files_carry_the_archive_tier(lockstep):
    import numpy as _np
    for who in ("jax", "port"):
        names = _np.load(lockstep["files"][who]).files
        assert {"tier0_0_key", "tier0_1_key", "tier0_0_col_p0"} <= set(names), who


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_packages(lockstep, direction):
    """A file saved half way by one package, loaded into the other's chain
    (the same chain objects, after the whole run): the second half gives
    the uninterrupted run's rows, batch by batch."""
    half = lockstep["half"]
    if direction == "jax_to_port":
        tc = lockstep["tc"]
        tck.load_chain(tc, lockstep["files"]["jax"])
        got = [batch_pairs(tc.push(b)) for b in lockstep["tb"][half:]]
    else:
        jc = lockstep["jc"]
        jck.load_chain(jc, lockstep["files"]["port"])
        got = [batch_pairs(jc.push(b)) for b in lockstep["jb"][half:]]
    assert got == lockstep["rows"][half:]


# ----------------------------------------------------------- the cold fetch

def _stores(rng, n_rows, keys):
    cols = {"ts": np.int32, "id": np.int32, "p0": np.float32}
    shapes = {"p0": (2,)}
    js = JHostStore("a", cols, shapes, unique=False)
    ts = HostStore("a", cols, shapes, unique=False)
    k = rng.integers(0, keys, n_rows)
    z = np.zeros(n_rows, np.int64)
    rows = {"ts": rng.integers(0, 100, n_rows).astype(np.int32),
            "id": np.arange(n_rows, dtype=np.int32),
            "p0": rng.standard_normal((n_rows, 2)).astype(np.float32)}
    for st in (js, ts):
        st.append(k, z, z, z, rows)
    return js, ts


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("m", [1, 3, 8])
def test_cold_fetch_plain_matches_the_jax_store(m):
    rng = np.random.default_rng(m)
    js, ts = _stores(rng, 600, 40)
    for step in range(3):
        # compaction retires rows anywhere in a chain (ts is not ordered
        # along it), so the chains that stay skip their middle rows
        for st in (js, ts):
            st.compact_below("ts", 10 * (step + 1))
        keys = rng.integers(-5, 45, 257).astype(np.int32)
        want = rng.random(257) < 0.8
        jmask, jmeta, jcols = js.fetch_multi(keys, want, m)
        tmask, tmeta, tcols = ts.fetch_multi(keys, want, m)
        _same(tmask, jmask, "mask")
        _same(tmeta, jmeta, "meta")
        for k in jcols:
            _same(tcols[k], jcols[k], k)
        got = cold_fetch(ts, torch.from_numpy(keys), torch.from_numpy(want), m)
        want_out = (jmask, *(jcols[k] for k in ("ts", "id", "p0")))
        assert len(got) == len(want_out)
        for g, w in zip(got, want_out):
            _same(g.numpy(), w, "cold_fetch")
        assert js.manifest()["counters"].tolist() == ts.manifest()["counters"].tolist()
    # truncation at m: a key with more rows than m gives its oldest m
    full = ts.fetch_multi(keys, want, 64)[0].sum(1)
    assert (full > m).any() or m == 8


def test_cold_fetch_after_restore_and_counts_nothing():
    rng = np.random.default_rng(7)
    js, ts = _stores(rng, 300, 10)
    man = ts.manifest()
    ts2 = HostStore("b", {"ts": np.int32, "id": np.int32, "p0": np.float32},
                    {"p0": (2,)}, unique=False)
    ts2.restore(man)
    keys = torch.arange(-2, 12, dtype=torch.int32)
    want = torch.ones(14, dtype=torch.bool)
    a = cold_fetch_plain(ts, keys, want, 5)
    b = cold_fetch_plain(ts2, keys, want, 5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ts.counters()["state_readmits"] == 0


def test_cold_fetch_cuda_tensor_without_a_mapped_store_raises():
    """No fallback: a CUDA tensor goes to the kernel, which needs the store
    mapped on its card (a CPU-only build cannot make a CUDA tensor: the
    wrapper's checks run first on a meta stand-in)."""
    from windflow_tpu_torch.ops.cold_probe import cold_fetch_cuda
    rng = np.random.default_rng(1)
    _js, ts = _stores(rng, 10, 3)
    with pytest.raises(ValueError, match="mapped"):
        cold_fetch_cuda(ts, torch.zeros(4, dtype=torch.int32),
                        torch.ones(4, dtype=torch.bool), 4)

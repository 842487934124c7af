"""Event-time monitoring in the port against the JAX package, on the CPU.

Mirrors ``tests/test_event_time.py``:

- the device update (``observability/event_time.py::lateness_update``) byte
  for byte against the JAX function on seeded ``ts``/watermark/mask
  triples, ``ts`` past the watermark and the int32 extremes included, and
  the host bucket math (``bucket_of`` and the quantiles) against the JAX
  module's;
- every event-time operator's state after a run with event time on, byte
  for byte under the JAX tree paths (the lateness histograms ``lat_hist``,
  ``lat_l``, ``lat_r`` included), and its ``event_time_stats`` section:
  Key_FFAT on the global-time path (YSB) and per key (TB, jittered),
  StreamTableJoin (q3), IntervalJoin (q4), SessionWindow (q5 with
  stragglers), TopN (q6) and Distinct (q7);
- rows with event time on equal rows with it off on every driver;
- the ``lateness_drop`` records sum to the operator's drop counter;
- checkpoints holding lateness histograms, written by either package,
  restore in the other and resume to the same states.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.nexmark import make_query as jmake
from windflow_tpu.observability import event_time as jet
from windflow_tpu.runtime import checkpoint as jck
from windflow_tpu_torch import convert
from windflow_tpu_torch.nexmark import make_query as tmake
from windflow_tpu_torch.observability import event_time as tet
from windflow_tpu_torch.observability import journal as tjournal
from windflow_tpu_torch.runtime import checkpoint as tck
from windflow_tpu_torch.runtime.checkpoint import flatten_with_paths
from tests.test_torch_archive_tier import assert_states_equal
from tests.test_torch_monitoring import (CPU, ENV, SIZES, drive, monitored,
                                         reset_process_counters, scenario)

I32 = np.iinfo(np.int32)


# ------------------------------------------------------------ the histogram

@pytest.mark.parametrize("seed", range(4))
def test_lateness_update_equals_jax(seed):
    rng = np.random.default_rng(seed)
    C = 300
    wm = int(rng.integers(I32.min, I32.max, dtype=np.int64))
    ts = rng.integers(I32.min, I32.max, C, dtype=np.int64)
    ts[:100] = np.clip(wm - rng.integers(-50, 1 << 20, 100), I32.min, I32.max)
    ts[100:104] = [I32.min, I32.max, wm, wm + 1 if wm < I32.max else wm]
    ts = ts.astype(np.int32)
    mask = rng.random(C) < 0.8
    hist = rng.integers(0, 1000, tet.NB).astype(np.int32)
    want = jet.lateness_update(jnp.asarray(hist), jnp.asarray(wm, jnp.int32),
                               jnp.asarray(ts), jnp.asarray(mask))
    got = tet.lateness_update(torch.from_numpy(hist), wm, torch.from_numpy(ts),
                              torch.from_numpy(mask))
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    # the host mirror agrees lane by lane where wm - ts does not wrap
    near = np.arange(100)[mask[:100]]
    counts = np.zeros(tet.NB, np.int64)
    for i in near:
        counts[tet.bucket_of(wm - int(ts[i]))] += 1
    part = tet.lateness_update(torch.zeros(tet.NB, dtype=torch.int32), wm,
                               torch.from_numpy(ts[:100]), torch.from_numpy(mask[:100]))
    assert part.tolist() == counts.tolist()


def test_host_bucket_math_equals_jax():
    rng = np.random.default_rng(7)
    for v in [-5, 0, 1, 2, 3, 4, 7, 8, 1 << 20, (1 << 31) - 1]:
        assert tet.bucket_of(v) == jet.bucket_of(v)
    for i in range(-1, tet.NB + 1):
        assert tet.bucket_upper(i) == jet.bucket_upper(i)
    for _ in range(20):
        counts = rng.integers(0, 5, tet.NB).tolist()
        for q in (0.01, 0.5, 0.95, 0.99, 1.0):
            assert tet.lateness_quantile(counts, q) == jet.lateness_quantile(counts, q)
            assert tet.recommend_delay(counts, q) == jet.recommend_delay(counts, q)
        assert tet.summarize(counts) == jet.summarize(counts)
    assert tet.summarize([0] * tet.NB) == jet.summarize([0] * jet.NB)


# --------------------------------------------------------- operator states

def per_key_ffat(pkg):
    """A per-key TB Key_FFAT over a jittered stream (the per-key lateness
    update against the largest per-key watermark)."""
    jitter = lambda i: (i * 7) % 9  # noqa: E731
    if pkg == "jax":
        src = wf.Source(lambda i: {"v": (i % 5).astype(jnp.float32)}, total=600,
                        num_keys=3, ts_fn=lambda i: jnp.maximum(0, i - jitter(i)))
        return src, [wf.Key_FFAT(lambda t: t.v, jnp.add,
                                 spec=wf.WindowSpec(20, 10, wf.win_type_t.TB, delay=2),
                                 num_keys=3, global_time=False)]
    src = wt.Source(lambda i: {"v": (i % 5).float()}, total=600, num_keys=3,
                    ts_fn=lambda i: torch.clamp(i - jitter(i), min=0), **CPU)
    return src, [wt.Key_FFAT(lambda t: t.v, torch.add,
                             spec=wt.WindowSpec(20, 10, wt.win_type_t.TB, delay=2),
                             num_keys=3, global_time=False, **CPU)]


def event_time_run(pkg, name, out):
    """One Pipeline run with event-time monitoring on (by the environment,
    as every driver of both packages reads it); returns the chain."""
    batch = 50
    if name in ("ysb", "q3", "q5"):
        src, ops = scenario(pkg, name)
        batch = SIZES[name][1]
    elif name == "ffat_key":
        src, ops = per_key_ffat(pkg)
    else:
        src, ops = (jmake(name, 400) if pkg == "jax" else tmake(name, 400, **CPU))
    m = wf if pkg == "jax" else wt
    kw = {} if pkg == "jax" else CPU
    with env_event_time(out):
        p = m.Pipeline(src, ops, m.Sink(lambda v: None, **kw), batch_size=batch, **kw)
        p.run()
    return p.chain


class env_event_time:
    """Monitoring with event time on by the environment (artifacts under
    ``out``), as every driver of both packages reads it."""

    def __init__(self, out):
        self.out = str(out)

    def __enter__(self):
        self.saved = {k: os.environ.pop(k, None) for k in ENV}
        os.environ.update({"WF_MONITORING": self.out, "WF_MONITORING_EVENT_TIME": "1",
                           "WF_MONITORING_INTERVAL": "60"})
        reset_process_counters()
        return self

    def __exit__(self, *exc):
        for k in ENV:
            os.environ.pop(k, None)
        for k, v in self.saved.items():
            if v is not None:
                os.environ[k] = v
        reset_process_counters()


EVENT_TIME_OPS = ["ysb", "ffat_key", "q3", "q4_interval_join", "q5",
                  "q6_topn", "q7_distinct"]


@pytest.mark.parametrize("name", EVENT_TIME_OPS)
def test_operator_event_time_state_equals_jax(name, tmp_path):
    chains = {pkg: event_time_run(pkg, name, tmp_path / pkg) for pkg in ("jax", "port")}
    tc, jc = chains["port"], chains["jax"]
    assert tc.event_time and jc.event_time
    hists = 0
    for op, top, tst, jst in zip(jc.ops, tc.ops, tc.states, jc.states):
        assert_states_equal(tst, jst, f"{name}:{op.getName()}")
        assert top.event_time_stats(tst) == op.event_time_stats(jst)
        assert top.drop_counters(tst) == op.drop_counters(jst)
        hists += sum(p.split(".")[-1].strip("[]'") in ("lat_hist", "lat_l", "lat_r")
                     for p, _ in flatten_with_paths(tst))
    # TopN ranks scores and Distinct keeps values: no frontier, no histogram
    assert hists == {"q6_topn": 0, "q7_distinct": 0, "q4_interval_join": 2}.get(name, 1)


def test_count_window_carries_no_histogram():
    """A CB window has no event-time frontier: no histogram, no section."""
    src = wt.Source(lambda i: {"v": i.float()}, total=64, num_keys=2, **CPU)
    op = wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(8, 4), num_keys=2, **CPU)
    chain = wt.CompiledChain([op], src.payload_spec(), batch_capacity=16, event_time=True,
                             **CPU)
    assert chain.states[0].lat_hist is None and op.event_time_stats(chain.states[0]) is None


# ------------------------------------------------------------ rows unchanged

@pytest.mark.parametrize("driver", ["plain", "dispatch", "threaded", "graph",
                                    "graph_threaded", "supervised", "graph_supervised"])
@pytest.mark.parametrize("name", ["ysb", "q5"])
def test_event_time_changes_state_never_rows(name, driver, tmp_path):
    """Event time on (and monitoring) changes the carried state only: every
    driver's rows equal the rows with it off, byte for byte, in delivery
    order."""
    with env_event_time(tmp_path):
        on, on_chains = drive("port", name, driver)
    reset_process_counters()
    off, off_chains = drive("port", name, driver)
    assert on == off and on
    assert all(c.event_time for c in on_chains) and not any(c.event_time for c in off_chains)


def test_lateness_drop_records_sum_to_drop_counters(tmp_path):
    """q5 over a stream with stragglers: the ``lateness_drop`` records' ``n``
    sum to the session window's OLD drops, and each carries the trace
    coordinates of the sampled batch it rode."""
    rows, chains = monitored("port", "q5", "plain", str(tmp_path), health=False)
    recs = [r for r in tjournal.read_journal(str(tmp_path / "mon" / "events.jsonl"))
            if r["event"] == "lateness_drop"]
    op, st = chains[0].ops[1], chains[0].states[1]
    assert recs and sum(r["n"] for r in recs) == op.drop_counters(st)["old_drops"] > 0
    assert recs[-1]["total"] == op.get_StatsRecords()[0].tuples_dropped_old
    assert any("tid" in r and r["pos"] >= 0 for r in recs)


# ---------------------------------------------------------------- checkpoints

def checkpoint_chains(kind):
    C = 50
    if kind == "ffat_key":
        js, jops = per_key_ffat("jax")
        ts, tops = per_key_ffat("port")
    else:
        js, jops = jmake(kind, 500)
        ts, tops = tmake(kind, 500, **CPU)
    jc = wf.CompiledChain(jops, js.payload_spec(), batch_capacity=C, event_time=True)
    tc = wt.CompiledChain(tops, ts.payload_spec(), batch_capacity=C, event_time=True,
                          **CPU)
    return jc, tc, list(js.batches(C)), list(ts.batches(C))


def assert_chain_states_equal(tc, jc):
    t, j = tck._flatten(tc.states), jck._flatten(jc.states)
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].tobytes() == j[k].tobytes(), k
    assert tck.leaf_paths(tc.states) == jck._leaf_paths(jc.states)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["ffat_key", "q3_enrich_join", "q4_interval_join",
                                  "q5_session"])
def test_checkpoint_with_lateness_histograms_both_ways(kind, writer, tmp_path):
    jc, tc, jbs, tbs = checkpoint_chains(kind)
    path = str(tmp_path / kind)
    if writer == "jax":
        for b in jbs[:4]:
            jc.push(b)
        jck.save_chain(jc, path, meta={"batches_done": 4})
        assert tck.load_chain(tc, path) == {"batches_done": 4}
    else:
        for b in tbs[:4]:
            tc.push(b)
        tck.save_chain(tc, path, meta={"batches_done": 4})
        assert jck.load_chain(jc, path) == {"batches_done": 4}
    assert_chain_states_equal(tc, jc)
    for jb, tb in zip(jbs[4:], tbs[4:]):
        jo, to = jc.push(jb), tc.push(tb)
        assert np.asarray(jo.valid).tobytes() == to.valid.numpy().tobytes()
    assert_chain_states_equal(tc, jc)


def test_convert_carries_lateness_histograms():
    """``convert`` moves a Win_SeqFFAT state with its histogram both ways
    and a join's dict with its own."""
    jc, tc, jbs, _ = checkpoint_chains("ffat_key")
    for b in jbs[:4]:
        jc.push(b)
    jst = jax.tree.map(np.asarray, jc.states[0])
    st = convert.state_from_numpy(tc.ops[0], jst)
    assert st.lat_hist.tolist() == np.asarray(jst.lat_hist).tolist()
    back = convert.state_to_numpy(tc.ops[0], st)
    assert back["lat_hist"].tobytes() == np.asarray(jst.lat_hist).tobytes()

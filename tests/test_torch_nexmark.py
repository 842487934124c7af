"""The port's Nexmark queries against the JAX package's, on the CPU.

The same query runs through ``windflow_tpu`` and through ``windflow_tpu_torch``
(``device="cpu"``, so every kernel runs as its plain PyTorch version). The
sink views must be identical field by field, bytes and dtypes, in emission
order, and equal to the dense oracles (rows built as in
``tests/test_nexmark.py``). Also: q3 at a larger key space, the sources past
the int32 wrap of ``i * 2477`` and ``i * 7919``, the name registries, and
``tests/test_nexmark.py``'s supervised and graph-supervised drivers for q3,
q4 and q5: byte-identical to the plain Pipeline, without faults and under a
FaultPlan.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.nexmark import generators as jgen
from windflow_tpu.nexmark import make_query as jmake
from windflow_tpu_torch.nexmark import PORTED, generators as tgen, oracles
from windflow_tpu_torch.nexmark import make_query as tmake

TOTAL = 400


def _capture(views):
    def cb(view):
        if view is not None:
            views.append(view)
    return cb


def run_jax(name, batch, **kw):
    src, ops = jmake(name, TOTAL, **kw)
    views = []
    wf.Pipeline(src, ops, wf.Sink(_capture(views)), batch_size=batch).run()
    return views


def run_port(name, batch, driver="plain", **kw):
    src, ops = tmake(name, TOTAL, device="cpu")
    views = []
    sink = wt.Sink(_capture(views), device="cpu")
    if driver == "plain":
        wt.Pipeline(src, ops, sink, batch_size=batch, device="cpu").run()
    elif driver == "supervised":
        wt.SupervisedPipeline(src, ops, sink, batch_size=batch, backoff_base=0.001,
                              backoff_cap=0.01, device="cpu", **kw).run()
    else:                                   # graph-supervised
        g = wt.PipeGraph(batch_size=batch, device="cpu")
        mp = g.add_source(src)
        for op in ops:
            mp.add(op)
        mp.add_sink(sink)
        g.run_supervised(checkpoint_every=2, backoff_base=0.001, backoff_cap=0.01, **kw)
    return views


def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}.{k}", v, out)
    else:
        out[prefix] = np.asarray(tree)


def _fields(view):
    out = {f: np.asarray(view[f]) for f in ("key", "id", "ts")}
    _flat("payload", view["payload"], out)
    return out


def assert_views_identical(got, want):
    """Same number of views, and in each the same fields with the same bytes
    and dtypes."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        gf, wf_ = _fields(g), _fields(w)
        assert sorted(gf) == sorted(wf_), i
        for f in wf_:
            assert gf[f].dtype == wf_[f].dtype, (i, f, gf[f].dtype, wf_[f].dtype)
            assert gf[f].tobytes() == wf_[f].tobytes(), (i, f)


ROW_FNS = {
    "q1_currency": ("id", "payload.auction", "payload.euro"),
    "q2_selection": ("id", "payload.auction", "payload.price"),
    "q3_enrich_join": ("id", "payload.auction", "payload.category", "payload.price"),
    "q4_interval_join": ("payload.auction", "payload.open_ts", "payload.bid_ts",
                         "payload.price"),
    "q5_session": ("key", "id", "payload.start", "payload.end", "payload.n",
                   "payload.agg.bids", "payload.agg.spend"),
    "q7_distinct": ("id", "payload.auction"),
}


def rows(name, views):
    """The oracle's rows: sorted tuples, or q6's final leaderboard."""
    if name == "q6_topn":
        final = {}
        for v in views:
            f = _fields(v)
            for k, r, i, s in zip(f["key"].tolist(), f["payload.rank"].tolist(),
                                  f["id"].tolist(), f["payload.score"].tolist()):
                final[(k, r)] = (i, s)
        return sorted((k, r, i, s) for (k, r), (i, s) in final.items())
    out = []
    for v in views:
        f = _fields(v)
        out.extend(zip(*(f[c].tolist() for c in ROW_FNS[name])))
    return sorted(out)


@pytest.mark.parametrize("batch", [32, 64, 100, 400])
@pytest.mark.parametrize("name", PORTED)
def test_query_matches_jax_and_dense_oracle(name, batch):
    got = run_port(name, batch)
    assert_views_identical(got, run_jax(name, batch))
    assert rows(name, got) == oracles.ORACLES[name](TOTAL)


@pytest.mark.parametrize("batch", [32, 64, 400])
def test_q3_larger_key_space_matches_jax(batch):
    """q3 with 50 auctions (more than the 16 bid auctions of the default)."""
    src, ops = tmake("q3_enrich_join", TOTAL, device="cpu", n_auctions=50)
    got = []
    wt.Pipeline(src, ops, wt.Sink(_capture(got), device="cpu"), batch_size=batch,
                device="cpu").run()
    assert_views_identical(got, run_jax("q3_enrich_join", batch, n_auctions=50))
    want = sorted((i, (i * 2477) % 50, ((i * 2477) % 50 * 13) % 7,
                   (i * 7919) % 9973 + 100) for i in range(50, TOTAL))
    assert rows("q3_enrich_join", got) == want


@pytest.mark.parametrize("source", ["bid", "enrich", "open_bid"])
def test_sources_match_jax_past_int32_wrap(source):
    start, C = 1_000_000, 2048           # i * 2477 and i * 7919 have wrapped
    make = {"bid": "make_bid_source", "enrich": "make_enrich_source",
            "open_bid": "make_open_bid_source"}[source]
    jb = getattr(jgen, make)(2_000_000).make_batch(jnp.asarray(start, jnp.int32), C)
    tb = getattr(tgen, make)(2_000_000, device="cpu").make_batch(start, C)
    for f in ("key", "id", "ts", "valid"):
        assert getattr(tb, f).numpy().tobytes() == np.asarray(getattr(jb, f)).tobytes()
    assert sorted(tb.payload) == sorted(jb.payload)
    for k, v in jb.payload.items():
        assert tb.payload[k].numpy().dtype == np.asarray(v).dtype
        assert tb.payload[k].numpy().tobytes() == np.asarray(v).tobytes(), k


def test_name_registries_match_jax():
    from windflow_tpu.nexmark import QUERIES
    from windflow_tpu.observability.names import STAGE_COUNTERS
    from windflow_tpu_torch.nexmark import QUERIES as TQUERIES
    from windflow_tpu_torch.observability import names
    assert TQUERIES == QUERIES
    assert names.STAGE_COUNTERS == STAGE_COUNTERS
    assert set(oracles.ORACLES) == set(QUERIES)


# ------------------------------------------------ the supervised drivers

@pytest.mark.parametrize("name", ["q3_enrich_join", "q4_interval_join", "q5_session"])
def test_supervised_drivers_byte_identical(name):
    base = run_port(name, 50)
    assert_views_identical(run_port(name, 50, "supervised"), base)
    assert_views_identical(run_port(name, 50, "graph-supervised"), base)
    assert rows(name, base) == oracles.ORACLES[name](TOTAL)


@pytest.mark.parametrize("name", ["q3_enrich_join", "q4_interval_join", "q5_session"])
def test_supervised_drivers_byte_identical_under_faultplan(name):
    from windflow_tpu_torch.runtime.faults import FaultPlan, FaultSpec
    base = run_port(name, 50)
    plan = FaultPlan([FaultSpec("chain.step", at=[3, 5])], seed=3)
    assert_views_identical(run_port(name, 50, "supervised", checkpoint_every=2,
                                    faults=plan), base)
    assert_views_identical(run_port(name, 50, "graph-supervised", faults=plan), base)

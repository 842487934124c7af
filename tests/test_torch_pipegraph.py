"""PipeGraph/MultiPipe in the port against the JAX package on the CPU.

Every graph of ``tests/test_pipegraph.py``, ``tests/test_merge_split_legality.py``,
``tests/test_graph_shapes_ref.py``, ``tests/test_deterministic_mode.py`` and the
serial-driver graphs of ``tests/test_ordering_renumbering.py`` is written once
against a namespace (``JAX`` or ``PORT``) and built in both packages; the
ReduceSink results and the sorted Sink tuples must be equal (integer values,
or float sums of integers, so every sum is exact in any order), and each graph
also keeps its test's own oracle. DETERMINISTIC merges run at several batch
sizes. The legality cases must raise the same exception type with the same
leading words in both packages, and ``dump_DOTGraph`` must give the same text.
The JAX graphs that use FlatMap or Key_FFAT's CB path (not ported, ROADMAP
Queue 1 item 9) keep them; the port's copy of such a graph uses the Map with
the same output (fan-out 1), the ReduceSink with the same count (fan-out 2),
or Key_Farm with the same CB sums, as noted at each.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import Mode as JMode, win_type_t as jwt
from windflow_tpu.operators.window import WindowSpec as JSpec
from windflow_tpu.runtime import builders as jb
from windflow_tpu.runtime.pipegraph import PipeGraph as JPipeGraph
from windflow_tpu_torch.runtime import builders as tb

JAX = types.SimpleNamespace(
    name="jax", wf=wf, kw={}, B=jb, Mode=JMode, Spec=JSpec, CB=jwt.CB, TB=jwt.TB,
    i32=lambda a: a.astype(jnp.int32), f32=lambda a: a.astype(jnp.float32),
    stack=jnp.stack, where=jnp.where, one=lambda: jnp.ones((), jnp.int32), add=jnp.add,
    graph=lambda *a, **k: JPipeGraph(*a, **k), dev=lambda b: b,
    flatmap1=lambda f: wf.FlatMap(lambda t, sh: sh.push(f(t)), max_fanout=1),
    cb4_sum=lambda: wf.Key_FFAT(lambda t: t.v, jnp.add, spec=JSpec(4, 4, jwt.CB),
                                num_keys=2),
    flatmap2_count=lambda: [wf.FlatMap(lambda t, ship: (ship.push({"v": t.v}),
                                                        ship.push({"v": -t.v}))[0],
                                       max_fanout=2),
                            wf.ReduceSink(lambda t: jnp.ones((), jnp.int32),
                                          name="l1_count")])
PORT = types.SimpleNamespace(
    name="port", wf=wt, kw={"device": "cpu"}, B=tb, Mode=wt.Mode, Spec=wt.WindowSpec,
    CB=wt.win_type_t.CB, TB=wt.win_type_t.TB, i32=lambda a: a.to(torch.int32),
    f32=lambda a: a.to(torch.float32), stack=torch.stack, where=torch.where,
    one=lambda: torch.ones((), dtype=torch.int32), add=torch.add,
    graph=lambda *a, **k: wt.PipeGraph(*a, device="cpu", **k),
    dev=lambda b: b.withDevice("cpu"),
    # Key_FFAT's per-key CB path is not ported (ROADMAP Queue 1 item 9): the
    # same CB(4, 4) sums through Key_Farm on the Win_Seq engine
    cb4_sum=lambda: wt.Key_Farm(lambda wid, it: it.sum("v"),
                                wt.WindowSpec(4, 4, wt.win_type_t.CB), num_keys=2,
                                device="cpu"),
    # FlatMap with fan-out 1 is the Map of its one push
    flatmap1=lambda f: wt.Map(f, device="cpu"),
    # FlatMap pushing two tuples a tuple, counted: a count of 2 a tuple
    flatmap2_count=lambda: [wt.ReduceSink(lambda t: torch.full((), 2, dtype=torch.int32),
                                          name="l1_count", device="cpu")])


def both(fn, *args):
    """``fn(X, *args)`` in both packages; returns the JAX result after
    asserting the port's equals it."""
    want, got = _norm(fn(JAX, *args)), _norm(fn(PORT, *args))
    assert got == want
    return want


def _norm(r):
    if isinstance(r, dict):
        return {k: _norm(v) for k, v in r.items()}
    if isinstance(r, (list, tuple)):
        return type(r)(_norm(v) for v in r)
    if hasattr(r, "shape"):
        return np.asarray(r).tolist()
    return r


def Src(X, fn, total, **kw):
    return X.wf.Source(fn, total=total, **kw, **X.kw)


def RS(X, fn, name):
    return X.wf.ReduceSink(fn, name=name, **X.kw)


def Mp(X, fn, **kw):
    return X.wf.Map(fn, **kw, **X.kw)


def Fl(X, fn, **kw):
    return X.wf.Filter(fn, **kw, **X.kw)


def tuples_sink(X, out):
    def cb(view):
        if view is not None:
            out.extend(zip(view["key"].tolist(), view["id"].tolist(),
                           np.asarray(view["payload"]).tolist()))
    return X.wf.Sink(cb, **X.kw)


def values_sink(X, out):
    def cb(view):
        if view is not None:
            p = view["payload"]
            out.extend(np.asarray(p["v"] if isinstance(p, dict) else p).tolist())
    return X.wf.Sink(cb, **X.kw)


# ---- tests/test_pipegraph.py ----------------------------------------------------

def g_linear_builders(X):
    src = X.dev(X.B.Source_Builder(lambda i: {"v": X.i32(i)}).withName("src")
                .withTotal(500).withKeys(4)).build()
    m = X.dev(X.B.Map_Builder(lambda t: {"v": t.v * 3}).withName("triple")).build()
    f = X.dev(X.B.Filter_Builder(lambda t: t.v % 2 == 0).withName("evens")).build()
    rs = X.dev(X.B.ReduceSink_Builder(lambda t: t.v).withName("total")).build()
    g = X.graph("linear", batch_size=128)
    g.add_source(src).chain(m).chain(f).add(rs)
    return g.run()


def g_split_two(X):
    g = X.graph("split", batch_size=64)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 400))
    mp.split(lambda t: X.i32(t.v % 2), 2)
    mp.select(0).add(RS(X, lambda t: t.v, "evens"))
    mp.select(1).add(RS(X, lambda t: t.v, "odds"))
    return g.run()


def g_multicast(X):
    g = X.graph("mcast", batch_size=32)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 100))
    mp.split(lambda t: X.stack([t.v % 2 == 0, t.v % 3 == 0]), 2)
    mp.select(0).add(RS(X, lambda t: X.one(), "n2"))
    mp.select(1).add(RS(X, lambda t: X.one(), "n3"))
    return g.run()


def g_merge_ind(X):
    g = X.graph("merge", batch_size=50)
    mp1 = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 100, name="s1"))
    mp2 = g.add_source(Src(X, lambda i: {"v": X.i32(i + 1000)}, 100, name="s2"))
    mp1.merge(mp2).add(RS(X, lambda t: t.v, "sum"))
    return g.run()


def g_diamond(X):
    g = X.graph("diamond", batch_size=64)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 200))
    mp.split(lambda t: X.i32(t.v % 2), 2)
    b0 = mp.select(0).add(Mp(X, lambda t: {"v": t.v * 10}, name="m0"))
    b1 = mp.select(1).add(Mp(X, lambda t: {"v": t.v * 100}, name="m1"))
    b0.merge(b1).add(RS(X, lambda t: t.v, "sum"))
    return g.run()


def g_window_flush(X):
    total, K = 120, 2
    g = X.graph("win", batch_size=40)
    src = Src(X, lambda i: {"v": X.f32(i // K)}, total, num_keys=K)
    kf = X.dev(X.B.KeyFarm_Builder(lambda wid, it: it.sum("v")).withCBWindows(10, 10)
               .withKeys(K).withName("kf")).build()
    got = []
    g.add_source(src).add(kf).add_sink(tuples_sink(X, got))
    g.run()
    return sorted(got)


def g_dot(X):
    g = X.graph("dotg", batch_size=32)
    mp = g.add_source(Src(X, lambda i: {"v": i * 1.0}, 64, name="gen"))
    mp.add(Mp(X, lambda t: {"v": t.v}, name="id"))
    mp.add_sink(X.wf.Sink(lambda v: None, name="sk", **X.kw))
    return g.dump_DOTGraph(), len(g.listOperators()), g.getNumThreads()


def g_merge_then_split(X):
    g = X.graph("g1", batch_size=64)
    s1 = Src(X, lambda i: {"v": X.i32(i)}, 120, name="s1")
    s2 = Src(X, lambda i: {"v": X.i32(i + 1000)}, 120, name="s2")
    merged = g.add_source(s1).merge(g.add_source(s2))
    merged.add(Fl(X, lambda t: t.v % 2 == 0))
    merged.split(lambda t: X.i32(t.v >= 1000), 2)
    merged.select(0).add(RS(X, lambda t: t.v, "low"))
    merged.select(1).add(RS(X, lambda t: t.v, "high"))
    return g.run()


def g_nested_split(X):
    g = X.graph("g4", batch_size=64)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 300))
    mp.split(lambda t: X.i32(t.v % 3 == 0), 2)
    b_rest, b_mul3 = mp.select(0), mp.select(1)
    b_rest.split(lambda t: X.i32(t.v % 3 - 1), 2)
    b_rest.select(0).add(RS(X, lambda t: t.v, "r1"))
    b_rest.select(1).add(RS(X, lambda t: t.v, "r2"))
    b_mul3.add(RS(X, lambda t: t.v, "r0"))
    return g.run()


def g_branch_with_independent_rejected(X):
    g = X.graph("g3", batch_size=64)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 200, name="sa"))
    mp.split(lambda t: X.i32(t.v % 2), 2)
    b0, b1 = mp.select(0), mp.select(1)
    ind = g.add_source(Src(X, lambda i: {"v": X.i32(i + 5000)}, 50, name="sb"))
    with pytest.raises(RuntimeError, match="not supported"):
        b1.merge(ind)
    b0.merge(b1, ind).add(RS(X, lambda t: t.v, "m"))
    return g.run()


def g_disjoint(X):
    g = X.graph("g5", batch_size=32)
    g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 80, name="sA")).add(
        Mp(X, lambda t: {"v": t.v * 2})).add(RS(X, lambda t: t.v, "a"))
    g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 60, name="sB")).add(
        Fl(X, lambda t: t.v < 30)).add(RS(X, lambda t: t.v, "b"))
    return g.run()


def g_merge_three(X):
    g = X.graph("g6", batch_size=64)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 90, name="sa"))
    mp.split(lambda t: X.i32(t.v % 2), 2)
    ind = g.add_source(Src(X, lambda i: {"v": X.i32(i + 700)}, 10, name="sb"))
    mp.select(0).merge(mp.select(1), ind).add(RS(X, lambda t: t.v, "all"))
    return g.run()


def g_closing(X):
    calls = []
    m = X.dev(X.B.Map_Builder(lambda t: {"v": t.v * 2}).withName("m").withParallelism(3)
              .withClosingFunction(lambda ctx: calls.append(
                  (ctx.getReplicaIndex(), ctx.getParallelism())))).build()
    src = X.dev(X.B.Source_Builder(lambda i: {"v": X.i32(i)}).withName("s")
                .withTotal(64)).build()
    g = X.graph("closing", batch_size=32)
    g.add_source(src).chain(m).add(
        X.dev(X.B.ReduceSink_Builder(lambda t: t.v).withName("out")).build())
    res = g.run()
    return res, sorted(calls)


def g_recombined(X):
    g = X.graph("g2", batch_size=64)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 200))
    mp.chain(Mp(X, lambda t: {"v": t.v + 1}))
    mp.split(lambda t: X.i32(t.v % 2), 2)
    b0 = (mp.select(0).chain(Fl(X, lambda t: t.v % 3 != 0))
          .chain(Mp(X, lambda t: {"v": t.v * 10})))
    b1 = mp.select(1).chain(Fl(X, lambda t: t.v % 5 != 0))
    merged = b0.merge(b1)
    merged.chain(Mp(X, lambda t: {"v": t.v + 7}))
    merged.add(RS(X, lambda t: t.v, "out"))
    return g.run()


def g8(X):
    g = X.graph("g8", batch_size=48)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 240))
    mp.chain(Mp(X, lambda t: {"v": t.v + 1}))
    mp.split(lambda t: X.stack([t.v % 2 == 1, t.v % 2 == 0,
                                (t.v % 2 == 0) & (t.v % 3 != 0)]), 3)
    b0 = mp.select(0).chain(Fl(X, lambda t: t.v % 5 != 0)).chain(
        Mp(X, lambda t: {"v": t.v * 10}))
    b1 = mp.select(1).chain(Fl(X, lambda t: t.v % 7 != 0)).chain(
        Mp(X, lambda t: {"v": t.v * 100}))
    b2 = mp.select(2).chain(Fl(X, lambda t: t.v > 20)).chain(
        Mp(X, lambda t: {"v": t.v + 3}))
    m01 = b1.merge(b0)
    m01.chain(Mp(X, lambda t: {"v": t.v + 1}))
    m01.chain(Mp(X, lambda t: {"v": t.v + 2}))
    m01.merge(b2).add(RS(X, lambda t: t.v, "out"))
    return g.run(), g.dump_DOTGraph()


def g9(X):
    g = X.graph("g9", batch_size=60)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 300))
    mp.chain(Mp(X, lambda t: {"v": t.v + 1}))
    mp.split(lambda t: X.i32(X.where(t.v % 2 == 1, 0, X.where(t.v % 3 == 0, 1, 2))), 3)
    b0 = mp.select(0).chain(Fl(X, lambda t: t.v % 5 != 0)).chain(
        Mp(X, lambda t: {"v": t.v * 10}))
    b1 = mp.select(1).chain(Fl(X, lambda t: t.v > 6)).chain(
        Mp(X, lambda t: {"v": t.v + 100}))
    b2 = mp.select(2).chain(Fl(X, lambda t: t.v < 50))
    b2.add(RS(X, lambda t: t.v, "solo"))
    b1.split(lambda t: X.i32(t.v % 4 >= 2), 2)
    leaf0 = b1.select(0).chain(Mp(X, lambda t: {"v": t.v * 2}))
    leaf1 = b1.select(1).chain(Mp(X, lambda t: {"v": t.v * 3}))
    final = b0.merge(leaf0, leaf1)
    final.chain(Mp(X, lambda t: {"v": t.v + 1}))
    final.add(RS(X, lambda t: t.v, "out"))
    return g.run(), g.dump_DOTGraph()


def _sum(xs):
    return sum(xs)


PIPEGRAPH_ORACLES = {
    g_linear_builders: lambda r: r["total"] == sum(i * 3 for i in range(500)
                                                   if (i * 3) % 2 == 0),
    g_split_two: lambda r: (r["evens"], r["odds"]) == (
        sum(range(0, 400, 2)), sum(range(1, 400, 2))),
    g_multicast: lambda r: (r["n2"], r["n3"]) == (50, 34),
    g_merge_ind: lambda r: r["sum"] == sum(range(100)) + sum(range(1000, 1100)),
    g_diamond: lambda r: r["sum"] == sum(i * 10 for i in range(0, 200, 2))
    + sum(i * 100 for i in range(1, 200, 2)),
    g_window_flush: lambda r: r == sorted(
        (k, w, float(sum([i // 2 for i in range(120) if i % 2 == k][w * 10:w * 10 + 10])))
        for k in range(2) for w in range(6)),
    g_dot: lambda r: "digraph PipeGraph" in r[0] and "gen" in r[0] and r[1:] == (3, 3),
    g_merge_then_split: lambda r: (r["low"], r["high"]) == (
        sum(range(0, 120, 2)), sum(range(1000, 1120, 2))),
    g_nested_split: lambda r: (r["r0"], r["r1"], r["r2"]) == tuple(
        sum(i for i in range(300) if i % 3 == m) for m in range(3)),
    g_branch_with_independent_rejected: lambda r: r["m"] == sum(range(200))
    + sum(range(5000, 5050)),
    g_disjoint: lambda r: (r["a"], r["b"]) == (sum(2 * i for i in range(80)), sum(range(30))),
    g_merge_three: lambda r: r["all"] == sum(range(90)) + sum(range(700, 710)),
    g_closing: lambda r: r[1] == [(0, 3), (1, 3), (2, 3)] and r[0]["out"] == 4032,
    g_recombined: lambda r: r["out"] == sum(
        v + 7 for v in [v * 10 for v in range(1, 201) if v % 2 == 0 and v % 3 != 0]
        + [v for v in range(1, 201) if v % 2 == 1 and v % 5 != 0]),
    g8: lambda r: r[0]["out"] == sum(v + 3 for v in [v * 10 for v in range(1, 241)
                                                     if v % 2 == 1 and v % 5 != 0]
                                     + [v * 100 for v in range(1, 241)
                                        if v % 2 == 0 and v % 7 != 0])
    + sum(v + 3 for v in range(1, 241) if v % 2 == 0 and v % 3 != 0 and v > 20),
    g9: lambda r: r[0]["solo"] == sum(v for v in range(1, 301)
                                      if v % 2 == 0 and v % 3 != 0 and v < 50),
}


@pytest.mark.parametrize("graph", list(PIPEGRAPH_ORACLES), ids=lambda f: f.__name__)
def test_pipegraph_graphs_match_jax(graph):
    """The 16 graphs of tests/test_pipegraph.py: same results in both
    packages, and the test's oracle."""
    res = both(graph)
    assert PIPEGRAPH_ORACLES[graph](res), res


# ---- tests/test_merge_split_legality.py ---------------------------------------

def lsrc(X, total=90, mod=7, name="s"):
    return Src(X, lambda i: {"v": X.f32(i % mod)}, total, num_keys=2, name=name)


def l_self(X):
    g = X.graph()
    a = g.add_source(lsrc(X))
    a.merge(a)


def l_foreign(X):
    a = X.graph().add_source(lsrc(X))
    b = X.graph().add_source(lsrc(X))
    a.merge(b)


def l_already(X):
    g = X.graph()
    a, b, c = (g.add_source(lsrc(X, name=n)) for n in "abc")
    a.merge(b)
    a.merge(c)


def l_split(X):
    g = X.graph()
    a = g.add_source(lsrc(X)).split(lambda t: t.v % 2 == 0, 2)
    a.merge(g.add_source(lsrc(X, name="b")))


def l_sunk(X):
    g = X.graph()
    a = g.add_source(lsrc(X)).add_sink(values_sink(X, []))
    g.add_source(lsrc(X, name="b")).merge(a)


def l_noncontiguous(X):
    g = X.graph()
    s = g.add_source(lsrc(X)).split(lambda t: X.i32(t.v) % 3, 3)
    s.select(0).merge(s.select(2))


def l_mixed(X):
    g = X.graph()
    s = g.add_source(lsrc(X)).split(lambda t: X.i32(t.v) % 2, 2)
    s.select(0).merge(g.add_source(lsrc(X, name="b")))


def l_different_parents(X):
    g = X.graph()
    s1 = g.add_source(lsrc(X, name="s1")).split(lambda t: X.i32(t.v) % 2, 2)
    s2 = g.add_source(lsrc(X, name="s2")).split(lambda t: X.i32(t.v) % 2, 2)
    s1.select(0).merge(s2.select(0))


def l_contiguous_legal(X):
    g = X.graph()
    s = g.add_source(lsrc(X)).split(lambda t: X.i32(t.v) % 3, 3)
    m = s.select(0).merge(s.select(1))
    return m._covers_idx, m._merge_parent is s


def l_subtree_legal(X):
    g = X.graph()
    s = g.add_source(lsrc(X)).split(lambda t: X.i32(t.v) % 3, 3)
    m = s.select(0).merge(s.select(1), s.select(2))
    return m._covers_idx, m._merge_parent is None


def _outcome(fn, X):
    try:
        return "ok", _norm(fn(X))
    except Exception as e:              # noqa: BLE001 — the outcome is compared
        return type(e).__name__, " ".join(str(e).split()[:6])


@pytest.mark.parametrize("case,words", [
    (l_self, "merged with itself"), (l_foreign, "does not belong"),
    (l_already, "already been merged"), (l_split, "split MultiPipe cannot be merged"),
    (l_sunk, "sink"), (l_noncontiguous, "contiguous"), (l_mixed, "not supported"),
    (l_different_parents, "different split parents"), (l_contiguous_legal, None),
    (l_subtree_legal, None)], ids=lambda c: getattr(c, "__name__", str(c)))
def test_merge_legality_matches_jax(case, words):
    """Same exception type and leading words (or the same legal merge) in
    both packages, and the JAX test's expected message."""
    want, got = _outcome(case, JAX), _outcome(case, PORT)
    assert got == want
    if words is None:
        assert want[0] == "ok"
    else:
        assert want[0] == "RuntimeError"
        with pytest.raises(RuntimeError, match=words):
            case(PORT)


def vals(total=90, mod=7):
    return [float(i % mod) for i in range(total)]


def s_merge_three_roots(X, batch_size):
    g = X.graph(batch_size=batch_size)
    a = g.add_source(lsrc(X, name="a")).add(Mp(X, lambda t: {"v": t.v + 1}))
    b = g.add_source(lsrc(X, mod=5, name="b")).add(Mp(X, lambda t: {"v": t.v + 2}))
    c = (g.add_source(lsrc(X, mod=3, name="c")).add(Fl(X, lambda t: t.v > 0))
         .add(Mp(X, lambda t: {"v": t.v * 2})))
    out = []
    a.merge(b, c).add(Mp(X, lambda t: {"v": t.v * 10})).add_sink(values_sink(X, out))
    g.run()
    return sorted(out)


def s_merge_of_merged(X, batch_size):
    g = X.graph(batch_size=batch_size)
    a = g.add_source(lsrc(X, name="a"))
    b = g.add_source(lsrc(X, mod=5, name="b"))
    m1 = a.merge(b).add(Fl(X, lambda t: t.v % 2 == 0))
    c = g.add_source(lsrc(X, mod=3, name="c"))
    out = []
    m1.merge(c).add(Mp(X, lambda t: {"v": t.v + 100})).add_sink(values_sink(X, out))
    g.run()
    return sorted(out)


def s_partial_merge(X, batch_size):
    g = X.graph(batch_size=batch_size)
    s = g.add_source(lsrc(X)).split(lambda t: X.i32(t.v) % 3, 3)
    rejoined, solo = [], []
    (s.select(0).merge(s.select(1)).add(Mp(X, lambda t: {"v": t.v * 10}))
     .add_sink(values_sink(X, rejoined)))
    s.select(2).add_sink(values_sink(X, solo))
    g.run()
    return sorted(rejoined), sorted(solo)


def s_nested_window_leaf(X, batch_size):
    g = X.graph(batch_size=batch_size)
    s0 = g.add_source(lsrc(X, total=120)).split(lambda t: t.v % 2 == 0, 2)
    inner = (s0.select(1).add(Mp(X, lambda t: {"v": t.v + 1}))
             .split(lambda t: X.i32(t.v) // 2 % 2, 2))
    win_out, plain_out, fm_out = [], [], []
    inner.select(1).add(X.cb4_sum()).add_sink(values_sink(X, win_out))
    inner.select(0).add_sink(values_sink(X, plain_out))
    s0.select(0).add(X.flatmap1(lambda t: {"v": t.v * 2})).add_sink(values_sink(X, fm_out))
    g.run()
    return sorted(win_out), sorted(plain_out), sorted(fm_out)


def s_partial_chain(X, batch_size):
    g = X.graph(batch_size=batch_size)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 200))
    mp.split(lambda t: X.i32(t.v % 4), 4)
    b = [mp.select(i).chain(Mp(X, (lambda m: lambda t: {"v": t.v * m})(10 ** i)))
         for i in range(4)]
    m012 = b[0].merge(b[1]).merge(b[2])
    node = g._node_of(mp)
    assert [c.mp for c in node.children] == [m012, b[3]]
    m012.add(RS(X, lambda t: t.v, "m"))
    b[3].add(RS(X, lambda t: t.v, "r3"))
    return g.run()


@pytest.mark.parametrize("shape,batch_size", [
    (s_merge_three_roots, 32), (s_merge_three_roots, 77), (s_merge_of_merged, 32),
    (s_partial_merge, 32), (s_partial_merge, 45), (s_nested_window_leaf, 32),
    (s_nested_window_leaf, 64), (s_partial_chain, 32)],
    ids=lambda c: getattr(c, "__name__", str(c)))
def test_reference_dag_shapes_match_jax(shape, batch_size):
    """The merge_test/split_test shapes of tests/test_merge_split_legality.py
    (serial driver), with their dense oracles."""
    res = both(shape, batch_size)
    if shape is s_merge_three_roots:
        assert res == sorted([10 * (v + 1) for v in vals()] + [10 * (v + 2) for v in vals(mod=5)]
                             + [10 * (v * 2) for v in vals(mod=3) if v > 0])
    elif shape is s_partial_merge:
        assert res == (sorted(v * 10 for v in vals() if int(v) % 3 in (0, 1)),
                       sorted(v for v in vals() if int(v) % 3 == 2))
    elif shape is s_partial_chain:
        assert res == {"m": sum(v * 10 ** (v % 4) for v in range(200) if v % 4 < 3),
                       "r3": sum(v * 1000 for v in range(200) if v % 4 == 3)}
    elif shape is s_nested_window_leaf:
        assert res[0] and res[2] == sorted(v * 2 for v in vals(120) if v % 2 == 1)


# ---- tests/test_graph_shapes_ref.py ---------------------------------------------

def r_split5(X, batch_size):
    TOTAL, K = 360, 3
    g = X.graph("split5", batch_size=batch_size)
    mp = g.add_source(Src(X, lambda i: {"v": X.f32(i % 11)}, TOTAL, num_keys=K))
    mp.split(lambda t: X.i32(t.v % 2), 2)
    mp.select(0).chain(Mp(X, lambda t: {"v": t.v * 2.0})).add(
        RS(X, lambda t: t.v, "branch_map"))
    nested = X.wf.Key_Farm(X.wf.Pane_Farm(lambda pid, it: it.sum("v"),
                                          lambda wid, it: it.sum(),
                                          X.Spec(12, 4, X.CB), num_keys=K, **X.kw),
                           parallelism=2)
    win_out = []
    mp.select(1).add(nested).add_sink(tuples_sink(X, win_out))
    res = g.run()
    return res, sorted(win_out)


def r_merge4(X, batch_size):
    g = X.graph("merge4", batch_size=batch_size)
    p1 = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 100, name="s1"))
    p2 = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 80, name="s2")).chain(
        Mp(X, lambda t: {"v": t.v + 1}))
    p3 = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 60, name="s3")).chain(
        Mp(X, lambda t: {"v": t.v * 2}))
    p1.merge(p2, p3).chain(Fl(X, lambda t: t.v % 3 == 0)).chain(
        Mp(X, lambda t: {"v": t.v + 10})).add(RS(X, lambda t: t.v, "out"))
    return g.run()


def r_split3_flatmap(X, batch_size):
    g = X.graph("split3", batch_size=batch_size)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 120))
    mp.split(lambda t: X.i32(t.v % 2), 2)
    inner = mp.select(0).chain(Mp(X, lambda t: {"v": t.v + 1}))
    inner.split(lambda t: X.i32(t.v % 3 == 0), 2)
    inner.select(0).add(RS(X, lambda t: t.v, "l0"))
    leaf = inner.select(1)
    for op in X.flatmap2_count():
        leaf.chain(op)
    mp.select(1).add(RS(X, lambda t: t.v, "r"))
    return g.run()


@pytest.mark.parametrize("shape,batch_size", [
    (r_split5, 48), (r_split5, 120), (r_merge4, 40), (r_merge4, 100),
    (r_split3_flatmap, 36), (r_split3_flatmap, 90)],
    ids=lambda c: getattr(c, "__name__", str(c)))
def test_graph_shapes_ref_match_jax(shape, batch_size):
    res = both(shape, batch_size)
    if shape is r_merge4:
        stream = list(range(100)) + [i + 1 for i in range(80)] + [i * 2 for i in range(60)]
        assert res["out"] == sum(v + 10 for v in stream if v % 3 == 0)
    elif shape is r_split3_flatmap:
        evens = [i + 1 for i in range(120) if i % 2 == 0]
        assert res["l1_count"] == 2 * len([v for v in evens if v % 3 == 0])
    else:
        assert res[1] and res[0]["branch_map"] == sum(
            (i % 11) * 2.0 for i in range(360) if (i % 11) % 2 == 0)


# ---- DETERMINISTIC merges: tests/test_deterministic_mode.py and the serial
# ---- graphs of tests/test_ordering_renumbering.py

def det_tb(X, batch_size, swap=False):
    g = X.graph("det", batch_size=batch_size, mode=X.Mode.DETERMINISTIC)
    sa = Src(X, lambda i: {"v": X.f32(i % 5)}, 120, num_keys=2, ts_fn=lambda i: 2 * i,
             name="even_ts")
    sb = Src(X, lambda i: {"v": X.f32(i % 7)}, 120, num_keys=2,
             ts_fn=lambda i: 2 * i + 1, name="odd_ts")
    pa, pb = g.add_source(sa), g.add_source(sb)
    m = pb.merge(pa) if swap else pa.merge(pb)
    out = []
    m.add(X.wf.Win_Seq(lambda wid, it: it.sum("v"), X.Spec(30, 30, X.TB, delay=60),
                       num_keys=2, **X.kw)).add_sink(tuples_sink(X, out))
    g.run()
    return sorted(out)


def det_cb(X, batch_size, swap=False):
    g = X.graph("det_cb", batch_size=batch_size, mode=X.Mode.DETERMINISTIC)
    sa = Src(X, lambda i: {"v": X.f32(i % 5)}, 100, num_keys=2, ts_fn=lambda i: 2 * i,
             name="even_ts")
    sb = Src(X, lambda i: {"v": X.f32(i % 7)}, 100, num_keys=2,
             ts_fn=lambda i: 2 * i + 1, name="odd_ts")
    pa, pb = g.add_source(sa), g.add_source(sb)
    m = pb.merge(pa) if swap else pa.merge(pb)
    out = []
    m.add(X.wf.Win_Seq(lambda wid, it: it.sum("v"), X.Spec(10, 10, X.CB), num_keys=2,
                       **X.kw)).add_sink(tuples_sink(X, out))
    g.run()
    assert m._ordering is not None and m._ordering.mode.name == "TS_RENUMBERING"
    return sorted(out)


def det_oracle_tb():
    want = {}
    for i in range(120):
        for ts, v in ((2 * i, i % 5), (2 * i + 1, i % 7)):
            want[(i % 2, ts // 30)] = want.get((i % 2, ts // 30), 0.0) + v
    return sorted((k, w, r) for (k, w), r in want.items())


def det_oracle_cb():
    rows = sorted([(2 * i, i % 2, i % 5) for i in range(100)]
                  + [(2 * i + 1, i % 2, i % 7) for i in range(100)])
    want = []
    for k in range(2):
        vs = [v for _, kk, v in rows if kk == k]
        want += [(k, w, float(sum(vs[10 * w:10 * w + 10]))) for w in range(-(-len(vs) // 10))]
    return sorted(want)


@pytest.mark.parametrize("batch_size", [32, 77, 240])
def test_deterministic_tb_merge_matches_jax_and_oracle(batch_size):
    assert both(det_tb, batch_size) == det_oracle_tb()


@pytest.mark.parametrize("batch_size", [32, 77, 200])
def test_deterministic_cb_windows_after_merge_match_jax_and_oracle(batch_size):
    assert both(det_cb, batch_size) == det_oracle_cb()


@pytest.mark.parametrize("which", [det_tb, det_cb], ids=lambda f: f.__name__)
def test_deterministic_invariant_under_operand_order(which):
    base = _norm(which(PORT, 60))
    assert _norm(which(PORT, 60, swap=True)) == base
    assert _norm(which(PORT, 90, swap=True)) == base


def test_unbalanced_merge_releases_early():
    """A short source running dry stops gating (and hoarding) the long one."""
    def run(X):
        g = X.graph("unbal", batch_size=16, mode=X.Mode.DETERMINISTIC)
        pa = g.add_source(Src(X, lambda i: {"v": X.f32(i)}, 16, num_keys=1,
                              ts_fn=lambda i: i, name="short"))
        pb = g.add_source(Src(X, lambda i: {"v": X.f32(i)}, 512, num_keys=1,
                              ts_fn=lambda i: i, name="long"))
        m = pa.merge(pb)
        seen = []
        m.add(Mp(X, lambda t: {"v": t.v})).add_sink(values_sink(X, seen))
        g.run()
        assert m._ordering is not None and m._ordering._pending is None
        return seen
    seen = both(run)
    assert len(seen) == 528


def test_dot_text_matches_jax():
    """dump_DOTGraph's text, with chained, routed (keyed) and bare operators,
    splits and merges, equals the JAX package's."""
    def build(X):
        g = X.graph("dot", batch_size=32)
        mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 64, name="src"))
        mp.chain(Mp(X, lambda t: {"v": t.v + 1}, name="inc"))
        mp.add(Fl(X, lambda t: t.v > 3, keyed=True, name="kf"))
        mp.split(lambda t: X.i32(t.v % 2), 2)
        b0 = mp.select(0).chain(Mp(X, lambda t: {"v": t.v * 2}, name="dbl"))
        m = b0.merge(mp.select(1))
        m.add_sink(X.wf.Sink(lambda v: None, name="out", **X.kw))
        return g.dump_DOTGraph()
    dot = both(build)
    assert "inc (chained)" in dot and "kf (keyby)" in dot and "[label=merge]" in dot


def test_pipegraph_with_scan_dispatch_matches_per_batch():
    """dispatch=K through the graph driver: byte-identical sink tuples to the
    per-batch run (two roots, a split and a DETERMINISTIC merge)."""
    def run(dispatch):
        g = wt.PipeGraph("disp", batch_size=32, mode=wt.Mode.DETERMINISTIC,
                         dispatch=dispatch, device="cpu")
        a = g.add_source(Src(PORT, lambda i: {"v": PORT.f32(i % 9)}, 300, num_keys=3,
                             ts_fn=lambda i: 2 * i, name="a"))
        b = g.add_source(Src(PORT, lambda i: {"v": PORT.f32(i % 4)}, 200, num_keys=3,
                             ts_fn=lambda i: 3 * i, name="b"))
        a.chain(Mp(PORT, lambda t: {"v": t.v * 2}))
        out = []
        a.merge(b).add(wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(8, 4),
                                  num_keys=3, device="cpu")).add_sink(tuples_sink(PORT, out))
        g.run()
        return sorted(out)
    assert run(3) == run(False)


def test_graph_windows_oracle_matches_jax():
    """chip_smoke.py's graph_windows graph (split -> two branches -> a
    DETERMINISTIC merge-partial -> CB Win_Seq sum) at a small size: the port's
    windows equal the JAX package's and chip_smoke.py's numpy oracle."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    total, keys, win_len, slide, batch = 3000, 8, 16, 8, 64

    def run(X):
        out = []
        cb = tuples_sink(X, out).fn
        if X is PORT:
            g, mp, m = smoke.graph_windows(torch, wt, total, keys, win_len, slide, batch,
                                           cb, device="cpu")
        else:
            g = JPipeGraph("graph_windows", mode=JMode.DETERMINISTIC, batch_size=batch)
            mp = g.add_source(wf.Source(lambda i: {"v": (i % 97).astype(jnp.float32)},
                                        total=total, num_keys=keys))
            mp.split(lambda t: (t.id % 3).astype(jnp.int32), 3)
            b0 = mp.select(0).chain(wf.Map(lambda t: {"v": t.v + 0.0}, name="b0"))
            b1 = mp.select(1).chain(wf.Map(lambda t: {"v": t.v * 1.0}, name="b1"))
            mp.select(2).add(wf.ReduceSink(lambda t: jnp.ones((), jnp.int32), name="rest"))
            m = b0.merge(b1)
            m.add(wf.Win_Seq(lambda wid, it: it.sum("v"), JSpec(win_len, slide, jwt.CB),
                             num_keys=keys)).add_sink(wf.Sink(cb))
        res = g.run()
        assert m._merge_parent is mp and m._covers_idx == (0, 1)
        assert m._ordering.mode.name == "TS_RENUMBERING"
        return sorted(out), int(np.asarray(res["rest"]))
    wins, rest = both(run)
    assert rest == len(range(2, total, 3))
    want = smoke.graph_windows_oracle(np, total, keys, win_len, slide)
    assert {(k, w): int(v) for k, w, v in wins} == want

"""The port's threaded drivers and prefetched ingest against the JAX package's.

Mirrors ``tests/test_native_runtime.py``, ``tests/test_pipegraph_threaded.py``,
``tests/test_prefetch_ingest.py``, and the threaded cases of
``tests/test_dispatch.py``, ``tests/test_merge_split_legality.py``,
``tests/test_deterministic_mode.py``, ``tests/test_ordering_renumbering.py``
and ``tests/test_nexmark.py``. Each graph is written once against a namespace
(``JAX`` or ``PORT``) and run in both packages on the same streams: the sink
rows must be equal byte for byte, in delivery order, for a single chain; for
a DETERMINISTIC merge every window must be equal (values compared exactly)
with the emission order across batches left free, since it follows the
Ordering_Node's release chunks, which the threads' interleave moves; and
once sorted for DEFAULT merges (their interleave is free).

Every driver run goes through :func:`within_deadline`, which runs it in a
thread and fails the test if it has not returned after ``DEADLINE_S``: a hang
fails one test and does not eat the suite's clock. Also the repairs of the
port's single-thread assumptions that a CPU can show: the launch counter
under two threads, a capture's collector that takes no other thread's
launches, the hand-off's pass-through on the CPU, and the chains closed to
captures while the stage threads run.
"""

import os
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import Mode as JMode, win_type_t as jwt
from windflow_tpu.operators.window import WindowSpec as JSpec
from windflow_tpu.runtime.pipegraph import PipeGraph as JPipeGraph
from windflow_tpu.runtime.threaded import ThreadedPipeline as JThreaded
from windflow_tpu_torch.ops import registry
from windflow_tpu_torch.runtime import handoff
from windflow_tpu_torch.runtime.threaded import drain_queue_to_sentinel

DEADLINE_S = 60.0
CPU = {"device": "cpu"}


def within_deadline(fn, *args, timeout=DEADLINE_S, **kw):
    """``fn(*args, **kw)`` in a daemon thread joined with a deadline: its
    result, its exception raised here, or a failure if it is still running."""
    box = {}

    def body():
        try:
            box["result"] = fn(*args, **kw)
        except BaseException as e:      # noqa: BLE001 — raised in the test
            box["error"] = e
    t = threading.Thread(target=body, daemon=True, name="test-driver")
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"driver still running after {timeout} s (a hang)")
    if "error" in box:
        raise box["error"]
    return box["result"]


JAX = types.SimpleNamespace(
    name="jax", wf=wf, kw={}, Mode=JMode, Spec=JSpec, CB=jwt.CB, TB=jwt.TB,
    i32=lambda a: a.astype(jnp.int32), f32=lambda a: a.astype(jnp.float32),
    add=jnp.add, graph=lambda *a, **k: JPipeGraph(*a, **k),
    threaded=lambda *a, **k: JThreaded(*a, pin=False, **k))
PORT = types.SimpleNamespace(
    name="port", wf=wt, kw=CPU, Mode=wt.Mode, Spec=wt.WindowSpec,
    CB=wt.win_type_t.CB, TB=wt.win_type_t.TB, i32=lambda a: a.to(torch.int32),
    f32=lambda a: a.to(torch.float32), add=torch.add,
    graph=lambda *a, **k: wt.PipeGraph(*a, device="cpu", **k),
    threaded=lambda *a, **k: wt.ThreadedPipeline(*a, pin=False, device="cpu", **k))


def Src(X, fn, total, **kw):
    return X.wf.Source(fn, total=total, **kw, **X.kw)


def Mp(X, fn, **kw):
    return X.wf.Map(fn, **kw, **X.kw)


def RS(X, fn, name):
    return X.wf.ReduceSink(fn, name=name, **X.kw)


def rows_sink(X, out, fields=("key", "id", "ts", "payload")):
    """A Sink appending each delivered view's fields as numpy arrays."""
    def as_np(v):
        return {k: np.asarray(x) for k, x in v.items()} if isinstance(v, dict) \
            else np.asarray(v)

    def cb(view):
        if view is not None:
            out.append({f: as_np(view[f]) for f in fields})
    return X.wf.Sink(cb, **X.kw)


def flat(rows):
    """A run's rows as (field, dtype, bytes), in delivery order."""
    out = []
    for r in rows:
        for f in sorted(r):
            v = r[f]
            if isinstance(v, dict):
                out += [(f"{f}.{k}", np.asarray(v[k]).dtype.str, np.asarray(v[k]).tobytes())
                        for k in sorted(v)]
            else:
                out.append((f, v.dtype.str, v.tobytes()))
    return out


def stream(rows):
    """A run's rows as one stream: each field's arrays concatenated in
    delivery order, as (field, dtype, bytes) — equal whatever the chunking."""
    if not rows:
        return []
    cols = {}
    for r in rows:
        for f, v in r.items():
            for name, a in ([(f"{f}.{k}", v[k]) for k in sorted(v)]
                            if isinstance(v, dict) else [(f, v)]):
                cols.setdefault(name, []).append(np.asarray(a))
    return [(f, cols[f][0].dtype.str, np.concatenate(cols[f]).tobytes())
            for f in sorted(cols)]


def tuples(rows):
    """A run's rows as sorted per-tuple tuples, values exact (DEFAULT merges,
    and the windows of a DETERMINISTIC merge as a set)."""
    out = []
    for r in rows:
        cols = [r[f] for f in sorted(r) if not isinstance(r[f], dict)]
        cols += [np.asarray(r[f][k]) for f in sorted(r) if isinstance(r[f], dict)
                 for k in sorted(r[f])]
        out += list(zip(*[c.tolist() for c in cols]))
    return sorted(out)


def ints(res):
    return {k: int(v) for k, v in res.items()}


# ---- repairs: launch counts, captures, hand-off ---------------------------------------

def test_launch_counter_is_exact_under_two_threads():
    registry.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [registry.count_launch("lookup")
                                               for _ in range(100_000)])
              for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(DEADLINE_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert registry.launch_counts()["lookup"] == 200_000
    registry.reset_launches()


def test_capture_collector_takes_no_other_threads_launches():
    """A capture in one thread collects only that thread's launches; another
    thread counting meanwhile keeps its launches in the totals."""
    registry.reset_launches()
    started, release = threading.Event(), threading.Event()
    got = {}

    def capturing():
        with registry.collect() as counts:
            registry.count_launch("histogram")
            started.set()
            release.wait(DEADLINE_S)
            registry.add_launches({"histogram": 2, "lookup": 1})
        got.update(counts)

    t = threading.Thread(target=capturing)
    t.start()
    started.wait(DEADLINE_S)
    for _ in range(1000):
        registry.count_launch("histogram")
    release.set()
    t.join(DEADLINE_S)
    assert got == {"histogram": 3, "lookup": 1}
    counts = registry.launch_counts()
    assert counts["histogram"] == 1000 and counts["lookup"] == 0
    registry.reset_launches()


def test_handoff_is_a_pass_through_on_the_cpu():
    b = next(wt.Source(lambda i: {"v": i}, total=8, **CPU).batches(8))
    item = handoff.send(b)
    assert item[0] is b and item[1] is None
    assert handoff.receive(item) is b
    assert len(handoff.batch_tensors(b)) == 5


def test_chains_refuse_captures_while_stage_threads_run():
    """With dispatch on, the threaded drivers make every program ready before
    the stage threads start and close the chains to captures meanwhile."""
    seen = []
    tp = wt.ThreadedPipeline(Src(PORT, lambda i: {"v": i}, 64),
                             [[Mp(PORT, lambda t: {"v": t.v + 1})]],
                             wt.Sink(lambda v: seen.append(tp.chains[0].capture_closed),
                                     **CPU),
                             batch_size=16, pin=False, dispatch=2, **CPU)
    within_deadline(tp.run)
    assert seen and all(seen) and not tp.chains[0].capture_closed
    with pytest.raises(RuntimeError, match="no graph was captured"):
        tp.chains[0].capture_closed = True
        tp.chains[0]._graph(0, 3, 16)


@pytest.mark.parametrize("kw", [{"control": True}, {"monitoring": True},
                                {"trace": True}])
def test_unported_arguments_raise(kw, tmp_path):
    """``control=`` runs the governor over every ring; ``monitoring=`` and
    ``trace=`` run and write their artifacts."""
    src = Src(PORT, lambda i: {"v": i}, 8)
    if "control" in kw:
        got = []
        tp = wt.ThreadedPipeline(src, [[Mp(PORT, lambda t: {"v": t.v + 1})]],
                                 wt.Sink(lambda v: got.append(v), **CPU), batch_size=4,
                                 pin=False, device="cpu", **kw)
        within_deadline(tp.run)
        assert got[-1] is None and len(got) == 3
        assert [e[0] for e in tp.governor._edges] == tp.edge_names
    else:
        out = str(tmp_path / "out")
        tp = wt.ThreadedPipeline(src, [[Mp(PORT, lambda t: {"v": t.v + 1})]],
                                 wt.Sink(lambda v: None, **CPU), batch_size=4, pin=False,
                                 device="cpu", **{next(iter(kw)): out})
        within_deadline(tp.run)
        assert os.path.exists(os.path.join(
            out, "snapshot.json" if "monitoring" in kw else "flight.jsonl"))
    from windflow_tpu_torch.runtime.faults import FaultPlan
    wt.ThreadedPipeline(src, [], None, device="cpu", faults=FaultPlan())  # ported
    with pytest.raises(RuntimeError, match="cuda"):
        wt.ThreadedPipeline(src, [], None)        # device None means the card


# ---- ThreadedPipeline (tests/test_native_runtime.py, test_dispatch.py) ---------------

def tp_sum(X):
    src = Src(X, lambda i: {"v": X.f32(i % 11)}, 2000, num_keys=4)
    return X.threaded(src, [[Mp(X, lambda t: {"v": t.v * 2.0})],
                            [X.wf.Filter(lambda t: t.v > 4.0, **X.kw),
                             RS(X, lambda t: t.v, "total")]],
                      batch_size=128).run()


def test_threaded_pipeline_matches_sequential_and_jax():
    port = within_deadline(tp_sum, PORT)
    expect = sum(v * 2.0 for v in (i % 11 for i in range(2000)) if v * 2.0 > 4.0)
    assert float(port["total"]) == expect == float(tp_sum(JAX)["total"])


def tp_windows(X, driver):
    total, K = 600, 3
    src = Src(X, lambda i: {"v": X.f32(i // K)}, total, num_keys=K)
    ff = X.wf.Key_FFAT(lambda t: t.v, X.add, spec=X.Spec(10, 10), num_keys=K, **X.kw)
    rows = []
    if driver == "threaded":
        X.threaded(src, [[ff]], rows_sink(X, rows), batch_size=100).run()
    else:
        X.wf.Pipeline(src, [ff], rows_sink(X, rows), batch_size=100, **X.kw).run()
    return rows


def test_threaded_pipeline_with_windows_byte_identical():
    port = within_deadline(tp_windows, PORT, "threaded")
    assert flat(port) == flat(tp_windows(PORT, "serial"))
    assert flat(port) == flat(tp_windows(JAX, "threaded"))
    expect = []
    for k in range(3):
        vals = [float(i // 3) for i in range(600) if i % 3 == k]
        for w in range((len(vals) - 1) // 10 + 1):
            expect.append((k, w, sum(vals[w * 10:(w + 1) * 10])))
    got = [(k, w, v) for r in port for k, w, v in
           zip(r["key"].tolist(), r["id"].tolist(), r["payload"].tolist())]
    assert sorted(got) == sorted(expect)


def tp_two_maps(X, dispatch=None, **kw):
    rows = []
    src = Src(X, lambda i: {"v": X.f32(i % 13)}, 480, num_keys=3)
    X.threaded(src, [[Mp(X, lambda t: {"v": t.v * 3})], [Mp(X, lambda t: {"v": t.v + 1})]],
               rows_sink(X, rows), batch_size=16, dispatch=dispatch, **kw).run()
    return rows


@pytest.mark.parametrize("dispatch", [4, {"k": 4, "linger_s": 0.0}, {"k": 3}])
def test_threaded_dispatch_byte_identical(dispatch):
    plain = within_deadline(tp_two_maps, PORT)
    assert flat(plain) == flat(tp_two_maps(JAX))
    assert flat(within_deadline(tp_two_maps, PORT, dispatch)) == flat(plain)


def test_edges_capacities_and_depths():
    tp = PORT.threaded(Src(PORT, lambda i: {"v": i}, 64),
                       [[Mp(PORT, lambda t: {"v": t.v})], [Mp(PORT, lambda t: {"v": t.v})]],
                       None, queue_capacity={"seg0->seg1": 2, 0: 5})
    jtp = JAX.threaded(Src(JAX, lambda i: {"v": i}, 64),
                       [[Mp(JAX, lambda t: {"v": t.v})], [Mp(JAX, lambda t: {"v": t.v})]],
                       None, queue_capacity={"seg0->seg1": 2, 0: 5})
    assert tp.edge_names == jtp.edge_names == ["src->seg0", "seg0->seg1", "seg1->sink"]
    assert tp.edge_capacities == jtp.edge_capacities == {
        "src->seg0": 5, "seg0->seg1": 2, "seg1->sink": 8}
    assert tp.queue_depths() == dict.fromkeys(tp.edge_names, 0)
    with pytest.raises(ValueError, match="capacity"):
        PORT.threaded(Src(PORT, lambda i: {"v": i}, 8), [], None, queue_capacity=0)


def test_failing_stage_drains_to_eos_and_run_raises():
    """A segment that raises drains its input ring to EOS (the source, blocked
    on a ring of one behind it, finishes), the run closes the sink, and
    run() raises the stage's error."""
    calls = {"n": 0}

    def bad(t):
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("stage died")
        return {"v": t.v}
    closed = []
    sink = wt.Sink(lambda v: None, **CPU)
    sink.close = lambda: closed.append(True)
    tp = PORT.threaded(Src(PORT, lambda i: {"v": i}, 4000),
                       [[wt.BatchMap(lambda p: bad(types.SimpleNamespace(v=p["v"])),
                                     **CPU)], [Mp(PORT, lambda t: {"v": t.v})]],
                       sink, batch_size=16, queue_capacity=1)
    with pytest.raises(RuntimeError, match="stage died"):
        within_deadline(tp.run)
    assert closed == [True]


def test_drain_queue_to_sentinel():
    from windflow_tpu_torch.native import SPSCQueue
    q, eos = SPSCQueue(8), object()
    for i in range(5):
        q.push(i)
    q.push(eos)
    assert drain_queue_to_sentinel(q, eos, timeout_s=5)
    assert q.size() == 0
    assert not drain_queue_to_sentinel(q, eos, timeout_s=0.05)


def test_watchdog_lists_a_stalled_stage():
    def slow(p):
        time.sleep(0.4)
        return p
    tp = PORT.threaded(Src(PORT, lambda i: {"v": i}, 32),
                       [[wt.BatchMap(slow, **CPU)]], None, batch_size=16,
                       heartbeat_timeout=0.1)
    within_deadline(tp.run)
    assert "seg0" in tp.watchdog_stale


# ---- prefetched ingest (tests/test_prefetch_ingest.py) -----------------------------

def gen_source(X, total=300, chunk=64):
    def it():
        for s in range(0, total, chunk):
            n = min(chunk, total - s)
            i = np.arange(s, s + n, dtype=np.int32)
            yield ({"v": (i % 7).astype(np.float32)}, i % 4, i)
    spec = ({"v": jax.ShapeDtypeStruct((), jnp.float32)} if X is JAX
            else {"v": torch.zeros((), dtype=torch.float32)})
    return X.wf.GeneratorSource(it, spec, name="gen", **X.kw)


def port_rows(batches):
    return [{"key": b.key.numpy(), "id": b.id.numpy(), "ts": b.ts.numpy(),
             "valid": b.valid.numpy(), "payload": {"v": b.payload["v"].numpy()}}
            for b in batches]


def test_prefetched_batches_equal_plain_batches_and_jax():
    plain = port_rows(gen_source(PORT).batches(64))
    pref = port_rows(within_deadline(lambda: list(gen_source(PORT).batches_prefetched(64, 3))))
    assert flat(pref) == flat(plain) and len(plain) == 5
    jax_rows = [{"key": np.asarray(b.key), "id": np.asarray(b.id), "ts": np.asarray(b.ts),
                 "valid": np.asarray(b.valid), "payload": {"v": np.asarray(b.payload["v"])}}
                for b in gen_source(JAX).batches_prefetched(64, depth=3)]
    assert flat(pref) == flat(jax_rows)


def test_prefetch_of_a_device_source():
    src = Src(PORT, lambda i: {"v": i * 2}, 100)
    assert flat(port_rows(within_deadline(lambda: list(src.batches_prefetched(16, 2))))) \
        == flat(port_rows(src.batches(16)))


def test_prefetch_worker_exception_propagates():
    def bad():
        yield {"v": np.zeros(4, np.float32)}
        raise RuntimeError("source died")
    src = wt.GeneratorSource(bad, {"v": torch.zeros(())}, **CPU)
    it = src.batches_prefetched(8, depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="source died"):
        within_deadline(list, it)


def test_prefetch_early_close_stops_worker():
    before = {id(t) for t in threading.enumerate()}
    it = gen_source(PORT, total=10000, chunk=50).batches_prefetched(50, depth=2)
    next(it)
    it.close()

    def leaked():
        return [t for t in threading.enumerate()
                if t.name == "wf-prefetch" and t.is_alive() and id(t) not in before]
    deadline = time.monotonic() + 20
    while leaked() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not leaked()


def test_prefetch_pause_event_holds_the_worker():
    pause = threading.Event()
    pause.set()
    it = gen_source(PORT).batches_prefetched(64, depth=2, pause_event=pause)
    got = []
    t = threading.Thread(target=lambda: got.append(next(it)), daemon=True)
    t.start()
    time.sleep(0.2)
    assert not got                              # paused: nothing was pulled
    pause.clear()
    t.join(DEADLINE_S)
    assert len(got) == 1
    it.close()


@pytest.mark.parametrize("driver", ["pipeline", "threaded"])
def test_pipeline_with_prefetch_matches_without(driver):
    def run(prefetch):
        rows = []
        if driver == "pipeline":
            p = wt.Pipeline(gen_source(PORT), [Mp(PORT, lambda t: {"v": t.v * 2})],
                            rows_sink(PORT, rows), batch_size=64, prefetch=prefetch, **CPU)
        else:
            p = PORT.threaded(gen_source(PORT), [[Mp(PORT, lambda t: {"v": t.v * 2})]],
                              rows_sink(PORT, rows), batch_size=64, prefetch=prefetch)
        within_deadline(p.run)
        return rows
    assert flat(run(3)) == flat(run(0))
    jrows = []
    wf.Pipeline(gen_source(JAX), [Mp(JAX, lambda t: {"v": t.v * 2})],
                rows_sink(JAX, jrows), batch_size=64, prefetch=3).run()
    assert flat(run(3)) == flat(jrows)


# ---- PipeGraph.run(threaded=True) (tests/test_pipegraph_threaded.py) ------------------

def g_diamond(X, threaded):
    g = X.graph("t", batch_size=64)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 300))
    mp.split(lambda t: X.i32(t.v % 2), 2)
    b0 = mp.select(0).add(Mp(X, lambda t: {"v": t.v * 10}, name="m0"))
    b1 = mp.select(1).add(Mp(X, lambda t: {"v": t.v * 100}, name="m1"))
    b0.merge(b1).add(RS(X, lambda t: t.v, "sum"))
    return ints(g.run(threaded=threaded))


def g_windowed(X, threaded):
    total, K = 400, 2
    rows = []
    g = X.graph("w", batch_size=80)
    ff = X.wf.Key_FFAT(lambda t: t.v, X.add, spec=X.Spec(10, 10), num_keys=K, **X.kw)
    g.add_source(Src(X, lambda i: {"v": X.f32(i // K)}, total, num_keys=K)).add(
        ff).add_sink(rows_sink(X, rows))
    g.run(threaded=threaded)
    return rows


def g_nested_3way(X, threaded):
    g = X.graph("tg", batch_size=64)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 240, name="sa"))
    mp.split(lambda t: X.i32(t.v % 3 == 0), 2)
    b_rest, b_mul3 = mp.select(0), mp.select(1)
    b_mul3.add(Mp(X, lambda t: {"v": t.v * 1000}, name="mz"))
    b_rest.split(lambda t: X.i32(t.v % 3 - 1), 2)
    r1 = b_rest.select(0)
    r2 = b_rest.select(1).add(Mp(X, lambda t: {"v": t.v * 10}, name="m2"))
    ind = g.add_source(Src(X, lambda i: {"v": X.i32(i + 900)}, 12, name="sb"))
    r1.merge(r2, b_mul3).merge(ind).add(RS(X, lambda t: t.v, "m"))
    return ints(g.run(threaded=threaded))


def g_nested_subtree(X, threaded):
    g = X.graph("tg2", batch_size=64)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 240, name="sa"))
    mp.split(lambda t: X.i32(t.v % 3 == 0), 2)
    b_rest, b_mul3 = mp.select(0), mp.select(1)
    b_rest.split(lambda t: X.i32(t.v % 3 - 1), 2)
    merged = b_rest.select(0).merge(b_rest.select(1))
    ind = g.add_source(Src(X, lambda i: {"v": X.i32(i + 900)}, 12, name="sb"))
    with pytest.raises(RuntimeError, match="not supported"):
        merged.merge(ind)
    ind.add(RS(X, lambda t: t.v, "i"))
    merged.add(RS(X, lambda t: t.v, "m"))
    b_mul3.add(RS(X, lambda t: t.v, "z"))
    return ints(g.run(threaded=threaded))


GRAPH_ORACLES = {
    g_diamond: lambda r: r == {"sum": sum(i * 10 for i in range(300) if i % 2 == 0)
                               + sum(i * 100 for i in range(300) if i % 2 == 1)},
    g_nested_3way: lambda r: r == {"m": sum(i * 1000 for i in range(240) if i % 3 == 0)
                                   + sum(i for i in range(240) if i % 3 == 1)
                                   + sum(i * 10 for i in range(240) if i % 3 == 2)
                                   + sum(range(900, 912))},
    g_nested_subtree: lambda r: r == {"z": sum(i for i in range(240) if i % 3 == 0),
                                      "m": sum(i for i in range(240) if i % 3),
                                      "i": sum(range(900, 912))},
}


@pytest.mark.parametrize("graph", list(GRAPH_ORACLES), ids=lambda f: f.__name__)
def test_threaded_graphs_match_serial_jax_and_oracle(graph):
    got = within_deadline(graph, PORT, True)
    assert got == graph(PORT, False) == graph(JAX, True)
    assert GRAPH_ORACLES[graph](got)


def test_threaded_windowed_graph_byte_identical():
    got = within_deadline(g_windowed, PORT, True)
    assert flat(got) == flat(g_windowed(PORT, False)) == flat(g_windowed(JAX, True))


def test_iter_edges_match_jax():
    def edges(X):
        g = X.graph("e", batch_size=32)
        mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 64, name="a"))
        mp.split(lambda t: X.i32(t.v % 2), 2)
        m = mp.select(0).merge(mp.select(1))
        b = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 8, name="b"))
        m.merge(b).add(RS(X, lambda t: t.v, "s"))
        pipes = g._all_pipes()
        idx = {id(p): i for i, p in enumerate(pipes)}
        return [(None if p is None else idx[id(p)], idx[id(c)], label, n)
                for p, c, label, n in g._iter_edges()]
    assert edges(PORT) == edges(JAX)


# ---- tests/test_merge_split_legality.py threaded shapes -------------------------------

def lsrc(X, total=90, mod=7, name="s"):
    return Src(X, lambda i: {"v": X.f32(i % mod)}, total, name=name)


def values_sink(X, out):
    def cb(view):
        if view is not None:
            out.extend(np.asarray(view["payload"]["v"]).tolist())
    return X.wf.Sink(cb, **X.kw)


def s_merge_three_roots(X, batch_size, threaded):
    g = X.graph(batch_size=batch_size)
    a = g.add_source(lsrc(X, name="a")).add(Mp(X, lambda t: {"v": t.v + 1}))
    b = g.add_source(lsrc(X, mod=5, name="b")).add(Mp(X, lambda t: {"v": t.v + 2}))
    c = (g.add_source(lsrc(X, mod=3, name="c"))
         .add(X.wf.Filter(lambda t: t.v > 0, **X.kw))
         .add(Mp(X, lambda t: {"v": t.v * 2})))
    out = []
    a.merge(b, c).add(Mp(X, lambda t: {"v": t.v * 10})).add_sink(values_sink(X, out))
    g.run(threaded=threaded)
    return sorted(out)


def s_merge_of_merged(X, batch_size, threaded):
    g = X.graph(batch_size=batch_size)
    a = g.add_source(lsrc(X, name="a"))
    b = g.add_source(lsrc(X, mod=5, name="b"))
    m1 = a.merge(b).add(X.wf.Filter(lambda t: t.v % 2 == 0, **X.kw))
    c = g.add_source(lsrc(X, mod=3, name="c"))
    out = []
    m1.merge(c).add(Mp(X, lambda t: {"v": t.v + 100})).add_sink(values_sink(X, out))
    g.run(threaded=threaded)
    return sorted(out)


def s_split_partial_merge(X, batch_size, threaded):
    g = X.graph(batch_size=batch_size)
    s = g.add_source(lsrc(X)).split(lambda t: X.i32(t.v) % 3, 3)
    rejoined, solo = [], []
    (s.select(0).merge(s.select(1))
     .add(Mp(X, lambda t: {"v": t.v * 10})).add_sink(values_sink(X, rejoined)))
    s.select(2).add_sink(values_sink(X, solo))
    g.run(threaded=threaded)
    return sorted(rejoined), sorted(solo)


def s_partial_chain(X, batch_size, threaded):
    g = X.graph(batch_size=batch_size)
    mp = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 200))
    mp.split(lambda t: X.i32(t.v % 4), 4)
    def mk(m):
        return Mp(X, lambda t: {"v": t.v * m})
    b = [mp.select(i).chain(mk(10 ** i)) for i in range(4)]
    b[0].merge(b[1]).merge(b[2]).add(RS(X, lambda t: t.v, "m"))
    b[3].add(RS(X, lambda t: t.v, "r3"))
    return ints(g.run(threaded=threaded))


@pytest.mark.parametrize("shape,batch_size", [
    (s_merge_three_roots, 45), (s_merge_of_merged, 60), (s_split_partial_merge, 60),
    (s_partial_chain, 32)], ids=lambda x: getattr(x, "__name__", str(x)))
def test_reference_dag_shapes_threaded_match_serial_and_jax(shape, batch_size):
    got = within_deadline(shape, PORT, batch_size, True)
    assert got == shape(PORT, batch_size, False) == shape(JAX, batch_size, True)


# ---- DETERMINISTIC merges (test_deterministic_mode.py, test_ordering_renumbering.py) --

def det_graph(X, batch_size, spec, total, swap=False, threaded=False, dispatch=None,
              window=True):
    g = X.graph("det", batch_size=batch_size, mode=X.Mode.DETERMINISTIC,
                **({} if dispatch is None else {"dispatch": dispatch}))
    sa = Src(X, lambda i: {"v": X.f32(i % 5)}, total, num_keys=2, ts_fn=lambda i: 2 * i,
             name="even_ts")
    sb = Src(X, lambda i: {"v": X.f32(i % 7)}, total, num_keys=2,
             ts_fn=lambda i: 2 * i + 1, name="odd_ts")
    pa, pb = g.add_source(sa), g.add_source(sb)
    m = pb.merge(pa) if swap else pa.merge(pb)
    rows = []
    if window:
        m.add(X.wf.Win_Seq(lambda wid, it: it.sum("v"), spec(X), num_keys=2, **X.kw)
              ).add_sink(rows_sink(X, rows, ("key", "id", "payload")))
    else:
        m.add_sink(rows_sink(X, rows))
    g.run(threaded=threaded)
    return rows


def det_tb(X, batch_size, **kw):
    return det_graph(X, batch_size, lambda X: X.Spec(30, 30, X.TB, delay=60), 120, **kw)


def det_cb(X, batch_size, **kw):
    return det_graph(X, batch_size, lambda X: X.Spec(10, 10, X.CB), 100, **kw)


@pytest.mark.parametrize("which,batch_size,swap", [
    (det_tb, 60, False), (det_tb, 90, True), (det_cb, 50, False), (det_cb, 80, True)],
    ids=lambda x: getattr(x, "__name__", str(x)))
def test_deterministic_threaded_byte_identical(which, batch_size, swap):
    """A DETERMINISTIC merge releases in (ts, id, channel) order whatever the
    threads' interleave: the merged stream, concatenated in delivery order,
    equals the serial driver's and the JAX package's threaded run's byte for
    byte. The windows over it equal the serial run's as a set, values
    exact: their emission order across keys follows the release chunks,
    which the interleave moves."""
    merged = within_deadline(which, PORT, batch_size, swap=swap, threaded=True, window=False)
    assert stream(merged) == stream(which(PORT, batch_size, swap=swap, window=False))
    assert stream(merged) == stream(which(JAX, batch_size, swap=swap, threaded=True,
                                          window=False))
    got = within_deadline(which, PORT, batch_size, swap=swap, threaded=True)
    assert tuples(got) == tuples(which(PORT, batch_size, swap=swap))
    assert tuples(got) == tuples(which(JAX, batch_size, swap=swap, threaded=True))
    assert len(tuples(got)) == len({t[:2] for t in tuples(got)}) > 10


# ---- PipeGraph threaded dispatch (tests/test_dispatch.py) -----------------------------

def disp_graph(X, mode, dispatch=None):
    wins, plains = [], []
    g = X.graph("disp", batch_size=40, mode=mode,
                **({} if dispatch is None else {"dispatch": dispatch}))
    a = g.add_source(Src(X, lambda i: {"v": X.f32(i % 9)}, 240, num_keys=3, name="a"))
    b = g.add_source(Src(X, lambda i: {"v": X.f32(i % 7)}, 120, num_keys=3, name="b",
                         ts_fn=lambda i: i * 2))
    m = a.merge(b).split(lambda t: t.v % 2 == 0, 2)
    (m.select(1).add(X.wf.Win_Seq(lambda wid, it: it.sum("v"), X.Spec(12, 12, X.CB),
                                  num_keys=3, **X.kw))
     .add_sink(rows_sink(X, wins, ("key", "id", "payload"))))
    m.select(0).add_sink(rows_sink(X, plains, ("id", "payload")))
    g.run(threaded=True)
    return wins, plains


@pytest.mark.parametrize("mode", ["DEFAULT", "DETERMINISTIC"])
def test_pipegraph_threaded_dispatch_identical(mode):
    """Dispatch per pipe thread changes nothing: DETERMINISTIC windows exact
    (the JAX package's too); DEFAULT's plain rows once sorted and its
    windows' total (a CB window over a free interleave holds other tuples
    from run to run)."""
    pm, jm = getattr(PORT.Mode, mode), getattr(JAX.Mode, mode)
    w0, p0 = within_deadline(disp_graph, PORT, pm)
    w1, p1 = within_deadline(disp_graph, PORT, pm, {"k": 4, "linger_s": 0.0})
    jw, jp = disp_graph(JAX, jm)
    assert tuples(p1) == tuples(p0) == tuples(jp)
    if mode == "DETERMINISTIC":
        assert tuples(w1) == tuples(w0) == tuples(jw)
    else:
        total = lambda rows: sum(float(v) for r in rows for v in r["payload"])  # noqa: E731
        assert round(total(w1), 3) == round(total(w0), 3) == round(total(jw), 3)


def test_default_merge_threaded_rows_sorted_equal():
    """A DEFAULT merge into a Sink: the threaded rows equal the serial
    driver's and the JAX package's once sorted."""
    def run(X, threaded):
        g = X.graph("dm", batch_size=32)
        a = g.add_source(Src(X, lambda i: {"v": X.i32(i)}, 200, name="a", num_keys=4))
        b = g.add_source(Src(X, lambda i: {"v": X.i32(-i)}, 150, name="b", num_keys=4))
        rows = []
        a.merge(b).add(Mp(X, lambda t: {"v": t.v * 3})).add_sink(rows_sink(X, rows))
        g.run(threaded=threaded)
        return tuples(rows)
    got = within_deadline(run, PORT, True)
    assert got == run(PORT, False) == run(JAX, True)
    assert len(got) == 350


# ---- Nexmark under ThreadedPipeline (tests/test_nexmark.py) ---------------------------

@pytest.mark.parametrize("name", ["q1_currency", "q2_selection", "q3_enrich_join",
                                  "q6_topn", "q7_distinct"])
def test_nexmark_threaded_equals_serial(name):
    from windflow_tpu_torch.nexmark import make_query

    def run(threaded):
        src, ops = make_query(name, 400, device="cpu")
        rows = []
        sink = wt.Sink(lambda v: v is not None and rows.append(
            {"key": v["key"], "id": v["id"], "ts": v["ts"], "payload": v["payload"]}), **CPU)
        if threaded:
            PORT.threaded(src, [ops[:1], ops[1:]] if len(ops) > 1 else [ops], sink,
                          batch_size=64).run()
        else:
            wt.Pipeline(src, ops, sink, batch_size=64, **CPU).run()
        return rows
    got = within_deadline(run, True)
    assert got and flat(got) == flat(run(False))

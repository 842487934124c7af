"""The port's IntervalJoin and SessionWindow against the JAX package's, on the CPU.

The same batches, made from a seed with numpy, go through one operator of
each package (``windflow_tpu`` and ``windflow_tpu_torch`` with
``device="cpu"``); after every batch and after ``flush`` the output batches
(every lane, valid or not) and the states must be identical, bytes and
dtypes, the states compared leaf by leaf under the JAX package's tree paths.
The cases cover float payloads (``-0.0``, unmatched picks), narrow integer
payloads (``jnp.sum``'s widening of a picked candidate), ``ts_l``/``ts_r``,
match and archive drops, OLD stragglers, a non-add session combine and the
flush. Then the mirrored cases of the JAX package's
``tests/test_join_operators.py`` (interval, session and ``join_with``), a
stream carried mid-way from the JAX package into the port with ``convert``,
and Nexmark q4/q5 identical across every driver of the port: ``Pipeline``,
``dispatch=4``, ``WF_DISPATCH``, ``ThreadedPipeline`` and ``PipeGraph``
(one source, serial and threaded; q4 also as two sources through
``join_with``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.batch import Batch as JBatch
from windflow_tpu.nexmark import make_query as jmake
from windflow_tpu.operators.join import IntervalJoin as JIntervalJoin
from windflow_tpu.operators.session import SessionWindow as JSessionWindow
from windflow_tpu.operators.window import WindowSpec as JWindowSpec
from windflow_tpu_torch import Batch as TBatch
from windflow_tpu_torch import convert
from windflow_tpu_torch.basic import win_type_t
from windflow_tpu_torch.nexmark import make_query as tmake, oracles
from windflow_tpu_torch.runtime.checkpoint import flatten_with_paths

CPU = {"device": "cpu"}
DEADLINE_S = 60.0


# ------------------------------------------------------------------ helpers

def jspec(dtypes):
    return {k: jax.ShapeDtypeStruct((), np.dtype(d)) for k, d in dtypes.items()}


def tspec(dtypes):
    return {k: torch.empty((), dtype=getattr(torch, np.dtype(d).name), device="meta")
            for k, d in dtypes.items()}


def both_batches(arrs):
    """The same batch in both packages from numpy arrays."""
    pay = arrs["payload"]
    jb = JBatch(key=jnp.asarray(arrs["key"]), id=jnp.asarray(arrs["id"]),
                ts=jnp.asarray(arrs["ts"]),
                payload={k: jnp.asarray(v) for k, v in pay.items()},
                valid=jnp.asarray(arrs["valid"]))
    tb = TBatch(key=torch.from_numpy(arrs["key"].copy()), id=torch.from_numpy(arrs["id"].copy()),
                ts=torch.from_numpy(arrs["ts"].copy()),
                payload={k: torch.from_numpy(v.copy()) for k, v in pay.items()},
                valid=torch.from_numpy(arrs["valid"].copy()))
    return jb, tb


def jax_paths(tree):
    kl, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(leaf)) for p, leaf in kl]


def assert_trees_identical(got, want, what):
    g = [(p, np.asarray(leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf))
         for p, leaf in flatten_with_paths(got)]
    w = jax_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype, (what, p, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, p, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), (what, p, a, b)


def batch_tree(b):
    return {"key": b.key, "id": b.id, "ts": b.ts, "valid": b.valid, "payload": b.payload}


def run_both(jop, top, dtypes, batches, C):
    """Push every batch through a one-op chain of each package, then flush;
    outputs and states compared after each step."""
    jc = wf.CompiledChain([jop], jspec(dtypes), batch_capacity=C)
    tc = wt.CompiledChain([top], tspec(dtypes), batch_capacity=C, **CPU)
    assert_trees_identical(tc.states[0], jc.states[0], "init")
    n_valid = 0
    for s, arrs in enumerate(batches):
        jb, tb = both_batches(arrs)
        jo, to = jc.push(jb), tc.push(tb)
        assert_trees_identical(batch_tree(to), batch_tree(jo), f"out {s}")
        assert_trees_identical(tc.states[0], jc.states[0], f"state {s}")
        n_valid += int(np.asarray(jo.valid).sum())
    jf, tf = jc.flush(), tc.flush()
    assert len(jf) == len(tf)
    for s, (jo, to) in enumerate(zip(jf, tf)):
        assert_trees_identical(batch_tree(to), batch_tree(jo), f"flush {s}")
        n_valid += int(np.asarray(jo.valid).sum())
    assert_trees_identical(tc.states[0], jc.states[0], "after flush")
    return jc, tc, n_valid


def stream(seed, n_batches, C, keys, *, step=0.5, jitter=0, valid_p=0.9, side=False,
           floats=False, small_ints=False, ts_base=0):
    """Batches of a seeded stream: ts about ``step`` a lane with ``jitter``
    of disorder, keys in ``[0, keys)``, some invalid lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        i = np.arange(b * C, (b + 1) * C)
        ts = (i * step).astype(np.int64)
        if jitter:
            ts = ts + rng.integers(-jitter, jitter + 1, C)
        pay = {"v": rng.integers(-1000, 1000, C).astype(np.int32)}
        if side:
            pay["side"] = (rng.random(C) < 0.3).astype(np.int32)
        if floats:
            f = rng.normal(size=C).astype(np.float32)
            f[rng.random(C) < 0.25] = -0.0
            pay["f"] = f
        if small_ints:
            pay["s8"] = rng.integers(-128, 128, C).astype(np.int8)
        ts = ((ts + ts_base + 2 ** 31) % 2 ** 32 - 2 ** 31)       # wraps as int32
        out.append({"key": rng.integers(0, keys, C).astype(np.int32),
                    "id": i.astype(np.int32), "ts": ts.astype(np.int32),
                    "payload": pay, "valid": rng.random(C) < valid_p})
    return out


# ------------------------------------------------- IntervalJoin parity

JOIN_CASES = {
    # name: (lower, upper, kwargs, stream kwargs)
    "int_window": (0, 4, {"max_matches": 4}, {}),
    "negative_bounds_delay": (-3, 2, {"max_matches": 3, "delay": 2}, {"jitter": 2}),
    "float_and_int8_payload": (0, 6, {"max_matches": 5},
                               {"floats": True, "small_ints": True}),
    "match_drops": (0, 20, {"max_matches": 2}, {}),
    "archive_drops": (0, 100, {"max_matches": 4, "archive": 40}, {}),
    "ts_wrapping_past_int32_max": (-2, 5, {"max_matches": 4}, {"ts_base": 2 ** 31 - 40}),
    "empty_window": (3, 1, {"max_matches": 2}, {}),
}


@pytest.mark.parametrize("block", [128, 4])
@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_interval_join_matches_jax(case, block, monkeypatch):
    """``block`` is the probe's column block: 4 puts a row's matches in
    several blocks."""
    from windflow_tpu_torch.operators import join as tj
    monkeypatch.setattr(tj, "PROBE_BLOCK", block)
    lower, upper, kw, skw = JOIN_CASES[case]
    C = 32
    batches = stream(11 + len(case), 6, C, keys=3, side=True, **skw)
    dtypes = {k: v.dtype for k, v in batches[0]["payload"].items()}
    side = lambda t: t.side == 1  # noqa: E731
    jop = JIntervalJoin(side, lower, upper, **kw)
    top = wt.IntervalJoin(side, lower, upper, **kw, **CPU)
    jc, tc, n = run_both(jop, top, dtypes, batches, C)
    assert (n == 0) == (case == "empty_window")
    st = jc.states[0]
    if case == "match_drops":
        assert int(st["match_drops"]) > 0
    if case == "archive_drops":
        assert int(st["arch_drops"]) > 0
    assert top.drop_counters(tc.states[0]) == jop.drop_counters(st)


def test_interval_join_ts_extractors_and_custom_emit_match_jax():
    C = 16
    batches = stream(5, 5, C, keys=2, side=True)
    for b in batches:
        b["payload"]["ev"] = (b["ts"] // 2).astype(np.int32)
    dtypes = {k: v.dtype for k, v in batches[0]["payload"].items()}
    side = lambda t: t.side == 1  # noqa: E731
    emit = lambda l, r: {"lt": l.ts, "rt": r.ts, "p": r.data["v"] - l.data["v"]}  # noqa: E731
    jop = JIntervalJoin(side, 0, 3, max_matches=6, ts_l=lambda t: t.ev,
                        ts_r=lambda t: t.ev + 1, emit=emit)
    top = wt.IntervalJoin(side, 0, 3, max_matches=6, ts_l=lambda t: t.ev,
                          ts_r=lambda t: t.ev + 1, emit=emit, **CPU)
    _, _, n = run_both(jop, top, dtypes, batches, C)
    assert n > 0


def test_interval_join_probe_chunks_agree(monkeypatch):
    """Row chunks of the probe (forced to 3 rows, with blocks of 4 and 128
    columns) give the unchunked result."""
    from windflow_tpu_torch.operators import join as tj
    C = 16
    batches = stream(9, 4, C, keys=2, side=True, floats=True)
    dtypes = {k: v.dtype for k, v in batches[0]["payload"].items()}
    side = lambda t: t.side == 1  # noqa: E731
    outs = []
    for cells, block in ((tj.PROBE_CHUNK_CELLS, 128), (3 * 3 * C, 4), (3 * 128, 128)):
        monkeypatch.setattr(tj, "PROBE_CHUNK_CELLS", cells)
        monkeypatch.setattr(tj, "PROBE_BLOCK", block)
        tc = wt.CompiledChain([wt.IntervalJoin(side, 0, 8, max_matches=3, **CPU)],
                              tspec(dtypes), batch_capacity=C, **CPU)
        res = []
        for arrs in batches:
            o = tc.push(both_batches(arrs)[1])
            res.append([t.numpy().tobytes() for _, t in flatten_with_paths(batch_tree(o))])
        outs.append(res)
    assert outs[0] == outs[1] == outs[2]


# ------------------------------------------------- SessionWindow parity

SESSION_CASES = {
    # name: (gap, delay, value kind, combine, stream kwargs)
    "int_sum": (3, 0, "int", None, {}),
    "delay_and_disorder": (4, 2, "int", None, {"jitter": 3}),
    "float_sum": (2, 1, "float", None, {"floats": True, "step": 0.7}),
    "max_combine": (3, 0, "pair", "max", {"jitter": 1}),
    "sparse_keys_long_gaps": (1, 0, "int", None, {"step": 2.0, "valid_p": 0.5}),
}


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_session_window_matches_jax(case):
    gap, delay, kind, combine, skw = SESSION_CASES[case]
    C, K = 32, 5
    batches = stream(21 + len(case), 6, C, keys=K, **skw)
    dtypes = {k: v.dtype for k, v in batches[0]["payload"].items()}
    if kind == "int":
        jfn = tfn = lambda t: t.v  # noqa: E731
    elif kind == "float":
        jfn = tfn = lambda t: {"f": t.f, "n": t.v}  # noqa: E731
    else:
        jfn = lambda t: {"hi": t.v, "t": t.ts}  # noqa: E731
        tfn = jfn
    jkw = tkw = {}
    if combine == "max":
        jkw = {"combine": jnp.maximum, "identity": -(1 << 31)}
        tkw = {"combine": torch.maximum, "identity": -(1 << 31)}
    jop = JSessionWindow(jfn, JWindowSpec.session(gap, delay), num_keys=K, **jkw)
    top = wt.SessionWindow(tfn, wt.WindowSpec.session(gap, delay), num_keys=K, **tkw,
                           **CPU)
    jc, tc, n = run_both(jop, top, dtypes, batches, C)
    assert n > 0
    assert top.drop_counters(tc.states[0]) == jop.drop_counters(jc.states[0])
    if case == "delay_and_disorder":
        assert int(jc.states[0]["old"]) > 0      # OLD stragglers were dropped


def test_session_flush_emits_once():
    C, K = 16, 3
    batches = stream(3, 2, C, keys=K)
    dtypes = {k: v.dtype for k, v in batches[0]["payload"].items()}
    top = wt.SessionWindow(lambda t: t.v, wt.WindowSpec.session(2), num_keys=K, **CPU)
    tc = wt.CompiledChain([top], tspec(dtypes), batch_capacity=C, **CPU)
    for arrs in batches:
        tc.push(both_batches(arrs)[1])
    st, out = top.flush(tc.states[0])
    assert out is not None and int(st["eos"]) == 1 and not bool(st["open"].any())
    assert top.flush(st) == (st, None)


# ---------------------------------------- mirrored test_join_operators cases

def test_interval_join_ts_extractors_batching_invariant():
    def gen(i):
        is_l = (i % 8) == 0
        return {"side": torch.where(is_l, 1, 0).to(torch.int32),
                "ev": (i // 4).to(torch.int32), "p": (i * 3).to(torch.int32)}

    def run(batch):
        src = wt.Source(gen, total=64, num_keys=1, key_fn=lambda i: i * 0,
                        ts_fn=lambda i: i // 4, **CPU)
        op = wt.IntervalJoin(lambda t: t.side == 1, 0, 2, max_matches=16,
                             ts_l=lambda t: t.ev, ts_r=lambda t: t.ev,
                             emit=lambda l, r: {"lt": l.ts, "rt": r.ts, "p": r.data["p"]},
                             **CPU)
        rows = []

        def cb(view):
            if view is None:
                return
            rows.extend(zip(np.asarray(view["payload"]["lt"]).tolist(),
                            np.asarray(view["payload"]["rt"]).tolist(),
                            np.asarray(view["payload"]["p"]).tolist()))
        wt.Pipeline(src, [op], wt.Sink(cb, **CPU), batch_size=batch, **CPU).run()
        return sorted(rows)
    a, b, c = run(8), run(16), run(64)
    assert a == b == c and a
    assert all(0 <= lt <= 16 and 0 <= rt <= 16 for lt, rt, _ in a)


def test_interval_join_match_drops_counted_when_max_matches_too_small():
    def gen(i):
        return {"side": torch.where(i == 0, 1, 0).to(torch.int32), "p": i.to(torch.int32)}
    src = wt.Source(gen, total=8, num_keys=1, key_fn=lambda i: i * 0,
                    ts_fn=lambda i: i * 0, **CPU)
    op = wt.IntervalJoin(lambda t: t.side == 1, 0, 0, max_matches=2, **CPU)
    chain = wt.CompiledChain([op], src.payload_spec(), batch_capacity=8, **CPU)
    chain.push(next(src.batches(8)))
    # the single open matches 7 same-tick bids; 2 kept, 5 counted dropped
    assert int(chain.states[0]["match_drops"]) == 5


def test_session_old_events_dropped_and_counted():
    ts_tab = torch.tensor([0, 1, 10, 11, 2, 12, 13, 14], dtype=torch.int32)
    src = wt.Source(lambda i: {"v": torch.ones((), dtype=torch.int32)}, total=8,
                    num_keys=1, ts_fn=lambda i: ts_tab[i.long()], **CPU)
    op = wt.SessionWindow(lambda t: t.v, wt.WindowSpec.session(3), num_keys=1, **CPU)
    rows = []

    def cb(view):
        if view is None:
            return
        rows.extend(zip(view["key"].tolist(), view["id"].tolist(),
                        np.asarray(view["payload"]["start"]).tolist(),
                        np.asarray(view["payload"]["end"]).tolist(),
                        np.asarray(view["payload"]["n"]).tolist()))
    wt.Pipeline(src, [op], wt.Sink(cb, **CPU), batch_size=4, **CPU).run()
    assert (0, 0, 0, 1, 2) in rows               # first session closed
    assert (0, 1, 10, 14, 5) in rows             # second session at EOS
    op.collect_stats(None)
    assert op.get_StatsRecords()[0].tuples_dropped_old == 1


def test_session_spec_requires_session_type():
    with pytest.raises(ValueError, match="session spec"):
        wt.SessionWindow(lambda t: t.v, wt.WindowSpec(10, 10, win_type_t.TB), **CPU)


def test_windowspec_session_triggerer_is_gap_dependent():
    spec = wt.WindowSpec.session(5, delay=2)
    assert spec.is_session and spec.gap == 5
    last = torch.tensor([0, 10], dtype=torch.int32)
    fired = spec.fired_session(last, torch.tensor(8, dtype=torch.int32))
    assert fired.tolist() == [True, False]


def test_session_triggerer_wraps_as_int32():
    """``wm - delay`` and ``last + gap`` wrap in int32, as XLA's do."""
    imin, imax = -(1 << 31), (1 << 31) - 1
    last = np.array([imax - 1, imin, 0, imax], np.int32)
    for wm in (imin, imin + 1, imax, 5):
        j = JWindowSpec.session(3, 2).fired_session(jnp.asarray(last), jnp.int32(wm))
        t = wt.WindowSpec.session(3, 2).fired_session(torch.from_numpy(last),
                                                      torch.tensor(wm, dtype=torch.int32))
        assert t.numpy().tolist() == np.asarray(j).tolist(), wm


def test_join_with_rejects_non_join_operator():
    g = wt.PipeGraph(batch_size=32, **CPU)
    mk = lambda: wt.Source(lambda i: {"side": (i % 2).to(torch.int32)},  # noqa: E731
                           total=64, num_keys=4, **CPU)
    a, b = g.add_source(mk()), g.add_source(mk())
    with pytest.raises(TypeError, match="StreamTableJoin/IntervalJoin"):
        a.join_with(b, wt.Map(lambda t: t.data, **CPU))


def test_unported_options_raise(monkeypatch):
    """The interval join's tiered archive (item 13b) builds, by argument and
    by ``WF_STATE_TIERED``, as a tiered SessionWindow does; event-time
    monitoring builds q4 with a lateness histogram a side, and the SLO engine
    turns on by environment too, as in the JAX package."""
    assert wt.IntervalJoin(lambda t: t.side == 1, 0, 4, tiered=True, **CPU)._tier_cfg \
        is not None
    assert wt.SessionWindow(lambda t: t.v, wt.WindowSpec.session(2), tiered=True,
                            **CPU)._tier_cfg is not None
    monkeypatch.setenv("WF_STATE_TIERED", "1")
    assert wt.IntervalJoin(lambda t: t.side == 1, 0, 4, **CPU)._tier_cfg is not None
    src, ops = tmake("q4_interval_join", 64, **CPU)
    p = wt.Pipeline(src, ops, batch_size=32, event_time=True, **CPU)
    st = next(st for st in p.chain.states if isinstance(st, dict) and "lat_l" in st)
    assert st["lat_l"].shape == st["lat_r"].shape == (32,)
    monkeypatch.setenv("WF_SLO", "1")
    from windflow_tpu.observability import MonitoringConfig as JMonitoringConfig
    assert wt.observability.MonitoringConfig.resolve(True).slo is True
    assert JMonitoringConfig.resolve(True).slo is True


# ------------------------------------------------------ convert mid-stream

@pytest.mark.parametrize("name", ["q4_interval_join", "q5_session"])
def test_state_carried_from_jax_continues_to_jax_rows(name):
    """Run half the stream in the JAX package, carry every state into the
    port with ``convert``, run the rest there: the port's outputs equal the
    JAX package's uninterrupted run, batch for batch."""
    total, C = 400, 50
    jsrc, jops = jmake(name, total)
    tsrc, tops = tmake(name, total, **CPU)
    jc = wf.CompiledChain(jops, jsrc.payload_spec(), batch_capacity=C)
    tc = wt.CompiledChain(tops, tsrc.payload_spec(), batch_capacity=C, **CPU)
    jbs = list(jsrc.batches(C))
    tbs = list(tsrc.batches(C))
    half = len(jbs) // 2
    for b in jbs[:half]:
        jc.push(b)
    convert.chain_states_from_numpy(tc, [jax.tree.map(np.asarray, s) for s in jc.states])
    for s, (jb, tb) in enumerate(zip(jbs[half:], tbs[half:])):
        assert_trees_identical(batch_tree(tc.push(tb)), batch_tree(jc.push(jb)), s)
    for jo, to in zip(jc.flush(), tc.flush()):
        assert_trees_identical(batch_tree(to), batch_tree(jo), "flush")
    for top, jst, tst in zip(tops, jc.states, tc.states):
        if jst is not None:
            assert_trees_identical(tst, jst, "final state")
            back = convert.state_to_numpy(top, tst)
            assert_trees_identical(back, jst, "state_to_numpy")


# ------------------------------------------------- q4/q5 across drivers

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


ROWS = {
    "q4_interval_join": lambda v: zip(*(np.asarray(v["payload"][f]).tolist()
                                        for f in ("auction", "open_ts", "bid_ts", "price"))),
    "q5_session": lambda v: zip(v["key"].tolist(), v["id"].tolist(),
                                *(np.asarray(x).tolist() for x in (
                                    v["payload"]["start"], v["payload"]["end"],
                                    v["payload"]["n"], v["payload"]["agg"]["bids"],
                                    v["payload"]["agg"]["spend"]))),
}

TOTAL, BATCH = 400, 50


def run_driver(name, driver):
    src, ops = tmake(name, TOTAL, **CPU)
    views = []
    sink = wt.Sink(lambda v: views.append(v) if v is not None else None, **CPU)
    if driver in ("plain", "dispatch"):
        wt.Pipeline(src, ops, sink, batch_size=BATCH, **CPU,
                    dispatch=4 if driver == "dispatch" else None).run()
    elif driver == "threaded":
        within_deadline(lambda: wt.ThreadedPipeline(src, [ops], sink, batch_size=BATCH,
                                                    pin=False, **CPU).run())
    else:
        g = wt.PipeGraph(batch_size=BATCH, **CPU)
        mp = g.add_source(src)
        for op in ops:
            mp.add(op)
        mp.add_sink(sink)
        within_deadline(lambda: g.run(threaded=driver == "graph_threaded"))
    return [(k, np.asarray(a).tobytes()) for v in views
            for k, a in sorted(_flat_view(v).items())]


def _flat_view(v, prefix="", out=None):
    out = {} if out is None else out
    for k, x in v.items():
        if isinstance(x, dict):
            _flat_view(x, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = x
    return out


@pytest.mark.parametrize("driver", ["dispatch", "wf_dispatch", "threaded", "graph",
                                    "graph_threaded"])
@pytest.mark.parametrize("name", ["q4_interval_join", "q5_session"])
def test_query_byte_identical_across_drivers(name, driver, monkeypatch):
    monkeypatch.delenv("WF_DISPATCH", raising=False)
    base = run_driver(name, "plain")
    if driver == "wf_dispatch":
        monkeypatch.setenv("WF_DISPATCH", "4")
        driver = "plain"
    assert run_driver(name, driver) == base


def two_source_q4(total):
    """q4's stream as two sources: the auction opens (event ``16 j``) and the
    bids (every other event), each with the event's fields and time."""
    from windflow_tpu_torch.nexmark import generators as g

    def opens_ev(i):
        return i * g.OPEN_EVERY

    def bids_ev(i):
        return i + i // (g.OPEN_EVERY - 1) + 1

    def source(ev, n, name):
        def gen(i):
            e = ev(i)
            is_open = (e % g.OPEN_EVERY) == 0
            auction = torch.where(is_open, (e // g.OPEN_EVERY) % g.N_AUCTIONS,
                                  g.bid_auction(e))
            return {"side": is_open.to(torch.int32), "auction": auction.to(torch.int32),
                    "price": torch.where(is_open, 0, g.bid_price(e)).to(torch.int32)}
        return wt.Source(gen, total=n, name=name,
                         key_fn=lambda i: torch.where((ev(i) % g.OPEN_EVERY) == 0,
                                                      (ev(i) // g.OPEN_EVERY) % g.N_AUCTIONS,
                                                      g.bid_auction(ev(i))),
                         ts_fn=lambda i: ev(i) // g.EVENTS_PER_TICK, **CPU)
    n_open = (total + g.OPEN_EVERY - 1) // g.OPEN_EVERY
    return source(opens_ev, n_open, "opens"), source(bids_ev, total - n_open, "bids")


@pytest.mark.parametrize("threaded", [False, True])
def test_q4_two_sources_join_with_matches_pipeline(threaded):
    opens, bids = two_source_q4(TOTAL)
    _, ops = tmake("q4_interval_join", TOTAL, **CPU)
    views = []
    g = wt.PipeGraph("q4", mode=wt.Mode.DETERMINISTIC, batch_size=BATCH, **CPU)
    a, b = g.add_source(opens), g.add_source(bids)
    a.join_with(b, ops[0]).add_sink(
        wt.Sink(lambda v: views.append(v) if v is not None else None, **CPU))
    within_deadline(lambda: g.run(threaded=threaded))
    got = sorted(r for v in views for r in ROWS["q4_interval_join"](v))
    assert got == oracles.q4_interval_join(TOTAL) and got


def test_kernel_paths_of_q4_and_q5(monkeypatch):
    """On the card q5's SessionWindow apply launches K2 14 times (its [8]-row
    tables) and K3 5 times (three fragment sums at S = C, two close counts at
    S = K), its flush nothing, and q4's IntervalJoin no kernel: counted here
    at the plain versions those wrappers stand for on the CPU."""
    from windflow_tpu_torch.ops import lookup as L, segment as S
    calls = []
    plain_l, plain_s = L.lookup_plain, S.segment_fold_plain
    monkeypatch.setattr(L, "lookup_plain",
                        lambda t, i: calls.append(("K2", t.shape[0])) or plain_l(t, i))
    monkeypatch.setattr(S, "segment_fold_plain",
                        lambda v, s, m, n: calls.append(("K3", n)) or plain_s(v, s, m, n))
    for name, C, per_apply in (("q5_session", 64, [("K2", 8)] * 14 + [("K3", 64)] * 3
                                + [("K3", 8)] * 2),
                               ("q4_interval_join", 64, [])):
        src, ops = tmake(name, 4 * C, **CPU)
        chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=C, **CPU)
        for b in src.batches(C):
            calls.clear()
            chain.push(b)
            assert sorted(calls) == sorted(per_apply), name
        calls.clear()
        chain.flush()
        assert calls == [], name

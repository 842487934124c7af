"""Keyed state in the port against the JAX package on the CPU.

The same inputs, made from a numpy seed or a source's index arithmetic, go
through the JAX package and through the port with ``device="cpu"``:

- 2-D ``table_lookup`` at K = 16, 2048 (select-reduce) and 2049 (``take``),
  with out-of-range indices, ``-0.0``, NaN and infinities: byte for byte;
- ``segment_prefix_scan`` with and without a carry table
  (``tests/test_segment_ops.py``): byte for byte on integer payloads, on
  integer-valued floats whose partial sums stay below 2^24 and with the max
  combine; on random floats within the JAX test's rtol = 1e-4, atol = 1e-5;
  on ``bench_keyed_stateful``'s stream (``v = i % 1000``, partial sums past
  2^24) within atol = 2^-21 * the largest running total, because
  the port's fixed-order prefix sum and XLA's cumsum round in other orders;
- Accumulator (``tests/test_keyed_state.py``: rolling sum, batch-size
  invariance, max) and ``bench_keyed_stateful``'s chain at K = 1 and 500;
  KeyedMap (the counter with duplicate keys, the in-order fold, the
  ``max_key_multiplicity=1`` promise; ``tests/test_stats_and_guards.py``);
  FlatMap ids, keys, timestamps and valid masks; general ReduceSink
  combines; ``examples/01_wordcount.py``'s graph, all byte for byte;
- states carried from the JAX package into the port with ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.batch import Batch as JBatch
from windflow_tpu.ops import lookup as jl, segment as js
from windflow_tpu.operators.accumulator import Accumulator as JAccumulator
from windflow_tpu.operators.map import KeyedMap as JKeyedMap
from windflow_tpu_torch import convert
from windflow_tpu_torch.benchmarks import keyed
from windflow_tpu_torch.ops import lookup as tl, segment as ts

CPU = {"device": "cpu"}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bytes_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ----------------------------------------------------------------- 2-D lookup

@pytest.mark.parametrize("K", [1, 16, 2048, 2049])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_table_lookup_2d_matches_jax(K, dtype):
    """[K, 3] tables: rows, 0 out of range, ``-0.0`` read as ``+0.0`` (a
    one-row table keeps it) up to 2048 rows; ``jnp.take``'s wrap and fill
    above. Eager and jitted JAX agree; the port's traced and concrete routes
    give the same."""
    rng = np.random.default_rng(K)
    table = rng.integers(-50, 50, (K, 3)).astype(dtype)
    if dtype == np.float32:
        table[::3] = -0.0
        table[1::5, 1] = np.nan
        table[2::7, 2] = -np.inf
    idx = rng.integers(-K - 5, K + 5, 4000).astype(np.int32)
    want = np.asarray(jl.table_lookup(jnp.asarray(table), jnp.asarray(idx)))
    _bytes_equal(np.asarray(jax.jit(jl.table_lookup)(jnp.asarray(table), jnp.asarray(idx))),
                 want)
    for traced in (False, True):
        _bytes_equal(tl.table_lookup(_t(table), _t(idx), traced=traced).numpy(), want)


def test_table_lookup_3d_takes_take():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(8, 2, 2)).astype(np.float32)
    idx = np.array([0, 7, -1, -8, 8, -9, 3], np.int32)
    _bytes_equal(tl.table_lookup(_t(table), _t(idx)).numpy(),
                 np.asarray(jl.table_lookup(jnp.asarray(table), jnp.asarray(idx))))


# -------------------------------------------------------- segment_prefix_scan

def _random_batch(rng, c, k):
    keys = rng.integers(0, k, size=c).astype(np.int32)
    return keys, rng.normal(size=c).astype(np.float32), rng.random(c) < 0.8


def _scan(pkg, vals, keys, valid, combine, identity=0, carry=None):
    if pkg == "jax":
        out = js.segment_prefix_scan(
            jax.tree.map(jnp.asarray, vals), jnp.asarray(keys), jnp.asarray(valid),
            combine, identity, carry_in=None if carry is None else jax.tree.map(
                jnp.asarray, carry))
        return jax.tree.map(np.asarray, out)
    out = ts.segment_prefix_scan(
        jax.tree.map(_t, vals), _t(keys), _t(valid), combine, identity,
        carry_in=None if carry is None else jax.tree.map(_t, carry))
    return jax.tree.map(lambda t: t.numpy(), out)


@pytest.mark.parametrize("with_carry", [False, True])
def test_prefix_scan_random_floats_stream_order(with_carry):
    """test_segment_prefix_scan_stream_order / _with_carry: the numpy running
    sum and the JAX package, within rtol = 1e-4, atol = 1e-5."""
    rng = np.random.default_rng(3 if with_carry else 2)
    keys, vals, valid = _random_batch(rng, 101, 5)
    carry = np.arange(5, dtype=np.float32) * 100 if with_carry else None
    got = _scan("port", vals, keys, valid, torch.add, carry=carry)
    want = _scan("jax", vals, keys, valid, jnp.add, carry=carry)
    run = dict(enumerate(carry)) if with_carry else {}
    for i, (k, v, ok) in enumerate(zip(keys, vals, valid)):
        if ok:
            run[k] = run.get(k, 0.0) + v
            np.testing.assert_allclose(got[i], run[k], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_carry", [False, True])
def test_prefix_scan_exact_cases_byte_for_byte(with_carry):
    """int32 payloads (wrapping sums), integer-valued floats below 2^24, a
    [C, 3] payload with a [K, 3] carry (the 2-D lookup), and the max
    combine: byte for byte on the valid lanes."""
    rng = np.random.default_rng(7)
    C, K = 513, 9
    keys = rng.integers(0, K, C).astype(np.int32)
    valid = rng.random(C) < 0.85
    cases = [
        (rng.integers(-2 ** 31, 2 ** 31, C).astype(np.int32), "add",
         rng.integers(-2 ** 31, 2 ** 31, K).astype(np.int32)),
        (rng.integers(0, 1000, C).astype(np.float32), "add",
         rng.integers(0, 10 ** 5, K).astype(np.float32)),
        (rng.integers(-99, 99, (C, 3)).astype(np.float32), "add",
         rng.integers(-99, 99, (K, 3)).astype(np.float32)),
        (rng.normal(size=C).astype(np.float32), "max", rng.normal(size=K).astype(np.float32)),
    ]
    for vals, comb, carry in cases:
        carry = carry if with_carry else None
        tc, jc, ident = ((torch.add, jnp.add, 0) if comb == "add" else
                         (torch.maximum, jnp.maximum, -1e30))
        got = _scan("port", vals, keys, valid, tc, ident, carry)
        want = _scan("jax", vals, keys, valid, jc, ident, carry)
        _bytes_equal(got[valid], want[valid])


def test_prefix_scan_bench_stream_within_prefix_tolerance():
    """``bench_keyed_stateful``'s values (i % 1000, float32) over 2^16 lanes:
    partial sums reach 3.3e7, past float32's exact integers, where the
    port's fixed-order prefix sum and XLA's cumsum round differently. Held
    within atol = 2^-21 * max|global cumsum| of the JAX package and of
    float64; the int32 form of the same stream is byte for byte."""
    C = 1 << 16
    i = np.arange(C)
    for K in (1, 7, 500):
        keys = (i % K).astype(np.int32)
        valid = np.ones(C, bool)
        vals = (i % 1000).astype(np.float32)
        atol = 2.0 ** -21 * float(np.cumsum(vals.astype(np.float64)).max())
        got = _scan("port", vals, keys, valid, torch.add)
        np.testing.assert_allclose(got, _scan("jax", vals, keys, valid, jnp.add),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(got, keyed.keyed_stateful_oracle(K, C), rtol=0, atol=atol)
        iv = vals.astype(np.int32)
        _bytes_equal(_scan("port", iv, keys, valid, torch.add),
                     _scan("jax", iv, keys, valid, jnp.add))


# ---------------------------------------------------------------- Accumulator

def _sink_rows(out):
    def cb(view):
        if view is not None:
            out.extend(zip(np.asarray(view["key"]).tolist(), np.asarray(view["id"]).tolist(),
                           np.asarray(view["payload"]).tolist()))
    return cb


def _acc_run(pkg, total, K, batch, fn, **kw):
    """Sink rows (key, id, accumulator) and the final table."""
    out = []
    if pkg == "jax":
        src = wf.Source(lambda i: {"v": fn(i).astype(jnp.float32)}, total=total, num_keys=K)
        op = wf.Accumulator(lambda t: t.v, num_keys=K, **kw)
        p = wf.Pipeline(src, [op], wf.Sink(_sink_rows(out)), batch_size=batch)
    else:
        kw = {k: (torch.maximum if v is jnp.maximum else v) for k, v in kw.items()}
        src = wt.Source(lambda i: {"v": fn(i).float()}, total=total, num_keys=K, **CPU)
        op = wt.Accumulator(lambda t: t.v, num_keys=K, **kw, **CPU)
        p = wt.Pipeline(src, [op], wt.Sink(_sink_rows(out), **CPU), batch_size=batch, **CPU)
    p.run()
    return sorted(out), np.asarray(p.chain.states[0])


def test_accumulator_rolling_sum_per_key():
    """test_accumulator_rolling_sum_per_key: every tuple's running sum, in
    stream order per key, byte for byte with the JAX package and equal to
    the sequential fold."""
    total, K = 300, 5
    got, _ = _acc_run("port", total, K, 64, lambda i: i % 7, init_value=0.0)
    assert got == _acc_run("jax", total, K, 64, lambda i: i % 7, init_value=0.0)[0]
    want = []
    run = dict.fromkeys(range(K), 0.0)
    for i in range(total):
        run[i % K] += float(i % 7)
        want.append((i % K, i, run[i % K]))
    assert got == sorted(want)


def test_accumulator_invariant_under_batch_size():
    total, K = 211, 3
    finals = [_acc_run("port", total, K, bs, lambda i: i * 0 + 1)[1] for bs in (32, 211, 512)]
    want = _acc_run("jax", total, K, 32, lambda i: i * 0 + 1)[1]
    for f in finals:
        _bytes_equal(f, want)
    np.testing.assert_array_equal(finals[0], [len(range(k, total, K)) for k in range(K)])


def test_accumulator_custom_combine_max():
    total, K = 100, 4
    kw = {"combine": jnp.maximum, "identity": -1e30, "init_value": -1e30}
    got = _acc_run("port", total, K, 33, lambda i: (i * 37) % 91, **kw)
    want = _acc_run("jax", total, K, 33, lambda i: (i * 37) % 91, **kw)
    assert got[0] == want[0]
    _bytes_equal(got[1], want[1])


def _stateful(pkg, K, total, batch, dtype):
    """bench_keyed_stateful's chain: sink rows and the ReduceSink total."""
    out = []
    if pkg == "jax":
        from windflow_tpu.operators.sink import ReduceSink
        jdt = jnp.float32 if dtype == torch.float32 else jnp.int32
        src = wf.Source(lambda i: {"v": (i % 1000).astype(jdt)}, total=total, num_keys=K)
        ops = [JAccumulator(lambda t: t.data["v"], init_value=0, num_keys=max(K, 8)),
               ReduceSink(lambda t: t.data, name="keyed_stateful_total")]
        res = wf.Pipeline(src, ops, wf.Sink(_sink_rows(out)), batch_size=batch).run()
    else:
        src, ops = keyed.make_keyed_stateful(K, total, dtype=dtype, **CPU)
        res = wt.Pipeline(src, ops, wt.Sink(_sink_rows(out), **CPU), batch_size=batch,
                          **CPU).run()
    return sorted(out), np.asarray(res["keyed_stateful_total"])


@pytest.mark.parametrize("K", [1, 500])
def test_keyed_stateful_chain_matches_jax(K):
    """``make_keyed_stateful`` against the JAX chain of
    ``bench_keyed_stateful`` over 3 batches of 4096: the per-tuple running
    sums byte for byte, int32 and float32 (partial sums reach 6.1e6 here,
    exact below 2^24, so both also equal float64); the ReduceSink total of
    the float32 sums (3.7e10, rounded in another order) within
    rtol = 1e-6."""
    total, batch = 3 * 4096, 4096
    got, tot = _stateful("port", K, total, batch, torch.int32)
    want, wtot = _stateful("jax", K, total, batch, torch.int32)
    assert got == want
    _bytes_equal(tot, wtot)
    by_id = lambda rows: sorted(rows, key=lambda r: r[1])  # noqa: E731
    got, tot = _stateful("port", K, total, batch, torch.float32)
    want, wtot = _stateful("jax", K, total, batch, torch.float32)
    got = by_id(got)
    assert got == by_id(want)
    assert [r[:2] for r in got] == [(i % K, i) for i in range(total)]
    assert [r[2] for r in got] == keyed.keyed_stateful_oracle(K, total).tolist()
    np.testing.assert_allclose(tot, wtot, rtol=1e-6)


# ------------------------------------------------------------------ KeyedMap

def _counter(X):
    return lambda t, st: ({"n": st + 1}, st + 1)


def test_keyed_map_stateful_counter():
    """test_keyed_map_stateful_counter: duplicate keys in every batch take the
    in-order rounds; the counters equal the JAX package's and 1..n a key."""
    total, K = 120, 4
    runs = {}
    for X in ("jax", "port"):
        out = []

        def cb(view):
            if view is not None:
                out.extend(zip(np.asarray(view["key"]).tolist(), np.asarray(view["id"]).tolist(),
                               np.asarray(view["payload"]["n"]).tolist()))
        if X == "jax":
            src = wf.Source(lambda i: {"v": i.astype(jnp.int32)}, total=total, num_keys=K)
            km = wf.KeyedMap(_counter(X), init_state_value=jnp.zeros((), jnp.int32),
                             num_keys=K)
            wf.Pipeline(src, [km], wf.Sink(cb), batch_size=32).run()
        else:
            src = wt.Source(lambda i: {"v": i}, total=total, num_keys=K, **CPU)
            km = wt.KeyedMap(_counter(X), init_state_value=0, num_keys=K, **CPU)
            wt.Pipeline(src, [km], wt.Sink(cb, **CPU), batch_size=32, **CPU).run()
        runs[X] = sorted(out)
    assert runs["port"] == runs["jax"] and len(runs["port"]) == total
    by_key = {}
    for k, _, n in runs["port"]:
        by_key.setdefault(k, []).append(n)
    assert all(ns == list(range(1, len(ns) + 1)) for ns in by_key.values())


def _dup_batch(X):
    k = [1, 1, 2]
    if X == "jax":
        return JBatch(key=jnp.asarray(k, jnp.int32), id=jnp.arange(3, dtype=jnp.int32),
                      ts=jnp.arange(3, dtype=jnp.int32),
                      payload={"v": jnp.asarray([1.0, 2.0, 3.0], jnp.float32)},
                      valid=jnp.ones(3, bool))
    return wt.Batch.of({"v": np.array([1.0, 2.0, 3.0], np.float32)}, key=k,
                       id=[0, 1, 2], ts=[0, 1, 2], **CPU)


def _sum_map(X, **kw):
    f = lambda t, s: ({"v": s + t.v}, s + t.v)  # noqa: E731
    if X == "jax":
        return JKeyedMap(f, jnp.float32(0), num_keys=4, **kw)
    return wt.KeyedMap(f, 0.0, num_keys=4, **kw, **CPU)


def test_keyed_map_folds_duplicates_in_order_and_vector_state():
    """test_keyed_map_folds_duplicates_in_order_even_unordered (key 1: 1 then
    3; key 2: 3), and a [K, 2] state table (the 2-D lookup), both packages."""
    op, jop = _sum_map("port", ordered=False), _sum_map("jax", ordered=False)
    st, out = op.apply(op.init_state({"v": torch.zeros(())}), _dup_batch("port"))
    jst, jout = jax.jit(jop.apply)(jop.init_state({"v": jax.ShapeDtypeStruct((), jnp.float32)}),
                                   _dup_batch("jax"))
    _bytes_equal(out.payload["v"].numpy(), np.asarray(jout.payload["v"]))
    np.testing.assert_array_equal(out.payload["v"].numpy(), [1.0, 3.0, 3.0])
    _bytes_equal(st["tbl"].numpy(), np.asarray(jst["tbl"]))
    vec = lambda t, s: ({"v": s.sum() + t.v}, s + t.v)  # noqa: E731
    op = wt.KeyedMap(vec, np.zeros(2, np.float32), num_keys=4, **CPU)
    jop = JKeyedMap(vec, jnp.zeros(2, jnp.float32), num_keys=4)
    st, out = op.apply(op.init_state(None), _dup_batch("port"))
    jst, jout = jax.jit(jop.apply)(jop.init_state(None), _dup_batch("jax"))
    _bytes_equal(out.payload["v"].numpy(), np.asarray(jout.payload["v"]))
    _bytes_equal(st["tbl"].numpy(), np.asarray(jst["tbl"]))


def test_keyed_map_promise():
    """max_key_multiplicity=1: kept, one round and a clean flush; violated, the
    CPU reports at apply (the JAX package's early report) and the flag
    latched in the state raises at flush (the card's only report)."""
    op = _sum_map("port", max_key_multiplicity=1)
    st0 = op.init_state(None)
    b = wt.Batch.of({"v": np.ones(3, np.float32)}, key=[0, 1, 2], id=[0, 1, 2],
                    ts=[0, 1, 2], **CPU)
    st, out = op.apply(st0, b)
    np.testing.assert_array_equal(out.payload["v"].numpy(), [1.0, 1.0, 1.0])
    assert op.flush(st) == (st, None)
    with pytest.raises(ValueError, match="max_key_multiplicity"):
        op.apply(st0, _dup_batch("port"))
    with pytest.raises(ValueError, match="max_key_multiplicity"):
        op.flush({"tbl": st["tbl"], "bad": torch.ones((), dtype=torch.bool)})


# ------------------------------------------------------------------- FlatMap

def _fm(t, shipper):
    shipper.push({"v": t.v})
    shipper.push({"v": -t.v}, when=t.id % 2 == 0, key=t.key + 1)
    shipper.push({"v": t.v * 2}, when=t.v > 20, ts=t.ts * 3)


def test_flatmap_ids_keys_and_masks_match_jax():
    """Capacity C * F, ids id * F + j, pushed keys and timestamps, the masks
    (``when`` and the input's valid lanes): byte for byte; and
    test_flatmap_fanout's output count."""
    C = 40
    rng = np.random.default_rng(9)
    v = rng.integers(0, 40, C).astype(np.float32)
    key, ids, tss = rng.integers(0, 5, C), np.arange(C) * 3, np.arange(C) * 7
    valid = rng.random(C) < 0.7
    op = wt.FlatMap(_fm, max_fanout=3, **CPU)
    _, out = op.apply(None, wt.Batch.of({"v": v}, key=key, id=ids, ts=tss, valid=valid, **CPU))
    jop = wf.FlatMap(_fm, max_fanout=3)
    _, jout = jax.jit(jop.apply)(None, JBatch(
        key=jnp.asarray(key, jnp.int32), id=jnp.asarray(ids, jnp.int32),
        ts=jnp.asarray(tss, jnp.int32), payload={"v": jnp.asarray(v)},
        valid=jnp.asarray(valid)))
    assert out.capacity == op.out_capacity(C) == 3 * C
    for f in ("key", "id", "ts", "valid"):
        _bytes_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)))
    _bytes_equal(out.payload["v"].numpy()[out.valid.numpy()],
                 np.asarray(jout.payload["v"])[np.asarray(jout.valid)])
    total = 50
    fan = lambda t, sh: (sh.push({"v": t.v}), sh.push({"v": -t.v}, when=t.id % 2 == 0))  # noqa: E731
    res = wt.Pipeline(wt.Source(lambda i: {"v": i.float()}, total=total, **CPU),
                      [wt.FlatMap(fan, max_fanout=2, **CPU),
                       wt.ReduceSink(lambda t: torch.ones((), dtype=torch.int32), **CPU)],
                      batch_size=16, **CPU).run()
    assert int(res["reduce_sink"]) == total + total // 2


def _wordcount(pkg, total=3000, vocab=50):
    """examples/01_wordcount.py's graph: {word: final rolling count}."""
    counts = {}

    def sink(view):
        if view is not None:
            for k, v in zip(np.asarray(view["key"]).tolist(),
                            np.asarray(view["payload"]).tolist()):
                counts[k] = v

    def split(t, shipper):
        for j in range(3):
            shipper.push({"word": t.w[j]})
    if pkg == "jax":
        g = wf.PipeGraph("wordcount", batch_size=256)
        (g.add_source(wf.Source(lambda i: {"w": jnp.stack(
            [(i * 7) % vocab, (i * 13) % vocab, (i * 29) % vocab])}, total=total))
         .add(wf.FlatMap(split, max_fanout=3))
         .add(wf.Map(lambda t: {"one": jnp.ones((), jnp.int32), "word": t.word}))
         .add(wf.KeyBy(lambda t: t.word, num_keys=vocab))
         .add(wf.Accumulator(lambda t: t.data["one"], init_value=0, num_keys=vocab))
         .add_sink(wf.Sink(sink)))
    else:
        g = wt.PipeGraph("wordcount", batch_size=256, **CPU)
        (g.add_source(wt.Source(lambda i: {"w": torch.stack(
            [(i * 7) % vocab, (i * 13) % vocab, (i * 29) % vocab])}, total=total, **CPU))
         .add(wt.FlatMap(split, max_fanout=3, **CPU))
         .add(wt.Map(lambda t: {"one": torch.ones((), dtype=torch.int32), "word": t.word},
                     **CPU))
         .add(wt.KeyBy(lambda t: t.word, num_keys=vocab, **CPU))
         .add(wt.Accumulator(lambda t: t.data["one"], init_value=0, num_keys=vocab, **CPU))
         .add_sink(wt.Sink(sink, **CPU)))
    g.run()
    return {k: int(v) for k, v in counts.items()}


def test_wordcount_graph_matches_jax_and_oracle():
    got = _wordcount("port")
    want = {}
    for i in range(3000):
        for w in ((i * 7) % 50, (i * 13) % 50, (i * 29) % 50):
            want[w] = want.get(w, 0) + 1
    assert got == _wordcount("jax") == want


# --------------------------------------------------------------- ReduceSink

@pytest.mark.parametrize("case", ["xor", "max_lambda", "min_vector"])
def test_reduce_sink_general_combines_match_jax(case):
    """Combines other than add/maximum/minimum fold each batch with the
    pairwise tree and then into the accumulator; exact combines give the JAX
    package's bits."""
    total, batch = 777, 64
    spec = {
        "xor": (lambda t: t.x, jnp.bitwise_xor, torch.bitwise_xor, 0),
        "max_lambda": (lambda t: t.f, lambda a, b: jnp.maximum(a, b),
                       lambda a, b: torch.maximum(a, b), -1e30),
        "min_vector": (lambda t: t.vec, lambda a, b: jnp.minimum(a, b),
                       lambda a, b: torch.minimum(a, b), 1e30),
    }[case]
    value_fn, jcomb, tcomb, ident = spec

    def src(X):
        if X == "jax":
            return wf.Source(lambda i: {"x": (i * 7919) % 1000003, "f": (
                (i * 37) % 91).astype(jnp.float32), "vec": jnp.stack(
                [(i * 7) % 53, (i * 11) % 59]).astype(jnp.float32)}, total=total)
        return wt.Source(lambda i: {"x": (i * 7919) % 1000003, "f": (
            (i * 37) % 91).float(), "vec": torch.stack(
            [(i * 7) % 53, (i * 11) % 59]).float()}, total=total, **CPU)
    got = wt.Pipeline(src("port"), [wt.ReduceSink(value_fn, combine=tcomb, identity=ident,
                                                  name="r", **CPU)],
                      batch_size=batch, **CPU).run()["r"]
    want = wf.Pipeline(src("jax"), [wf.ReduceSink(value_fn, combine=jcomb, identity=ident,
                                                  name="r")], batch_size=batch).run()["r"]
    _bytes_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- convert

def _keyed_chain(pkg, which, total=240, batch=40):
    if pkg == "jax":
        src = wf.Source(lambda i: {"v": (i % 13).astype(jnp.int32)}, total=total, num_keys=5)
        op = (wf.KeyedMap(lambda t, s: ({"n": s + t.v}, s + t.v), jnp.zeros((), jnp.int32),
                          num_keys=5) if which == "keyed_map" else
              wf.Accumulator(lambda t: t.v, init_value=0, num_keys=5))
        return src, wf.CompiledChain([op], src.payload_spec(), batch_capacity=batch)
    src = wt.Source(lambda i: {"v": (i % 13).int()}, total=total, num_keys=5, **CPU)
    op = (wt.KeyedMap(lambda t, s: ({"n": s + t.v}, s + t.v), 0, num_keys=5, **CPU)
          if which == "keyed_map" else wt.Accumulator(lambda t: t.v, init_value=0,
                                                       num_keys=5, **CPU))
    return src, wt.CompiledChain([op], src.payload_spec(), batch_capacity=batch, **CPU)


@pytest.mark.parametrize("which", ["keyed_map", "accumulator"])
def test_keyed_states_carried_from_jax(which):
    """A KeyedMap's ``{"tbl", "bad"}`` and an Accumulator's table carried
    from the JAX package mid-stream (and back unchanged); the port's final
    state equals the JAX-only run's."""
    def push(pkg, src, chain, starts):
        for s in starts:
            chain.push(src.make_batch(jnp.asarray(s, jnp.int32) if pkg == "jax" else s, 40))
    starts = list(range(0, 240, 40))
    jsrc, jchain = _keyed_chain("jax", which)
    push("jax", jsrc, jchain, starts)
    want = jax.tree.map(np.asarray, jchain.states[0])
    jsrc, jchain = _keyed_chain("jax", which)
    push("jax", jsrc, jchain, starts[:2])
    host = [jax.tree.map(np.asarray, s) for s in jchain.states]
    tsrc, tchain = _keyed_chain("port", which)
    convert.chain_states_from_numpy(tchain, host)
    back = convert.chain_states_to_numpy(tchain)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        _bytes_equal(b, a)
    push("port", tsrc, tchain, starts[2:])
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(convert.chain_states_to_numpy(tchain))):
        _bytes_equal(b, a)

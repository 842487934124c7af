"""The port's core batch protocol, compaction, emitters, stateless operators,
sources, builders and async sink against the JAX package on the CPU.

Inputs are made from a numpy seed and handed to both packages; every
comparison is byte for byte (integer data, or float values compared as their
bits). Mirrors ``tests/test_parallel.py`` (the emitter cases),
``tests/test_generator_source.py``, ``tests/test_stateless_slice.py``,
``tests/test_builder_hints.py`` and ``tests/test_async_sink*.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import batch as jbatch
from windflow_tpu.basic import routing_modes_t as jroute
from windflow_tpu.ops import compaction as jcomp
from windflow_tpu.parallel import emitters as jem
from windflow_tpu_torch import batch as tbatch
from windflow_tpu_torch.basic import opt_level_t, routing_modes_t as troute
from windflow_tpu_torch.ops import compaction as tcomp
from windflow_tpu_torch.parallel import emitters as tem
from windflow_tpu_torch.runtime.builders import (Map_Builder, ReduceSink_Builder,
                                                 Source_Builder)
from windflow_tpu_torch.runtime.pipeline import resolve_batch_hint

CPU = {"device": "cpu"}


def cols(seed, C=64, K=8, valid_p=0.7):
    rng = np.random.default_rng(seed)
    return {"key": rng.integers(0, K, C).astype(np.int32),
            "id": np.arange(C, dtype=np.int32),
            "ts": rng.integers(0, 50, C).astype(np.int32),
            "v": rng.normal(size=C).astype(np.float32),
            "w": rng.integers(-9, 9, (C, 3)).astype(np.int32),
            "valid": rng.random(C) < valid_p}


def both_batches(c):
    pay = lambda f: {"v": f(c["v"]), "w": f(c["w"])}  # noqa: E731
    jb = jbatch.Batch(key=jnp.asarray(c["key"]), id=jnp.asarray(c["id"]),
                      ts=jnp.asarray(c["ts"]), payload=pay(jnp.asarray),
                      valid=jnp.asarray(c["valid"]))
    tb = tbatch.Batch(key=torch.from_numpy(c["key"]), id=torch.from_numpy(c["id"]),
                      ts=torch.from_numpy(c["ts"]), payload=pay(torch.from_numpy),
                      valid=torch.from_numpy(c["valid"]))
    return jb, tb


def bits(b, jax_side):
    """Every lane of a batch (valid or not) as bytes per field."""
    a = np.asarray if jax_side else (lambda x: x.numpy())
    out = {f: a(getattr(b, f)).tobytes() for f in ("key", "id", "ts", "valid")}
    out.update({k: a(v).tobytes() for k, v in b.payload.items()})
    return out


def live_bits(b, jax_side):
    a = np.asarray if jax_side else (lambda x: x.numpy())
    v = a(b.valid)
    out = {f: a(getattr(b, f))[v].tobytes() for f in ("key", "id", "ts")}
    out.update({k: a(x)[v].tobytes() for k, x in b.payload.items()})
    return out


# ---- batch.py ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_compact_select_sorted_by_match_jax(seed):
    c = cols(seed)
    jb, tb = both_batches(c)
    assert bits(tb.compact(), False) == bits(jb.compact(), True)
    for by in ("ts", "id"):
        assert bits(tb.sorted_by(by=by), False) == bits(jb.sorted_by(by=by), True)
    rng = np.random.default_rng(seed + 10)
    idx = rng.integers(0, 64, 40).astype(np.int32)
    keep = rng.random(40) < 0.5
    assert bits(tb.select(torch.from_numpy(idx), torch.from_numpy(keep)), False) == \
        bits(jb.select(jnp.asarray(idx), jnp.asarray(keep)), True)
    assert int(tb.count()) == int(jb.count())


def test_concat_and_split_batch_match_jax():
    (ja, ta), (jb_, tb_) = both_batches(cols(2)), both_batches(cols(3))
    jc, tc = jbatch.concat_batches(ja, jb_), tbatch.concat_batches(ta, tb_)
    assert bits(tc, False) == bits(jc, True)
    for cap in (16, 32, 128):
        jp, tp = jbatch.split_batch(jc, cap), tbatch.split_batch(tc, cap)
        assert [bits(t, False) for t in tp] == [bits(j, True) for j in jp]
    for bad in (0, 7, 256):
        with pytest.raises(ValueError, match="does not divide"):
            tbatch.split_batch(tc, bad)


def test_trace_meta_rides_on_the_object_only():
    _, tb = both_batches(cols(4))
    assert wt.trace_meta(tb) is None
    object.__setattr__(tb, wt.TRACE_META_ATTR, 17)
    assert wt.trace_meta(tb) == 17
    assert wt.trace_meta(tb.replace(valid=tb.valid)) is None
    assert wt.trace_meta(tbatch.split_batch(tb, 32)[0]) is None


def test_mutable_tuple_ref():
    ref = tbatch.TupleRef(key=torch.tensor(1), id=torch.tensor(2), ts=torch.tensor(3),
                          data={"v": torch.tensor(4.0)})
    m = tbatch.MutableTupleRef(ref)
    m.v = m.v * 2
    m.extra = m.id + 1
    assert m._payload() == {"v": torch.tensor(8.0), "extra": torch.tensor(3)}
    with pytest.raises(TypeError, match="read-only"):
        m.key = 5
    with pytest.raises(TypeError, match="dict payload"):
        tbatch.MutableTupleRef(tbatch.TupleRef(key=1, id=2, ts=3, data=(1, 2)))


@pytest.mark.parametrize("keys", [
    ["alpha", "beta", "gamma", "alpha", ""], [b"alpha", b"beta", b"\x00\xff"],
    [0, 2, 3, 10, 12345, 2 ** 40 + 7, 2 ** 63 - 1, -1, -(2 ** 40), 2 ** 70 + 3]],
    ids=["str", "bytes", "ints"])
@pytest.mark.parametrize("n", [3, 8, 1000])
def test_hash_key_to_slot_matches_jax(keys, n):
    """Scalars, numpy arrays (int64, uint64, strings, bytes, objects): the
    same slots as the JAX package (FNV-1a, Knuth multiply in uint64
    wraparound)."""
    for k in keys:
        assert tbatch.hash_key_to_slot(k, n) == jbatch.hash_key_to_slot(k, n)
    ints = [k for k in keys if isinstance(k, int)]
    arrays = [np.asarray(keys, dtype=object)]
    if ints and all(-(2 ** 63) <= k < 2 ** 63 for k in ints):
        arrays.append(np.asarray(ints, np.int64))
    if ints and all(0 <= k < 2 ** 64 for k in ints):
        arrays.append(np.asarray(ints, np.uint64))
    if not ints:
        arrays.append(np.asarray(keys))
    for arr in arrays:
        got = tbatch.hash_key_to_slot(arr, n)
        want = jbatch.hash_key_to_slot(arr, n)
        assert np.asarray(got).tolist() == np.asarray(want).tolist()
        assert [tbatch.hash_key_to_slot(k, n) for k in arr.tolist()] == \
            np.asarray(got).tolist()
    with pytest.raises(TypeError, match="float"):
        tbatch.hash_key_to_slot(np.asarray([1.2, 1.9]), 4)


# ---- ops/compaction.py --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compaction_matches_jax(seed):
    rng = np.random.default_rng(seed)
    C = int(rng.integers(8, 100))
    valid = rng.random(C) < 0.6
    x = rng.integers(0, 5, C).astype(np.int32)
    vals = {"a": rng.normal(size=C).astype(np.float32),
            "b": rng.integers(-5, 5, (C, 2)).astype(np.int32)}
    t, j = torch.from_numpy, jnp.asarray
    eq = lambda got, want: np.testing.assert_array_equal(  # noqa: E731
        got.numpy(), np.asarray(want))
    eq(tcomp.exclusive_scan(t(x)), jcomp.exclusive_scan(j(x)))
    for g, w in zip(tcomp.compact_indices(t(valid)), jcomp.compact_indices(j(valid))):
        eq(g, w)
    for cap in (None, C // 2):
        gp, gv = tcomp.scatter_compact({k: t(v) for k, v in vals.items()}, t(valid), cap)
        wp, wv = jcomp.scatter_compact({k: j(v) for k, v in vals.items()}, j(valid), cap)
        eq(gv, wv)
        for k in vals:
            eq(gp[k], wp[k])
    dest = rng.integers(-2, 6, C).astype(np.int32)     # out-of-range destinations drop
    for fn_t, fn_j in ((tcomp.partition_by_destination, jcomp.partition_by_destination),
                       (tcomp.partition_by_destination_onehot,
                        jcomp.partition_by_destination_onehot)):
        for cap in (3, C):
            got = fn_t(t(dest), t(valid), 4, cap, return_counts=True)
            want = fn_j(j(dest), j(valid), 4, cap, return_counts=True)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32 or g.dtype == torch.bool
                eq(g, w)


# ---- parallel/emitters.py (tests/test_parallel.py) -----------------------------------

def _batch(total, C, K):
    ids = np.arange(C, dtype=np.int32)
    return both_batches({"key": ids % K, "id": ids, "ts": ids,
                         "v": (ids % 13).astype(np.float32),
                         "w": np.zeros((C, 3), np.int32), "valid": np.arange(C) < total})


def _same_routes(touts, jouts):
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert (t is None) == (j is None)
        if t is not None:
            assert live_bits(t, False) == live_bits(j, True)


def test_standard_emitter_keyby_and_variants_match_jax():
    jb, tb = _batch(96, 96, 8)
    for part in ("sort", "onehot"):
        touts = tem.Standard_Emitter(4, troute.KEYBY, partition=part).route(tb)
        jouts = jem.Standard_Emitter(4, jroute.KEYBY, partition=part).route(jb)
        _same_routes(touts, jouts)
        for d, ob in enumerate(touts):
            assert bool((ob.key[ob.valid] % 4 == d).all())
    with pytest.raises(ValueError, match="partition"):
        tem.Standard_Emitter(2, troute.KEYBY, partition="hash")


@pytest.mark.parametrize("trial", range(6))
def test_standard_emitter_overflow_lossless_matches_jax(trial):
    """capacity_per_dest below a destination's share: the residue is
    re-partitioned in further passes, nothing is lost, and the sub-batches
    equal the JAX package's."""
    rng = np.random.default_rng(23 + trial)
    C = int(rng.integers(8, 128))
    n_dest, cap = int(rng.integers(2, 6)), int(rng.integers(1, 8))
    c = cols(100 + trial, C=C, K=int(rng.integers(1, 12)), valid_p=0.85)
    jb, tb = both_batches(c)
    te = tem.Standard_Emitter(n_dest, troute.KEYBY, capacity_per_dest=cap)
    je = jem.Standard_Emitter(n_dest, jroute.KEYBY, capacity_per_dest=cap)
    touts, jouts = te.route(tb), je.route(jb)
    _same_routes(touts, jouts)
    assert te.overflow_rounds == je.overflow_rounds
    got = sorted(i for ob in touts for i in ob.id[ob.valid].tolist())
    assert got == [i for i in range(C) if c["valid"][i]]


def test_forward_broadcast_splitting_and_tree_emitters_match_jax():
    jb, tb = _batch(32, 32, 4)
    fwd_t, fwd_j = tem.Standard_Emitter(3), jem.Standard_Emitter(3)
    for _ in range(4):
        _same_routes(fwd_t.route(tb), fwd_j.route(jb))
    tree_t = tem.Tree_Emitter(tem.Broadcast_Emitter(2),
                              [tem.Standard_Emitter(2, troute.KEYBY)] * 2)
    tree_j = jem.Tree_Emitter(jem.Broadcast_Emitter(2),
                              [jem.Standard_Emitter(2, jroute.KEYBY)] * 2)
    touts = tree_t.route(tb)
    _same_routes(touts, tree_j.route(jb))
    assert sum(int(o.valid.sum()) for o in touts) == 64
    split_t = tem.Splitting_Emitter(lambda t: torch.stack([t.v > 3, t.key == 1]), 2)
    split_j = jem.Splitting_Emitter(lambda t: jnp.stack([t.v > 3, t.key == 1]), 2)
    _same_routes(split_t.route(tb), split_j.route(jb))
    split_t = tem.Splitting_Emitter(lambda t: (t.key % 3).to(torch.int32), 3)
    split_j = jem.Splitting_Emitter(lambda t: (t.key % 3).astype(jnp.int32), 3)
    _same_routes(split_t.route(tb), split_j.route(jb))
    assert tem._pad_batch_pow2(tb).capacity == 32
    assert bits(tem._pad_batch_pow2(tbatch.split_batch(
        tbatch.concat_batches(tb, tb), 64)[0]), False) == \
        bits(jem._pad_batch_pow2(jbatch.split_batch(jbatch.concat_batches(jb, jb), 64)[0]),
             True)


# ---- operators: loop Source, GeneratorSource, FilterMap, Compact, in-place Map --------

def _collect(X, src, ops, bs, kw):
    out = []

    def cb(view):
        if view is not None:
            p = view["payload"]
            out.extend(zip(view["key"].tolist(), view["id"].tolist(), view["ts"].tolist(),
                           *(np.asarray(p[k]).tolist() for k in sorted(p))))
    res = X.Pipeline(src, ops, X.Sink(cb, **kw), batch_size=bs, **kw).run()
    return out, {k: np.asarray(v).tolist() for k, v in res.items()}


@pytest.mark.parametrize("bs", [16, 25])
def test_loop_source_matches_jax(bs):
    """f(i, shipper) with a when= mask, key= and ts= per push, rich flavour
    too: the same batches (fan-out lanes, ids i * F + j) as the JAX package."""
    def mk(X, cast, rich):
        def fn(i, shipper):
            shipper.push({"v": cast(i)})
            shipper.push({"v": -cast(i)}, when=i % 2 == 0, key=i % 3, ts=i * 10)

        def fn_rich(i, shipper, ctx):
            shipper.push({"v": cast(i) + ctx.getParallelism()})
        return X.Source(fn_rich if rich else fn, total=50, max_fanout=3, num_keys=4,
                        **({} if X is wf else CPU))
    for rich in (False, True):
        want = _collect(wf, mk(wf, lambda a: a.astype(jnp.float32), rich), [], bs, {})
        got = _collect(wt, mk(wt, lambda a: a.to(torch.float32), rich), [], bs, CPU)
        assert got == want and want[0]
    src = mk(wt, lambda a: a.to(torch.float32), False)
    assert src.out_capacity(bs) == 3 * bs and src.is_loop


def test_generator_source_matches_jax_and_skips_on_resume():
    def gen():
        rng = np.random.default_rng(0)
        for chunk in range(5):
            n = 40 + chunk
            yield ({"v": rng.normal(size=n).astype(np.float32)},
                   rng.integers(0, 4, n).astype(np.int32), np.arange(n) + chunk * 100)
    want = _collect(wf, wf.GeneratorSource(gen, {"v": jnp.zeros((), jnp.float32)}), [],
                    64, {})
    src = wt.GeneratorSource(gen, {"v": torch.zeros(())}, **CPU)
    got = _collect(wt, src, [], 64, CPU)
    assert got == want and len(want[0]) == sum(40 + c for c in range(5))
    assert src.get_StatsRecords()[0].bytes_copied_hd == 5 * 64 * (4 * 4 + 1)
    tok = {"batch": 2, "next_id": 128}
    first = next(iter(src.batches(64, cursor=tok)))
    assert first.id[0].item() == 128 and int(first.valid.sum()) == 42
    assert src.cursor() == {"batch": 3, "next_id": 128 + 42}


def test_generator_source_string_keys_and_raw_string_refusal():
    names = np.asarray(["alpha", "beta", "gamma", "delta"])

    def gen():
        for chunk in range(4):
            yield ({"v": np.ones(32, np.float32)}, names[np.arange(32) % 4],
                   np.arange(32) + chunk * 32)
    want = _collect(wf, wf.GeneratorSource(gen, {"v": jnp.zeros((), jnp.float32)},
                                           num_keys=8), [], 32, {})
    got = _collect(wt, wt.GeneratorSource(gen, {"v": torch.zeros(())}, num_keys=8, **CPU),
                   [], 32, CPU)
    assert got == want
    assert {k for k, *_ in got[0]} == {tbatch.hash_key_to_slot(s, 8) for s in names.tolist()}
    src = wt.GeneratorSource(lambda: iter([({"v": np.ones(4, np.float32)},
                                            np.asarray(["a", "b", "a", "b"]),
                                            np.arange(4))]), {"v": torch.zeros(())}, **CPU)
    with pytest.raises(TypeError, match="num_keys"):
        wt.Pipeline(src, [wt.ReduceSink(lambda t: t.v, **CPU)], batch_size=8, **CPU).run()


def test_filtermap_compact_and_inplace_map_match_jax():
    """tests/test_stateless_slice.py's optional Filter and the in-place Map,
    plus Compact, through both packages."""
    def ops(X, kw, f32):
        def inplace(t):
            t.v = t.v * 3
            t.u = t.v + f32(t.id)
        return [X.FilterMap(lambda t: ({"v": t.v + 100.0}, t.v % 3 == 0), **kw),
                X.Compact(**kw), X.Map(inplace, **kw)]
    src = lambda X, c, kw: X.Source(lambda i: {"v": c(i)}, total=60, **kw)  # noqa: E731
    want = _collect(wf, src(wf, lambda a: a.astype(jnp.float32), {}),
                    ops(wf, {}, lambda a: a.astype(jnp.float32)), 25, {})
    got = _collect(wt, src(wt, lambda a: a.to(torch.float32), CPU),
                   ops(wt, CPU, lambda a: a.to(torch.float32)), 25, CPU)
    assert got == want and len(want[0]) == 20
    b = tbatch.Batch.of({"v": torch.arange(6.0)}, valid=torch.tensor([0, 1, 0, 1, 1, 0]).bool(),
                        **CPU)
    out = wt.Compact(**CPU).apply(None, b)[1]
    assert out.valid.tolist() == [True] * 3 + [False] * 3
    assert out.payload["v"][:3].tolist() == [1.0, 3.0, 4.0]


# ---- builders (tests/test_builder_hints.py) -------------------------------------------

def _src(total=300):
    return (Source_Builder(lambda i: {"v": i.to(torch.int32)}).withName("src")
            .withTotal(total).withKeys(4).withDevice("cpu").build())


def test_with_batch_sets_pipeline_and_graph_batch_size():
    m = Map_Builder(lambda t: {"v": t.v * 2}).withBatch(64).withDevice("cpu").build()
    rs = ReduceSink_Builder(lambda t: t.v).withName("s").withDevice("cpu").build()
    p = wt.Pipeline(_src(), [m, rs], **CPU)
    assert p.batch_size == 64 and int(p.run()["s"]) == sum(i * 2 for i in range(300))
    m1 = Map_Builder(lambda t: {"v": t.v}).withBatch(128).withDevice("cpu").build()
    m2 = Map_Builder(lambda t: {"v": t.v}).withBatch(32).withDevice("cpu").build()
    assert resolve_batch_hint([m1, m2]) == 32
    assert wt.Pipeline(_src(), [m1, m2], **CPU).batch_size == 32
    assert wt.Pipeline(_src(), [m2], batch_size=100, **CPU).batch_size == 100
    g = wt.PipeGraph("hints", **CPU)
    g.add_source(_src()).chain(Map_Builder(lambda t: {"v": t.v * 3}).withBatch(56)
                               .withDevice("cpu").build()).add(
        ReduceSink_Builder(lambda t: t.v).withName("total").withDevice("cpu").build())
    res = g.run()
    assert g.batch_size == 56 and int(res["total"]) == sum(i * 3 for i in range(300))
    with pytest.raises(ValueError, match="withBatch"):
        Map_Builder(lambda t: {"v": t.v}).withBatch(0)


def test_with_device_opt_and_conflicting_hints():
    m = Map_Builder(lambda t: {"v": t.v + 1}).withDevice("cpu").build()
    assert m._device == torch.device("cpu") and m.device == torch.device("cpu")
    chain = wt.CompiledChain([m], _src().payload_spec(), batch_capacity=50)
    assert chain.device == torch.device("cpu")
    m1 = Map_Builder(lambda t: {"v": t.v}).withDevice("cpu").build()
    m2 = Map_Builder(lambda t: {"v": t.v}).withDevice("cpu").build()
    m2._device = torch.device("meta")
    with pytest.raises(ValueError, match="conflicting withDevice"):
        wt.CompiledChain([m1, m2], _src().payload_spec(), batch_capacity=32)
    m = Map_Builder(lambda t: {"v": t.v}).withOpt(opt_level_t.LEVEL2).withDevice("cpu").build()
    assert m._opt_level == opt_level_t.LEVEL2
    with pytest.raises(ValueError):
        Map_Builder(lambda t: {"v": t.v}).withOpt(99)
    for b in (wt.FlatMap_Builder(lambda t, sh: None).withMaxFanout(2),
              wt.Accumulator_Builder(lambda acc, t: acc),
              wt.Map_Builder(lambda t, s: (t, s)).withState(0)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            b.withDevice("cpu").build()


def test_chain_outcome_recorded_and_rendered():
    g = wt.PipeGraph("chainrec", batch_size=64, **CPU)
    m = Map_Builder(lambda t: {"v": t.v * 2}).withName("dbl").withDevice("cpu").build()
    f = wt.Filter(lambda t: t.v >= 0, keyed=True, name="kf", **CPU)
    g.add_source(_src()).chain(m).chain(f).add(wt.ReduceSink(lambda t: t.v, name="out", **CPU))
    assert m._chained is True and f._chained is False
    dot = g.dump_DOTGraph()
    assert "dbl (chained)" in dot and "kf (keyby)" in dot
    assert int(g.run()["out"]) == sum(2 * i for i in range(300))


# ---- async sink (tests/test_async_sink*.py) and stats --------------------------------

def test_async_shipper_order_and_depth():
    sh = wt.AsyncResultShipper(depth=2)
    for i in range(5):
        sh.ship({"a": torch.full((4,), i), "b": torch.tensor(i * 2)}, tag=i)
    got = sh.harvest()
    assert [r.tag for r in got] == [0, 1, 2] and len(sh) == 2
    rest = sh.drain()
    assert [r.tag for r in rest] == [3, 4] and len(sh) == 0
    for r in got + rest:
        np.testing.assert_array_equal(r.value["a"], np.full((4,), r.tag))
        assert int(r.value["b"]) == r.tag * 2 and isinstance(r.value["a"], np.ndarray)
        assert r.receipt_time >= r.ship_time


@pytest.mark.parametrize("depth", [1, 3])
def test_async_sink_matches_sync_in_order(depth):
    def run(d):
        got, eos = [], []

        def cb(view):
            if view is None:
                eos.append(True)
            else:
                got.extend(view["payload"]["v"].tolist())
        src = wt.Source(lambda i: {"v": (i % 9).to(torch.float32)}, total=200, num_keys=2,
                        **CPU)
        wt.Pipeline(src, [wt.Map(lambda t: {"v": t.v * 3}, **CPU)],
                    wt.Sink(cb, async_depth=d, **CPU), batch_size=32, **CPU).run()
        assert eos == [True]
        return got
    assert run(depth) == run(0) and len(run(0)) == 200


def test_dump_stats_writes_service_histogram(tmp_path):
    g = wt.PipeGraph("stats", batch_size=16, **CPU)
    g.add_source(wt.Source(lambda i: {"v": i}, total=16 * 40, **CPU)).add(
        wt.Map(lambda t: {"v": t.v + 1}, name="inc", **CPU)).add(
        wt.ReduceSink(lambda t: t.v, name="s", **CPU))
    g.run()
    paths = g.dump_stats(str(tmp_path))
    assert len(paths) == 3
    import json
    rec = [json.load(open(p)) for p in paths if "_inc_" in p][0]
    assert rec["num_kernels"] == 40 and rec["service_time_us"]["samples"] == 40 // 16
    h = wt.LogHistogram()
    for s in (1e-6, 2e-6, 1e-3):
        h.record(s)
    assert h.percentile(50) >= 2e-6 and h.summary_us()["samples"] == 3

"""The port's join, rank and network ops against the JAX package, on the CPU.

Each case feeds the same numpy inputs (made from a seed) to the JAX function
(its XLA reference, and its Pallas form in interpret mode where it has one)
and to the port's function on CPU tensors, which runs the plain PyTorch
version of the port's CUDA kernel. Every comparison is exact: bytes and
dtypes.

- K5 ``join_probe`` (Pallas ``_join_probe_pallas``), and the float ``-0.0``
  repair of K2 ``table_lookup`` and of ``join_probe``;
- the JoinTable (``join_table_upsert``/``join_table_probe``): every state
  field after each step of scripted sequences;
- K4 ``sort_network``/``merge_network`` (Pallas ``_pallas_network``), batched;
- ``segment_rank``; the ``TopN`` and ``Distinct`` operators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
from windflow_tpu.ops import bitonic as jb
from windflow_tpu.ops import lookup as jl
from windflow_tpu.ops import segment as js
from windflow_tpu.operators.rank import Distinct as JDistinct, TopN as JTopN
from windflow_tpu_torch import Batch as TBatch
from windflow_tpu_torch.operators.rank import Distinct as TDistinct, TopN as TTopN
from windflow_tpu_torch.ops import bitonic as tb
from windflow_tpu_torch.ops import lookup as tl
from windflow_tpu_torch.ops import segment as ts

IMIN = -(1 << 31)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same(got, want, what=""):
    """Byte-for-byte equality of a torch tensor and a JAX/numpy array,
    dtype and shape included."""
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert g.tobytes() == w.tobytes(), f"{what}: values differ\n{g}\n{w}"


# ------------------------------------------------------------ K5 join_probe

PROBE_DTYPES = [np.int8, np.bool_, np.uint16, np.int32, np.float32]


def _probe_case(K, dtype, seed, C=1024):
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.arange(-4 * K - 8, 4 * K + 8), K, replace=False).astype(np.int32)
    if dtype == np.bool_:
        vals = rng.random(K) < 0.5
    elif dtype == np.float32:
        vals = rng.normal(size=K).astype(np.float32)
        vals[::3] = -0.0
        if K > 2:
            vals[1] = np.nan
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, int(info.max) + 1, K).astype(dtype)
    hits = keys[rng.integers(0, K, C)]
    misses = rng.integers(-5 * K - 20, 5 * K + 20, C).astype(np.int32)
    probe = np.where(rng.random(C) < 0.6, hits, misses).astype(np.int32)
    valid = rng.random(C) < 0.8
    return keys, vals, probe, valid


@pytest.mark.parametrize("dtype", PROBE_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("K", [1, 16, 200])
def test_join_probe_matches_jax(K, dtype):
    """Bytes and dtype of the XLA reference (``jnp.sum``'s dtype). The Pallas
    form keeps the table's own dtype, so it is held to the same values; it
    refuses bool values, so bool is held to the reference alone."""
    keys, vals, probe, valid = _probe_case(K, dtype, K)
    gv, gh = tl.join_probe(_t(keys), _t(vals), _t(probe), _t(valid))
    args = [jnp.asarray(a) for a in (keys, vals, probe, valid)]
    xv, xh = jl._join_probe_xla(*args)
    assert_same(gv, xv, "vals vs xla")
    assert_same(gh, xh, "hit vs xla")
    if dtype != np.bool_:
        pv, ph = jl._join_probe_pallas(*args, interpret=True)
        assert_same(gv, np.asarray(pv).astype(xv.dtype), "vals vs pallas")
        assert_same(gh, ph, "hit vs pallas")
    assert gh.any() and not gh.all()


@pytest.mark.parametrize("K", [100, 1000, 3000])
def test_table_lookup_negative_zero_matches_jax(K):
    rng = np.random.default_rng(K + 1)
    table = rng.normal(size=K).astype(np.float32)
    table[::2] = -0.0
    idx = rng.integers(-10, K + 10, 4096).astype(np.int32)
    got = tl.table_lookup(_t(table), _t(idx))
    want = jl.table_lookup(jnp.asarray(table), jnp.asarray(idx))
    assert_same(got, want, "table_lookup")
    assert not np.signbit(got.numpy()[got.numpy() == 0]).any()


@pytest.mark.parametrize("case", ["one_row", "take_branch_nan"])
def test_table_lookup_negative_zero_edges_match_jax(case):
    """A one-row table keeps -0.0 (XLA drops a one-element sum), and the
    ``take`` branch (a non-finite float table above 2048 rows) keeps it as
    ``jnp.take`` does."""
    K = 1 if case == "one_row" else 3000
    table = np.full(K, -0.0, np.float32)
    if case == "take_branch_nan":
        table[7] = np.nan
    idx = np.array([0, K - 1, K, -1, 5 % K], np.int32)
    got = tl.table_lookup(_t(table), _t(idx))
    assert_same(got, jl.table_lookup(jnp.asarray(table), jnp.asarray(idx)), case)
    assert np.signbit(got.numpy()[0])


@pytest.mark.parametrize("K", [1, 2, 64])
def test_join_probe_negative_zero_matches_jax(K):
    keys = np.arange(K, dtype=np.int32) * 3
    vals = np.full(K, -0.0, np.float32)
    probe = np.concatenate([keys, [1, -3, IMIN]]).astype(np.int32)
    valid = np.ones(probe.shape, bool)
    gv, gh = tl.join_probe(_t(keys), _t(vals), _t(probe), _t(valid))
    xv, xh = jl._join_probe_xla(*(jnp.asarray(a) for a in (keys, vals, probe, valid)))
    assert_same(gv, xv, "vals")
    assert_same(gh, xh, "hit")
    assert bool(np.signbit(gv.numpy()[0])) == (K == 1)


# ------------------------------------------------------------ the JoinTable

def _jspec(cols):
    return {c: jax.ShapeDtypeStruct((), jnp.dtype(dt)) for c, dt in cols.items()}


def _tspec(cols):
    return {c: torch.empty((), dtype=torch.from_numpy(np.zeros(0, dt)).dtype,
                           device="meta") for c, dt in cols.items()}


def _scenario(name):
    """(K, P, delay, value columns, batches of (key, vals, ts, id, ok))."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cols = {"a": np.int32}
    K, P, delay, C, n_batches, key_hi = 8, 24, 0, 12, 5, 6
    if name == "dupes_across_batches":
        cols = {"a": np.int32, "b": np.float32}
    elif name == "delay":
        P, delay, n_batches = 64, 7, 7
    elif name == "late_upsert_no_rollback":
        delay, n_batches = 2, 6
    elif name == "ring_overflow":
        P, delay, C = 10, 50, 8
    elif name == "full_table":
        K, key_hi = 4, 12
    batches = []
    t0 = 0
    for b in range(n_batches):
        key = rng.integers(0, key_hi, C).astype(np.int32)
        ts = (t0 + rng.integers(0, 6, C)).astype(np.int32)
        if name == "late_upsert_no_rollback" and b >= 3:
            ts = rng.integers(0, 4, C).astype(np.int32)       # far behind the watermark
        t0 += 4
        tid = (b * C + np.arange(C)).astype(np.int32)
        if name == "dupes_across_batches":
            tid = rng.integers(0, 5, C).astype(np.int32)      # (ts, id) ties
        ok = rng.random(C) < 0.8
        vals = {c: (rng.normal(size=C) if dt == np.float32 else
                    rng.integers(-100, 100, C)).astype(dt) for c, dt in cols.items()}
        if "b" in vals:
            vals["b"][::4] = -0.0
        batches.append((key, vals, ts, tid, ok))
    return K, P, delay, cols, batches


JOIN_SCENARIOS = ["dupes_across_batches", "delay", "late_upsert_no_rollback",
                  "ring_overflow", "full_table"]


@pytest.mark.parametrize("name", JOIN_SCENARIOS)
def test_join_table_state_matches_jax(name):
    K, P, delay, cols, batches = _scenario(name)
    jstate = jl.join_table_init(K, P, _jspec(cols))
    tstate = tl.join_table_init(K, P, _tspec(cols), "cpu")
    for key, vals, tss, tid, ok in batches:
        jstate = jl.join_table_upsert(jstate, jnp.asarray(key),
                                      {c: jnp.asarray(v) for c, v in vals.items()},
                                      jnp.asarray(tss), jnp.asarray(tid),
                                      jnp.asarray(ok), delay=delay)
        tstate = tl.join_table_upsert(tstate, _t(key), {c: _t(v) for c, v in vals.items()},
                                      _t(tss), _t(tid), _t(ok), delay=delay)
        assert set(tstate) == set(jstate)
        for f in jstate:
            if f in ("val", "pval"):
                for c in cols:
                    assert_same(tstate[f][c], jstate[f][c], f"{name}: {f}.{c}")
            else:
                assert_same(tstate[f], jstate[f], f"{name}: {f}")
        probe = np.concatenate([key[:5], [100, IMIN + 1]]).astype(np.int32)
        pok = np.ones(probe.shape, bool)
        pok[1] = False
        jv, jh = jl.join_table_probe(jstate, jnp.asarray(probe), jnp.asarray(pok))
        tv, th = tl.join_table_probe(tstate, _t(probe), _t(pok))
        assert_same(th, jh, f"{name}: probe hit")
        for c in cols:
            assert_same(tv[c], jv[c], f"{name}: probe {c}")
    dropped, version = int(tstate["dropped"]), int(tstate["version"])
    upserts = sum(int(b[4].sum()) for b in batches)
    if name in ("ring_overflow", "full_table"):
        assert dropped > 0
    else:
        assert dropped == 0
    if name == "late_upsert_no_rollback":
        assert version < upserts - int(tl.join_table_pending(tstate))
    assert tl.join_table_stats(tstate)["applied_version"] == version


# ------------------------------------------------------------ K4 networks

def _lanes(R, n, ties, seed):
    rng = np.random.default_rng(seed)
    hi = 3 if ties else 1 << 30
    prim = rng.integers(-hi, hi, (R, n)).astype(np.int32)
    sec = rng.integers(-hi, hi, (R, n)).astype(np.int32)
    chan = rng.integers(0, 2 if ties else 4, (R, n)).astype(np.int32)
    idx = np.stack([rng.permutation(n) for _ in range(R)]).astype(np.int32)
    return prim, sec, chan, idx


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n", [2, 8, 1024])
def test_sort_network_matches_jax(n, ties):
    R = 3
    lanes = _lanes(R, n, ties, n + ties)
    got = tb.sort_network(*(_t(a) for a in lanes))
    want = jax.vmap(jb.sort_network)(*(jnp.asarray(a) for a in lanes))
    for g, w in zip(got, want):
        assert_same(g, w, "sort vs xla")
    for r in range(R):
        row = [jnp.asarray(a[r]) for a in lanes]
        pal = jb.sort_network_pallas(*row, interpret=True)
        flat = tb.sort_network(*(_t(a[r]) for a in lanes))
        for g, gf, w in zip(got, flat, pal):
            assert_same(g[r], w, "sort vs pallas")
            assert_same(gf, w, "1-D sort vs pallas")
        perm = np.lexsort((lanes[3][r], lanes[2][r], lanes[1][r], lanes[0][r]))
        for g, a in zip(got, lanes):
            assert_same(g[r], a[r][perm], "sort vs lexsort")


@pytest.mark.parametrize("n", [2, 8, 1024])
def test_merge_network_matches_jax(n):
    R = 2
    prim, sec, chan, idx = _lanes(R, n, True, 7 * n)
    key = np.stack([np.lexsort((idx[r], chan[r], sec[r], prim[r])) for r in range(R)])
    lanes = [np.take_along_axis(a, key, 1) for a in (prim, sec, chan, idx)]
    h = n // 2
    lanes = [np.concatenate([a[:, :h], a[:, h:][:, ::-1]], 1) for a in lanes]  # bitonic
    got = tb.merge_network(*(_t(a) for a in lanes))
    want = jax.vmap(jb.merge_network)(*(jnp.asarray(a) for a in lanes))
    for g, w in zip(got, want):
        assert_same(g, w, "merge vs xla")
    for r in range(R):
        pal = jb.merge_network_pallas(*(jnp.asarray(a[r]) for a in lanes), interpret=True)
        for g, w in zip(got, pal):
            assert_same(g[r], w, "merge vs pallas")
    assert (np.diff(got[0].numpy(), axis=1) >= 0).all()


# ------------------------------------------------------------ segment_rank

@pytest.mark.parametrize("case", ["random", "one_key", "int32_max_keys", "all_invalid"])
def test_segment_rank_matches_jax(case):
    rng = np.random.default_rng(len(case))
    C = 777
    keys = rng.integers(-20, 20, C).astype(np.int32)
    valid = rng.random(C) < 0.7
    if case == "one_key":
        keys[:] = 5
    elif case == "int32_max_keys":
        keys[::3] = np.iinfo(np.int32).max
    elif case == "all_invalid":
        valid[:] = False
    got = ts.segment_rank(_t(keys), _t(valid))
    assert_same(got, js.segment_rank(jnp.asarray(keys), jnp.asarray(valid)), case)


# ------------------------------------------------------------ TopN, Distinct

def _op_batches(C, n_batches, seed, num_keys):
    rng = np.random.default_rng(seed)
    for b in range(n_batches):
        key = rng.integers(-1, num_keys + 1, C).astype(np.int32)
        tid = (b * C + np.arange(C)).astype(np.int32)
        v = rng.integers(0, 50, C).astype(np.int32)      # ties in score and value
        valid = rng.random(C) < 0.8
        yield ({"v": v}, key, tid, tid // 4, valid)


def _both(payload, key, tid, tss, valid):
    jbatch = wf.Batch.of({k: jnp.asarray(v) for k, v in payload.items()},
                         key=jnp.asarray(key), id=jnp.asarray(tid), ts=jnp.asarray(tss),
                         valid=jnp.asarray(valid))
    tbatch = TBatch.of({k: _t(v) for k, v in payload.items()}, key=_t(key), id=_t(tid),
                       ts=_t(tss), valid=_t(valid), device="cpu")
    return jbatch, tbatch


def _same_batch(tbatch, jbatch, what):
    for f in ("key", "id", "ts", "valid"):
        assert_same(getattr(tbatch, f), getattr(jbatch, f), f"{what}: {f}")
    assert sorted(tbatch.payload) == sorted(jbatch.payload)
    for k in jbatch.payload:
        assert_same(tbatch.payload[k], jbatch.payload[k], f"{what}: payload {k}")


@pytest.mark.parametrize("C", [16, 100])
def test_topn_operator_matches_jax(C):
    K, N = 5, 3
    jop = JTopN(lambda t: t.v, N, num_keys=K)
    top = TTopN(lambda t: t.v, N, num_keys=K, device="cpu")
    spec = {"v": jax.ShapeDtypeStruct((), jnp.int32)}
    jstate = jop.init_state(spec)
    tstate = top.init_state({"v": torch.empty((), dtype=torch.int32, device="meta")})
    assert top.out_capacity(C) == jop.out_capacity(C) == K * N
    for i, args in enumerate(_op_batches(C, 4, C, K)):
        jbatch, tbatch = _both(*args)
        jstate, jout = jop.apply(jstate, jbatch)
        tstate, tout = top.apply(tstate, tbatch)
        _same_batch(tout, jout, f"apply {i}")
        for f in jstate:
            assert_same(tstate[f], jstate[f], f"apply {i}: state {f}")
    jstate, jout = jop.flush(jstate)
    tstate, tout = top.flush(tstate)
    _same_batch(tout, jout, "flush")
    assert top.flush(tstate)[1] is None and jop.flush(jstate)[1] is None
    assert int(tstate["evict"]) > 0


@pytest.mark.parametrize("C", [16, 100])
def test_distinct_operator_matches_jax(C):
    jop = JDistinct(lambda t: t.v, num_slots=64)
    top = TDistinct(lambda t: t.v, num_slots=64, device="cpu")
    jop.bind_geometry(C)
    top.bind_geometry(C)
    jstate = jop.init_state({"v": jax.ShapeDtypeStruct((), jnp.int32)})
    tstate = top.init_state({"v": torch.empty((), dtype=torch.int32, device="meta")})
    seen = set()
    for i, args in enumerate(_op_batches(C, 4, 3 * C, 8)):
        seen.update(args[0]["v"][args[4]].tolist())
        jbatch, tbatch = _both(*args)
        jstate, jout = jop.apply(jstate, jbatch)
        tstate, tout = top.apply(tstate, tbatch)
        _same_batch(tout, jout, f"apply {i}")
        for f in jstate:
            if f in ("val", "pval"):
                assert_same(tstate[f]["one"], jstate[f]["one"], f"apply {i}: {f}")
            else:
                assert_same(tstate[f], jstate[f], f"apply {i}: state {f}")
    assert int(tstate["version"]) == len(seen)      # each value passed once

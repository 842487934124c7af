"""K6 (per-window masked sum), the Iterable view and segment_reduce's other
combines: the port against the JAX package on the CPU.

Inputs are made from a numpy seed and handed to both packages. The port runs
its plain versions here (``device="cpu"``); the hand kernel itself is held
against the plain version on the card by ``chip_smoke.py``. Tolerances: float
sums are compared at ``rtol = atol = 1e-4`` (``tests/test_pallas_kernels.py``'s
tolerance: the two sum in different orders); integer data and integer-valued
floats must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu.operators.window import Iterable as JIterable
from windflow_tpu.ops import pallas_kernels as pk
from windflow_tpu.ops.segment import segment_reduce as jax_segment_reduce
from windflow_tpu_torch.operators.window import Iterable, WindowSpec
from windflow_tpu_torch.ops import registry
from windflow_tpu_torch.ops import window_reduce as wr
from windflow_tpu_torch.ops.segment import segment_reduce

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(W, L, dtype, seed, density=0.7):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        vals = rng.normal(size=(W, L)).astype(np.float32)
    elif dtype == np.bool_:
        vals = rng.random((W, L)) < 0.5
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, size=(W, L), endpoint=True).astype(dtype)
    mask = rng.random((W, L)) < density
    mask[W // 2] = False                       # one all-false row
    return vals, mask


def _port(vals, mask):
    return wr.masked_window_reduce(torch.from_numpy(vals), torch.from_numpy(mask)).numpy()


def test_plain_matches_pallas_interpret_float():
    vals, mask = _inputs(512, 256, np.float32, 0)
    want = np.asarray(pk.masked_window_reduce(jnp.asarray(vals), jnp.asarray(mask),
                                              interpret=True))
    got = _port(vals, mask)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(512, 256), (10, 7)])
def test_plain_matches_jax_exactly_on_integers(shape):
    """int32 (wrapping) and integer-valued float32: bit-identical to both JAX
    forms (the Pallas kernel in interpret mode at a tile-aligned shape, the
    XLA fallback at [10, 7])."""
    vals, mask = _inputs(*shape, np.int32, 1)
    want = np.asarray(pk.masked_window_reduce(jnp.asarray(vals), jnp.asarray(mask),
                                              interpret=True))
    np.testing.assert_array_equal(_port(vals, mask), want)
    assert want.dtype == np.int32
    fvals = np.random.default_rng(2).integers(-50, 50, size=shape).astype(np.float32)
    want = np.asarray(pk.masked_window_reduce(jnp.asarray(fvals), jnp.asarray(mask),
                                              interpret=True))
    np.testing.assert_array_equal(_port(fvals, mask).view(np.int32), want.view(np.int32))


def test_fallback_shape_matches_jax():
    vals = np.ones((10, 7), np.float32)
    mask = np.ones((10, 7), bool)
    want = np.asarray(pk.masked_window_reduce(jnp.asarray(vals), jnp.asarray(mask)))
    np.testing.assert_array_equal(_port(vals, mask), want)
    np.testing.assert_array_equal(_port(vals, mask), np.full(10, 7.0, np.float32))


@pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.int16, np.int32])
def test_small_ints_widen_as_jnp_sum(dtype):
    vals, mask = _inputs(33, 40, dtype, 3)
    want = np.asarray(pk._xla_masked_sum(jnp.asarray(vals), jnp.asarray(mask)))
    got = _port(vals, mask)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_cuda_wrapper_refuses_unported_dtypes_and_fake_shapes():
    v = torch.zeros((4, 5), dtype=torch.float64)
    m = torch.ones((4, 5), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="32-bit defaults"):
        wr.masked_window_reduce_cuda(v.to(torch.int64), m)
    out = wr.masked_window_reduce(v.to("meta").to(torch.int8), m.to("meta"))
    assert out.shape == (4,) and out.dtype == torch.int32 and out.device.type == "meta"
    for dt, want in ((torch.uint8, torch.uint32), (torch.uint16, torch.uint32),
                     (torch.float16, torch.float16), (torch.bfloat16, torch.bfloat16),
                     (torch.float64, torch.float64)):
        out = wr.masked_window_reduce(v.to("meta").to(dt), m.to("meta"))
        assert out.shape == (4,) and out.dtype == want, (dt, out.dtype)
    one = Iterable({"v": v[0].to("meta").to(torch.int8)}, None, None, m[0].to("meta"))
    assert one.sum("v").shape == () and one.sum("v").dtype == torch.int32


# ------------------------------------------- F4: every dtype jnp.sum takes

#: the JAX dtype of each torch dtype the repair adds
_JNP = {torch.uint8: jnp.uint8, torch.uint16: jnp.uint16, torch.uint32: jnp.uint32,
        torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
        torch.float64: jnp.float64}


def _f4_inputs(W, L, dtype, seed):
    """Seeded numpy data for ``dtype``: the full range of an unsigned dtype,
    normal floats otherwise (made as float64, rounded by each package to
    ``dtype`` the same way)."""
    rng = np.random.default_rng(seed)
    if dtype in (torch.uint8, torch.uint16, torch.uint32):
        npd = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.uint32: np.uint32}[dtype]
        vals = rng.integers(0, np.iinfo(npd).max, size=(W, L), endpoint=True).astype(npd)
    else:
        vals = rng.normal(size=(W, L))
    mask = rng.random((W, L)) < 0.7
    mask[W // 2] = False
    return vals, mask


def _jax_sum(vals, mask, dtype):
    with jax.enable_x64(dtype == torch.float64):
        out = pk._xla_masked_sum(jnp.asarray(vals, _JNP[dtype]), jnp.asarray(mask))
        return np.asarray(out.astype(jnp.float32) if dtype in _HALF else out)


_HALF = (torch.float16, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.uint32])
@pytest.mark.parametrize("shape", [(33, 40), (9, 3), (4, 70000)])
def test_unsigned_sums_to_uint32_as_jnp_sum(dtype, shape):
    """uint8, uint16 and uint32 sum to uint32, wrapping modulo 2^32 (the
    [4, 70000] uint16 rows pass 2^32), exactly as ``jnp.sum`` does."""
    vals, mask = _f4_inputs(*shape, dtype, 11)
    want = _jax_sum(vals, mask, dtype)
    got = wr.masked_window_reduce(torch.from_numpy(vals), torch.from_numpy(mask))
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    one = np.array([[200, 100, 50, 255]], np.uint8)
    got = wr.masked_window_reduce(torch.from_numpy(one),
                                  torch.tensor([[True, True, False, True]]))
    assert got.dtype == torch.uint32 and got.tolist() == [555]


@pytest.mark.parametrize("dtype,tol", [(torch.float16, 1e-2), (torch.bfloat16, 1e-2),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(33, 40), (9, 3)])
def test_half_and_double_sums_as_jnp_sum(dtype, tol, shape):
    """float16 and bfloat16 accumulate in float32 and keep their dtype, float64
    keeps its own: within rtol = atol = 1e-2 (half types) and 1e-12
    (float64) of ``jnp.sum``."""
    vals, mask = _f4_inputs(*shape, dtype, 12)
    want = _jax_sum(vals, mask, dtype)
    got = wr.masked_window_reduce(torch.from_numpy(vals).to(dtype), torch.from_numpy(mask))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.double().numpy(), want.astype(np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("npd", [np.uint8, np.uint16, np.uint32])
def test_iterable_over_unsigned_fields_matches_jax(npd):
    """Every Iterable reduction over unsigned fields (1-D and [L, 2]):
    ``jnp.sum``'s uint32 sums, max/min/at in the field's dtype, float32
    means, as the JAX package computes them."""
    rng = np.random.default_rng(13)
    W, L = 7, 45
    u = rng.integers(0, np.iinfo(npd).max, size=(W, L), endpoint=True).astype(npd)
    data = {"u": u, "u2": np.stack([u, u[:, ::-1]], axis=-1).copy()}
    ids = np.arange(W * L, dtype=np.int32).reshape(W, L)
    ts = rng.integers(0, 100, size=(W, L)).astype(np.int32)
    mask = rng.random((W, L)) < 0.6
    mask[2] = False

    def fn(it):
        return {"sum": it.sum("u"), "sum2": it.sum("u2"), "max": it.max("u"),
                "min": it.min("u2"), "at": it.at(3).data["u"], "mean": it.mean("u")}
    want = jax.vmap(lambda d, i, t, m: fn(JIterable(d, i, t, m)))(
        {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(ids), jnp.asarray(ts),
        jnp.asarray(mask))
    t = torch.from_numpy
    got = torch.func.vmap(lambda d, i, s, m: fn(Iterable(d, i, s, m)))(
        {k: t(v) for k, v in data.items()}, t(ids), t(ts), t(mask))
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if k == "mean":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_win_seq_cb_sum_over_uint8_field_matches_jax():
    """A Win_Seq CB ``it.sum`` over a uint8 field: the same uint32 window sums
    in both packages (windows of 40 tuples of up to 255 pass 2^8 and 2^16)."""
    import windflow_tpu as wf
    import windflow_tpu_torch as wt
    from windflow_tpu.basic import win_type_t as jwt
    from windflow_tpu.operators.window import WindowSpec as JSpec

    def run(pkg, spec, cast, kw):
        src = pkg.Source(lambda i: {"v": cast((i * 37) % 256)}, total=700, num_keys=3,
                         **kw)
        op = pkg.Win_Seq(lambda wid, it: it.sum("v"), spec, num_keys=3, **kw)
        out = []

        def cb(view):
            if view is not None:
                p = np.asarray(view["payload"])
                assert p.dtype == np.uint32, p.dtype
                out.extend(zip(view["key"].tolist(), view["id"].tolist(), p.tolist()))
        pkg.Pipeline(src, [op], pkg.Sink(cb, **kw), batch_size=128, **kw).run()
        return sorted(out)
    want = run(wf, JSpec(40, 20, jwt.CB), lambda a: a.astype(jnp.uint8), {})
    got = run(wt, wt.WindowSpec(40, 20, wt.win_type_t.CB), lambda a: a.to(torch.uint8),
              {"device": "cpu"})
    assert got == want and want and max(r for _, _, r in want) > 255


def _row_sum(vals, mask):
    """One window's sum as Win_Seq's window functions take it."""
    return Iterable({"v": vals}, None, None, mask).sum("v")


def test_vmap_folds_batch_dims_into_one_call(monkeypatch):
    """Iterable.sum of a 1-D leaf vmapped once and twice (Win_MapReduce's MAP
    inside the window vmap) reaches masked_window_reduce as one
    [outer*inner, L] call, int32 kept; an unbatched mask is expanded."""
    calls = []
    plain = wr.masked_window_reduce_plain

    def spy(vals, mask):
        calls.append(tuple(vals.shape))
        return plain(vals, mask)
    monkeypatch.setattr(wr, "masked_window_reduce_plain", spy)
    vals, mask = _inputs(3 * 4, 5, np.int32, 4)
    v = torch.from_numpy(vals).reshape(3, 4, 5)
    m = torch.from_numpy(mask).reshape(3, 4, 5)
    got = torch.func.vmap(torch.func.vmap(_row_sum))(v, m)
    assert calls == [(12, 5)] and got.dtype == torch.int32
    np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                  np.where(mask, vals, 0).sum(1, dtype=np.int32))
    calls.clear()
    got = torch.func.vmap(lambda r: _row_sum(r, m[0, 0]))(v[0])
    assert calls == [(4, 5)]
    np.testing.assert_array_equal(
        got.numpy(), np.where(mask[0], vals[:4], 0).sum(1, dtype=np.int32))


# ----------------------------------------------------------- Iterable

def _iter_inputs(seed, W=6, L=9):
    rng = np.random.default_rng(seed)
    data = {"v": rng.integers(-20, 20, size=(W, L)).astype(np.float32),
            "n": rng.integers(-(2 ** 31), 2 ** 31 - 1, size=(W, L)).astype(np.int32),
            "s": rng.integers(-100, 100, size=(W, L)).astype(np.int16),
            "emb": rng.integers(-5, 5, size=(W, L, 3)).astype(np.float32)}
    ids = np.arange(W * L, dtype=np.int32).reshape(W, L)
    ts = rng.integers(0, 1000, size=(W, L)).astype(np.int32)
    mask = rng.random((W, L)) < 0.6
    mask[1] = False
    return data, ids, ts, mask


def _iter_fn(it):
    return {"sum_v": it.sum("v"), "sum_n": it.sum("n"), "sum_s": it.sum("s"),
            "sum_emb": it.sum("emb"), "size": it.size(), "max_v": it.max("v"),
            "min_n": it.min("n"), "mean_v": it.mean("v"), "mean_s": it.mean("s"),
            "at1": it.at(1).data["n"], "last_ts": it.last().ts}


def _jax_iter(data, ids, ts, mask):
    return jax.vmap(lambda d, i, t, m: _iter_fn(JIterable(d, i, t, m)))(
        {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(ids), jnp.asarray(ts),
        jnp.asarray(mask))


def _assert_same(got, want):
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if k.startswith("mean"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_iterable_under_vmap_matches_jax():
    data, ids, ts, mask = _iter_inputs(5)
    want = _jax_iter(data, ids, ts, mask)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = torch.func.vmap(lambda d, i, s, m: _iter_fn(Iterable(d, i, s, m)))(
        {k: t(v) for k, v in data.items()}, t(ids), t(ts), t(mask))
    _assert_same(got, want)


def test_iterable_under_nested_vmap_matches_jax():
    data, ids, ts, mask = _iter_inputs(6, W=8)
    want = _jax_iter(data, ids, ts, mask)
    t = lambda a: torch.from_numpy(a).reshape((2, 4) + a.shape[1:])  # noqa: E731
    inner = torch.func.vmap(lambda d, i, s, m: _iter_fn(Iterable(d, i, s, m)))
    got = torch.func.vmap(inner)({k: t(v) for k, v in data.items()}, t(ids), t(ts),
                                 t(mask))
    _assert_same({k: v.reshape((8,) + tuple(v.shape[2:])) for k, v in got.items()}, want)


def test_triggerers_match_jax():
    from windflow_tpu.operators.window import WindowSpec as JSpec
    from windflow_tpu.basic import win_type_t as jwt
    from windflow_tpu_torch.basic import win_type_t
    c = np.array([-3, -1, 0, 1, 5, 17, 1023, 1024, 2047, 4096], np.int32)
    for L, S, d in ((4, 4, 0), (6, 2, 0), (1024, 512, 0), (10, 5, 16)):
        j, p = JSpec(L, S, jwt.TB, d), WindowSpec(L, S, win_type_t.TB, d)
        tc = torch.from_numpy(c)
        for name, args_j, args_p in (
                ("fired_hi_cb", (jnp.asarray(c),), (tc,)),
                ("fired_hi_tb", (jnp.asarray(c),), (tc,)),
                ("flush_hi_cb", (jnp.asarray(c),), (tc,)),
                ("flush_hi_tb", (jnp.asarray(c), jnp.asarray(c > 0)), (tc, tc > 0))):
            want = np.asarray(getattr(j, name)(*args_j))
            got = getattr(p, name)(*args_p).numpy()
            assert got.dtype == want.dtype == np.int32, name
            np.testing.assert_array_equal(got, want, err_msg=name)


# ----------------------------------------------------- segment_reduce

def _seg_inputs(seed, C=300, K=17):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2, K + 2, size=C).astype(np.int32)
    keys[rng.random(C) < 0.3] = 3                 # a hot key
    valid = rng.random(C) < 0.8
    valid[keys == 5] = False                      # key 5: invalid lanes only
    ints = rng.integers(-1000, 1000, size=C).astype(np.int32)
    floats = rng.integers(-64, 64, size=(C, 2)).astype(np.float32)
    return keys, valid, ints, floats, K


@pytest.mark.parametrize("which", ["max", "min"])
def test_segment_reduce_max_min_matches_jax(which):
    keys, valid, ints, floats, K = _seg_inputs(7)
    jc = jnp.maximum if which == "max" else jnp.minimum
    tc = torch.maximum if which == "max" else torch.minimum
    for ident in (-1, 7):
        vals = {"i": ints, "f": floats}
        want = jax_segment_reduce(jax.tree.map(jnp.asarray, vals), jnp.asarray(keys),
                                  jnp.asarray(valid), K, combine=jc, identity=ident)
        got = segment_reduce({k: torch.from_numpy(v) for k, v in vals.items()},
                             torch.from_numpy(keys), torch.from_numpy(valid), K,
                             combine=tc, identity=ident)
        for k in vals:
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("combine", ["mul_wrap", "first_nonzero", "add_float"])
def test_segment_reduce_general_combine_matches_jax(combine):
    keys, valid, ints, floats, K = _seg_inputs(8)
    keys = np.clip(keys, 0, K + 1)                # the JAX scatter wraps negative keys
    fns = {"mul_wrap": (lambda a, b: a * b, lambda a, b: a * b, ints % 5 - 2, 1),
           "first_nonzero": (lambda a, b: jnp.where(a != 0, a, b),
                             lambda a, b: torch.where(a != 0, a, b), ints % 3, 0),
           "add_float": (jnp.add, torch.add, floats, 0)}
    jf, tf, vals, ident = fns[combine]
    want = np.asarray(jax_segment_reduce(jnp.asarray(vals), jnp.asarray(keys),
                                         jnp.asarray(valid), K, combine=jf,
                                         identity=ident))
    got = segment_reduce(torch.from_numpy(vals), torch.from_numpy(keys),
                         torch.from_numpy(valid), K, combine=tf, identity=ident).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_cpu_calls_launch_no_kernel():
    registry.reset_launches()
    vals, mask = _inputs(64, 64, np.float32, 9)
    _port(vals, mask)
    torch.func.vmap(_row_sum)(torch.from_numpy(vals), torch.from_numpy(mask))
    assert registry.launch_counts()["masked_window_reduce"] == 0

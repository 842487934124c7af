"""The port's kernel modules against the JAX package, on the CPU.

Each case feeds the same numpy inputs (made from a seed) to the JAX function —
its XLA form, and its Pallas form in interpret mode — and to the port's
function on CPU tensors, which runs the plain PyTorch version of the port's
CUDA kernel. All values are integers, so every comparison is exact.

- K1 ``keyed_pane_histogram`` (Pallas ``_pallas_fast``);
- K2 ``table_lookup`` (Pallas ``_pallas_factored_lookup``), with the ``take``
  branch for large or non-f32-exact tables, and the chain route
  (``traced=True``) against ``jax.jit(table_lookup)``; its grouped read
  ``table_lookup_many`` table by table against the Pallas kernel;
- K3 ``segment_fold`` (Pallas ``_pallas_segment_fold``), wrapping int32 sums;
- the fixed-order float fold (``segment_reduce`` of floats: XLA's
  ``segment_sum`` in the JAX package, ``index_add_`` on the port's CPU path),
  byte for byte apart from NaN payloads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu.ops import histogram as jh
from windflow_tpu.ops import lookup as jl
from windflow_tpu.ops import segment as js
from windflow_tpu_torch.ops import histogram as th
from windflow_tpu_torch.ops import lookup as tl
from windflow_tpu_torch.ops import segment as ts


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ K1 histogram

def _hist_case(name):
    rng = np.random.default_rng(HIST_CASES.index(name))
    C, K, P = 4096, 7, 64
    key = rng.integers(0, K, C).astype(np.int32)
    valid = rng.random(C) < 0.7
    pane = (np.arange(C) // 157 + 5).astype(np.int32)          # sorted timestamps
    local = True                                               # Pallas precondition
    if name == "wraparound":
        K, P = 5, 32
        key = rng.integers(0, K, C).astype(np.int32)
        pane = (np.arange(C) // 600 + P - 2).astype(np.int32)
    elif name == "negative_panes":
        P = 16
        pane = (np.arange(C) // 300 - 10).astype(np.int32)
    elif name == "keys_out_of_range":
        key = rng.integers(-3, K + 3, C).astype(np.int32)
    elif name == "locality_violation":
        pane = rng.integers(-500, 1000, C).astype(np.int32)
        local = False
    elif name == "p_less_than_l":
        P = 4
    elif name == "all_invalid":
        valid = np.zeros(C, bool)
    elif name == "odd_capacity":
        C = 1000
        key, pane, valid = key[:C], pane[:C], valid[:C]
    elif name == "span_past_window":
        # panes spread over a million: every chunk spans more than a window
        pane = rng.integers(0, 10 ** 6, C).astype(np.int32)
        local = False
    elif name == "one_cell":
        key = np.full(C, 3, np.int32)
        pane = np.full(C, 17, np.int32)
    elif name == "panes_near_int32_limits":
        # the first half climbs to INT32_MAX, the second starts at INT32_MIN;
        # each 1024-lane chunk stays on one side
        half = C // 2
        top = np.iinfo(np.int32).max - (np.arange(half)[::-1] // 300)
        bottom = np.iinfo(np.int32).min + np.arange(half) // 300
        pane = np.concatenate([top, bottom]).astype(np.int32)
    elif name == "ysb_like_stream":
        # YSB's shape at C = 2^14: 100 campaigns, 1000-event panes, a view in
        # three events, the full 4096-pane ring
        C, K, P = 1 << 14, 100, 4096
        key = rng.integers(0, K, C).astype(np.int32)
        valid = rng.random(C) < 1 / 3
        pane = (np.arange(C) // 1000 + 4090).astype(np.int32)
    return key, pane, valid, K, P, local


HIST_CASES = ["sorted", "wraparound", "negative_panes", "keys_out_of_range",
              "locality_violation", "p_less_than_l", "all_invalid", "odd_capacity",
              "span_past_window", "one_cell", "panes_near_int32_limits",
              "ysb_like_stream"]


@pytest.mark.parametrize("case", HIST_CASES)
def test_histogram_matches_jax(case):
    key, pane, valid, K, P, local = _hist_case(case)
    got = th.keyed_pane_histogram(_t(key), _t(pane), _t(valid), K, P).numpy()
    assert got.dtype == np.int32 and got.shape == (K, P)
    jk, jp, jv = jnp.asarray(key), jnp.asarray(pane), jnp.asarray(valid)
    np.testing.assert_array_equal(got, np.asarray(jh.keyed_pane_histogram(jk, jp, jv, K, P)))
    np.testing.assert_array_equal(
        got, np.asarray(jh.keyed_pane_histogram(jk, jp, jv, K, P, impl="pallas")))
    if local:
        np.testing.assert_array_equal(got, np.asarray(
            jh.keyed_pane_histogram_pallas(jk, jp, jv, K, P, interpret=True)))
    np.testing.assert_array_equal(
        got, th.histogram_plain(_t(key), _t(pane), _t(valid), K, P).numpy())


# ------------------------------------------------------------------ K2 lookup

@pytest.mark.parametrize("K", [100, 1000, 4096])
def test_lookup_matches_jax(K):
    rng = np.random.default_rng(K)
    C = 8192
    table = rng.integers(-(1 << 20), 1 << 20, K).astype(np.int32)
    idx = rng.integers(-50, K + 50, C).astype(np.int32)       # out of range both ways
    got = tl.table_lookup(_t(table), _t(idx)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jl.table_lookup(jnp.asarray(table), jnp.asarray(idx))))
    np.testing.assert_array_equal(got, np.asarray(jl._pallas_factored_lookup(
        jnp.asarray(table), jnp.asarray(idx), interpret=True)))
    want = np.where((idx >= 0) & (idx < K), table[np.clip(idx, 0, K - 1)], 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["k_beyond_factored", "not_f32_exact", "float_nan"])
def test_lookup_take_branch_matches_jax(case):
    rng = np.random.default_rng(7)
    if case == "k_beyond_factored":
        K = 70000
        table = np.arange(K, dtype=np.int32)
    elif case == "not_f32_exact":
        K = 3000
        table = rng.integers(1 << 25, 1 << 30, K).astype(np.int32)
    else:
        K = 3000
        table = rng.normal(size=K).astype(np.float32)
        table[17] = np.nan
    idx = np.concatenate([[-1, 5, K, -K, -K - 1, K + 10 ** 5],
                          rng.integers(-K - 5, K + 5, 2042)]).astype(np.int32)
    got = tl.table_lookup(_t(table), _t(idx)).numpy()
    want = np.asarray(jl.table_lookup(jnp.asarray(table), jnp.asarray(idx)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


#: the chain route at K = 4096 (inside an operator's apply the JAX table is a
#: tracer): the table, the indices and what jax.jit(table_lookup) gives
CHAIN_ROUTE_CASES = {
    "int32": (np.arange(4096, dtype=np.int32) * 3, [4096, 5000, -1, -5],
              [-2147483648, -2147483648, 12285, 12273]),
    "float32": (np.arange(4096, dtype=np.float32) * 0.5, [0, 5, 4096, -1],
                [0.0, 2.5, np.nan, 2047.5]),
    "int16": ((np.arange(4096) % 3000).astype(np.int16), [4096, 5000, -1, -5, 7],
              [0, 0, 0, 0, 7]),
}


@pytest.mark.parametrize("case", sorted(CHAIN_ROUTE_CASES))
def test_lookup_chain_route_matches_jitted_jax(case):
    """``traced=True`` routes by K and dtype alone, as the JAX package's
    jitted chain does: int32 and float32 tables of 4096 rows take ``take``
    (dtype fill out of range, negative indices wrap), int16 the factored
    branch (0 out of range); no table value is read."""
    table, head, want_head = CHAIN_ROUTE_CASES[case]
    rng = np.random.default_rng(11)
    idx = np.concatenate([head, rng.integers(-4200, 4200, 1000)]).astype(np.int32)
    got = tl.table_lookup(_t(table), _t(idx), traced=True).numpy()
    want = np.asarray(jax.jit(jl.table_lookup)(jnp.asarray(table), jnp.asarray(idx)))
    assert got.dtype == want.dtype == table.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:len(head)], np.asarray(want_head, table.dtype))


def test_lookup_keeps_table_dtype():
    rng = np.random.default_rng(3)
    for dt in (np.int16, np.uint8, np.float32):
        table = rng.integers(0, 100, 500).astype(dt)
        idx = rng.integers(-5, 505, 1024).astype(np.int32)
        got = tl.table_lookup(_t(table), _t(idx)).numpy()
        want = np.asarray(jl.table_lookup(jnp.asarray(table), jnp.asarray(idx)))
        assert got.dtype == want.dtype == dt
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K", [200, 1000, 4096])
def test_lookup_many_matches_jax_pallas(K):
    """The grouped read (``table_lookup_many``, one K2 launch on the card)
    of int32, int16 and uint8 tables through one index, read as eager JAX
    reads concrete tables (``traced=False``: the int32 table's values are
    f32-exact): each output equals the JAX package's Pallas kernel
    (interpret mode) on its table."""
    rng = np.random.default_rng(K + 1)
    C = 8192
    tables = [rng.integers(-(1 << 20), 1 << 20, K).astype(np.int32),
              rng.integers(-(1 << 15), 1 << 15, K).astype(np.int16),
              rng.integers(0, 256, K).astype(np.uint8)]
    idx = rng.integers(-50, K + 50, C).astype(np.int32)
    got = tl.table_lookup_many([_t(t) for t in tables], _t(idx), traced=False)
    for t, g in zip(tables, got):
        want = np.asarray(jl._pallas_factored_lookup(jnp.asarray(t), jnp.asarray(idx),
                                                     interpret=True))
        assert g.numpy().dtype == want.dtype == t.dtype
        np.testing.assert_array_equal(g.numpy(), want)


def test_lookup_empty_table_gives_zeros():
    idx = np.array([-1, 0, 3], np.int32)
    table = np.zeros(0, np.int32)
    got = tl.table_lookup(_t(table), _t(idx)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jl.table_lookup(jnp.asarray(table), jnp.asarray(idx))))


# ------------------------------------------------------------------ K3 segment_fold

#: the kernel's regimes, as CPU cases of the plain version: S = 1; S one past
#: the direct path's 16384 shared-memory partials; S = 2^20, where every lane
#: takes a global atomic; every lane on one segment with values that wrap
FOLD_CASES = [("int32_wrap", np.int32, 1000), ("int32_wrap", np.int32, 4096),
              ("int32_wrap", np.int32, 5000), ("int8", np.int8, 300),
              ("int16", np.int16, 4096), ("uint8", np.uint8, 777),
              ("segs_out_of_range", np.int32, 2000), ("int32_wrap", np.int32, 1),
              ("int32_wrap", np.int32, 16385), ("int32_wrap", np.int32, 1 << 20),
              ("one_segment_wrap", np.int32, 50)]

#: the largest S the Pallas form runs for here in interpret mode (its one-hot
#: tiles grow with S)
FOLD_INTERPRET_MAX_S = 20000


@pytest.mark.parametrize("case,dtype,S", FOLD_CASES)
def test_segment_fold_matches_jax(case, dtype, S):
    rng = np.random.default_rng(S)
    C = 4096
    info = np.iinfo(dtype)
    if case in ("int32_wrap", "one_segment_wrap"):
        # values near +-2^31: every segment sum overflows and wraps
        values = np.where(rng.random(C) < 0.5, info.max - rng.integers(0, 1000, C),
                          info.min + rng.integers(0, 1000, C)).astype(dtype)
    else:
        values = rng.integers(info.min, int(info.max) + 1, C).astype(dtype)
    lo, hi = (-20, S + 20) if case == "segs_out_of_range" else (0, S)
    seg = rng.integers(lo, hi, C).astype(np.int32)
    if case == "one_segment_wrap":
        seg = np.full(C, 7, np.int32)
    valid = rng.random(C) < 0.8
    got = ts.segment_fold(_t(values), _t(seg), _t(valid), S).numpy()
    assert got.dtype == dtype and got.shape == (S,)
    jv, jsg, jok = jnp.asarray(values), jnp.asarray(seg), jnp.asarray(valid)
    np.testing.assert_array_equal(got, np.asarray(js.segment_fold(jv, jsg, jok, S)))
    if S <= FOLD_INTERPRET_MAX_S:
        np.testing.assert_array_equal(got, np.asarray(
            js._pallas_segment_fold(jv, jsg, jok, S, interpret=True)))


def test_segment_reduce_sum_and_unported_combine():
    rng = np.random.default_rng(11)
    vals = {"a": rng.integers(-100, 100, 512).astype(np.int32),
            "b": rng.integers(-100, 100, (512, 3)).astype(np.int32)}
    keys = rng.integers(0, 9, 512).astype(np.int32)
    valid = rng.random(512) < 0.6
    got = ts.segment_reduce({k: _t(v) for k, v in vals.items()}, _t(keys), _t(valid), 9)
    want = js.segment_reduce({k: jnp.asarray(v) for k, v in vals.items()},
                             jnp.asarray(keys), jnp.asarray(valid), 9)
    for k in vals:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the max combine, unported until the windowed-operator slice, now
    # equals the JAX package's (more cases: tests/test_torch_window_reduce.py)
    got = ts.segment_reduce(_t(vals["a"]), _t(keys), _t(valid), 9, combine=torch.maximum,
                            identity=-1)
    want = js.segment_reduce(jnp.asarray(vals["a"]), jnp.asarray(keys), jnp.asarray(valid),
                             9, combine=jnp.maximum, identity=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- the fixed-order float fold

#: float dtypes of the fold, with their JAX counterparts
FLOAT_FOLD_DTYPES = {"float32": (torch.float32, jnp.float32),
                     "float64": (torch.float64, jnp.float64),
                     "float16": (torch.float16, jnp.float16),
                     "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: the fold's regimes: one hot run of 2^16 lanes at S = 8; S = 2^14 with most
#: segments empty; out-of-range and invalid lanes; -0.0, NaN and +-inf
#: inputs; D = 3 trailing columns
FLOAT_FOLD_CASES = ("hot_run", "sparse_S16384", "dropped_lanes", "specials", "D3")


def _float_fold_case(case, seed):
    rng = np.random.default_rng(seed)
    C, S, D = 4096, 64, ()
    if case == "hot_run":
        C, S = 1 << 16, 8
    elif case == "sparse_S16384":
        S = 1 << 14
    elif case == "D3":
        D = (3,)
    values = rng.standard_normal((C,) + D) * 3.0
    seg = rng.integers(0, S, C).astype(np.int32)
    valid = rng.random(C) < 0.9
    if case == "hot_run":
        seg[rng.random(C) < 0.95] = 5                  # one run of about 2^16 lanes
    elif case == "sparse_S16384":
        seg = rng.choice(rng.integers(0, S, 300), C).astype(np.int32)   # <= 300 live
    elif case == "dropped_lanes":
        seg = rng.integers(-40, S + 40, C).astype(np.int32)
        valid = rng.random(C) < 0.5
        values[~valid] = np.nan                         # masked out: never summed
    elif case == "specials":
        pick = rng.random(C)
        values[pick < 0.2] = -0.0
        values[(pick >= 0.2) & (pick < 0.21)] = np.inf
        values[(pick >= 0.21) & (pick < 0.22)] = -np.inf
        values[(pick >= 0.22) & (pick < 0.225)] = np.nan
        seg[pick < 0.2] = rng.integers(0, 4, int((pick < 0.2).sum()))  # all -0.0 segments
        seg[(seg < 4) & (pick >= 0.2)] += 4
    return values, seg, valid, S


@pytest.mark.parametrize("dtype", sorted(FLOAT_FOLD_DTYPES))
@pytest.mark.parametrize("case", FLOAT_FOLD_CASES)
def test_float_segment_reduce_matches_jax_bits(case, dtype):
    """``segment_reduce`` of floats: the port's CPU fold (``index_add_``, the
    bits the card's fixed-order fold is held to) against the JAX package's
    ``segment_sum``, byte for byte on every non-NaN cell (compared as
    integers) and NaN exactly where JAX has NaN. NaN payloads are not
    compared: the CPU's own ``index_add_`` picks another payload where two
    NaNs meet for D = 1 than for D > 1, and for bfloat16 its vectorised
    path writes 0xffff."""
    tdt, jdt = FLOAT_FOLD_DTYPES[dtype]
    values, seg, valid, S = _float_fold_case(case, FLOAT_FOLD_CASES.index(case))
    got = ts.segment_reduce(_t(values).to(tdt), _t(seg), _t(valid), S)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(js.segment_reduce(jnp.asarray(values, dtype=jdt), jnp.asarray(seg),
                                            jnp.asarray(valid), S))
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (S,) + values.shape[1:]
    ints = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32), 8: (torch.int64, np.int64)}
    ti, ni = ints[got.element_size()]
    g, w = got.view(ti).numpy(), want.view(ni)
    g_nan, w_nan = torch.isnan(got).numpy(), np.isnan(want.astype(np.float64))
    np.testing.assert_array_equal(g_nan, w_nan)
    np.testing.assert_array_equal(np.where(g_nan, 0, g), np.where(w_nan, 0, w))
    if case == "specials":
        assert g_nan.any() and np.isinf(want.astype(np.float64)).any()
        assert not np.signbit(want.astype(np.float64)[:4]).any()   # -0.0 runs give +0.0
    if case == "sparse_S16384":
        assert (got == 0).sum() > S // 2


# ------------------------------------------- F23: strided lanes reach the kernels

def _dense_only(plain, what):
    """A stand-in for a ``*_cuda`` wrapper: refuses a tensor that is not
    contiguous, as the kernels' wrappers do, then runs the plain version."""
    def run(*args):
        for a in args:
            if isinstance(a, torch.Tensor) and not a.is_contiguous():
                raise ValueError(f"{what}: a non-contiguous {tuple(a.shape)} tensor")
        return plain(*args)
    return run


@pytest.fixture
def kernels_route_dense(monkeypatch):
    """The dispatchers take the ``cuda`` route on the CPU, into stand-ins
    that refuse strided inputs as the kernels' wrappers do."""
    for mod in (th, tl, ts):
        monkeypatch.setattr(mod, "resolve_impl", lambda *a, **k: "cuda")
    monkeypatch.setattr(th, "histogram_cuda", _dense_only(th.histogram_plain, "K1"))
    monkeypatch.setattr(tl, "lookup_cuda", _dense_only(tl.lookup_plain, "K2"))
    monkeypatch.setattr(tl, "join_probe_cuda", _dense_only(tl.join_probe_plain, "K5"))
    monkeypatch.setattr(ts, "segment_fold_cuda", _dense_only(ts.segment_fold_plain, "K3"))


def test_dispatchers_hand_strided_lanes_to_the_kernels_dense(kernels_route_dense):
    """F23: lanes that are a broadcast constant (``vmap_lanes`` expands a
    per-lane constant, stride 0) or a column of a wider field (stride 3)
    reach K1, K2, K3 and K5 as dense tensors, with the plain results."""
    rng = np.random.default_rng(23)
    C = 96
    wide = torch.from_numpy(rng.integers(0, 40, (C, 3)).astype(np.int32))
    key, ones = wide[:, 1], torch.ones((), dtype=torch.int32).expand(C)
    valid = torch.from_numpy(rng.random(C) < 0.8)
    assert key.stride() == (3,) and ones.stride() == (0,)
    assert torch.equal(ts.segment_fold(ones, key, valid, 40),
                       ts.segment_fold_plain(ones.clone(), key.clone(), valid, 40))
    assert torch.equal(th.keyed_pane_histogram(key, ones, valid, 40, 4),
                       th.histogram_plain(key.clone(), ones.clone(), valid, 40, 4))
    table = torch.from_numpy(rng.integers(-9, 9, 300).astype(np.int32))
    assert torch.equal(tl.gather_or_zero(table, key), tl.lookup_plain(table, key.clone()))
    tk = torch.arange(0, 40, 2, dtype=torch.int32)
    tv = torch.from_numpy(rng.integers(0, 9, 20).astype(np.int32))
    got = tl.join_probe(tk, tv, key, valid)
    want = tl.join_probe_plain(tk, tv, key.clone(), valid)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_word_count_accumulator_over_a_constant_field(kernels_route_dense):
    """F23 as the word-count example met it on the card: the Accumulator
    folds a per-lane constant (``torch.ones(())`` from a Map) with K3."""
    from windflow_tpu_torch.examples import wordcount
    wordcount.main(["--device", "cpu"])

"""The port's kernel modules against the JAX package, on the CPU.

Each case feeds the same numpy inputs (made from a seed) to the JAX function —
its XLA form, and its Pallas form in interpret mode — and to the port's
function on CPU tensors, which runs the plain PyTorch version of the port's
CUDA kernel. All values are integers, so every comparison is exact.

- K1 ``keyed_pane_histogram`` (Pallas ``_pallas_fast``);
- K2 ``table_lookup`` (Pallas ``_pallas_factored_lookup``), with the ``take``
  branch for large or non-f32-exact tables;
- K3 ``segment_fold`` (Pallas ``_pallas_segment_fold``), wrapping int32 sums.
"""

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
    return key, pane, valid, K, P, local


HIST_CASES = ["sorted", "wraparound", "negative_panes", "keys_out_of_range",
              "locality_violation", "p_less_than_l", "all_invalid", "odd_capacity"]


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


def test_lookup_keeps_table_dtype():
    rng = np.random.default_rng(3)
    for dt in (np.int16, np.uint8, np.float32):
        table = rng.integers(0, 100, 500).astype(dt)
        idx = rng.integers(-5, 505, 1024).astype(np.int32)
        got = tl.table_lookup(_t(table), _t(idx)).numpy()
        want = np.asarray(jl.table_lookup(jnp.asarray(table), jnp.asarray(idx)))
        assert got.dtype == want.dtype == dt
        np.testing.assert_array_equal(got, want)


def test_lookup_empty_table_gives_zeros():
    idx = np.array([-1, 0, 3], np.int32)
    table = np.zeros(0, np.int32)
    got = tl.table_lookup(_t(table), _t(idx)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jl.table_lookup(jnp.asarray(table), jnp.asarray(idx))))


# ------------------------------------------------------------------ K3 segment_fold

FOLD_CASES = [("int32_wrap", np.int32, 1000), ("int32_wrap", np.int32, 4096),
              ("int32_wrap", np.int32, 5000), ("int8", np.int8, 300),
              ("int16", np.int16, 4096), ("uint8", np.uint8, 777),
              ("segs_out_of_range", np.int32, 2000)]


@pytest.mark.parametrize("case,dtype,S", FOLD_CASES)
def test_segment_fold_matches_jax(case, dtype, S):
    rng = np.random.default_rng(S)
    C = 4096
    info = np.iinfo(dtype)
    if case == "int32_wrap":
        # values near +-2^31: every segment sum overflows and wraps
        values = np.where(rng.random(C) < 0.5, info.max - rng.integers(0, 1000, C),
                          info.min + rng.integers(0, 1000, C)).astype(dtype)
    else:
        values = rng.integers(info.min, int(info.max) + 1, C).astype(dtype)
    lo, hi = (-20, S + 20) if case == "segs_out_of_range" else (0, S)
    seg = rng.integers(lo, hi, C).astype(np.int32)
    valid = rng.random(C) < 0.8
    got = ts.segment_fold(_t(values), _t(seg), _t(valid), S).numpy()
    assert got.dtype == dtype and got.shape == (S,)
    jv, jsg, jok = jnp.asarray(values), jnp.asarray(seg), jnp.asarray(valid)
    np.testing.assert_array_equal(got, np.asarray(js.segment_fold(jv, jsg, jok, S)))
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
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ts.segment_reduce(_t(vals["a"]), _t(keys), _t(valid), 9, combine=torch.maximum)

"""The explicit collectives (``parallel/collective.py``) of the port against
the JAX package's on the CPU.

The JAX functions run under ``shard_map`` on the 8 virtual CPU devices, the
port's on 8 CPU positions; the same numpy inputs go through both and every
output is compared with the JAX one: integers and masks bit for bit, float
results bit for bit where both fold in the same order (max, the ring's
in-order pane folds, the matrix chain) and within the stated ``rtol``
where XLA's all-reduce picks its own order (a float ``psum``). Mirrors the
nine cases of ``tests/test_collective.py``, with the port's own oracle
assertions beside the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu.parallel import collective as jcol
from windflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from windflow_tpu_torch.parallel import collective as tcol
from windflow_tpu_torch.parallel import make_mesh

P = 8
CPU8 = ["cpu"] * P


def meshes(axis):
    return jmake_mesh(P, axis=axis), make_mesh(P, axis=axis, devices=CPU8)


def t(a):
    return torch.as_tensor(np.asarray(a))


def full(x):
    return x.full().numpy()


def test_wmr_psum_matches_jax():
    jm, tm = meshes("part")
    L = 64
    data = np.arange(L, dtype=np.float32) * 0.5
    valid = np.arange(L) % 5 != 0
    got = tcol.wmr_map_reduce(lambda d, v: torch.sum(torch.where(v, d, 0.0)), torch.add,
                              tm, axis="part")(t(data), t(valid))
    want = jax.jit(jcol.wmr_map_reduce(lambda d, v: jnp.sum(jnp.where(v, d, 0.0)), jnp.add,
                                       jm, axis="part"))(data, valid)
    np.testing.assert_allclose(full(got), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(full(got), np.sum(np.where(valid, data, 0.0)), rtol=1e-6)
    # the port folds in axis order: exactly the partials added one by one
    parts = [np.float32(np.sum(np.where(valid[i * 8:(i + 1) * 8], data[i * 8:(i + 1) * 8],
                                        0.0), dtype=np.float32)) for i in range(P)]
    acc = parts[0]
    for x in parts[1:]:
        acc = np.float32(acc + x)
    assert full(got) == acc
    assert all(torch.equal(s.data, got.addressable_shards[0].data)
               for s in got.addressable_shards)


def test_wmr_pmax_and_generic_combine_match_jax():
    jm, tm = meshes("part")
    L = 64
    data = np.random.default_rng(0).normal(size=L).astype(np.float32)
    valid = np.ones(L, bool)
    got = tcol.wmr_map_reduce(lambda d, v: torch.max(torch.where(v, d, -torch.inf)),
                              torch.maximum, tm, axis="part")(t(data), t(valid))
    want = jax.jit(jcol.wmr_map_reduce(lambda d, v: jnp.max(jnp.where(v, d, -jnp.inf)),
                                       jnp.maximum, jm, axis="part"))(data, valid)
    assert full(got) == np.asarray(want) == np.max(data)

    # generic associative, non-commutative combine: 2x2 matrix products over
    # the partitions' products, folded pairwise in axis order
    mats = np.stack([np.eye(2, dtype=np.float32)
                     + 0.01 * np.asarray([[0, i], [i % 3, 0]], np.float32)
                     for i in range(16)])

    def map_mats(X):
        def f(local, lv):
            res = X.eye(2)
            for i in range(local.shape[0]):
                res = res @ local[i]
            return res
        return f
    got = tcol.wmr_map_reduce(map_mats(torch), torch.matmul, tm, axis="part")(
        t(mats), torch.ones(16, dtype=torch.bool))
    want = jax.jit(jcol.wmr_map_reduce(map_mats(jnp), jnp.dot, jm, axis="part"))(
        mats, np.ones(16, bool))
    np.testing.assert_allclose(full(got), np.asarray(want), rtol=1e-6)
    dense = np.eye(2)
    for i in range(16):
        dense = dense @ mats[i]
    np.testing.assert_allclose(full(got), dense, rtol=1e-5)


def test_wmr_generic_combine_pytree_partials_match_jax():
    jm, tm = meshes("part")
    L = 64
    data = np.random.default_rng(3).normal(size=L).astype(np.float32)
    valid = np.arange(L) % 3 != 0

    def map_fn(X):
        return lambda d, v: {"s": X.sum(X.where(v, d, 0.0)), "n": X.sum(v.astype(X.float32)
                                                                          if X is jnp else
                                                                          v.float())}

    def combine(a, b):
        return {"s": a["s"] + b["s"], "n": a["n"] + b["n"]}
    got = tcol.wmr_map_reduce(map_fn(torch), combine, tm, axis="part")(t(data), t(valid))
    want = jax.jit(jcol.wmr_map_reduce(map_fn(jnp), combine, jm, axis="part"))(data, valid)
    np.testing.assert_allclose(full(got["s"]), float(want["s"]), rtol=1e-5)
    assert full(got["n"]) == float(want["n"]) == valid.sum()


@pytest.mark.parametrize("win_panes,slide_panes",
                         [(4, 2), (8, 4), (3, 1), (9, 3), (5, 3), (7, 5), (11, 2)])
def test_ring_pane_windows_match_jax(win_panes, slide_panes):
    jm, tm = meshes("win")
    Ptot = 64
    panes = np.random.default_rng(1).normal(size=Ptot).astype(np.float32)
    pane_valid = np.ones(Ptot, bool)
    res, ok = tcol.ring_pane_windows(torch.add, 0.0, tm, win_panes=win_panes,
                                     slide_panes=slide_panes, axis="win")(t(panes),
                                                                          t(pane_valid))
    jres, jok = jax.jit(jcol.ring_pane_windows(jnp.add, 0.0, jm, win_panes=win_panes,
                                               slide_panes=slide_panes, axis="win"))(
        panes, pane_valid)
    # every slot, valid or not, bit for bit: both fold a window's panes in order
    np.testing.assert_array_equal(full(ok), np.asarray(jok))
    np.testing.assert_array_equal(full(res), np.asarray(jres))
    got = sorted(float(r) for r, v in zip(full(res), full(ok)) if v)
    want = [float(np.sum(panes[s:s + win_panes]))
            for s in range(0, Ptot - win_panes + 1, slide_panes)]
    np.testing.assert_allclose(got, sorted(want), rtol=1e-5)


def _exchange(capacity, keys, valid, pay, residue=False):
    jm, tm = meshes("key")
    got = tcol.keyed_all_to_all(tm, axis="key", capacity=capacity, return_residue=residue)(
        t(keys), t(valid), {k: t(v) for k, v in pay.items()})
    want = jax.jit(jcol.keyed_all_to_all(jm, axis="key", capacity=capacity,
                                         return_residue=residue))(keys, valid, pay)
    return got, want


def _same(got, want):
    """Every output of the port's exchange equals the JAX one, bit for bit."""
    for i in (0, 1, 3, 4)[:len(want) - 1]:
        np.testing.assert_array_equal(full(got[i]), np.asarray(want[i]))
    for k in want[2]:
        np.testing.assert_array_equal(full(got[2][k]), np.asarray(want[2][k]))


def test_keyed_all_to_all_ownership_and_conservation_match_jax():
    C = 128 * P
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 57, C).astype(np.int32)
    valid = rng.random(C) < 0.9
    pay = {"v": np.arange(C, dtype=np.float32),
           "m": rng.normal(size=(C, 3)).astype(np.float32)}
    got, want = _exchange(64, keys, valid, pay)
    rk, rv, rp, n_left = got
    assert int(full(n_left).sum()) == 0
    # rows land on the owner, and the padding rows carry zeros, as in JAX
    _same(got, want)
    per = rk.shape[0] // P
    rkn, rvn = full(rk), full(rv)
    for d in range(P):
        live = rkn[d * per:(d + 1) * per][rvn[d * per:(d + 1) * per]]
        assert np.all(live % P == d)
    want_rows = sorted((int(k), float(v)) for k, v, ok in zip(keys, pay["v"], valid) if ok)
    got_rows = sorted((int(k), float(v)) for k, v, ok in zip(rkn, full(rp["v"]), rvn) if ok)
    assert got_rows == want_rows


def test_keyed_all_to_all_overflow_is_loud_not_silent():
    C = 16 * P
    got, want = _exchange(4, np.zeros(C, np.int32), np.ones(C, bool),
                          {"v": np.arange(C, dtype=np.float32)})
    _same(got, want)
    rv, n_left = full(got[1]), full(got[3])
    assert rv.sum() == 4 * P and n_left.shape == (P,) and np.all(n_left == 12)
    assert int(rv.sum()) + int(n_left.sum()) == C


def test_keyed_all_to_all_residue_identifies_left_rows():
    C = 16 * P
    got, want = _exchange(4, np.zeros(C, np.int32), np.ones(C, bool),
                          {"v": np.arange(C, dtype=np.float32)}, residue=True)
    _same(got, want)
    resid = full(got[4])
    assert resid.shape == (C,) and resid.sum() == int(full(got[3]).sum())
    delivered = sorted(float(v) for v, ok in zip(full(got[2]["v"]), full(got[1])) if ok)
    left = [float(v) for v, r in zip(np.arange(C), resid) if r]
    assert sorted(delivered + left) == [float(i) for i in range(C)]


def test_keyed_all_to_all_rejects_zero_capacity():
    jm, tm = meshes("key")
    C = P * (P // 2)
    args = (np.zeros(C, np.int32), np.ones(C, bool), {"v": np.zeros(C, np.float32)})
    with pytest.raises(ValueError, match="capacity"):
        tcol.keyed_all_to_all(tm, axis="key")(*(t(a) for a in args[:2]),
                                              {"v": t(args[2]["v"])})
    with pytest.raises(ValueError, match="capacity"):
        jax.jit(jcol.keyed_all_to_all(jm, axis="key"))(*args)


def test_keyed_all_to_all_lossless_matches_jax():
    jm, tm = meshes("key")
    C = 16 * P
    rng = np.random.default_rng(7)
    keys = np.where(rng.random(C) < 0.7, 0, rng.integers(0, 29, C)).astype(np.int32)
    valid = rng.random(C) < 0.95
    pay = {"v": np.arange(C, dtype=np.float32)}
    rk, rv, rp, n = tcol.keyed_all_to_all_lossless(tm, axis="key", capacity=3)(
        t(keys), t(valid), {"v": t(pay["v"])})
    jk, jv, jp, jn = jcol.keyed_all_to_all_lossless(jm, axis="key", capacity=3)(
        keys, valid, pay)
    assert n == jn and n > 1
    rows = lambda k, v, p: sorted((int(a), float(b)) for a, b, ok in zip(k, p, v) if ok)  # noqa: E731
    want = rows(keys, valid, pay["v"])
    assert rows(full(rk), full(rv), full(rp["v"])) == want
    assert rows(np.asarray(jk), np.asarray(jv), np.asarray(jp["v"])) == want
    # each position's rounds end to end: round r of position d is JAX's round
    # r of device d (JAX lays the rounds end to end globally)
    blk = rk.shape[0] // P // n
    jk, jv = np.asarray(jk).reshape(n, P, blk), np.asarray(jv).reshape(n, P, blk)
    tk, tv = full(rk).reshape(P, n, blk), full(rv).reshape(P, n, blk)
    np.testing.assert_array_equal(tk.transpose(1, 0, 2), jk)
    np.testing.assert_array_equal(tv.transpose(1, 0, 2), jv)

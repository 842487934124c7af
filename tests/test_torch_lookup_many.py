"""The grouped table read (``windflow_tpu_torch/ops/lookup.py::
table_lookup_many``, kernel K2's grouped launch) against the JAX package's
``table_lookup``, table by table, on the CPU; and the launch structure of
the operators that read several tables through one index.

Inputs are made with numpy from a seed and fed to both packages. On the CPU
each table goes through K2's plain version; the launch-structure tests
route the selection to ``cuda`` and stand the wrappers in with counting
plain versions, so they count what the card would launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu.ops import lookup as jl
from windflow_tpu_torch.nexmark import make_query
from windflow_tpu_torch.ops import lookup as tl

CPU = {"device": "cpu"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(rng):
    """Tables of every route: K = 1 (a float holding -0.0), 8, 100, 300 (one
    byte a row), 1000 (a float holding -0.0 and NaN), 3000 (int16: K2
    traced or not; float32: ``take`` when traced, factored when concrete
    and finite), and a 2-D ``[8, 3]`` table (the plain select)."""
    f1000 = rng.normal(size=1000).astype(np.float32)
    f1000[::7] = -0.0
    f1000[3::11] = np.nan
    f2d = rng.normal(size=(8, 3)).astype(np.float32)
    f2d[2, 1] = -0.0
    return [np.array([-0.0], np.float32),
            rng.integers(-(1 << 30), 1 << 30, 8).astype(np.int32),
            rng.integers(-(1 << 20), 1 << 20, 100).astype(np.int32),
            rng.integers(-128, 128, 300).astype(np.int8),
            f1000,
            rng.integers(-(1 << 15), 1 << 15, 3000).astype(np.int16),
            rng.normal(size=3000).astype(np.float32),
            f2d]


def _idx(rng, C=2048):
    """Indices past both ends of the widest table, and past each smaller one."""
    return np.concatenate([[-1, 0, 1, 7, 8, 99, 100, 999, 1000, 2999, 3000, -3000],
                           rng.integers(-3100, 3100, C - 12)]).astype(np.int32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    """Equal dtypes, shapes and bits (NaN against the same NaN)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("traced", [True, False])
def test_matches_jax_table_by_table(traced):
    """Each output equals the JAX package's ``table_lookup`` of its table
    (under ``jax.jit`` when ``traced``, eagerly otherwise), bit for bit: its
    dtype, 0 or the dtype's fill out of range, -0.0 read as +0.0 from a
    float table of two rows or more, a NaN's bits kept."""
    rng = np.random.default_rng(23)
    tables, idx = _tables(rng), _idx(rng)
    got = tl.table_lookup_many([_t(t) for t in tables], _t(idx), traced=traced)
    jfn = jax.jit(jl.table_lookup) if traced else jl.table_lookup
    assert len(got) == len(tables)
    for t, g in zip(tables, got):
        want = np.asarray(jfn(jnp.asarray(t), jnp.asarray(idx)))
        assert g.dtype == tl.table_lookup(_t(t), _t(idx), traced=traced).dtype
        assert g.numpy().dtype == want.dtype and g.shape == want.shape, t.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(want))


def test_outputs_come_back_in_the_tables_order():
    rng = np.random.default_rng(5)
    tables = [_t(t) for t in _tables(rng)]
    idx = _t(_idx(rng))
    order = rng.permutation(len(tables))
    got = tl.table_lookup_many([tables[i] for i in order], idx)
    for i, g in zip(order, got):
        assert _same(g, tl.table_lookup(tables[i], idx, traced=True))


def test_plain_version_is_lookup_plain_for_each_table():
    rng = np.random.default_rng(6)
    tables = [_t(t) for t in _tables(rng)[:6]] + [_t(np.arange(40, dtype=np.int64))]
    idx = _t(_idx(rng, 512))
    got = tl.lookup_many_plain(tables, idx)
    for t, g in zip(tables, got):
        assert _same(g, tl.lookup_plain(t, idx))


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The grouped launch takes 1 to 16 contiguous 1-D tables and an int32
    index vector; anything else raises before a launch."""
    t = torch.arange(8, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    for bad_tables, bad_idx in (([t] * 17, idx), ([], idx), ([t], idx.long()),
                                ([t.view(2, 4)], idx), ([t[::2]], idx),
                                ([t], torch.zeros((2, 2), dtype=torch.int32))):
        with pytest.raises(ValueError):
            tl.lookup_many_cuda(bad_tables, bad_idx)
    assert tl.LOOKUP_MAX_TABLES == 16


# ------------------------------------------------------ launch structure

@pytest.fixture
def k2_launches(monkeypatch):
    """The selection routed to ``cuda`` on the CPU; K2's two wrappers stood
    in by their plain versions, each call recorded as the launch it stands
    for: ``("one", K)`` or ``("many", (K, ...))``."""
    calls = []

    def one(table, idx):
        calls.append(("one", table.shape[0]))
        return tl.lookup_plain(table, idx)

    def many(tables, idx):
        assert 1 <= len(tables) <= tl.LOOKUP_MAX_TABLES
        assert idx.is_contiguous() and all(t.is_contiguous() for t in tables)
        calls.append(("many", tuple(t.shape[0] for t in tables)))
        return tl.lookup_many_plain(tables, idx)
    monkeypatch.setattr(tl, "resolve_impl", lambda *a, **k: "cuda")
    monkeypatch.setattr(tl, "lookup_cuda", one)
    monkeypatch.setattr(tl, "lookup_many_cuda", many)
    return calls


def test_grouped_call_launches_once_for_its_k2_tables(k2_launches):
    """The K2 tables of a group share one launch; a 2-D or ``take`` table
    launches nothing; a group of one takes the single-table launch; a
    seventeenth table opens a second launch."""
    rng = np.random.default_rng(7)
    tables, idx = [_t(t) for t in _tables(rng)], _t(_idx(rng))
    got = tl.table_lookup_many(tables, idx)
    # traced: K = 1, 8, 100, 300, 1000 and the int16 3000 on K2; the float
    # 3000 takes ``take``, the [8, 3] table the plain select
    assert k2_launches == [("many", (1, 8, 100, 300, 1000, 3000))]
    for t, g in zip(tables, got):
        assert _same(g, tl.table_lookup(t, idx, traced=True))
    k2_launches.clear()
    tl.table_lookup_many([tables[1], tables[6]], idx)
    assert k2_launches == [("one", 8)]
    k2_launches.clear()
    many = [_t(np.arange(k + 2, dtype=np.int32)) for k in range(17)]
    got = tl.table_lookup_many(many, idx)
    assert k2_launches == [("many", tuple(range(2, 18))), ("many", (18,))]
    for t, g in zip(many, got):
        assert _same(g, tl.lookup_plain(t, idx))


def test_q5_session_apply_makes_four_k2_launches(k2_launches):
    """q5's SessionWindow apply: the floor by the batch's keys, the open flag
    and last end by the sorted keys (one launch), nine tables by the
    fragments' keys (one launch), the close counts n1 alone: 4 launches,
    where it made 14 single-table launches before."""
    C = 64
    src, ops = make_query("q5_session", 4 * C, **CPU)
    chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=C, **CPU)
    K = ops[1].num_keys
    n = 0
    for b in src.batches(C):
        k2_launches.clear()
        chain.push(b)
        assert sorted(k2_launches, key=str) == sorted(
            [("one", K), ("many", (K, K)), ("many", (K,) * 9), ("one", K)], key=str)
        n += 1
    assert n == 4
    k2_launches.clear()
    chain.flush()
    assert k2_launches == []


@pytest.mark.parametrize("spec,want", [
    ("tb", [("many", (4, 4))]),     # next_win and count in one launch
    ("cb", [("one", 4)]),           # the count alone
])
def test_win_seq_insert_makes_one_k2_launch(k2_launches, spec, want):
    """A Win_Seq apply reads its per-key tables through the batch's keys in
    one K2 launch: a TB window its purge horizon and count together (two
    launches before), a CB window its count."""
    ws = wt.WindowSpec(8, 4, wt.win_type_t.TB if spec == "tb" else wt.win_type_t.CB)
    op = wt.Win_Seq(lambda wid, it: it.sum("v"), ws, num_keys=4, **CPU)
    src = wt.Source(lambda i: {"v": (i % 7).float()}, total=128, num_keys=4,
                    ts_fn=lambda i: i // 2, **CPU)
    out = []
    pipe = wt.Pipeline(src, [op], wt.Sink(out.append, **CPU), batch_size=32, **CPU)
    chain = pipe.chain
    for b in src.batches(32):
        k2_launches.clear()
        chain.push(b)
        assert k2_launches == want

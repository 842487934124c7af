"""Win_Seq in the port against the JAX package on the CPU.

Every case of ``tests/test_win_seq.py`` runs as the same stream through both
packages (the port with ``device="cpu"``, so every kernel wrapper takes its
plain version). The sorted ``(key, wid, value)`` sink tuples must be equal,
at the case's batch size and at others. Stream values are integers carried
as float32, so every window sum is exact in any order. A stream started in
the JAX package and carried across with ``convert`` mid-stream must finish in
the port with the JAX-only run's tuples.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import win_type_t as jwt
from windflow_tpu.operators import win_patterns as jpat
from windflow_tpu.operators.win_seq import Win_Seq as JWin_Seq
from windflow_tpu.operators.window import WindowSpec as JWindowSpec
from windflow_tpu_torch import convert

# The two packages side by side: a case builds its operator and source from
# one of these, so both run the same text.
JAX = types.SimpleNamespace(
    name="jax", kw={}, Win_Seq=JWin_Seq, WindowSpec=JWindowSpec, CB=jwt.CB, TB=jwt.TB,
    Win_Farm=jpat.Win_Farm, Key_Farm=jpat.Key_Farm, Key_FFAT=jpat.Key_FFAT,
    Pane_Farm=jpat.Pane_Farm, Win_MapReduce=jpat.Win_MapReduce, add=jnp.add,
    f32=lambda a: a.astype(jnp.float32), ones=lambda n: jnp.ones(n, jnp.float32),
    zeros=lambda shape: jnp.zeros(shape, jnp.float32), Source=wf.Source,
    Pipeline=wf.Pipeline, Sink=wf.Sink, CompiledChain=wf.CompiledChain,
    cursor=lambda s: jnp.asarray(s, jnp.int32))
PORT = types.SimpleNamespace(
    name="port", kw={"device": "cpu"}, Win_Seq=wt.Win_Seq, WindowSpec=wt.WindowSpec,
    CB=wt.win_type_t.CB, TB=wt.win_type_t.TB, Win_Farm=wt.Win_Farm,
    Key_Farm=wt.Key_Farm, Key_FFAT=wt.Key_FFAT, Pane_Farm=wt.Pane_Farm,
    Win_MapReduce=wt.Win_MapReduce, add=torch.add, f32=lambda a: a.float(),
    ones=lambda n: torch.ones(n), zeros=lambda shape: torch.zeros(shape),
    Source=wt.Source, Pipeline=wt.Pipeline, Sink=wt.Sink,
    CompiledChain=wt.CompiledChain, cursor=lambda s: s)


def div_k(K):
    """The stream of tests/test_win_seq.py: v = i // K for tuple i, key i % K."""
    return lambda X: lambda i: {"v": X.f32(i // K)}


def ident(X):
    return lambda i: {"v": X.f32(i)}


def _value(r):
    return tuple(r) if isinstance(r, list) else round(float(r), 3)


def run(X, make_op, total, K, batch_size, src_fn=None, ts_fn=None):
    """Sorted (key, wid, value) sink tuples of ``make_op(X)`` over the stream."""
    fn = (src_fn or div_k(K))(X)
    src = X.Source(fn, total=total, num_keys=K, ts_fn=ts_fn, **X.kw)
    out = []

    def cb(view):
        if view is None:
            return
        out.extend((int(k), int(w), _value(r)) for k, w, r in
                   zip(view["key"].tolist(), view["id"].tolist(),
                       np.asarray(view["payload"]).tolist()))
    X.Pipeline(src, [make_op(X)], X.Sink(cb, **X.kw), batch_size=batch_size,
               **X.kw).run()
    return sorted(out)


# name: (make_op, total, K, batch sizes (the first is the JAX test's), source, ts_fn)
CASES = {
    "cb_tumbling_sum": (lambda X: X.Win_Seq(lambda wid, it: it.sum("v"),
                                            X.WindowSpec(4, 4, X.CB), num_keys=2, **X.kw),
                        160, 2, (32, 7), None, None),
    "cb_sliding_sum": (lambda X: X.Win_Seq(lambda wid, it: it.sum("v"),
                                           X.WindowSpec(6, 2, X.CB), num_keys=3, **X.kw),
                       200, 3, (64, 50), None, None),
    "cb_invariance_under_batch_size": (
        lambda X: X.Win_Seq(lambda wid, it: it.sum("v"), X.WindowSpec(5, 3, X.CB),
                            num_keys=4, **X.kw),
        121, 4, (16, 64, 121), None, None),
    "cb_incremental_fold": (
        lambda X: X.Win_Seq(lambda wid, t, acc: acc + t.v, X.WindowSpec(4, 4, X.CB),
                            num_keys=2, incremental=True, init_acc=X.zeros(()), **X.kw),
        96, 2, (24, 40), None, None),
    "cb_max_window": (lambda X: X.Win_Seq(lambda wid, it: it.max("v"),
                                          X.WindowSpec(8, 8, X.CB), num_keys=2, **X.kw),
                      128, 2, (32, 19), None, None),
    "tb_tumbling_sum": (lambda X: X.Win_Seq(lambda wid, it: it.sum("v"),
                                            X.WindowSpec(8, 8, X.TB), num_keys=2, **X.kw),
                        160, 2, (40, 64), None, None),
    "tb_sliding_with_lateness": (
        lambda X: X.Win_Seq(lambda wid, it: it.sum("v"),
                            X.WindowSpec(10, 5, X.TB, delay=16), num_keys=1,
                            archive_capacity=256, **X.kw),
        120, 1, (30, 45), ident, lambda i: i + (i % 3) * 2 - 2),
    "iterable_positional_access": (
        lambda X: X.Win_Seq(lambda wid, it: it.last().v - it.first().v + 100.0 * it[1].v,
                            X.WindowSpec(8, 8, X.CB), num_keys=1, **X.kw),
        40, 1, (16, 40), ident, None),
    "vector_payload_sum": (
        lambda X: X.Win_Seq(lambda wid, it: it.sum("emb"), X.WindowSpec(8, 8, X.CB),
                            num_keys=2, **X.kw),
        96, 2, (32, 12), lambda X: lambda i: {"emb": X.f32(i % 5) * X.ones(4)}, None),
    "vector_payload_fold": (
        lambda X: X.Win_Seq(lambda wid, t, acc: acc + t.emb, X.WindowSpec(8, 8, X.CB),
                            init_acc=X.zeros(4), num_keys=2, **X.kw),
        96, 2, (32, 12), lambda X: lambda i: {"emb": X.f32(i % 5) * X.ones(4)}, None),
    # 4096 keys: the per-key count and next_win reads take table_lookup's
    # chain route past 2048 rows (jnp.take under JAX's jit, take in the port)
    "tb_sliding_4096_keys": (
        lambda X: X.Win_Seq(lambda wid, it: it.sum("v"), X.WindowSpec(4, 2, X.TB),
                            num_keys=4096, archive_capacity=64, **X.kw),
        6 * 4096, 4096, (1024, 3000), None, lambda i: i // 4096),
}

PARAMS = [(name, bs) for name, case in CASES.items() for bs in case[3]]


@functools.lru_cache(maxsize=None)
def jax_result(name):
    make_op, total, K, sizes, src_fn, ts_fn = CASES[name]
    return run(JAX, make_op, total, K, sizes[0], src_fn, ts_fn)


@pytest.mark.parametrize("name,batch_size", PARAMS)
def test_win_seq_matches_jax(name, batch_size):
    make_op, total, K, _, src_fn, ts_fn = CASES[name]
    want = jax_result(name)
    assert want, "the JAX run emitted nothing"
    assert run(PORT, make_op, total, K, batch_size, src_fn, ts_fn) == want


def test_flavours_and_guards():
    spec = wt.WindowSpec(4, 4)
    ws = wt.Win_Seq(lambda wid, t, acc: acc + t.v, spec, init_acc=0.0, device="cpu")
    assert ws.incremental and not ws.is_rich
    ws = wt.Win_Seq(lambda wid, it, ctx: it.sum("v"), spec, device="cpu")
    assert not ws.incremental and ws.is_rich
    with pytest.raises(ValueError, match="init_acc"):
        wt.Win_Seq(lambda wid, t, acc: acc, spec, device="cpu")
    with pytest.raises(ValueError, match="max_wins"):
        wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(1024, 1),
                   device="cpu")._resolve_w(1 << 16)
    # window sharding: the fired-window rows split
    # over four CPU positions give the JAX package's rows, CB and TB
    mesh = wt.parallel.make_mesh(4, axis="w", devices=["cpu"] * 4)
    for name in ("cb_sliding_sum", "tb_tumbling_sum"):
        make_op, total, K, sizes, src_fn, ts_fn = CASES[name]

        def sharded(X, make_op=make_op):
            op = make_op(X)
            op.set_window_sharding(mesh, "w")
            return op
        assert run(PORT, sharded, total, K, sizes[0], src_fn, ts_fn) == jax_result(name)
    assert ws._wdevs is None
    ws.set_window_sharding(mesh, "w")
    assert ws._wdevs == [torch.device("cpu")] * 4
    # ring sizing: next_pow2(L + C) for CB, next_pow2(2C or tb_capacity) for TB
    ws.bind_geometry(1000)
    assert ws.A == 1024
    tb = wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(8, 8, wt.win_type_t.TB),
                    tb_capacity=5000, device="cpu")
    tb.bind_geometry(1 << 20)
    assert tb.A == 8192


# ------------------------------------------------- JAX prefix, port suffix

def _carry_ops(X):
    spec_cb, spec_tb = X.WindowSpec(6, 2, X.CB), X.WindowSpec(8, 4, X.TB)
    return {
        "win_seq_cb": X.Win_Seq(lambda wid, it: it.sum("v"), spec_cb, num_keys=3, **X.kw),
        "win_seq_tb": X.Win_Seq(lambda wid, it: it.sum("v"), spec_tb, num_keys=3, **X.kw),
        "pane_farm_cb": X.Pane_Farm(lambda pid, it: it.sum("v"), lambda wid, it: it.sum(),
                                    spec_cb, num_keys=3, **X.kw),
        "win_mapreduce_tb": X.Win_MapReduce(lambda wid, it: it.sum("v"),
                                            lambda wid, it: it.sum(), spec_tb,
                                            map_parallelism=2, num_keys=3, **X.kw),
        "key_farm_wmr_cb": X.Key_Farm(X.Win_MapReduce(
            lambda wid, it: it.sum("v"), lambda wid, it: it.sum(), spec_cb,
            map_parallelism=3, num_keys=3, **X.kw), parallelism=2),
    }


CARRY_TOTAL, CARRY_BATCH = 300, 48


def _chain(X, name):
    src = X.Source(div_k(3)(X), total=CARRY_TOTAL, num_keys=3, **X.kw)
    return src, X.CompiledChain([_carry_ops(X)[name]], src.payload_spec(),
                                batch_capacity=CARRY_BATCH, **X.kw)


def _tuples(view):
    return [(int(k), int(w), float(r)) for k, w, r in
            zip(np.asarray(view["key"]).tolist(), np.asarray(view["id"]).tolist(),
                np.asarray(view["payload"]).tolist())]


def _jax_view(b):
    v = np.asarray(b.valid)
    return {"key": np.asarray(b.key)[v], "id": np.asarray(b.id)[v],
            "payload": np.asarray(b.payload)[v]}


def _as_dicts(state):
    """A JAX state pytree with its dataclasses as dicts (convert's form)."""
    if dataclasses.is_dataclass(state):
        return {f.name: _as_dicts(getattr(state, f.name)) for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: _as_dicts(v) for k, v in state.items()}
    return state


def _push(X, src, chain, starts, out):
    view = _jax_view if X is JAX else wt.batch.host_view
    for s in starts:
        out += _tuples(view(chain.push(src.make_batch(X.cursor(s), CARRY_BATCH))))
    return out


def _flush(X, chain, out):
    view = _jax_view if X is JAX else wt.batch.host_view
    for fb in chain.flush():
        out += _tuples(view(fb))
    return sorted(out)


@pytest.mark.parametrize("name", ["win_seq_cb", "win_seq_tb", "pane_farm_cb",
                                  "win_mapreduce_tb", "key_farm_wmr_cb"])
@pytest.mark.parametrize("k", [1, 4])
def test_jax_prefix_then_port_matches_all_jax(name, k):
    starts = list(range(0, CARRY_TOTAL, CARRY_BATCH))
    jsrc, jchain = _chain(JAX, name)
    want = _flush(JAX, jchain, _push(JAX, jsrc, jchain, starts, []))

    jsrc, jchain = _chain(JAX, name)
    got = _push(JAX, jsrc, jchain, starts[:k], [])
    host = [jax.tree.map(np.asarray, s) for s in jchain.states]
    tsrc, tchain = _chain(PORT, name)
    convert.chain_states_from_numpy(tchain, host)
    # the carried state survives the round trip unchanged
    back = convert.chain_states_to_numpy(tchain)
    want_leaves = jax.tree.leaves([_as_dicts(h) for h in host])
    back_leaves = jax.tree.leaves(back)
    assert len(want_leaves) == len(back_leaves) == 7 * (2 if name == "pane_farm_cb" else 1)
    for a, b in zip(want_leaves, back_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got = _flush(PORT, tchain, _push(PORT, tsrc, tchain, starts[k:], got))
    assert got == want and len(want) > 10

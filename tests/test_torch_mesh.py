"""The mesh half of ``parallel`` in the port against the JAX package on the
CPU: ``ShardedChain`` over the key, dp, 2-D ``dp x key`` and ``key x win``
layouts, and the shard layouts of its states.

The JAX package runs on its 8 virtual CPU devices, the port on 8 CPU
positions (``devices=["cpu"] * 8``). The same numpy batches go through both;
the sorted ``(key, id, value)`` rows of every push and flush must be equal,
byte for byte (the values are small integers carried as float32, so every
window sum is exact in any order). Mirrors ``tests/test_parallel.py`` (the
sharded-chain case and the layout fuzz), ``tests/test_mesh_2d.py`` and
``tests/test_win_farm_sharding.py``, with their shard-shape assertions; a
port-only check holds the gathered sharded state to the unsharded port
chain's, leaf for leaf, and every replicated leaf equal on every position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu.basic import win_type_t as jwt
from windflow_tpu.batch import Batch as JBatch
from windflow_tpu.operators import win_patterns as jpat
from windflow_tpu.operators.window import WindowSpec as JWindowSpec
from windflow_tpu.parallel import ShardedChain as JShardedChain
from windflow_tpu.parallel import make_mesh as jmake_mesh
from windflow_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from windflow_tpu.runtime.pipeline import CompiledChain as JCompiledChain
from windflow_tpu_torch.batch import jax_leaves
from windflow_tpu_torch.parallel import (ShardedChain, ShardedTensor, make_mesh,
                                         make_mesh_2d, shard_batch)

CPU8 = ["cpu"] * 8


class J:
    """The JAX side of a case."""
    Key_FFAT, Win_Farm, Pane_Farm = jpat.Key_FFAT, jpat.Win_Farm, jpat.Pane_Farm
    WindowSpec, CB, TB, add, kw = JWindowSpec, jwt.CB, jwt.TB, jnp.add, {}


class T:
    """The port's side of a case."""
    Key_FFAT, Win_Farm, Pane_Farm = wt.Key_FFAT, wt.Win_Farm, wt.Pane_Farm
    WindowSpec, CB, TB, add = wt.WindowSpec, wt.win_type_t.CB, wt.win_type_t.TB, torch.add
    kw = {"device": "cpu"}


def arrays(total, C, K, mod=13):
    """The JAX tests' batches as numpy: ids ``s..s+C``, key ``id % K``,
    ``ts = id``, ``v = id % mod``, the tail of the last batch invalid."""
    out = []
    for s in range(0, total, C):
        ids = np.arange(s, s + C, dtype=np.int32)
        out.append(dict(key=ids % K, id=ids, ts=ids, v=(ids % mod).astype(np.float32),
                        valid=np.arange(C) < min(C, total - s)))
    return out


def jbatch(a):
    return JBatch(key=jnp.asarray(a["key"]), id=jnp.asarray(a["id"]), ts=jnp.asarray(a["ts"]),
                  payload={"v": jnp.asarray(a["v"])}, valid=jnp.asarray(a["valid"]))


def tbatch(a):
    return wt.Batch.of({"v": a["v"]}, key=a["key"], id=a["id"], ts=a["ts"],
                       valid=a["valid"], device="cpu")


def rows(outs):
    acc = []
    for o in outs:
        key, ids, v = (np.asarray(x) for x in (o.key, o.id, o.valid))
        val = np.asarray(jax.tree.leaves(o.payload)[0]) if isinstance(o, JBatch) else \
            jax_leaves(o.payload)[0].numpy()
        acc.extend(zip(key[v].tolist(), ids[v].tolist(), val[v].tolist()))
    return sorted(acc)


def jax_mesh(layout):
    return {"key": lambda: jmake_mesh(8, axis="key"), "dp": lambda: jmake_mesh(8),
            "win": lambda: jmake_mesh(8, axis="win"),
            "2d": lambda: jmake_mesh_2d((2, 4), axes=("dp", "key")),
            "kw": lambda: jmake_mesh_2d((4, 2), axes=("key", "win"))}[layout]()


def port_mesh(layout):
    return {"key": lambda: make_mesh(8, axis="key", devices=CPU8),
            "dp": lambda: make_mesh(8, devices=CPU8),
            "win": lambda: make_mesh(8, axis="win", devices=CPU8),
            "2d": lambda: make_mesh_2d((2, 4), axes=("dp", "key"), devices=CPU8),
            "kw": lambda: make_mesh_2d((4, 2), axes=("key", "win"), devices=CPU8)}[layout]()


#: ShardedChain's axes a layout: (axis, win_axis, key_axis)
AXES = {"key": ("key", None, "key"), "dp": ("dp", None, None), "win": ("win", None, None),
        "2d": ("dp", None, "key"), "kw": ("key", "win", "key")}


def run_jax(make, batches, C, layout=None):
    chain = JCompiledChain([make(J)], {"v": jax.ShapeDtypeStruct((), jnp.float32)},
                           batch_capacity=C)
    if layout is not None:
        axis, win, key = AXES[layout]
        chain = JShardedChain(chain, jax_mesh(layout), axis=axis, win_axis=win, key_axis=key)
    outs = [chain.push(jbatch(a)) for a in batches]
    return rows(outs + chain.flush())


def port_chain(make, C):
    return wt.CompiledChain([make(T)], {"v": torch.zeros((), dtype=torch.float32)},
                            batch_capacity=C, device="cpu")


def check_layout(sc):
    """Split leaves hold ``shape[0] / p`` rows a position; replicated leaves
    are equal on every position; returns the split leaves."""
    split = []
    for st in sc.chain.states:
        for leaf in jax_leaves(st):
            if not isinstance(leaf, ShardedTensor):
                continue
            shards = leaf.addressable_shards
            assert len(shards) == sc.mesh.size
            ax = next((a for a in leaf.placement.spec if a is not None), None)
            if ax is None:
                assert all(torch.equal(s.data, shards[0].data) for s in shards)
            else:
                p = sc.mesh.shape[ax]
                assert all(s.data.shape[0] == leaf.shape[0] // p for s in shards)
                split.append(leaf)
    return split


def run_port(make, batches, C, layout, *, against_plain=True):
    """The port's sharded rows, checking the layout after every push and,
    with ``against_plain``, the gathered state against the unsharded port
    chain's after every push."""
    axis, win, key = AXES[layout]
    sc = ShardedChain(port_chain(make, C), port_mesh(layout), axis=axis, win_axis=win,
                      key_axis=key)
    plain = port_chain(make, C) if against_plain else None
    outs = []
    for a in batches:
        outs.append(sc.push(tbatch(a)))
        check_layout(sc)
        if plain is not None:
            want = rows([plain.push(tbatch(a))])
            assert rows([outs[-1]]) == want
            for got, ref in zip(jax_leaves(sc.chain.states), jax_leaves(plain.states)):
                full = got.full() if isinstance(got, ShardedTensor) else got
                assert torch.equal(full, ref)
    return rows(outs + sc.flush()), sc


# ------------------------------------------------------------ test_parallel.py

def _key_ffat_cb(K):
    return lambda X: X.Key_FFAT(lambda t: t.v, X.add, spec=X.WindowSpec(20, 20, X.CB),
                                num_keys=K, **X.kw)


def test_sharded_keyed_window_matches_jax():
    batches = arrays(400, 80, 16)
    want = run_jax(_key_ffat_cb(16), batches, 80)
    got, sc = run_port(_key_ffat_cb(16), batches, 80, "dp")
    assert got == want and want
    assert run_jax(_key_ffat_cb(16), batches, 80, "dp") == want


def _fuzz_trials():
    rng = np.random.default_rng(23)
    out = []
    for trial in range(4):
        slide = int(rng.integers(2, 6))
        win = slide * int(rng.integers(1, 4))
        K = 8 * int(rng.integers(1, 3))
        total = int(rng.integers(100, 300))
        bs = 8 * int(rng.integers(4, 12))
        out.append((trial, win, slide, K, total, bs))
    return out


@pytest.mark.parametrize("trial,win,slide,K,total,bs", _fuzz_trials())
def test_fuzz_sharded_chain_random_geometry(trial, win, slide, K, total, bs):
    """``test_parallel.py``'s fuzz: Key_FFAT (CB on even trials, TB on odd)
    over the key, dp and 2-D layouts, each equal to the JAX package's
    single-device rows."""
    def make(X):
        wtype = X.CB if trial % 2 == 0 else X.TB
        return X.Key_FFAT(lambda t: t.v, X.add, spec=X.WindowSpec(win, slide, wtype),
                          num_keys=K, **X.kw)
    batches = arrays(total, bs, K, mod=17)
    for a in batches:
        a["v"] = ((a["id"] * 11) % 17).astype(np.float32)
    oracle = run_jax(make, batches, bs)
    assert oracle, f"trial {trial}: no windows fired"
    for layout in ("key", "dp", "2d"):
        got, _ = run_port(make, batches, bs, layout, against_plain=layout == "2d")
        assert got == oracle, f"trial {trial}: layout={layout}"


# ------------------------------------------------------------- test_mesh_2d.py

def test_dp_x_key_mesh_matches_jax():
    K = 16
    batches = arrays(400, 80, K)
    make = _key_ffat_cb(K)
    want = run_jax(make, batches, 80, "2d")
    assert want == run_jax(make, batches, 80) and want
    got, sc = run_port(make, batches, 80, "2d")
    assert got == want
    # the key table splits 4-way over the key axis, replicated over dp
    leaves = [x for x in jax_leaves(sc.chain.states[0])
              if isinstance(x, ShardedTensor) and x.ndim >= 1 and x.shape[0] == K]
    assert leaves, "no key-table state leaves found"
    shards = leaves[0].addressable_shards
    assert len(shards) == 8
    assert all(s.data.shape[0] == K // 4 for s in shards)


# --------------------------------------------------- test_win_farm_sharding.py

def _keyless(total, C):
    out = arrays(total, C, 1, mod=11)
    for a in out:
        a["key"] = np.zeros(C, np.int32)
    return out


WIN_FARM = {
    "cb": (lambda X: X.Win_Farm(lambda wid, it: it.sum("v"), X.WindowSpec(16, 8, X.CB),
                                parallelism=8, max_wins=32, **X.kw), 512, 128),
    "tb": (lambda X: X.Win_Farm(lambda wid, it: it.max("v"), X.WindowSpec(20, 10, X.TB),
                                parallelism=8, max_wins=32, tb_capacity=256, **X.kw),
           400, 80),
    "nested_pane_farm": (
        lambda X: X.Win_Farm(X.Pane_Farm(lambda wid, it: it.sum("v"),
                                         lambda wid, it: it.sum(),
                                         X.WindowSpec(16, 8, X.CB), num_keys=1,
                                         max_wins=64, **X.kw), parallelism=8), 384, 128),
}


@pytest.mark.parametrize("case", sorted(WIN_FARM))
def test_win_farm_window_axis_sharded_matches_jax(case):
    make, total, C = WIN_FARM[case]
    batches = _keyless(total, C)
    want = run_jax(make, batches, C, "dp")
    assert want == run_jax(make, batches, C) and want
    got, sc = run_port(make, batches, C, "dp")
    assert got == want
    if case == "cb":
        # the W axis partitioned: 8 positions, W/8 rows each
        op = sc.chain.ops[0]
        assert op.window_rows == [32 // 8] * 8
        assert len(op._wdevs) == 8


def _keyed_win_farm(X):
    return X.Win_Farm(lambda wid, it: it.sum("v"), X.WindowSpec(16, 8, X.CB), num_keys=8,
                      max_wins=32, **X.kw)


def test_key_x_win_mesh_shards_archive_and_windows():
    K = 8
    batches = arrays(384, 96, K, mod=11)
    want = run_jax(_keyed_win_farm, batches, 96, "kw")
    assert want == run_jax(_keyed_win_farm, batches, 96) and want
    got, sc = run_port(_keyed_win_farm, batches, 96, "kw")
    assert got == want
    leaves = [x for x in jax_leaves(sc.chain.states[0]) if isinstance(x, ShardedTensor)]
    arch = [x for x in leaves if x.ndim >= 2 and x.shape[0] == K]
    assert arch, "no [K, ...] archive leaves found"
    shards = arch[0].addressable_shards
    assert len(shards) == 8
    assert all(s.data.shape[0] == K // 4 for s in shards)
    scalars = [x for x in leaves if x.ndim == 1 and x.shape[0] == K]
    assert scalars and all(s.data.shape[0] == K // 4 for s in scalars[0].addressable_shards)
    # each key block's rows split over its two window positions
    blk = next(iter(sc._splits[0].blocks.values()))
    assert [b.window_rows for b in blk] == [[16, 16]] * 4


def test_key_x_win_replicates_archive_without_explicit_key_axis():
    K = 8
    batches = arrays(192, 96, K, mod=11)
    got, sc = run_port(_keyed_win_farm, batches, 96, "win")
    assert got == run_jax(_keyed_win_farm, batches, 96)
    arch = [x for x in jax_leaves(sc.chain.states[0])
            if isinstance(x, ShardedTensor) and x.ndim >= 2 and x.shape[0] == K]
    assert all(s.data.shape[0] == K for s in arch[0].addressable_shards)


# ---------------------------------------------------------------- port-only

def test_key_split_global_budget_and_nestings():
    """A fired-window budget smaller than one batch's windows (the blocks'
    budgets are put back to the global one), and the Key_Farm nestings of
    Pane_Farm and Win_MapReduce, over the key axis against the unsharded
    port chain leaf for leaf and against the JAX package."""
    cases = {
        "budget": lambda X: X.Key_Farm(lambda wid, it: it.sum("v"), X.WindowSpec(4, 2, X.CB),
                                       num_keys=8, max_wins=5, **X.kw),
        "pane": lambda X: X.Key_Farm(X.Pane_Farm(lambda wid, it: it.sum("v"),
                                                 lambda wid, it: it.sum(),
                                                 X.WindowSpec(6, 2, X.CB), num_keys=8,
                                                 **X.kw)),
        "wmr_tb": lambda X: X.Key_Farm(X.Win_MapReduce(lambda wid, it: it.sum("v"),
                                                       lambda wid, it: it.sum(),
                                                       X.WindowSpec(8, 8, X.TB),
                                                       map_parallelism=2, num_keys=8,
                                                       **X.kw)),
        "ffat_tb_per_key": lambda X: X.Key_FFAT(lambda t: t.v, X.add,
                                                spec=X.WindowSpec(8, 4, X.TB), num_keys=8,
                                                global_time=False, **X.kw),
    }
    J.Key_Farm, J.Win_MapReduce = jpat.Key_Farm, jpat.Win_MapReduce
    T.Key_Farm, T.Win_MapReduce = wt.Key_Farm, wt.Win_MapReduce
    batches = arrays(240, 48, 8)
    for name, make in cases.items():
        got, sc = run_port(make, batches, 48, "key")
        assert got == run_jax(make, batches, 48), name
        assert sc._splits[0] is not None, name


def test_shard_batch_pieces_and_guards():
    mesh = make_mesh(8, devices=CPU8)
    b = tbatch(arrays(64, 64, 4)[0])
    sb = shard_batch(b, mesh)
    assert [s.data.shape[0] for s in sb.key.addressable_shards] == [8] * 8
    assert torch.equal(sb.key.full(), b.key)
    make = _key_ffat_cb(8)
    sc = ShardedChain(port_chain(make, 64), mesh)
    assert rows([sc.push(sb)]) == rows([port_chain(make, 64).push(b)])
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        ShardedChain(port_chain(make, 64), mesh, key_axis="kye")
    with pytest.raises(ValueError, match="does not split"):
        ShardedChain(port_chain(make, 64), mesh).push(tbatch(arrays(60, 60, 4)[0]))
    with pytest.raises(ValueError, match="repeats the chain's device"):
        ShardedChain(port_chain(make, 64), make_mesh(2, devices=["meta", "meta"]))


def test_stateless_and_whole_operators_around_a_key_split():
    """Stateless operators before a key split run lane block by lane
    block, those after it on the whole batch, and a ReduceSink (no key
    split) runs whole on its gathered state: the unsharded chain's rows and
    result."""
    def ops():
        return [wt.Filter(lambda t: t.v > 2.0, device="cpu"),
                wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(8, 4, T.TB),
                            num_keys=8, device="cpu"),
                wt.Map(lambda t: {"w": t.data * 2.0}, device="cpu"),
                wt.ReduceSink(lambda t: t.w, name="tot", device="cpu")]
    batches = arrays(256, 64, 8)

    def chain():
        return wt.CompiledChain(ops(), {"v": torch.zeros((), dtype=torch.float32)},
                                batch_capacity=64, device="cpu")
    plain = chain()
    want = [plain.push(tbatch(a)) for a in batches] + plain.flush()
    sc = ShardedChain(chain(), port_mesh("2d"), axis="dp", key_axis="key")
    got = [sc.push(tbatch(a)) for a in batches] + sc.flush()
    assert rows(got) == rows(want) and rows(want)
    assert sc._splits[1] is not None and sc._splits[3] is None
    assert torch.equal(sc.result()["tot"], plain.result()["tot"])
    check_layout(sc)

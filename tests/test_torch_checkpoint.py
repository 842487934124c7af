"""The port's checkpoints (``windflow_tpu_torch/runtime/checkpoint.py``), on the CPU.

Mirrors the JAX package's ``tests/test_checkpoint.py`` (the rescale across
meshes over 8 and 4 CPU positions, both ways) and adds the files'
cross-package contract: a checkpoint written by the JAX package's
``save_chain`` loads into the port, and one written by the port loads into
the JAX package, with equal states (bytes, dtypes and leaf paths) for
Key_FFAT, Win_Seq, Nexmark q4 and q5 chains and for a ``ShardedChain``'s
chain (whose file is the unsharded one); the port's leaf paths equal
``jax.tree_util.keystr``'s. Inputs come from seeded sources.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import win_type_t as jwin
from windflow_tpu.nexmark import make_query as jmake
from windflow_tpu.runtime import checkpoint as jck
from windflow_tpu_torch.basic import win_type_t
from windflow_tpu_torch.nexmark import make_query as tmake
from windflow_tpu_torch.runtime import checkpoint as tck
from windflow_tpu_torch.runtime import faults as faults_mod
from windflow_tpu_torch.runtime.checkpoint import (CheckpointCorrupt, load_chain,
                                                   manifest_path, save_chain)

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults_mod.set_active(None)
    faults_mod.reset_counters()
    yield
    faults_mod.set_active(None)


def _collect(outs):
    acc = []
    for o in outs:
        v = o.valid
        acc.extend(zip(o.key[v].tolist(), o.id[v].tolist(), o.payload[v].tolist()))
    return sorted(acc)


def _key_ffat_chain(total=600, K=3, C=64):
    src = wt.Source(lambda i: {"v": (i % 9).float()}, total=total, num_keys=K, **CPU)
    mk = lambda: wt.CompiledChain(  # noqa: E731
        [wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(20, 20), num_keys=K,
                     **CPU)], src.payload_spec(), batch_capacity=C, **CPU)
    return src, mk


# ------------------------------------------------ mirrored test_checkpoint

def test_checkpoint_resume_windowed(tmp_path):
    src, mk = _key_ffat_chain()
    batches = list(src.batches(64))
    c0 = mk()
    expect = _collect([c0.push(b) for b in batches] + c0.flush())
    half = len(batches) // 2
    c1 = mk()
    outs_a = [c1.push(b) for b in batches[:half]]
    ckpt = str(tmp_path / "state.npz")
    save_chain(c1, ckpt, meta={"next_batch": half})
    c2 = mk()
    meta = load_chain(c2, ckpt)
    assert meta["next_batch"] == half
    outs_b = [c2.push(b) for b in batches[half:]] + c2.flush()
    assert _collect(outs_a + outs_b) == expect


@pytest.mark.parametrize("n_save,n_load", [(8, 4), (4, 8)])
def test_checkpoint_rescale_across_meshes(n_save, n_load, tmp_path):
    """Elastic rescaling: a chain checkpointed while sharded over ``n_save``
    positions restores into a fresh chain, is placed over ``n_load`` and
    continues bit for bit; the file is the unsharded chain's, so the JAX
    package's ``load_chain`` takes it with equal leaves."""
    from windflow_tpu_torch.batch import jax_leaves
    from windflow_tpu_torch.parallel import ShardedChain, ShardedTensor, make_mesh
    total, K, C = 480, 8, 96
    src = wt.Source(lambda i: {"v": (i % 11).float()}, total=total, num_keys=K, **CPU)
    mk = lambda: wt.CompiledChain(  # noqa: E731
        [wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(16, 16), num_keys=K,
                     **CPU)], src.payload_spec(), batch_capacity=C, **CPU)
    mesh = lambda n: make_mesh(n, devices=["cpu"] * n)  # noqa: E731
    batches = list(src.batches(C))
    c0 = mk()
    expect = _collect([c0.push(b) for b in batches] + c0.flush())

    half = len(batches) // 2
    c_save = mk()
    s_save = ShardedChain(c_save, mesh(n_save))
    outs_a = [s_save.push(b) for b in batches[:half]]
    ckpt = str(tmp_path / "rescale.npz")
    save_chain(c_save, ckpt, meta={"next_batch": half})

    c_load = mk()
    meta = load_chain(c_load, ckpt)
    s_load = ShardedChain(c_load, mesh(n_load))
    assert meta["next_batch"] == half
    outs_b = [s_load.push(b) for b in batches[half:]] + s_load.flush()
    assert _collect(outs_a + outs_b) == expect

    # the [K] key table re-placed over n_load distinct blocks of the new mesh
    keyed = [x for x in jax_leaves(c_load.states[0])
             if isinstance(x, ShardedTensor) and x.ndim >= 1 and x.shape[0] == K
             and x.placement.spec[:1] == ("dp",)]
    assert keyed
    shards = keyed[0].addressable_shards
    assert len({s.index for s in shards}) == n_load
    assert len({s.data.data_ptr() for s in shards}) == n_load

    # the port's file of the sharded chain is the JAX package's unsharded one
    js = wf.Source(lambda i: {"v": (i % 11).astype(jnp.float32)}, total=total, num_keys=K)
    jmk = lambda: wf.CompiledChain(  # noqa: E731
        [wf.Key_FFAT(lambda t: t.v, jnp.add, spec=wf.WindowSpec(16, 16), num_keys=K)],
        js.payload_spec(), batch_capacity=C)
    j_ref = jmk()
    for b in list(js.batches(C))[:half]:
        j_ref.push(b)
    _assert_same_states(c_save.states, j_ref.states)
    j_load = jmk()
    assert jck.load_chain(j_load, ckpt) == {"next_batch": half}
    _assert_same_states(c_save.states, j_load.states)


def test_load_chain_into_a_sharded_chain_keeps_its_placement(tmp_path):
    """A file restored into a ``ShardedChain``'s own chain comes back placed
    over its mesh as before (fresh blocks), and the chain carries on to the
    unsharded rows."""
    from windflow_tpu_torch.batch import jax_leaves
    from windflow_tpu_torch.parallel import ShardedChain, ShardedTensor, make_mesh
    src, mk = _key_ffat_chain(total=480, K=8, C=96)
    batches = list(src.batches(96))
    c0 = mk()
    expect = _collect([c0.push(b) for b in batches] + c0.flush())
    c1 = mk()
    outs = [c1.push(b) for b in batches[:2]]
    save_chain(c1, str(tmp_path / "u"))
    c2 = mk()
    s2 = ShardedChain(c2, make_mesh(4, devices=["cpu"] * 4))
    before = [(x.placement, sorted(x.pieces)) for x in jax_leaves(c2.states[0])]
    load_chain(c2, str(tmp_path / "u"))
    after = jax_leaves(c2.states[0])
    assert all(isinstance(x, ShardedTensor) for x in after)
    assert [(x.placement, sorted(x.pieces)) for x in after] == before
    outs += [s2.push(b) for b in batches[2:]] + s2.flush()
    assert _collect(outs) == expect


def _win_seqffat_chain():
    src = wt.Source(lambda i: {"v": (i % 7).float()}, total=512, num_keys=4, **CPU)
    op = wt.Win_SeqFFAT(lambda t: torch.ones((), dtype=torch.int32), torch.add,
                        spec=wt.WindowSpec(8, 8, win_type_t.TB), num_keys=4,
                        pane_capacity=64, **CPU)
    return src, wt.CompiledChain([op], src.payload_spec(), batch_capacity=64, **CPU)


def test_load_chain_legacy_checkpoint_missing_trailing_leaves(tmp_path):
    src, c1 = _win_seqffat_chain()
    c1.push(next(src.batches(64)))
    ckpt = str(tmp_path / "legacy.npz")
    save_chain(c1, ckpt, meta={"v": 1})
    data = dict(np.load(ckpt))
    n_leaves = len([k for k in data if k.startswith("op0_leaf")])
    del data[f"op0_leaf{n_leaves - 1}"]          # the pre-dropped_old format
    np.savez(ckpt, **data)
    _, c2 = _win_seqffat_chain()
    assert load_chain(c2, ckpt) == {"v": 1}
    st = c2.states[0]
    assert int(st.dropped_old) == 0                # defaulted, not KeyError
    assert torch.equal(st.cnt, c1.states[0].cnt)


def test_load_chain_gap_in_leaves_still_raises(tmp_path):
    _, chain = _win_seqffat_chain()
    ckpt = str(tmp_path / "gap.npz")
    save_chain(chain, ckpt)
    data = dict(np.load(ckpt))
    assert "op0_leaf2" in data
    del data["op0_leaf0"]
    np.savez(ckpt, **data)
    with pytest.raises(KeyError, match="missing op0_leaf0"):
        load_chain(chain, ckpt)


def test_save_load_path_without_npz_suffix(tmp_path):
    src, mk = _key_ffat_chain(total=128, K=2, C=32)
    c1 = mk()
    c1.push(next(src.batches(32)))
    stem = str(tmp_path / "ckpt")
    written = save_chain(c1, stem, meta={"k": 9})
    assert written.endswith("ckpt.npz")
    assert load_chain(mk(), stem) == {"k": 9}


def test_checksum_detects_corruption(tmp_path):
    src, mk = _key_ffat_chain(total=256, K=2, C=64)
    c1 = mk()
    for b in src.batches(64):
        c1.push(b)
    ckpt = str(tmp_path / "c.npz")
    save_chain(c1, ckpt)
    data = dict(np.load(ckpt))
    key = next(k for k in data if k.startswith("op0_leaf") and data[k].size > 4
               and data[k].dtype.kind == "f")
    data[key] = data[key].copy()
    data[key].flat[1] += 1234.5
    np.savez(ckpt, **data)
    with pytest.raises(CheckpointCorrupt, match="sha256"):
        load_chain(mk(), ckpt)


def test_lineage_falls_back_to_newest_valid(tmp_path):
    src, mk = _key_ffat_chain(total=256, K=2, C=64)
    c1 = mk()
    stem = str(tmp_path / "lin.npz")
    files = []
    for n, b in enumerate(src.batches(64)):
        c1.push(b)
        files.append(save_chain(c1, stem, meta={"n": n}, keep=2))
    man = tck._read_manifest(manifest_path(stem))
    assert len(man["entries"]) == 2
    assert not os.path.exists(files[0])
    raw = open(files[-1], "rb").read()
    open(files[-1], "wb").write(raw[:len(raw) // 2])
    assert load_chain(mk(), stem) == {"n": len(files) - 2}
    ctr = faults_mod.counters()
    assert ctr["checkpoint_corrupt_skipped"] >= 1
    assert ctr["checkpoint_fallbacks"] >= 1
    raw2 = open(files[-2], "rb").read()
    open(files[-2], "wb").write(raw2[:len(raw2) // 2])
    with pytest.raises(CheckpointCorrupt, match="no valid checkpoint"):
        load_chain(mk(), stem)


# ------------------------------------------------- the port's own contract

def test_injected_torn_save_falls_back_to_previous_commit(tmp_path):
    """A ``checkpoint.save`` torn fault leaves half a file that never reaches
    the manifest; the load restores the commit before it."""
    src, mk = _key_ffat_chain(total=256, K=2, C=64)
    c1 = mk()
    stem = str(tmp_path / "torn")
    plan = faults_mod.FaultPlan([faults_mod.FaultSpec("checkpoint.save", kind="torn",
                                                      at=[3])])
    with faults_mod.activate(faults_mod.FaultInjector(plan)):
        for n, b in enumerate(src.batches(64)):
            c1.push(b)
            if n < 2:
                save_chain(c1, stem, meta={"n": n}, keep=3)
            else:
                with pytest.raises(faults_mod.InjectedFault, match="torn"):
                    save_chain(c1, stem, meta={"n": n}, keep=3)
                break
    assert os.path.exists(stem + ".000002.npz")      # the torn file
    assert len(tck._read_manifest(manifest_path(stem))["entries"]) == 2
    assert load_chain(mk(), stem) == {"n": 1}


def test_restored_state_is_fresh_and_continues(tmp_path):
    """Every restored tensor is new memory (no alias of the template or of
    the saved chain), and a Win_Seq chain (rings updated in place) carries
    on from it to the uninterrupted rows."""
    total, C, K = 400, 32, 3
    src = wt.Source(lambda i: {"v": i % 5}, total=total, num_keys=K, **CPU)
    mk = lambda: wt.CompiledChain(  # noqa: E731
        [wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(12, 6), num_keys=K, **CPU)],
        src.payload_spec(), batch_capacity=C, **CPU)
    batches = list(src.batches(C))
    c0 = mk()
    expect = _collect([c0.push(b) for b in batches] + c0.flush())
    c1 = mk()
    outs = [c1.push(b) for b in batches[:5]]
    save_chain(c1, str(tmp_path / "ws"))
    c2 = mk()
    template = [t.data_ptr() for _, t in tck.flatten_with_paths(c2.states)]
    saved = [t.data_ptr() for _, t in tck.flatten_with_paths(c1.states)]
    load_chain(c2, str(tmp_path / "ws"))
    now = [t.data_ptr() for _, t in tck.flatten_with_paths(c2.states)]
    assert not set(now) & (set(template) | set(saved))
    outs += [c2.push(b) for b in batches[5:]] + c2.flush()
    assert _collect(outs) == expect


def test_unported_parts_raise(tmp_path):
    """Item 14's sharded checkpoints and handoffs and item 13b's archive tier
    are ported: a sharded save and load round-trip, a seal is dropped by
    ``discard_handoffs``, and an IntervalJoin's ``tier*`` arrays restore its
    archive tier (tier arrays of an untiered operator of another kind are
    ignored, as the JAX package ignores them)."""
    src, mk = _key_ffat_chain(total=64, K=2, C=32)
    c = mk()
    layout = {"num_shards": 2, "moves": []}
    man = tck.save_sharded([c.states, c.states], str(tmp_path / "s"), layout=layout,
                           meta={"batches_done": 3})
    assert [e["shard"] for e in man["shards"]] == [0, 1]
    states, got_layout, meta = tck.load_sharded(mk().states, str(tmp_path / "s"))
    assert sorted(states) == [0, 1] and got_layout == layout and meta["batches_done"] == 3
    tck.seal_handoff([c.states], str(tmp_path / "s"), layout=layout, at_pos=3)
    assert tck.discard_handoffs(str(tmp_path / "s")) == ["s.handoff0.npz"]
    src, ops = tmake("q4_interval_join", 64, tiered=dict(), **CPU)
    chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=32, **CPU)
    for b in src.batches(32):
        chain.push(b)
    ckpt = save_chain(chain, str(tmp_path / "t"))
    data = dict(np.load(ckpt))
    assert "tier0_0_key" in data and "tier0_1_key" in data
    src, ops = tmake("q4_interval_join", 64, tiered=dict(), **CPU)
    fresh = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=32, **CPU)
    load_chain(fresh, ckpt)
    assert [t.manifest()["key"].tolist() for t in fresh.ops[0].tier_controllers()] == \
        [t.manifest()["key"].tolist() for t in chain.ops[0].tier_controllers()]
    src, mk = _key_ffat_chain(total=64, K=2, C=32)
    ckpt = save_chain(mk(), str(tmp_path / "k"))
    data = dict(np.load(ckpt))
    data["tier0_0_key"] = np.zeros(4, np.int64)
    np.savez(ckpt, **data)
    load_chain(mk(), ckpt)


# --------------------------------------------- cross-package checkpoints

def _chains(kind):
    """(jax chain, port chain, jax batches, port batches) of one kind."""
    C = 64
    if kind in ("q4_interval_join", "q5_session"):
        js, jops = jmake(kind, 640)
        ts, tops = tmake(kind, 640, **CPU)
    elif kind == "key_ffat":
        js = wf.Source(lambda i: {"v": (i % 9).astype(jnp.float32)}, total=640, num_keys=3)
        ts = wt.Source(lambda i: {"v": (i % 9).float()}, total=640, num_keys=3, **CPU)
        jops = [wf.Key_FFAT(lambda t: t.v, jnp.add, spec=wf.WindowSpec(20, 10),
                            num_keys=3)]
        tops = [wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(20, 10),
                            num_keys=3, **CPU)]
    else:   # win_seq: a TB window over an int and a float field
        js = wf.Source(lambda i: {"v": i % 7, "f": (i % 5).astype(jnp.float32) - 2.0},
                       total=640, num_keys=3, ts_fn=lambda i: i // 3)
        ts = wt.Source(lambda i: {"v": i % 7, "f": (i % 5).float() - 2.0}, total=640,
                       num_keys=3, ts_fn=lambda i: i // 3, **CPU)
        jops = [wf.Win_Seq(lambda wid, it: it.sum(), wf.WindowSpec(16, 8, jwin.TB),
                           num_keys=3)]
        tops = [wt.Win_Seq(lambda wid, it: it.sum(), wt.WindowSpec(16, 8, win_type_t.TB),
                           num_keys=3, **CPU)]
    jc = wf.CompiledChain(jops, js.payload_spec(), batch_capacity=C)
    tc = wt.CompiledChain(tops, ts.payload_spec(), batch_capacity=C, **CPU)
    return jc, tc, list(js.batches(C)), list(ts.batches(C))


def _assert_same_states(tc_states, jc_states):
    t = jck._flatten(jc_states)
    p = tck._flatten(tc_states)
    assert sorted(t) == sorted(p)
    for k in t:
        assert p[k].dtype == t[k].dtype and p[k].shape == t[k].shape, k
        assert p[k].tobytes() == t[k].tobytes(), k
    assert tck.leaf_paths(tc_states) == jck._leaf_paths(jc_states)


KINDS = ["key_ffat", "win_seq", "q4_interval_join", "q5_session"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_file_restores_in_the_port(kind, tmp_path):
    jc, tc, jbs, tbs = _chains(kind)
    for b in jbs[:5]:
        jc.push(b)
    jck.save_chain(jc, str(tmp_path / kind), meta={"batches_done": 5})
    assert load_chain(tc, str(tmp_path / kind)) == {"batches_done": 5}
    _assert_same_states(tc.states, jc.states)
    # both carry on to the same rows and states
    for jb, tb in zip(jbs[5:], tbs[5:]):
        jo, to = jc.push(jb), tc.push(tb)
        assert np.asarray(jo.valid).tobytes() == to.valid.numpy().tobytes()
    _assert_same_states(tc.states, jc.states)


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_restores_in_jax(kind, tmp_path):
    jc, tc, jbs, tbs = _chains(kind)
    for b in tbs[:5]:
        tc.push(b)
    written = save_chain(tc, str(tmp_path / kind), meta={"batches_done": 5}, keep=2)
    assert written.endswith(".000000.npz")
    assert jck.load_chain(jc, str(tmp_path / kind)) == {"batches_done": 5}
    _assert_same_states(tc.states, jc.states)


@pytest.mark.parametrize("kind", KINDS)
def test_leaf_paths_equal_jax_keystr(kind):
    jc, tc, _, _ = _chains(kind)
    for st_t, st_j in zip(tc.states, jc.states):
        kl, _ = jax.tree_util.tree_flatten_with_path(st_j)
        assert [p for p, _ in tck.flatten_with_paths(st_t)] == \
            [jax.tree_util.keystr(p) for p, _ in kl]

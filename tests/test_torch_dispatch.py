"""Scan dispatch in the port (``runtime/dispatch.py``, ``CompiledChain.push_many``,
``Pipeline(dispatch=)``) on the CPU, mirroring ``tests/test_dispatch.py``.

On the CPU ``push_many`` is the plain loop over the step a CUDA graph
captures on the card. K batches through it must be byte-identical to K
sequential ``push`` calls, and to the JAX package's ``push_many`` and
``Pipeline(dispatch=4)`` on the same seeded stream (a Win_Seq chain and a
small-width YSB chain). Tolerance: byte identity (integer-valued float32
sums are exact in any order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.benchmarks import ysb as jysb
from windflow_tpu_torch.batch import stack_batches, tree_leaves, unstack_batches
from windflow_tpu_torch.benchmarks import device_cursor_step
from windflow_tpu_torch.benchmarks import ysb as tysb
from windflow_tpu_torch.runtime.dispatch import (DispatchConfig, MicrobatchAccumulator,
                                                 build_k_ladder, refuse_k_tuner)

TOTAL, NKEYS = 240, 3
CPU = {"device": "cpu"}


def mk_source(total=TOTAL, X=wt):
    kw = CPU if X is wt else {}
    f32 = (lambda a: a.float()) if X is wt else (lambda a: a.astype(jnp.float32))
    return X.Source(lambda i: {"v": f32(i % 13)}, total=total, num_keys=NKEYS, **kw)


def _leaves(b):
    return tree_leaves((b.key, b.id, b.ts, b.payload, b.valid))


def _batches_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


# ------------------------------------------------------- stack / unstack

def test_stack_unstack_roundtrip_byte_exact():
    batches = list(mk_source(64).batches(16))
    stacked = stack_batches(batches)
    assert stacked.key.shape == (len(batches), 16)
    back = unstack_batches(stacked)
    assert len(back) == len(batches)
    for a, b in zip(batches, back):
        _batches_equal(a, b)


def test_stack_batches_rejects_mixed_capacity_and_empty():
    b16 = next(iter(mk_source(32).batches(16)))
    b8 = next(iter(mk_source(32).batches(8)))
    with pytest.raises(ValueError, match="mixed capacities"):
        stack_batches([b16, b8])
    with pytest.raises(ValueError, match="at least one"):
        stack_batches([])


# ----------------------------------------------------------- accumulator

class _FakeBatch:
    def __init__(self, capacity):
        self.capacity = capacity


def test_accumulator_groups_by_k_and_flushes_on_capacity_switch():
    acc = MicrobatchAccumulator(3)
    out = []
    for _ in range(5):
        out += acc.feed(_FakeBatch(16))
    assert [len(g) for g in out] == [3]
    groups = acc.feed(_FakeBatch(8))      # the partial run goes first
    assert [len(g) for g in groups] == [2]
    assert [b.capacity for b in groups[0]] == [16, 16]
    assert len(acc) == 1
    assert [b.capacity for b in acc.drain()] == [8]
    assert acc.drain() == []


def test_accumulator_linger_and_set_k_fake_clock():
    now = {"t": 0.0}
    acc = MicrobatchAccumulator(4, linger_s=0.5, clock=lambda: now["t"])
    assert not acc.expired()
    acc.feed(_FakeBatch(16))
    assert not acc.expired()
    now["t"] = 0.6
    assert acc.expired()
    assert len(acc.take()) == 1
    assert not acc.expired()          # empty: never expired
    acc.set_k(2)
    assert acc.feed(_FakeBatch(16)) == []
    assert len(acc.feed(_FakeBatch(16))[0]) == 2
    acc.feed(_FakeBatch(16))
    acc.clear()
    assert len(acc) == 0 and acc.drain() == []


def test_dispatch_config_resolve_forms(monkeypatch, tmp_path):
    monkeypatch.delenv("WF_DISPATCH", raising=False)
    monkeypatch.delenv("WF_DISPATCH_K", raising=False)
    monkeypatch.delenv("WF_CONTROL", raising=False)
    assert DispatchConfig.resolve(None) is None
    assert DispatchConfig.resolve(False) is None
    assert DispatchConfig.resolve(0) is None
    assert DispatchConfig.resolve(True).k == 8
    assert DispatchConfig.resolve(6).k == 6
    assert DispatchConfig.resolve({"k": 3, "linger_s": 0.0}).linger_s == 0.0
    assert DispatchConfig.resolve("5").k == 5
    cfg = DispatchConfig(k=5)
    assert DispatchConfig.resolve(cfg) is cfg
    path = tmp_path / "dispatch.json"
    path.write_text(json.dumps({"k": 7, "autotune_k": False}))
    r = DispatchConfig.resolve(str(path))
    assert (r.k, r.autotune_k) == (7, False)
    monkeypatch.setenv("WF_DISPATCH", "0")
    assert DispatchConfig.resolve(None) is None
    monkeypatch.setenv("WF_DISPATCH", "4")
    assert DispatchConfig.resolve(None).k == 4
    monkeypatch.setenv("WF_DISPATCH", json.dumps({"k": 2, "prewarm": False}))
    r = DispatchConfig.resolve(None)
    assert (r.k, r.prewarm) == (2, False)
    monkeypatch.setenv("WF_DISPATCH", "1")
    monkeypatch.setenv("WF_DISPATCH_K", "16")
    assert DispatchConfig.resolve(None).k == 16
    assert DispatchConfig.resolve(4).k == 16      # the K env wins whenever on
    with pytest.raises(ValueError):
        DispatchConfig(k=0)
    with pytest.raises(ValueError):
        DispatchConfig(linger_s=-1)


def test_k_tuner_is_refused_while_the_control_plane_is_asked_for(monkeypatch):
    monkeypatch.delenv("WF_CONTROL", raising=False)
    refuse_k_tuner(DispatchConfig(k=4))
    monkeypatch.setenv("WF_CONTROL", "1")
    refuse_k_tuner(DispatchConfig(k=4, autotune_k=False))
    refuse_k_tuner(DispatchConfig(k=1))
    with pytest.raises(NotImplementedError, match="item 15"):
        refuse_k_tuner(DispatchConfig(k=4))
    with pytest.raises(NotImplementedError, match="item 15"):
        _run_pipeline(4)


def test_build_k_ladder():
    assert build_k_ladder(1) == [1]
    assert build_k_ladder(8) == [1, 2, 4, 8]
    assert build_k_ladder(6) == [1, 2, 4, 6]
    with pytest.raises(ValueError):
        build_k_ladder(0)


# ------------------------------------------------------------- push_many

def _win_ops(X=wt):
    kw = CPU if X is wt else {}
    return [X.Map(lambda t: {"v": t.v * 2.0}, **kw),
            X.Win_Seq(lambda wid, it: it.sum("v"),
                      X.WindowSpec(10, 10, X.win_type_t.TB), num_keys=NKEYS, **kw)]


def _chain(total=128, X=wt):
    src = mk_source(total, X)
    kw = CPU if X is wt else {}
    return X.CompiledChain(_win_ops(X), src.payload_spec(), batch_capacity=16, **kw)


def test_push_many_byte_identical_to_sequential_push():
    seq, fused = _chain(), _chain()
    batches = list(mk_source(128).batches(16))
    outs_seq = [seq.push(b) for b in batches]
    outs_fused = fused.push_many(batches)
    assert len(outs_fused) == len(outs_seq)
    for a, b in zip(outs_seq, outs_fused):
        _batches_equal(a, b)
    for sa, sb in zip(convert_states(seq), convert_states(fused)):
        for x, y in zip(sa, sb):
            np.testing.assert_array_equal(x, y)
    one = fused.push_many([batches[0]])           # K = 1 delegates to push
    assert len(one) == 1


def convert_states(chain):
    from windflow_tpu_torch import convert
    return [jax.tree.leaves(s) for s in convert.chain_states_to_numpy(chain)]


def test_push_many_stats_k_batches_one_launch():
    chain = _chain(96)
    batches = list(mk_source(96).batches(16))
    chain.push_many(batches)
    for op in chain.ops:
        rec = op.get_StatsRecords()[0]
        assert rec.batches_received == rec.batches_sent == len(batches)
        assert rec.bytes_received > 0
    assert chain.ops[0].get_StatsRecords()[0].num_kernels == 1    # ONE for K batches
    assert chain.ops[1].get_StatsRecords()[0].num_kernels == 0


def test_push_many_matches_jax_push_many():
    jbatches = list(mk_source(128, wf).batches(16))
    jouts = _chain(128, wf).push_many(jbatches)
    touts = _chain(128).push_many(list(mk_source(128).batches(16)))
    assert len(jouts) == len(touts) == 8
    for j, t in zip(jouts, touts):
        for a, b in zip(jax.tree.leaves((j.key, j.id, j.ts, j.payload, j.valid)),
                        _leaves(t)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_warm_scan_touches_no_state():
    chain = _chain(64)
    for b in list(mk_source(64).batches(16))[:2]:   # a state with content
        chain.push(b)
    before = convert_states(chain)
    chain.warm_scan(4, 16)
    chain.warm_scan(1, 16)
    for a, b in zip(before, convert_states(chain)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert (0, 16) in chain._warmed


def test_captured_step_state_is_consumed():
    chain = _chain(64)
    held = chain.states[1]
    chain.push_many(list(mk_source(64).batches(16))[:2])
    with pytest.raises(RuntimeError, match="consumed"):
        chain.ops[1].apply(held, next(iter(mk_source(64).batches(16))))


# ------------------------------------------------------- Pipeline driver

def _collect(acc):
    def cb(view):
        if view is None:
            return
        acc.extend(zip(view["key"].tolist(), view["id"].tolist(),
                       np.asarray(view["payload"]).tolist()))
    return cb


def _pipe_ops(X):
    kw = CPU if X is wt else {}
    return [X.Map(lambda t: {"v": t.v * 3.0}, **kw),
            X.Win_Seq(lambda wid, it: it.sum("v"), X.WindowSpec(12, 6, X.win_type_t.CB),
                      num_keys=NKEYS, **kw)]


def _run_pipeline(dispatch=None, X=wt, batch=16):
    got = []
    kw = CPU if X is wt else {}
    X.Pipeline(mk_source(TOTAL, X), _pipe_ops(X), X.Sink(_collect(got), **kw),
               batch_size=batch, dispatch=dispatch, **kw).run()
    return got


@pytest.mark.parametrize("dispatch", [4, 1, {"k": 32, "prewarm": False}, "3"])
def test_pipeline_dispatch_byte_identical_with_partial_tail(dispatch, monkeypatch):
    monkeypatch.delenv("WF_DISPATCH", raising=False)
    monkeypatch.delenv("WF_DISPATCH_K", raising=False)
    # 15 batches: at K=4 three full groups and a 3-batch tail at EOS
    assert _run_pipeline(dispatch) == _run_pipeline(None)


def test_pipeline_dispatch_env(monkeypatch):
    monkeypatch.setenv("WF_DISPATCH", "4")
    monkeypatch.delenv("WF_DISPATCH_K", raising=False)
    got = _run_pipeline(None)
    monkeypatch.setenv("WF_DISPATCH", "0")
    assert got == _run_pipeline(None)


def test_pipeline_dispatch_matches_jax(monkeypatch):
    monkeypatch.delenv("WF_DISPATCH", raising=False)
    monkeypatch.delenv("WF_DISPATCH_K", raising=False)
    want = _run_pipeline(4, wf)
    assert want
    assert _run_pipeline(4) == want


def _ysb(X, dispatch, total=3000, batch=256):
    results = []

    def cb(view):
        if view is None:
            return
        results.extend((int(k), int(w), int(c)) for k, w, c in
                       zip(view["key"].tolist(), view["id"].tolist(),
                           np.asarray(view["payload"]).tolist()))
    if X is wf:
        wf.Pipeline(jysb.make_source(total), jysb.make_ops(), wf.Sink(cb),
                    batch_size=batch, dispatch=dispatch).run()
    else:
        wt.Pipeline(tysb.make_source(total, device="cpu"), tysb.make_ops(device="cpu"),
                    wt.Sink(cb, device="cpu"), batch_size=batch, device="cpu",
                    dispatch=dispatch).run()
    return results


def test_pipeline_dispatch_ysb_matches_jax_and_dispatch_off(monkeypatch):
    monkeypatch.delenv("WF_DISPATCH", raising=False)
    monkeypatch.delenv("WF_DISPATCH_K", raising=False)
    plain = _ysb(wt, None)
    assert sum(c for *_, c in plain) == tysb.oracle_totals(3000)
    got = _ysb(wt, 4)
    assert got == plain
    assert got == _ysb(wf, 4)


def test_device_cursor_step_on_the_cpu_is_the_eager_step():
    src = tysb.make_source(4 * 256, device="cpu")
    chain = wt.CompiledChain(tysb.make_ops(device="cpu"), src.payload_spec(),
                             batch_capacity=256, device="cpu")
    step = device_cursor_step(chain, src, 256)
    assert callable(step) and not hasattr(step, "graph")
    states, cur = tuple(chain.states), torch.zeros((), dtype=torch.int32)
    for _ in range(3):
        states, cur, out = step(states, cur)
    assert int(cur) == 3 * 256 and out.shape == (chain.ops[-1].out_capacity(256),)


def test_state_tree_leaves_rebuild_and_consume():
    """The captured step's state carry: leaves in a fixed order, a rebuilt
    tree of fresh objects over new leaves (a fresh WinSeqState is not
    consumed), and consume() marking what a captured step hands over."""
    from windflow_tpu_torch.runtime.graphs import consume, leaves, rebuild
    chain = _chain(64)
    chain.push(next(iter(mk_source(64).batches(16))))
    tree = (list(chain.states), {"n": torch.arange(3), "none": None})
    flat = leaves(tree)
    assert flat[0] is None                          # the Map's state
    assert flat[-1] is None and torch.equal(flat[-2], torch.arange(3))
    again = rebuild(tree, [x.clone() if isinstance(x, torch.Tensor) else x for x in flat])
    assert type(again) is tuple and type(again[0]) is list
    assert again[0][1] is not chain.states[1]
    for a, b in zip(leaves(again), flat):
        assert (a is None and b is None) or torch.equal(a, b)
    consume(again)
    with pytest.raises(RuntimeError, match="consumed"):
        chain.ops[1].apply(again[0][1], next(iter(mk_source(64).batches(16))))
    chain.push(next(iter(mk_source(64).batches(16))))   # the chain's own state lives on

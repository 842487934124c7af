"""The parallel window patterns and YSB-WMR in the port against the JAX
package on the CPU.

Every case of ``tests/test_win_patterns.py`` except the Key_FFAT max-combine
case (the port's Win_SeqFFAT combines with ``torch.add`` only) runs as the
same stream through both packages; the sorted ``(key, wid, value)`` sink
tuples must be equal, at the case's batch size and at another. The CB
Key_FFAT cases need Win_SeqFFAT's per-key path, which the port does not have
yet (it raises): there the port's Win_Seq is held to the JAX Key_FFAT, the
property the JAX test checks. YSB-WMR at a small total is held to
``windflow_tpu.benchmarks.ysb.make_ops_wmr`` and to a dense count.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.benchmarks import ysb as jysb
from windflow_tpu.runtime.builders import KeyFarm_Builder, WinMapReduce_Builder
from windflow_tpu_torch.benchmarks import ysb as tysb
from windflow_tpu_torch.ops import registry
from tests.test_torch_win_seq import JAX, PORT, run


def _sum_v(X, spec, K, **kw):
    return X.Win_Seq(lambda wid, it: it.sum("v"), spec, num_keys=K, **X.kw, **kw)


def _pf(X, spec, K):
    return X.Pane_Farm(lambda pid, it: it.sum("v"), lambda wid, it: it.sum(), spec,
                       num_keys=K, **X.kw)


def _wmr(X, spec, K, M=2, reduce=lambda wid, it: it.sum()):
    return X.Win_MapReduce(lambda wid, it: it.sum("v"), reduce, spec,
                           map_parallelism=M, num_keys=K, **X.kw)


def _kf_wmr_builder(X):
    if X is PORT:
        return X.Key_Farm(_wmr(X, X.WindowSpec(6, 3, X.CB), 2, M=3), parallelism=2)
    inner = (WinMapReduce_Builder(lambda wid, it: it.sum("v"), lambda wid, it: it.sum())
             .withCBWindows(6, 3).withMapParallelism(3).withKeys(2).build())
    return KeyFarm_Builder(inner).withParallelism(2).build()


def _inc1(X):
    return lambda i: {"v": X.f32(i + 1)}


# name: (make_op, total, K, batch sizes, source)
CASES = {
    "key_farm_matches_win_seq": (
        lambda X: X.Key_Farm(lambda wid, it: it.sum("v"), X.WindowSpec(6, 2, X.CB),
                             parallelism=4, num_keys=3, **X.kw), 150, 3, (32, 70), None),
    "win_farm_keyless": (
        lambda X: X.Win_Farm(lambda wid, it: it.sum("v"), X.WindowSpec(8, 4, X.CB),
                             parallelism=4, **X.kw), 128, 1, (32, 20), None),
    "key_ffat_tb": (
        lambda X: X.Key_FFAT(lambda t: t.v, X.add, spec=X.WindowSpec(8, 4, X.TB),
                             num_keys=2, **X.kw), 120, 2, (32, 48), None),
    "pane_farm_matches_win_seq": (
        lambda X: _pf(X, X.WindowSpec(6, 2, X.CB), 3), 150, 3, (32, 45), None),
    "win_mapreduce_matches_win_seq": (
        lambda X: _wmr(X, X.WindowSpec(8, 8, X.CB), 2, M=4), 160, 2, (32, 64), None),
    "win_mapreduce_non_divisible": (
        lambda X: _wmr(X, X.WindowSpec(10, 10, X.CB), 2, M=3), 200, 2, (32, 16), None),
    "win_mapreduce_tb": (
        lambda X: _wmr(X, X.WindowSpec(8, 8, X.TB), 2), 160, 2, (32, 80), None),
    "win_mapreduce_empty_partition_not_poisoning_reduce": (
        lambda X: _wmr(X, X.WindowSpec(2, 2, X.TB), 1, M=3,
                       reduce=lambda wid, it: it.min()), 8, 1, (8, 3), _inc1),
    "win_mapreduce_sliding": (
        lambda X: _wmr(X, X.WindowSpec(8, 4, X.CB), 2, M=4), 160, 2, (32, 24), None),
    "nested_wf_pf": (
        lambda X: X.Win_Farm(_pf(X, X.WindowSpec(6, 2, X.CB), 3), parallelism=4),
        150, 3, (32, 64), None),
    "nested_kf_pf_tb": (
        lambda X: X.Key_Farm(_pf(X, X.WindowSpec(8, 4, X.TB), 2), parallelism=2),
        160, 2, (32, 40), None),
    "nested_wf_wmr": (
        lambda X: X.Win_Farm(_wmr(X, X.WindowSpec(8, 4, X.CB), 2, M=4), parallelism=2),
        160, 2, (32, 56), None),
    "nested_kf_wmr_builder": (_kf_wmr_builder, 150, 2, (32, 50), None),
}

PARAMS = [(name, bs) for name, case in CASES.items() for bs in case[3]]


@functools.lru_cache(maxsize=None)
def jax_result(name):
    make_op, total, K, sizes, src_fn = CASES[name]
    return run(JAX, make_op, total, K, sizes[0], src_fn)


@pytest.mark.parametrize("name,batch_size", PARAMS)
def test_pattern_matches_jax(name, batch_size):
    make_op, total, K, _, src_fn = CASES[name]
    want = jax_result(name)
    assert want, "the JAX run emitted nothing"
    assert run(PORT, make_op, total, K, batch_size, src_fn) == want


def test_empty_partition_reduce_values():
    """The JAX test's own expectation: min over non-empty partials only."""
    got = [(w, v) for _, w, v in jax_result(
        "win_mapreduce_empty_partition_not_poisoning_reduce")]
    assert got == [(0, 1.0), (1, 3.0), (2, 5.0), (3, 7.0)]


def test_nesting_shapes_and_guards():
    spec = wt.WindowSpec(6, 2)
    op = wt.Win_Farm(_pf(PORT, spec, 3), parallelism=4)
    assert isinstance(op, wt.Nested_Farm) and op.shard_axis == "window"
    assert op.device == torch.device("cpu") and op.num_keys == 3
    op = wt.Key_Farm(_wmr(PORT, spec, 3), parallelism=2)
    assert isinstance(op, wt.Nested_Farm) and op.shard_axis == "key"
    with pytest.raises(TypeError, match="nesting accepts only"):
        wt.Key_Farm(_wmr(PORT, spec, 3), spec)
    with pytest.raises(TypeError, match="nesting accepts only"):
        wt.Win_Farm(_pf(PORT, spec, 3), device="cpu")
    with pytest.raises(ValueError, match="sliding"):
        wt.Pane_Farm(lambda p, it: it.sum("v"), lambda w, it: it.sum(), wt.WindowSpec(4, 4),
                     device="cpu")
    with pytest.raises(ValueError, match="map_parallelism"):
        wt.Win_MapReduce(lambda w, it: it.sum("v"), lambda w, it: it.sum(), spec,
                         map_parallelism=1, device="cpu")


def test_cb_key_ffat_cases_against_port_win_seq():
    """test_key_ffat_matches_win_seq_sum (CB): the port's Win_Seq equals the
    JAX Key_FFAT; the port's own CB Key_FFAT raises until its per-key path
    is ported."""
    spec_j = JAX.WindowSpec(6, 2, JAX.CB)
    want = run(JAX, lambda X: X.Key_FFAT(lambda t: t.v, jnp.add, spec=spec_j, num_keys=3),
               150, 3, 32)
    got = run(PORT, lambda X: _sum_v(X, X.WindowSpec(6, 2, X.CB), 3), 150, 3, 32)
    assert got == want and want
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(6, 2), num_keys=3,
                    device="cpu").init_state({"v": torch.zeros(())})


def _fuzz_geometry(trial):
    """The random geometry of test_fuzz_patterns_match_win_seq_random_geometry's
    trial ``trial`` (same generator, same draws)."""
    rng = np.random.default_rng(11)
    for t in range(trial + 1):
        tb = t % 2 == 1
        slide = int(rng.integers(2, 8))
        win = slide * int(rng.integers(1, 4))
        K = int(rng.integers(1, 4))
        total = int(rng.integers(60, 200))
        bs = int(rng.integers(16, 64))
    return tb, win, slide, K, total, bs


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_patterns_match_jax_win_seq(trial):
    """Every port pattern of the JAX fuzz trial equals the JAX Win_Seq
    oracle of that trial (the JAX test's property, across packages)."""
    tb, win, slide, K, total, bs = _fuzz_geometry(trial)

    def spec(X):
        return X.WindowSpec(win, slide, X.TB if tb else X.CB)
    oracle = run(JAX, lambda X: _sum_v(X, spec(X), K), total, K, bs)
    pats = [lambda X: X.Key_Farm(lambda wid, it: it.sum("v"), spec(X), parallelism=2,
                                 num_keys=K, **X.kw),
            lambda X: X.Win_Farm(lambda wid, it: it.sum("v"), spec(X), parallelism=3,
                                 num_keys=K, **X.kw)]
    if tb:                         # the port's Key_FFAT runs the global-time TB path
        pats.append(lambda X: X.Key_FFAT(lambda t: t.v, X.add, spec=spec(X),
                                         num_keys=K, **X.kw))
    if win > slide:
        pats.append(lambda X: _pf(X, spec(X), K))
    if not tb or win == slide:
        pats.append(lambda X: _wmr(X, spec(X), K))
    for make_op in pats:
        got = run(PORT, make_op, total, K, bs)
        assert got == oracle, (trial, make_op(PORT).name, win, slide, tb, K, total, bs)


# ------------------------------------------------------------- YSB-WMR

WMR_TOTAL, WMR_BATCH = 6000, 1000


def _ysb_wmr(X, batch):
    total_sink = (wf.ReduceSink(lambda t: t.data, name="wmr_total") if X is JAX else
                  wt.ReduceSink(lambda t: t.data, name="wmr_total", device="cpu"))
    if X is JAX:
        ops, src = jysb.make_ops_wmr(map_parallelism=4), jysb.make_source(WMR_TOTAL)
    else:
        ops = tysb.make_ops_wmr(map_parallelism=4, device="cpu")
        src = tysb.make_source(WMR_TOTAL, device="cpu")
    out = []

    def cb(view):
        if view is not None:
            out.extend(zip(np.asarray(view["key"]).tolist(), np.asarray(view["id"]).tolist(),
                           np.asarray(view["payload"]).tolist()))
    res = X.Pipeline(src, ops + [total_sink], X.Sink(cb, **X.kw), batch_size=batch,
                     **X.kw).run()
    return sorted(out), int(np.asarray(res["wmr_total"]))


@pytest.mark.parametrize("batch", [1000, 768])
def test_ysb_wmr_matches_jax_and_dense_count(batch):
    registry.reset_launches()
    got, total = _ysb_wmr(PORT, batch)
    want, want_total = _ysb_wmr(JAX, WMR_BATCH)
    assert got == want
    assert total == want_total == tysb.oracle_totals(WMR_TOTAL)
    assert {(k, w): c for k, w, c in got} == tysb.dense_oracle(WMR_TOTAL)
    assert set(registry.launch_counts().values()) == {0}   # CPU: plain versions only

"""The port's YSB chain against the JAX package's, on the CPU.

Mirrors ``tests/test_ysb.py::run_variant``: the same stream goes through
``windflow_tpu`` and through ``windflow_tpu_torch`` (``device="cpu"``, so every
kernel runs as its plain PyTorch version) and the sorted ``(key, window,
value)`` sink tuples must be identical. Also: the totals and dense per-window
oracles, source parity past the int32 wrap of ``i * 7919``, the YSB-sum
variant (an additive non-count lift: the K3 path), and the count-lift
detection, whose choice must not change the panes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.benchmarks import ysb as jysb
from windflow_tpu_torch.benchmarks import ysb as tysb
from windflow_tpu_torch.operators.win_seqffat import _detect_count_lift

TOTAL = 3000        # 300 time units = 3 windows per campaign


def _collect(results):
    def cb(view):
        if view is None:
            return
        for k, w, c in zip(view["key"].tolist(), view["id"].tolist(),
                           np.asarray(view["payload"]).tolist()):
            results.append((int(k), int(w), int(c)))
    return cb


def run_jax(ops, batch_size, total=TOTAL):
    results = []
    wf.Pipeline(jysb.make_source(total), ops, wf.Sink(_collect(results)),
                batch_size=batch_size).run()
    return sorted(results)


def run_port(ops, batch_size, total=TOTAL):
    results = []
    wt.Pipeline(tysb.make_source(total, device="cpu"), ops,
                wt.Sink(_collect(results), device="cpu"),
                batch_size=batch_size, device="cpu").run()
    return sorted(results)


def jax_sum_ops():
    """The JAX package's chain for YSB-sum (its ysb module has no such variant)."""
    from windflow_tpu.ops.lookup import table_lookup
    camp_of = jnp.asarray(np.arange(jysb.N_ADS) // jysb.ADS_PER_CAMPAIGN, jnp.int32)
    return [wf.Filter(lambda t: t.event_type == 0),
            wf.BatchMap(lambda p: {"cmp": table_lookup(camp_of, p["ad_id"]),
                                   "ad_id": p["ad_id"]}),
            wf.KeyBy(lambda t: t.cmp, jysb.N_CAMPAIGNS),
            wf.Key_FFAT(lambda t: t.ad_id, jnp.add,
                        spec=wf.WindowSpec(jysb.WIN_LEN, jysb.WIN_LEN, wf.win_type_t.TB),
                        num_keys=jysb.N_CAMPAIGNS)]


@pytest.mark.parametrize("batch_size", [256, 1000, TOTAL])
def test_ysb_sink_tuples_match_jax(batch_size):
    got = run_port(tysb.make_ops(device="cpu"), batch_size)
    assert got, "no window results emitted"
    assert got == run_jax(jysb.make_ops(), batch_size)
    assert sum(c for _, _, c in got) == tysb.oracle_totals(TOTAL) == jysb.oracle_totals(TOTAL)


def test_ysb_make_pipeline_reduce_sink_total():
    res = tysb.make_pipeline(TOTAL, batch_size=700, device="cpu").run()
    assert int(res["ysb_windows_total"]) == tysb.oracle_totals(TOTAL)


def test_ysb_per_window_counts_against_dense_oracle():
    got = {(k, w): c for k, w, c in run_port(tysb.make_ops(device="cpu"), 512)}
    want = {}
    for i in range(TOTAL):
        if i % 3 != 0:
            continue
        camp = (i * 7919) % tysb.N_ADS // tysb.ADS_PER_CAMPAIGN
        wid = (i // tysb.EVENTS_PER_TICK) // tysb.WIN_LEN
        want[(camp, wid)] = want.get((camp, wid), 0) + 1
    assert got == want == tysb.dense_oracle(TOTAL)


def test_make_batch_parity_past_int32_wrap():
    start, C = 1_000_000, 4096           # i * 7919 wraps once i >= 271,182
    jb = jysb.make_source(2_000_000).make_batch(jnp.asarray(start, jnp.int32), C)
    tb = tysb.make_source(2_000_000, device="cpu").make_batch(start, C)
    for name in ("key", "id", "ts", "valid"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    for name in ("ad_id", "event_type"):
        assert tb.payload[name].dtype == torch.int32
        np.testing.assert_array_equal(tb.payload[name].numpy(),
                                      np.asarray(jb.payload[name]))
    assert (tb.payload["ad_id"] >= 0).all()


@pytest.mark.parametrize("batch_size", [512, 1000])
def test_ysb_sum_matches_jax_and_oracle(batch_size):
    ops = tysb.make_ops_sum(device="cpu")
    got = run_port(ops, batch_size)
    assert ops[-1].count_lift is False
    assert got == run_jax(jax_sum_ops(), batch_size)
    assert {(k, w): c for k, w, c in got} == tysb.dense_oracle(TOTAL, "sum")


def test_count_lift_choice_gives_the_same_panes():
    """The detected count lift (histogram partials) and the forced general
    additive path (segment_fold partials) hold identical panes batch by batch."""
    src = tysb.make_source(TOTAL, device="cpu")
    chains = [wt.CompiledChain(tysb.make_ops(device="cpu", count_lift=cl),
                               src.payload_spec(), batch_capacity=500, device="cpu")
              for cl in (None, False)]
    for start in range(0, TOTAL, 500):
        outs = [c.push(src.make_batch(start, 500)) for c in chains]
        a, b = (c.states[-1] for c in chains)
        assert torch.equal(a.panes, b.panes) and torch.equal(a.cnt, b.cnt)
        for f in ("key", "id", "ts", "payload", "valid"):
            assert torch.equal(getattr(outs[0], f), getattr(outs[1], f))
    assert chains[0].ops[-1].count_lift is True
    assert chains[1].ops[-1].count_lift is False


@pytest.mark.parametrize("lift,expect", [
    (lambda t: torch.ones((), dtype=torch.int32), True),
    (lambda t: torch.tensor(1.0), True),
    (lambda t: t.ad_id, False),
    (lambda t: t.ad_id * 0 + 1, False),                     # depends on the input
    (lambda t: torch.ones((), dtype=torch.int32) * 2, False),
    (lambda t: torch.ones((2,), dtype=torch.int32), False),   # not a scalar
    (lambda t: torch.randint(1, 2, ()), False),               # random op
    (lambda t: torch.ones(()) if t.ad_id > 0 else torch.zeros(()), False),
])
def test_detect_count_lift(lift, expect):
    spec = {"ad_id": torch.empty((), dtype=torch.int32, device="meta")}
    assert _detect_count_lift(lift, spec) is expect

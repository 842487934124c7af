"""Carrying operator state from the JAX package into the port.

A stream starts in ``windflow_tpu`` for k batches; ``windflow_tpu_torch.convert``
carries the chain's states (Win_SeqFFAT pane ring and clock, ReduceSink
accumulator) across as numpy arrays; the port finishes the stream and flushes.
The sink tuples must equal a run done wholly in JAX, and the carried state must
survive the round trip unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.benchmarks import ysb as jysb
from windflow_tpu_torch import convert
from windflow_tpu_torch.benchmarks import ysb as tysb
from tests.test_torch_ysb import jax_sum_ops

TOTAL, BATCH = 3000, 512


def _tuples(view):
    return [(int(k), int(w), int(c)) for k, w, c in
            zip(view["key"].tolist(), view["id"].tolist(),
                np.asarray(view["payload"]).tolist())]


def _jax_view(b):
    v = np.asarray(b.valid)
    return {"key": np.asarray(b.key)[v], "id": np.asarray(b.id)[v],
            "payload": np.asarray(b.payload)[v]}


def _jax_chain(variant):
    ops = jysb.make_ops() if variant == "count" else jax_sum_ops()
    ops.append(wf.ReduceSink(lambda t: t.data, name="total"))
    src = jysb.make_source(TOTAL)
    return src, wf.CompiledChain(ops, src.payload_spec(), batch_capacity=BATCH)


def _port_chain(variant):
    ops = (tysb.make_ops(device="cpu") if variant == "count"
           else tysb.make_ops_sum(device="cpu"))
    ops.append(wt.ReduceSink(lambda t: t.data, name="total", device="cpu"))
    src = tysb.make_source(TOTAL, device="cpu")
    return src, wt.CompiledChain(ops, src.payload_spec(), batch_capacity=BATCH,
                                 device="cpu")


def _run_jax(src, chain, starts, out):
    for s in starts:
        out += _tuples(_jax_view(chain.push(src.make_batch(jnp.asarray(s, jnp.int32), BATCH))))


@pytest.mark.parametrize("variant", ["count", "sum"])
@pytest.mark.parametrize("k", [1, 3])
def test_jax_prefix_then_port_matches_all_jax(variant, k):
    starts = list(range(0, TOTAL, BATCH))
    # reference: the whole stream in JAX
    jsrc, jchain = _jax_chain(variant)
    want = []
    _run_jax(jsrc, jchain, starts, want)
    for fb in jchain.flush():
        want += _tuples(_jax_view(fb))
    want_total = int(np.asarray(jchain.result()["total"]))

    # k batches in JAX, the rest in the port
    jsrc, jchain = _jax_chain(variant)
    got = []
    _run_jax(jsrc, jchain, starts[:k], got)
    host_states = [jax.tree.map(np.asarray, s) for s in jchain.states]
    tsrc, tchain = _port_chain(variant)
    convert.chain_states_from_numpy(tchain, host_states)
    for s in starts[k:]:
        got += _tuples(wt.batch.host_view(tchain.push(tsrc.make_batch(s, BATCH))))
    for fb in tchain.flush():
        got += _tuples(wt.batch.host_view(fb))
    assert sorted(got) == sorted(want)
    assert int(tchain.result()["total"]) == want_total == sum(c for *_, c in want)


def test_state_round_trip():
    jsrc, jchain = _jax_chain("count")
    _run_jax(jsrc, jchain, [0, BATCH], [])
    host = [jax.tree.map(np.asarray, s) for s in jchain.states]
    _, tchain = _port_chain("count")
    convert.chain_states_from_numpy(tchain, host)
    back = convert.chain_states_to_numpy(tchain)
    win = back[3]
    for f in convert.GFFAT_FIELDS:
        np.testing.assert_array_equal(win[f], getattr(host[3], f))
        assert win[f].dtype == getattr(host[3], f).dtype
    np.testing.assert_array_equal(back[4], host[4])
    assert back[:3] == [None, None, None]

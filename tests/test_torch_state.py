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


# ----------------------------------------- F1 / F2: held states and snapshots

def _win_seq_chain(wtype):
    op = wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(24, 24, wtype),
                    num_keys=2, device="cpu")
    src = wt.Source(lambda i: {"v": i.float()}, total=10 * 16, num_keys=2, device="cpu")
    chain = wt.CompiledChain([op], src.payload_spec(), batch_capacity=16, device="cpu")
    return src, chain


def _window0(outs):
    return {k: v for b in outs for k, w, v in zip(*(
        wt.batch.host_view(b)[f].tolist() for f in ("key", "id", "payload"))) if w == 0}


@pytest.mark.parametrize("wtype,replay,want", [
    (wt.win_type_t.CB, 2, {0: 552.0, 1: 576.0}),
    (wt.win_type_t.TB, 1, {0: 132.0, 1: 144.0})])
def test_win_seq_held_state_raises_and_snapshot_replays(wtype, replay, want):
    """Win_Seq updates its rings in place: a state held after batch 1 is
    consumed by the next push, applying it again raises, and a snapshot
    taken with chain_states_to_numpy replays window 0 exactly after 8 more
    batches have wrapped the rings."""
    src, chain = _win_seq_chain(wtype)
    batches = [src.make_batch(16 * j, 16) for j in range(10)]
    chain.push(batches[0])
    held = chain.states[0]
    snap = convert.chain_states_to_numpy(chain)
    for b in batches[1:9]:
        chain.push(b)
    with pytest.raises(RuntimeError, match="consumed"):
        chain.ops[0].apply(held, batches[1])
    convert.chain_states_from_numpy(chain, snap)
    assert _window0([chain.push(b) for b in batches[1:1 + replay]]) == want


def test_state_to_numpy_snapshot_does_not_move():
    src, chain = _win_seq_chain(wt.win_type_t.TB)
    chain.push(src.make_batch(0, 16))
    snap = convert.chain_states_to_numpy(chain)
    kept = [np.array(a, copy=True) for a in jax.tree.leaves(snap)]
    for j in range(1, 6):
        chain.push(src.make_batch(16 * j, 16))
    for a, b in zip(jax.tree.leaves(snap), kept):
        np.testing.assert_array_equal(a, b)
    # the count chain's snapshot too (Win_SeqFFAT pane ring, ReduceSink)
    tsrc, tchain = _port_chain("count")
    tchain.push(tsrc.make_batch(0, BATCH))
    snap = convert.chain_states_to_numpy(tchain)
    kept = [np.array(a, copy=True) for a in jax.tree.leaves(snap)]
    for s in range(BATCH, 6 * BATCH, BATCH):
        tchain.push(tsrc.make_batch(s, BATCH))
    for a, b in zip(jax.tree.leaves(snap), kept):
        np.testing.assert_array_equal(a, b)

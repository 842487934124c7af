"""Win_SeqFFAT's per-key path and its general combines in the port against
the JAX package on the CPU.

The per-key path (CB windows, and TB with ``global_time=False``) runs the
same streams through both packages (the port with ``device="cpu"``):

- the 2x2 matrix product of ``tests/test_ffat_noncommutative.py`` (an
  associative combine that does not commute), against the JAX operator and
  the sequential oracle within rtol = 1e-4, atol = 1e-5 (the JAX test's
  tolerance: the two packages fold partials in other association orders);
- the random geometries of ``tests/test_fuzz_windows.py``: CB sum and max
  against the JAX Key_FFAT and the absolute Python oracle, per-key TB and
  its out-of-order lateness cases against the JAX Key_FFAT, byte for byte
  (the values are integers carried as float32, exact in any order);
- the max combine on the global-time TB path, ``tree_reduce``'s pairing, the
  default window-budget guard, and a stream started in the JAX package and
  carried into the port with ``convert`` (per-key ``FFATState``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu.operators.win_seqffat import _tree_reduce
from windflow_tpu_torch import convert
from windflow_tpu_torch.ops.segment import tree_reduce
from tests.test_fuzz_windows import CASES, OOO_CASES, TB_CASES, py_oracle
from tests.test_torch_win_seq import JAX, PORT, _flush, _push


def _matmul(X):
    if X is JAX:
        return lambda a, b: jnp.einsum("...ij,...jk->...ik", a, b)
    return lambda a, b: torch.einsum("...ij,...jk->...ik", a, b)


def _shear(X):
    """tuple value v -> [[1, v], [v / 2, 1]] (the JAX test's lift)."""
    stack = jnp.stack if X is JAX else torch.stack

    def lift(t):
        v = t.v
        one = v * 0 + 1
        return stack([stack([one, v]), stack([v * 0.5, one])])
    return lift


def _eye(X):
    return jnp.eye(2, dtype=jnp.float32) if X is JAX else torch.eye(2)


def _collect(X, op, total, K, batch, fn, ts_fn=None):
    """{(key, wid): payload array} of one pipeline run."""
    out = {}

    def cb(view):
        if view is not None:
            for k, w, m in zip(np.asarray(view["key"]).tolist(),
                               np.asarray(view["id"]).tolist(), np.asarray(view["payload"])):
                assert (k, w) not in out
                out[(k, w)] = np.array(m)
    X.Pipeline(X.Source(fn(X), total=total, num_keys=K, ts_fn=ts_fn, **X.kw), [op],
               X.Sink(cb, **X.kw), batch_size=batch, **X.kw).run()
    return out


def _same(got, want):
    """Byte for byte: the same windows with the same value bits."""
    assert got.keys() == want.keys() and want
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("L,S", [(8, 4), (6, 3)])
def test_noncommutative_matmul_matches_jax_and_sequential(L, S):
    """test_ffat_noncommutative.py through the port's per-key Key_FFAT; (6, 3)
    has three panes a window, where the pairwise tree still keeps operand
    order."""
    total, K = 96, 2

    def op(X):
        return X.Key_FFAT(_shear(X), _matmul(X), spec=X.WindowSpec(L, S, X.CB),
                          identity=_eye(X), num_keys=K, name="mm", **X.kw)
    fn = lambda X: lambda i: {"v": X.f32(i % 5) * 0.1}  # noqa: E731
    got = _collect(PORT, op(PORT), total, K, 32, fn)
    want = _collect(JAX, op(JAX), total, K, 32, fn)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
    for k in range(K):
        vals = [np.float32(i % 5) * np.float32(0.1) for i in range(k, total, K)]
        for w in range((len(vals) - 1) // S + 1):
            m = np.eye(2, dtype=np.float32)
            for v in vals[w * S: w * S + L]:
                m = m @ np.array([[1, v], [v * 0.5, 1]], np.float32)
            np.testing.assert_allclose(got[(k, w)], m, rtol=1e-4, atol=1e-5)


def _fuzz_fn(X):
    return lambda i: {"v": X.f32((i * 17) % 23)}


def _combine(X, red):
    if red == "sum":
        return X.add, 0
    return (jnp.maximum if X is JAX else torch.maximum), -1e30


@pytest.mark.parametrize("L,S,K,batch,red", CASES)
def test_cb_fuzz_matches_jax_and_oracle(L, S, K, batch, red):
    total = 10 * max(L, batch) // 2 + 37

    def op(X):
        comb, ident = _combine(X, red)
        return X.Key_FFAT(lambda t: t.v, comb, spec=X.WindowSpec(L, S, X.CB),
                          identity=ident, num_keys=K, **X.kw)
    got = _collect(PORT, op(PORT), total, K, batch, _fuzz_fn)
    _same(got, _collect(JAX, op(JAX), total, K, batch, _fuzz_fn))
    assert sorted((k, w, float(v)) for (k, w), v in got.items()) == py_oracle(
        total, K, L, S, red)


@pytest.mark.parametrize("L,S,K,batch,rate", TB_CASES)
def test_per_key_tb_fuzz_matches_jax(L, S, K, batch, rate):
    total = 6 * max(L * rate, batch) + 29

    def op(X):
        return X.Key_FFAT(lambda t: t.v, X.add, spec=X.WindowSpec(L, S, X.TB),
                          num_keys=K, global_time=False, **X.kw)
    ts_fn = lambda i: i // rate  # noqa: E731
    _same(_collect(PORT, op(PORT), total, K, batch, _fuzz_fn, ts_fn),
          _collect(JAX, op(JAX), total, K, batch, _fuzz_fn, ts_fn))


#: OOO_CASES drop no tuple; these two drop 7 and 3 stragglers
DROP_CASES = [(4, 2, 1, 8, 0, 9), (4, 4, 2, 12, 0, 7)]


@pytest.mark.parametrize("L,S,K,batch,delay,jitter", OOO_CASES + DROP_CASES)
def test_per_key_tb_lateness_matches_jax(L, S, K, batch, delay, jitter):
    """Out-of-order timestamps: stragglers behind a key's fired horizon are
    dropped and counted the same way in both packages."""
    total = 5 * max(L, batch) + 31
    drops = {}

    def op(X):
        return X.Key_FFAT(lambda t: t.v, X.add, spec=X.WindowSpec(L, S, X.TB, delay=delay),
                          num_keys=K, global_time=False, **X.kw)
    for X in (JAX, PORT):
        o = op(X)
        ts_fn = ((lambda i: jnp.maximum(0, i - (i * 7) % (jitter + 1))) if X is JAX else
                 (lambda i: torch.clamp(i - (i * 7) % (jitter + 1), min=0)))
        drops[X.name] = (_collect(X, o, total, K, batch, _fuzz_fn, ts_fn),
                         o.get_StatsRecords()[0].tuples_dropped_old)
    _same(drops["port"][0], drops["jax"][0])
    assert drops["port"][1] == drops["jax"][1]
    assert (drops["port"][1] > 0) == ((L, S, K, batch, delay, jitter) in DROP_CASES)


@pytest.mark.parametrize("global_time", [True, False])
def test_tb_max_combine_matches_jax(global_time):
    """The non-add branches of both TB paths (``_g_insert``/``_g_emit`` and
    ``_insert``/``_emit``): a max over integer values."""
    def op(X):
        comb, ident = _combine(X, "max")
        return X.Key_FFAT(lambda t: t.v, comb, spec=X.WindowSpec(8, 4, X.TB),
                          identity=ident, num_keys=3, global_time=global_time, **X.kw)
    for batch in (32, 45):
        _same(_collect(PORT, op(PORT), 240, 3, batch, _fuzz_fn),
              _collect(JAX, op(JAX), 240, 3, 32, _fuzz_fn))


@pytest.mark.parametrize("tb", [False, True])
def test_small_window_budget_carries_windows_over(tb):
    """``max_wins=3``: more windows fire a batch than the budget holds; the
    rest wait for the next batch and the flushes, in both packages (and, CB,
    as the absolute oracle says: the 40 tuples a key stay inside the
    64-pane ring, which a longer backlog would overrun in both packages)."""
    total, K, batch = 120, 3, 60

    def op(X):
        spec = X.WindowSpec(6, 2, X.TB if tb else X.CB)
        return X.Key_FFAT(lambda t: t.v, X.add, spec=spec, num_keys=K, max_wins=3,
                          global_time=False if tb else None, **X.kw)
    got = _collect(PORT, op(PORT), total, K, batch, _fuzz_fn)
    _same(got, _collect(JAX, op(JAX), total, K, batch, _fuzz_fn))
    if not tb:
        assert sorted((k, w, float(v)) for (k, w), v in got.items()) == py_oracle(
            total, K, 6, 2, "sum")


def test_tree_reduce_keeps_the_jax_pairing():
    """``tree_reduce`` pairs as the JAX ``_tree_reduce`` does, within
    rtol = 1e-4: in operand order up to three elements, and, for a combine
    that does not commute, out of order from four (both packages)."""
    rng = np.random.default_rng(5)
    for n in range(1, 7):
        m = rng.normal(size=(3, n, 2, 2)).astype(np.float32)
        got = tree_reduce(_matmul(PORT), torch.from_numpy(m), 1).numpy()
        want = np.asarray(_tree_reduce(_matmul(JAX), jnp.asarray(m), 1))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        seq = np.stack([np.linalg.multi_dot([np.eye(2, dtype=np.float32), *r]) for r in m])
        assert np.allclose(got, seq, rtol=1e-4, atol=1e-5) == (n <= 3)


def test_default_budget_guard_raises_in_both():
    """A [W, wpanes] gather beyond 2^22 cells asks for an explicit max_wins."""
    spec = lambda X: X.WindowSpec(4096, 1, X.CB)  # noqa: E731
    for X in (JAX, PORT):
        op = X.Key_FFAT(lambda t: t.v, X.add, spec=spec(X), num_keys=2, **X.kw)
        with pytest.raises(ValueError, match="max_wins"):
            op.out_capacity(1024)
        assert X.Key_FFAT(lambda t: t.v, X.add, spec=spec(X), num_keys=2, max_wins=64,
                          **X.kw).out_capacity(1024) == 64


CARRY_TOTAL, CARRY_BATCH = 300, 48


def _chain(X, tb):
    spec = X.WindowSpec(12, 4, X.TB, delay=3) if tb else X.WindowSpec(6, 2, X.CB)
    src = X.Source(lambda i: {"v": X.f32(i // 3)}, total=CARRY_TOTAL, num_keys=3,
                   ts_fn=(lambda i: i - (i * 7) % 4) if tb else None, **X.kw)
    op = X.Key_FFAT(lambda t: t.v, X.add, spec=spec, num_keys=3, global_time=False, **X.kw)
    return src, X.CompiledChain([op], src.payload_spec(), batch_capacity=CARRY_BATCH,
                                **X.kw)


@pytest.mark.parametrize("tb", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_jax_prefix_then_port_matches_all_jax(tb, k):
    """``convert`` carries the per-key ``FFATState`` (pane ring, pane ids,
    counts, watermarks, frontier, drops) from the JAX package into the port
    mid-stream and back unchanged; the port finishes with the JAX-only run's
    windows."""
    starts = list(range(0, CARRY_TOTAL, CARRY_BATCH))
    jsrc, jchain = _chain(JAX, tb)
    want = _flush(JAX, jchain, _push(JAX, jsrc, jchain, starts, []))
    jsrc, jchain = _chain(JAX, tb)
    got = _push(JAX, jsrc, jchain, starts[:k], [])
    host = [jax.tree.map(np.asarray, s) for s in jchain.states]
    tsrc, tchain = _chain(PORT, tb)
    convert.chain_states_from_numpy(tchain, host)
    assert isinstance(tchain.states[0], wt.FFATState)
    back = convert.chain_states_to_numpy(tchain)[0]
    for f in convert.FFAT_FIELDS:
        a, b = getattr(host[0], f), back[f]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    got = _flush(PORT, tchain, _push(PORT, tsrc, tchain, starts[k:], got))
    assert got == want and len(want) > 10


def test_per_key_dispatch_equals_push_and_counts_no_launch():
    """Pipeline(dispatch=3) runs the per-key step as push does (on the CPU,
    the plain loop); the CPU path launches no kernel."""
    from windflow_tpu_torch.ops import registry
    registry.reset_launches()
    runs = []
    for d in (False, 3):
        out = []
        src = wt.Source(lambda i: {"v": (i % 97).float()}, total=4096, num_keys=16,
                        device="cpu")
        op = wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(64, 32), num_keys=16,
                         device="cpu")
        wt.Pipeline(src, [op], wt.Sink(lambda v: v is None or out.append(
            (v["key"], v["id"], v["payload"])), device="cpu"), batch_size=512,
                    device="cpu", dispatch=d).run()
        runs.append([a.tobytes() for x in out for a in x])
    assert runs[0] == runs[1] and runs[0]
    assert set(registry.launch_counts().values()) == {0}

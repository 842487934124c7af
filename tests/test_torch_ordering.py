"""The port's Ordering_Node against the JAX package's, push by push, on the CPU.

Both nodes get the same seeded numpy batches. After every push (and every
channel EOS and the final flush) the released LIVE lanes must be equal byte
for byte (key, id, ts, payload, in order), and so must the released count,
the renumbering counter ``_next_id`` and the pool's capacity; the padding
lanes are not compared. On the CPU the port's K4 networks run their plain
version (``ops/bitonic.py::network_plain``); the JAX node runs its XLA
networks. Also here: the cases of ``tests/test_ordering_renumbering.py``,
``tests/test_fuzz_ordering.py`` and ``tests/test_async_sink_pipeline.py`` that
drive the node directly, through the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu.basic import ordering_mode_t as jmode
from windflow_tpu.batch import Batch as JBatch
from windflow_tpu.parallel.ordering import Ordering_Node as JNode
from windflow_tpu_torch.basic import ordering_mode_t as tmode
from windflow_tpu_torch.batch import Batch
from windflow_tpu_torch.ops import registry
from windflow_tpu_torch.parallel.ordering import WM_NONE, Ordering_Node

MODES = ["ID", "TS", "TS_RENUMBERING"]


def batches(keys, ids, ts, vals, valid=None):
    """The same lanes as a JAX batch and a port batch."""
    n = len(ids)
    cols = {"key": np.asarray(keys, np.int32), "id": np.asarray(ids, np.int32),
            "ts": np.asarray(ts, np.int32), "v": np.asarray(vals, np.float32),
            "valid": np.ones(n, bool) if valid is None else np.asarray(valid, bool)}
    jb = JBatch(key=jnp.asarray(cols["key"]), id=jnp.asarray(cols["id"]),
                ts=jnp.asarray(cols["ts"]), payload={"v": jnp.asarray(cols["v"])},
                valid=jnp.asarray(cols["valid"]))
    tb = Batch(key=torch.from_numpy(cols["key"]), id=torch.from_numpy(cols["id"]),
               ts=torch.from_numpy(cols["ts"]), payload={"v": torch.from_numpy(cols["v"])},
               valid=torch.from_numpy(cols["valid"]))
    return jb, tb


def live(b, jax_side):
    """Live lanes of a released batch, in order: (key, id, ts, v) tuples."""
    if b is None:
        return []
    a = (lambda x: np.asarray(x)) if jax_side else (lambda x: x.numpy())
    v = a(b.valid)
    return list(zip(a(b.key)[v].tolist(), a(b.id)[v].tolist(), a(b.ts)[v].tolist(),
                    a(b.payload["v"])[v].view(np.int32).tolist()))


class Pair:
    """A JAX node and a port node driven in lockstep; every call checks the
    two agree."""

    def __init__(self, n, mode):
        self.j = JNode(n, getattr(jmode, mode))
        self.t = Ordering_Node(n, getattr(tmode, mode))
        self.released = []

    def _check(self, jo, to):
        jl, tl = live(jo, True), live(to, False)
        assert tl == jl
        assert self.t.last_release_count == self.j.last_release_count == len(jl)
        if self.j._next_id is not None and self.t._next_id is not None:
            assert int(self.t._next_id) == int(self.j._next_id)
        jp, tp = self.j._pending, self.t._pending
        assert (jp is None) == (tp is None)
        if jp is not None:
            assert tp.capacity == jp.capacity
        self.released += tl

    def push(self, ch, jb, tb):
        self._check(self.j.push(ch, jb), self.t.push(ch, tb))

    def close(self, ch):
        self._check(self.j.close_channel(ch), self.t.close_channel(ch))

    def flush(self):
        self._check(self.j.flush(), self.t.flush())


def random_streams(rng, n_ch, lo, hi, gap, ties=True):
    """Per-channel streams: non-decreasing ts with gaps (and equal-ts ties
    across channels), globally unique ids, a few invalid lanes."""
    streams, uid = [], 0
    for _ in range(n_ch):
        n = int(rng.integers(lo, hi))
        ts = np.cumsum(rng.integers(0 if ties else 1, gap, n)).astype(np.int32)
        ids = np.arange(uid, uid + n, dtype=np.int32)
        uid += n
        streams.append((ts, ids))
    return streams


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_push_by_push_parity_with_jax(mode, seed):
    """Random interleavings of 2-4 channels, equal-ts ties, invalid lanes,
    random batch sizes (odd capacities padded), a channel closed early."""
    rng = np.random.default_rng(1000 * seed + MODES.index(mode))
    n_ch = int(rng.integers(2, 5))
    streams = random_streams(rng, n_ch, 20, 120, 3)
    pair = Pair(n_ch, mode)
    cur = [0] * n_ch
    closed = set()
    while any(cur[c] < len(streams[c][0]) for c in range(n_ch)):
        c = int(rng.integers(0, n_ch))
        ts, ids = streams[c]
        if cur[c] >= len(ts):
            if c not in closed:
                pair.close(c)
                closed.add(c)
            continue
        k = int(rng.choice([7, 16, 33]))     # few shapes: each is a JAX compile
        sl = slice(cur[c], cur[c] + k)
        cur[c] += k
        n = len(ts[sl])
        valid = rng.random(n) < 0.9
        jb, tb = batches(rng.integers(0, 8, n), ids[sl], ts[sl], rng.normal(size=n),
                         valid)
        pair.push(c, jb, tb)
    for c in range(n_ch):
        if c not in closed:
            pair.close(c)
    pair.flush()
    assert pair.released


@pytest.mark.parametrize("mode", MODES)
def test_long_unbalanced_stream_parity_and_bounded_backlog(mode):
    """A fast channel and a slow one (4 batches to 1), 120 pushes of 256:
    parity at every push, and the pool stays within a few batches."""
    B = 256
    pair = Pair(2, mode)
    rng = np.random.default_rng(5)
    nxt = [0, 0]
    max_cap = 0
    for i in range(120):
        ch = 0 if i % 5 else 1
        step = 1 if ch == 0 else 4
        ts = (nxt[ch] + step * np.arange(B)).astype(np.int32)
        nxt[ch] = int(ts[-1]) + step
        ids = 2 * ts + ch                 # unique, in ts order on each channel
        jb, tb = batches(np.zeros(B), ids, ts, rng.normal(size=B))
        pair.push(ch, jb, tb)
        max_cap = max(max_cap, pair.t._pending.capacity)
    pair.close(0)
    pair.close(1)
    pair.flush()
    assert len(pair.released) == 120 * B
    assert max_cap <= 8 * B, max_cap


def test_network_calls_per_push():
    """Every push sorts the incoming batch (K4 sort network at the batch's
    power of two) and, once there is a pool, merges (K4 merge network at the
    power of two covering pool + batch); the CPU launches no kernel."""
    registry.reset_launches()
    node = Ordering_Node(2, tmode.TS)
    for i in range(6):
        _, tb = batches(np.zeros(100), np.arange(100) + 100 * i, 2 * np.arange(100) + i % 2,
                        np.zeros(100))
        node.push(i % 2, tb)
        node.last_release_count
    sorts = {n: c for (n, s), c in node.networks.items() if s}
    merges = {n: c for (n, s), c in node.networks.items() if not s}
    assert sorts == {128: 6}
    assert sum(merges.values()) == 5 and all(n >= 128 for n in merges)
    assert registry.launch_counts()["ordering_merge"] == 0


# ---- tests/test_ordering_renumbering.py, through the port -----------------------

def tb_of(ids, ts=None, vals=None):
    ids = np.asarray(ids, np.int32)
    return batches(np.zeros(len(ids)), ids, ids if ts is None else ts,
                   ids.astype(np.float32) if vals is None else vals)[1]


def drain(node, pushes):
    out = []

    def take(b):
        if b is not None:
            out.extend(b.id[b.valid].tolist())
    for ch, b in pushes:
        take(node.push(ch, b))
    take(node.flush())
    return out


def test_id_mode_low_watermark():
    node = Ordering_Node(2, tmode.ID)
    rel = node.push(0, tb_of([3, 1, 5]))
    assert not bool(rel.valid.any())                  # ch1 has no watermark yet
    rel = node.push(1, tb_of([2, 4]))
    assert rel.id[rel.valid].tolist() == [1, 2, 3, 4]
    assert drain(node, []) == [5]


def test_ts_mode_interleave_and_renumbering():
    node = Ordering_Node(2, tmode.TS)
    got = drain(node, [(0, tb_of([0, 1], ts=[0, 20])), (1, tb_of([10, 11], ts=[10, 30])),
                       (0, tb_of([2], ts=[40])), (1, tb_of([12], ts=[50]))])
    assert got == [0, 10, 1, 11, 2, 12]
    node = Ordering_Node(2, tmode.TS_RENUMBERING)
    got = drain(node, [(0, tb_of([100, 200], ts=[5, 15])),
                       (1, tb_of([300, 400], ts=[10, 20]))])
    assert got == [0, 1, 2, 3]


def test_equal_ts_ties_are_deterministic():
    def seq(pushes):
        node = Ordering_Node(2, tmode.TS)
        out = []
        for ch, b in pushes + [(None, None)]:
            r = node.push(ch, b) if ch is not None else node.flush()
            if r is not None:
                out.extend(r.payload["v"][r.valid].tolist())
        return out
    b0 = tb_of([0, 1], ts=[5, 5], vals=[10.0, 11.0])
    b1 = tb_of([0, 1], ts=[5, 5], vals=[20.0, 21.0])
    assert seq([(0, b0), (1, b1)]) == seq([(1, b1), (0, b0)]) == [10.0, 20.0, 11.0, 21.0]


def test_channel_eos_unblocks():
    node = Ordering_Node(2, tmode.TS)
    held = node.push(0, tb_of([1, 2], ts=[1, 2]))
    assert not bool(held.valid.any()) and node.last_release_count == 0
    rel = node.close_channel(1)
    assert rel.id[rel.valid].tolist() == [1]
    rel2 = node.close_channel(0)
    assert rel2.id[rel2.valid].tolist() == [2]


def test_odd_capacity_padding_keeps_release_order():
    node = Ordering_Node(2, tmode.TS)
    out = []
    for ch, ids in ((0, [3, 1, 7]), (1, [2, 5]), (0, [9, 11, 13, 15, 17]), (1, [6, 8, 10])):
        r = node.push(ch, tb_of(ids))
        out.extend(r.id[r.valid].tolist())
    r = node.flush()
    out.extend(r.id[r.valid].tolist())
    assert out == sorted(out) == [1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17]


def test_flush_releases_max_sentinel_ts():
    top = int(np.iinfo(np.int32).max)
    node = Ordering_Node(2, tmode.TS)
    got = []
    for r in (node.push(0, tb_of([1, 2], ts=[5, top])), node.close_channel(1),
              node.close_channel(0), node.flush()):
        if r is not None:
            got.extend(r.id[r.valid].tolist())
    assert got == [1, 2]


# ---- tests/test_fuzz_ordering.py's property, through the port -------------------

def _fuzz(rng, mode, n_ch, lo, hi, gap, take_max):
    streams = random_streams(rng, n_ch, lo, hi, gap)
    node = Ordering_Node(n_ch, mode)
    released = []

    def take(b):
        if b is not None:
            v = b.valid
            released.extend(zip(b.ts[v].tolist(), b.id[v].tolist(),
                                b.payload["v"][v].tolist()))
    cur = [0] * n_ch
    while any(cur[c] < len(streams[c][0]) for c in range(n_ch)):
        c = int(rng.integers(0, n_ch))
        ts, ids = streams[c]
        if cur[c] >= len(ts):
            continue
        k = int(rng.integers(1, take_max))
        sl = slice(cur[c], cur[c] + k)
        cur[c] += k
        before = len(released)
        take(node.push(c, tb_of(ids[sl], ts=ts[sl], vals=ids[sl].astype(np.float32))))
        wms = [w for w in node._wm_dev.tolist() if w != WM_NONE]
        if mode == tmode.TS and len(wms) == n_ch and len(released) > before:
            # nothing is released above the provable low watermark
            assert all(t <= min(wms) for t, _, _ in released[before:])
    for c in range(n_ch):
        take(node.close_channel(c))
    take(node.flush())
    everything = [(int(t), int(i), float(i)) for ts, ids in streams for t, i in zip(ts, ids)]
    return released, everything


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_release_is_the_global_sorted_merge(trial):
    rng = np.random.default_rng(100 + trial)
    released, everything = _fuzz(rng, tmode.TS, int(rng.integers(2, 5)), 5, 60, 4, 9)
    assert released == sorted(everything, key=lambda x: (x[0], x[1]))


@pytest.mark.parametrize("mode", ["ID", "TS_RENUMBERING"])
def test_fuzz_other_modes(mode):
    rng = np.random.default_rng(7)
    released, everything = _fuzz(rng, getattr(tmode, mode), 3, 10, 40, 3, 6)
    if mode == "ID":
        assert [i for _, i, _ in released] == sorted(i for _, i, _ in everything)
    else:
        assert [v for _, _, v in released] == [
            v for _, _, v in sorted(everything, key=lambda x: (x[0], x[1]))]
        assert [i for _, i, _ in released] == list(range(len(everything)))

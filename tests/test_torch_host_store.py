"""The port's HostStore (``windflow_tpu_torch/state/host_store.py``) against the JAX package's.

The port keeps its own copy of the cold-tier store: an open-addressing index
in C (``native/csrc/host_store.cpp``) where the JAX store keeps a Python
dict, with the same semantics. Here the same seeded operations go to a store
of each package, and every result, counter and manifest (array for array,
row for row, dtypes included) must be equal: last-writer-wins upserts by the
``(m0, m1, m2)`` triplet with repeated keys in one call, the multimap's
``append``/``fetch_multi``, ``lookup``, ``pop_keys``, ``compact_below`` (with
the rebuild when dead rows dominate), growth past the initial capacity,
scalar and row-shaped columns of several dtypes, and manifests restored
across the two packages. Then the mirrored unit cases of the JAX package's
``tests/test_tiered_state.py`` and the cold probe's plain version.

On the card the store keeps a mirror of its index in device memory, kept in
step by copying the slots each C pass lists as written (and the whole index
after a rebuild). Here every such list is replayed onto a numpy copy of the
index (:class:`MirrorReplay`), which must equal the host index after every
write.
"""

import numpy as np
import pytest
import torch

from windflow_tpu.state import HostStore as JStore
from windflow_tpu.state.tiered import JoinTableTier as JJoinTier
from windflow_tpu.state.tiered import TierConfig as JTierConfig
from windflow_tpu_torch.ops.cold_probe import cold_probe, cold_scatter_plain
from windflow_tpu_torch.state import HostStore as TStore
from windflow_tpu_torch.state.tiered import JoinTableTier as TJoinTier
from windflow_tpu_torch.state.tiered import TierConfig as TTierConfig

COLS = {"a": np.int32, "b": np.float32, "c": np.int8, "w": np.int64}
SHAPES = {"w": (3,)}


def stores(unique=True, cols=COLS, shapes=SHAPES):
    return (JStore("t", cols, shapes, unique=unique),
            TStore("t", cols, shapes, unique=unique))


def rows(rng, n, keyspace, cols=COLS, shapes=SHAPES):
    out = {}
    for k, dt in cols.items():
        shape = (n,) + shapes.get(k, ())
        out[k] = (rng.integers(-100, 100, shape).astype(dt) if np.dtype(dt).kind in "iu"
                  else rng.standard_normal(shape).astype(dt))
    keys = rng.integers(-keyspace, keyspace, n).astype(np.int32)
    meta = [rng.integers(0, 4, n).astype(np.int32) for _ in range(3)]
    ok = rng.random(n) < 0.9
    return keys, meta, out, ok


def assert_same(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, (what, g.dtype, want.dtype)
        assert np.array_equal(g.view(np.uint8), want.view(np.uint8)), what
    else:
        assert got == want, what


class MirrorReplay:
    """A copy of ``st``'s index kept the way the card's mirror is kept: each
    slot list a write hands the mirror staged as the store stages it (key,
    head row, slot) and written by ``cold_scatter``'s plain version, the
    whole index where the write hands None (a rebuild). ``lists`` and
    ``fulls`` count the two."""

    def __init__(self, st):
        self.st, self.copy, self.lists, self.fulls = st, torch.from_numpy(st._idx.copy()), 0, 0
        inner = st._slots_written

        def replay(slots):
            if slots is None:
                self.copy = torch.from_numpy(self.st._idx.copy())
                self.fulls += 1
            elif len(slots):
                entries = np.zeros((len(slots), 4), np.int64)
                entries[:, :2] = self.st._idx[slots]
                entries[:, 2] = slots
                cold_scatter_plain(self.copy, entries)
                self.lists += 1
            inner(slots)
        st._slots_written = replay

    def check(self, what):
        assert np.array_equal(self.copy.numpy(), self.st._idx), f"{what}: mirror != host index"


def assert_stores(t, j, what):
    assert_same(t.manifest(), j.manifest(), f"{what}: manifest")
    assert t.counters() == j.counters(), what
    assert len(t) == len(j) and t.key_count() == j.key_count(), what


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unique_store_random_ops_equal_jax(seed):
    """Upserts (repeated keys in a call, stale and equal metas), lookups,
    compactions and EOS drains, seeded, against the JAX store; the store
    grows from 256 rows past 2048."""
    rng = np.random.default_rng(seed)
    j, t = stores()
    mirror = MirrorReplay(t)
    for step in range(40):
        op = rng.integers(0, 10)
        if op < 5:
            keys, meta, cols, ok = rows(rng, int(rng.integers(1, 160)), 1500)
            assert t.upsert(keys, *meta, cols, ok) == j.upsert(keys, *meta, cols, ok)
        elif op < 8:
            keys = rng.integers(-1500, 1500, 64).astype(np.int32)
            want = rng.random(64) < 0.7
            assert_same(t.lookup(keys, want), j.lookup(keys, want), f"lookup {step}")
        elif op < 9:
            col = ["m0", "m1", "a", "w"][int(rng.integers(0, 4))]
            thr = int(rng.integers(-50, 4))
            assert t.compact_below(col, thr) == j.compact_below(col, thr)
        else:
            m = int(rng.integers(0, 40))
            assert_same(t.pop_keys(m), j.pop_keys(m), f"pop {step}")
        assert_stores(t, j, f"step {step}")
        mirror.check(f"step {step}")
    assert t.spilled_rows > 256
    # upserts and drains hand their slots; growth and compaction the index
    assert mirror.lists > 0 and mirror.fulls > 1


@pytest.mark.parametrize("seed", [0, 1])
def test_multimap_store_random_ops_equal_jax(seed):
    """Appends, ``fetch_multi`` (oldest rows first, truncated at M) and
    compaction of a multimap store, against the JAX store."""
    rng = np.random.default_rng(seed)
    j, t = stores(unique=False)
    mirror = MirrorReplay(t)
    for step in range(30):
        op = rng.integers(0, 6)
        if op < 3:
            keys, meta, cols, ok = rows(rng, int(rng.integers(1, 120)), 40)
            assert t.append(keys, *meta, cols, ok) == j.append(keys, *meta, cols, ok)
        elif op < 5:
            keys = rng.integers(-40, 40, 32).astype(np.int32)
            want = rng.random(32) < 0.8
            m = int(rng.integers(1, 9))
            assert_same(t.fetch_multi(keys, want, m), j.fetch_multi(keys, want, m),
                        f"fetch {step}")
        else:
            thr = int(rng.integers(-80, 30))
            assert t.compact_below("a", thr) == j.compact_below("a", thr)
        assert_stores(t, j, f"step {step}")
        mirror.check(f"step {step}")
    assert mirror.lists > 0


def test_manifests_restore_across_packages():
    """A manifest of either store restores into the other; both then answer
    and grow alike."""
    rng = np.random.default_rng(7)
    j, t = stores()
    keys, meta, cols, ok = rows(rng, 700, 900)
    j.upsert(keys, *meta, cols, ok)
    j.lookup(keys[:50], np.ones(50, bool))
    t2 = TStore("t", COLS, SHAPES)
    t2.restore(j.manifest())
    assert_stores(t2, j, "jax -> port")
    j2 = JStore("t", COLS, SHAPES)
    j2.restore(t2.manifest())
    assert_stores(t2, j2, "port -> jax")
    keys, meta, cols, ok = rows(rng, 300, 900)
    t2.upsert(keys, *meta, cols, ok)
    j2.upsert(keys, *meta, cols, ok)
    probe = rng.integers(-900, 900, 200).astype(np.int32)
    assert_same(t2.lookup(probe, np.ones(200, bool)), j2.lookup(probe, np.ones(200, bool)),
                "lookup after restore")
    assert_stores(t2, j2, "after restore")


def test_restore_rewrites_the_arrays_in_place_when_they_fit():
    """Restores into a store whose arrays hold the snapshot (a smaller one,
    then one of the same size) rewrite them in place, a larger one replaces
    them; each answers, grows and counts as the JAX store restored alike."""
    rng = np.random.default_rng(3)
    j, t = stores()
    keys, meta, cols, ok = rows(rng, 1500, 2000)
    j.upsert(keys, *meta, cols, ok)
    t.upsert(keys, *meta, cols, ok)
    big = j.manifest()
    small_src = JStore("t", COLS, SHAPES)
    keys, meta, cols, ok = rows(rng, 40, 2000)
    small_src.upsert(keys, *meta, cols, ok)
    small = small_src.manifest()
    arrays = t._key
    mirror = MirrorReplay(t)
    for step, man in enumerate((small, big, small, small, big)):
        j.restore(man)
        t.restore(man)
        assert_stores(t, j, f"restore {step}")
        mirror.check(f"restore {step}")
        assert t._key is arrays, "a restore that fits keeps the store's arrays"
        probe = rng.integers(-2000, 2000, 300).astype(np.int32)
        want = rng.random(300) < 0.8
        assert_same(t.lookup(probe, want), j.lookup(probe, want), f"lookup {step}")
        keys, meta, cols, ok = rows(rng, 60, 2000)
        assert t.upsert(keys, *meta, cols, ok) == j.upsert(keys, *meta, cols, ok)
        assert t.compact_below("m1", 1) == j.compact_below("m1", 1)
        assert_stores(t, j, f"after restore {step}")
        mirror.check(f"after restore {step}")
    fresh = TStore("t", COLS, SHAPES)
    fresh.restore(big)
    assert fresh._cap >= len(big["key"]) and fresh._key is not arrays


def test_uncounted_probes_count_no_readmissions():
    """Lookups inside ``uncounted()`` (a dropped warm-up step) answer as
    usual and leave the readmission count alone; outside they count."""
    rng = np.random.default_rng(4)
    _, t = stores()
    keys, meta, cols, ok = rows(rng, 200, 300)
    t.upsert(keys, *meta, cols)
    probe, want = keys[:50], np.ones(50, bool)
    with t.uncounted():
        inside = t.lookup(probe, want)
    assert t.counters()["state_readmits"] == 0
    assert_same(t.lookup(probe, want), inside, "uncounted lookup")
    assert t.counters()["state_readmits"] == 50


def test_host_store_lww_by_version_triplet():
    hs = TStore("t", {"v": np.int32})
    hs.upsert([7], [5], [1], [0], {"v": np.asarray([10])})
    # an older spill must not roll the row back
    hs.upsert([7], [4], [9], [9], {"v": np.asarray([11])})
    found, meta, cols = hs.lookup(np.asarray([7]), np.asarray([True]))
    assert found[0] and cols["v"][0] == 10 and tuple(meta[0]) == (5, 1, 0)
    # a newer spill wins
    hs.upsert([7], [6], [0], [0], {"v": np.asarray([12])})
    _, _, cols = hs.lookup(np.asarray([7]), np.asarray([True]))
    assert cols["v"][0] == 12
    assert hs.key_count() == 1


def test_host_store_multimap_fetch_and_compaction():
    hs = TStore("a", {"ts": np.int32, "p": np.int32}, unique=False)
    z = np.zeros(3, np.int64)
    hs.append([1, 1, 2], z, z, z, {"ts": np.asarray([5, 9, 7]),
                                   "p": np.asarray([50, 90, 70])})
    mask, _m, cols = hs.fetch_multi(np.asarray([1, 2]), np.asarray([True, True]), 4)
    assert mask[0].sum() == 2 and mask[1].sum() == 1
    assert sorted(cols["ts"][0][mask[0]].tolist()) == [5, 9]
    assert len(hs) == 3          # fetch is read-only
    assert hs.compact_below("ts", 7) == 1
    assert len(hs) == 2 and hs.counters()["state_compactions"] == 1
    with pytest.raises(ValueError, match="append"):
        hs.upsert([1], [0], [0], [0], {"ts": np.asarray([1]), "p": np.asarray([1])})


def test_host_store_manifest_roundtrip():
    hs = TStore("t", {"v": np.int32})
    hs.upsert([3, 9], [1, 2], [0, 0], [0, 0], {"v": np.asarray([30, 90])})
    hs2 = TStore("t", {"v": np.int32})
    hs2.restore(hs.manifest())
    assert hs2.key_count() == 2
    assert hs2.counters() == hs.counters()
    _, _, cols = hs2.lookup(np.asarray([9]), np.asarray([True]))
    assert cols["v"][0] == 90


def test_host_store_pop_keys_sorted_and_removing():
    hs = TStore("t", {"v": np.int32})
    hs.upsert([9, 3, 5], [1, 1, 1], [0, 0, 0], [0, 0, 0], {"v": np.asarray([1, 2, 3])})
    keys, cols = hs.pop_keys(2)
    assert keys.tolist() == [3, 5] and cols["v"].tolist() == [2, 3]
    assert hs.key_count() == 1
    found, _, _ = hs.lookup(np.asarray([3, 5, 9]), np.ones(3, bool))
    assert found.tolist() == [False, False, True]


def test_index_survives_colliding_deletes():
    """Keys that share a home slot, removed in every order, leave every other
    key findable (the index's backward-shift deletion)."""
    rng = np.random.default_rng(3)
    hs = TStore("t", {"v": np.int32})
    mirror = MirrorReplay(hs)
    keys = np.arange(0, 4096 * 64, 64, dtype=np.int32)[:200]       # many collisions
    hs.upsert(keys, np.ones(200), np.zeros(200), np.zeros(200),
              {"v": np.arange(200, dtype=np.int32)})
    alive = set(keys.tolist())
    for _ in range(6):
        k = int(rng.integers(1, 40))
        popped, _ = hs.pop_keys(k)
        mirror.check(f"pop {k}")
        alive -= set(popped.tolist())
        probe = np.asarray(sorted(alive) + popped.tolist(), np.int32)
        found, _, cols = hs.lookup(probe, np.ones(len(probe), bool))
        assert found.tolist() == [p in alive for p in probe.tolist()]
        assert cols["v"][found].tolist() == [int(np.flatnonzero(keys == p)[0])
                                             for p in probe[found].tolist()]


def test_cold_probe_plain_is_the_jax_callback():
    """On the CPU the cold read is the store's host lookup: ``cold_probe``
    returns what the JAX ``JoinTableTier.lookup_cb`` returns (int32 meta,
    the value leaves), and counts the found lanes as readmitted."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    jt = JJoinTier("x", {"c": jax.ShapeDtypeStruct((), jnp.int32),
                         "a": jax.ShapeDtypeStruct((), jnp.float32)}, JTierConfig())
    tt = TJoinTier("x", {"c": torch.empty((), dtype=torch.int32, device="meta"),
                         "a": torch.empty((), dtype=torch.float32, device="meta")},
                   TTierConfig(), torch.device("cpu"))
    keys = rng.integers(0, 300, 200).astype(np.int32)
    meta = [rng.integers(-(1 << 31), 1 << 31, 200).astype(np.int32) for _ in range(3)]
    vals = {"v0": rng.standard_normal(200).astype(np.float32),
            "v1": rng.integers(-9, 9, 200).astype(np.int32)}
    jt.store.upsert(keys, *meta, vals)
    tt.store.upsert(keys, *meta, vals)
    probe = rng.integers(0, 400, 128).astype(np.int32)
    want = rng.random(128) < 0.75
    got = tt.lookup(torch.from_numpy(probe), torch.from_numpy(want))
    ref = jt.lookup_cb(probe, want)
    assert_same([g.numpy() for g in got], list(ref), "cold_probe vs lookup_cb")
    assert tt.store.counters() == jt.store.counters()
    assert tt.store.counters()["state_readmits"] == int(ref[0].sum()) > 0
    # the same through the wrapper, on the store directly
    res = cold_probe(tt.store, torch.from_numpy(probe), torch.from_numpy(want))
    assert [r.dtype for r in res] == [torch.bool] + [torch.int32] * 3 + [torch.float32,
                                                                         torch.int32]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("unique", [True, False])
def test_rows_sit_in_records_read_by_the_card(unique, wide):
    """A row's value columns share one record (``record_layout``) behind a
    multimap row's next-row link or a unique row's meta low words: a
    multiple of 16 bytes, the link (8 bytes) or the meta (three int32, the
    low 32 bits of ``(m0, m1, m2)``, what the card's probe returns) at byte
    0, each column at its element's alignment and clear of the others; the
    columns are views of the records, so what the store writes (appends, a
    rebuild after compaction, a restore) is what a record holds, a unique
    record holds its row's meta, and a multimap record's link is the next
    row of its key's chain, as ``fetch_multi`` walks it. ``wide``: a 1.2 KB
    leaf, a record wider than the card's fetch reads at once (it reads such
    a record a window at a time)."""
    from windflow_tpu_torch.state.host_store import record_layout
    cols = {"b": np.int8, "h": np.int16, "w": np.int64, "t": np.int32}
    shapes = {"t": (300,) if wide else (3,), "w": (2,)}
    st = TStore("r", cols, shapes, unique=unique)
    size, offs = record_layout(st._dtypes, st._shapes, unique)
    assert size == st.record_bytes and size % 16 == 0 and (size > 1024) == wide
    spans = sorted((offs[k], offs[k] + np.dtype(dt).itemsize
                    * int(np.prod(shapes.get(k, ()), dtype=np.int64))) for k, dt in cols.items())
    assert spans[0][0] >= (12 if unique else 8) and spans[-1][1] <= size
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(offs[k] % np.dtype(dt).itemsize == 0 for k, dt in cols.items())
    rng = np.random.default_rng(4)
    keys, meta, vals, ok = rows(rng, 600, 40, cols, shapes)
    (st.upsert if unique else st.append)(keys, *meta, vals, ok)
    st.compact_below("m0", 2)
    st.restore(st.manifest())
    n = st._n
    for k in cols:
        col = st._cols[k][:n]
        nb = col[0].nbytes
        assert col.strides[0] == size
        np.testing.assert_array_equal(st._rec[:n, offs[k]:offs[k] + nb],
                                      np.ascontiguousarray(col).view(np.uint8).reshape(n, nb))
    if unique:
        # meta drawn wider than 32 bits: the record keeps the low words
        keys, meta, vals, ok = rows(rng, 300, 40, cols, shapes)
        big = [m.astype(np.int64) * (1 << 33) + m for m in meta]
        st.upsert(keys, *big, vals, ok)
        st.restore(st.manifest())
        n = st._n
        want = st._meta[:n].astype(np.int32)
        assert np.abs(st._meta[:n]).max() >= 1 << 33
        np.testing.assert_array_equal(st._rec[:n, :12].view(np.int32), want)
        found, meta_got, _ = st.lookup(st._key[:n], st._live[:n])
        np.testing.assert_array_equal(meta_got[found].astype(np.int32), want[found])
    else:
        live = np.flatnonzero(st._live[:n])
        got = st.fetch_multi(st._key[live], np.ones(len(live), bool), 64)[0]
        for key in np.unique(st._key[live]):
            chain = live[st._key[live] == key]
            assert list(st._nxt[chain[:-1]]) == list(chain[1:]) and st._nxt[chain[-1]] == -1
        assert got.sum() == sum(min(64, int((st._key[live] == k).sum())) for k in st._key[live])

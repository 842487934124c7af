"""The port's tiered-state functions against the JAX package's, bit for bit, on the CPU.

The JoinTable's tier hooks (``ops/lookup.py``: ``join_table_tier_resolve``,
``_fallback``, ``_touch``, ``_evict``, ``_init``, ``_stats`` and the
``divert=`` path of ``join_table_upsert``) and the slot-directory primitives
(``state/tiered.py``: ``slot_lookup``, ``outbox_find_last``,
``slot_directory_resolve``, ``slot_directory_evict``, ``_init``,
``_stats``) compute the JAX package's results without its dense ``[R, K]``
and ``[R, S]`` compares. Here seeded random states (repeated keys, sentinel
lanes, a hot table with few free slots, a full or empty outbox, a cold store
with hits and misses) go through both packages' functions, and every output
field must be equal in bytes and dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu.ops import lookup as jl
from windflow_tpu.state import tiered as jtier
from windflow_tpu_torch.ops import lookup as tl
from windflow_tpu_torch.state import tiered as ttier

SENT = -(1 << 31)
IMIN = -(1 << 31)
K, P, S, KEYS = 32, 16, 24, 60


def to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_t(tree):
    if isinstance(tree, dict):
        return {k: to_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def assert_same(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}[{k}]")
        return
    if isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape)
    assert g.tobytes() == w.tobytes(), (what, g, w)


def i32(rng, lo, hi, shape=()):
    return rng.integers(lo, hi, shape).astype(np.int32)


def join_state(rng, free=8, ocnt=None):
    """A tiered JoinTable state: ``K - free`` used slots of unique keys,
    a pending ring whose live entries are a prefix, an outbox with repeated
    keys and ``ocnt`` live entries."""
    used = np.zeros(K, bool)
    used[rng.choice(K, K - free, replace=False)] = True
    key = np.full(K, SENT, np.int32)
    key[used] = rng.choice(KEYS, used.sum(), replace=False)
    npend = int(rng.integers(0, P + 1))
    ocnt = int(rng.integers(0, S + 1)) if ocnt is None else ocnt
    return {
        "key": key, "used": used,
        "val": {"c": i32(rng, -99, 99, K), "f": rng.standard_normal(K).astype(np.float32)},
        "ver": i32(rng, 0, 9, K), "vid": i32(rng, 0, 9, K), "vseq": i32(rng, 0, 9, K),
        "pkey": i32(rng, 0, KEYS, P), "pval": {"c": i32(rng, -99, 99, P),
                                               "f": rng.standard_normal(P).astype(np.float32)},
        "pts": i32(rng, 0, 12, P), "pid": i32(rng, 0, 9, P), "pseq": i32(rng, 0, 40, P),
        "pok": np.arange(P) < npend,
        "wm": np.int32(rng.integers(0, 12)), "seq": np.int32(40), "version": np.int32(3),
        "dropped": np.int32(1),
        "lap": i32(rng, 0, 10, K), "tick": np.int32(10),
        "okey": i32(rng, 0, KEYS, S), "oval": {"c": i32(rng, -99, 99, S),
                                               "f": rng.standard_normal(S).astype(np.float32)},
        "over": i32(rng, 0, 9, S), "ovid": i32(rng, 0, 9, S), "ovseq": i32(rng, 0, 9, S),
        "ocnt": np.int32(ocnt), "spills": np.int32(5), "readmits": np.int32(2),
    }


def join_tiers(rng):
    """The JAX and the port JoinTableTier over equal stores of random rows."""
    vspec_j = {"c": jax.ShapeDtypeStruct((), jnp.int32),
               "f": jax.ShapeDtypeStruct((), jnp.float32)}
    vspec_t = {"c": torch.empty((), dtype=torch.int32, device="meta"),
               "f": torch.empty((), dtype=torch.float32, device="meta")}
    jt = jtier.JoinTableTier("x", vspec_j, jtier.TierConfig())
    tt = ttier.JoinTableTier("x", vspec_t, ttier.TierConfig(), torch.device("cpu"))
    n = 40
    keys = rng.choice(KEYS, n, replace=False).astype(np.int32)
    meta = [i32(rng, 0, 9, n) for _ in range(3)]
    cols = {"v0": i32(rng, -99, 99, n), "v1": rng.standard_normal(n).astype(np.float32)}
    for t in (jt, tt):
        t.store.upsert(keys, *meta, cols)
    return jt, tt


def lanes(rng, R=40):
    keys = i32(rng, 0, KEYS + 10, R)
    keys[rng.random(R) < 0.1] = SENT
    return keys, rng.random(R) < 0.8


@pytest.mark.parametrize("seed", range(4))
def test_join_table_tier_resolve_equals_jax(seed):
    rng = np.random.default_rng(seed)
    st = join_state(rng, free=int(rng.integers(0, 12)))
    jt, tt = join_tiers(rng)
    keys, ok = lanes(rng)
    jout = jl.join_table_tier_resolve(to_j(st), jnp.asarray(keys), jnp.asarray(ok),
                                      jt.lookup_cb)
    tout = tl.join_table_tier_resolve(to_t(st), torch.from_numpy(keys),
                                      torch.from_numpy(ok), tt.lookup)
    assert_same(tout, jout, "resolve")
    assert tt.store.counters() == jt.store.counters()


@pytest.mark.parametrize("seed", range(3))
def test_join_table_tier_fallback_touch_evict_equal_jax(seed):
    rng = np.random.default_rng(seed)
    st = join_state(rng, free=int(rng.integers(0, 6)))
    keys, ok = lanes(rng)
    assert_same(tl.join_table_tier_fallback(to_t(st), torch.from_numpy(keys),
                                            torch.from_numpy(ok)),
                jl.join_table_tier_fallback(to_j(st), jnp.asarray(keys), jnp.asarray(ok)),
                "fallback")
    assert_same(tl.join_table_tier_touch(to_t(st), torch.from_numpy(keys),
                                         torch.from_numpy(ok)),
                jl.join_table_tier_touch(to_j(st), jnp.asarray(keys), jnp.asarray(ok)),
                "touch")
    for hot_target in (1, 8, 20, K):
        assert_same(tl.join_table_tier_evict(to_t(st), hot_target),
                    jl.join_table_tier_evict(to_j(st), hot_target), f"evict {hot_target}")
    assert tl.join_table_tier_stats(to_t(st)) == jl.join_table_tier_stats(to_j(st))


@pytest.mark.parametrize("seed", range(4))
def test_join_table_upsert_divert_equals_jax(seed):
    """A saturated tiered table diverts winning upserts to the outbox (a
    nearly full outbox drops the rest, counted)."""
    rng = np.random.default_rng(seed)
    st = join_state(rng, free=int(rng.integers(0, 3)), ocnt=int(rng.integers(S - 6, S + 1)))
    C = 24
    key = i32(rng, 0, KEYS + 20, C)
    val = {"c": i32(rng, -99, 99, C), "f": rng.standard_normal(C).astype(np.float32)}
    ts, tid = i32(rng, 0, 14, C), i32(rng, 0, 9, C)
    ok = rng.random(C) < 0.9
    delay = int(rng.integers(0, 3))
    want = jl.join_table_upsert(to_j(st), jnp.asarray(key), to_j(val), jnp.asarray(ts),
                                jnp.asarray(tid), jnp.asarray(ok), delay=delay, divert=True)
    got = tl.join_table_upsert(to_t(st), torch.from_numpy(key), to_t(val),
                               torch.from_numpy(ts), torch.from_numpy(tid),
                               torch.from_numpy(ok), delay=delay, divert=True)
    assert_same(got, want, "upsert divert")


def test_join_table_tier_init_equals_jax():
    vj = {"c": jax.ShapeDtypeStruct((), jnp.int32), "f": jax.ShapeDtypeStruct((), jnp.float32)}
    vt = {"c": torch.empty((), dtype=torch.int32, device="meta"),
          "f": torch.empty((), dtype=torch.float32, device="meta")}
    want = jl.join_table_tier_init(jl.join_table_init(K, P, vj), S, vj)
    got = tl.join_table_tier_init(tl.join_table_init(K, P, vt, "cpu"), S, vt)
    assert_same(got, want, "init")


# ------------------------------------------------------ slot-directory primitives

H = 24


def slot_state(rng, free=6):
    hused = np.zeros(H, bool)
    hused[rng.choice(H, H - free, replace=False)] = True
    hkey = np.full(H, SENT, np.int32)
    hkey[hused] = rng.choice(KEYS, hused.sum(), replace=False)
    ocnt = int(rng.integers(0, S + 1))
    return {"hkey": hkey, "hused": hused, "lap": i32(rng, 0, 10, H), "tick": np.int32(10),
            "okey": i32(rng, 0, KEYS, S), "otick": i32(rng, 0, 9, S), "ocnt": np.int32(ocnt),
            "spills": np.int32(4), "readmits": np.int32(1),
            "floor": i32(rng, -50, 50, H), "sid": i32(rng, 0, 9, H),
            "ofloor": i32(rng, -50, 50, S), "osid": i32(rng, 0, 9, S)}


def slot_tiers(rng):
    cols = {"floor": (np.int32, ()), "sid": (np.int32, ())}
    kw = dict(count_key="ocnt", col_keys=["okey", "otick", "ofloor", "osid"],
              state_to_store=None)
    jt = jtier.SlotTableTier("s", cols, jtier.TierConfig(), **kw)
    tt = ttier.SlotTableTier("s", cols, ttier.TierConfig(), device=torch.device("cpu"), **kw)
    n = 30
    keys = rng.choice(KEYS, n, replace=False).astype(np.int32)
    z = np.zeros(n, np.int64)
    vals = {"floor": i32(rng, -50, 50, n), "sid": i32(rng, 0, 9, n)}
    for t in (jt, tt):
        t.store.upsert(keys, i32(np.random.default_rng(0), 0, 9, n), z, z, vals)
    return jt, tt


def _admit(np_like):
    """An admit_write of the session shape, for either package."""
    def admit(out, widx, got, in_ob, oidx, host_res):
        found, h_floor, h_sid = host_res
        if np_like == "jax":
            floor = jnp.where(in_ob, jnp.take(out["ofloor"], oidx), h_floor)
            out["floor"] = out["floor"].at[widx].set(
                jnp.where(in_ob | found, floor, IMIN), mode="drop")
            out["sid"] = out["sid"].at[widx].set(
                jnp.where(in_ob, jnp.take(out["osid"], oidx), h_sid), mode="drop")
            return out
        floor = torch.where(in_ob, out["ofloor"].index_select(0, oidx), h_floor)
        out["floor"] = tl._set_drop(out["floor"], widx, torch.where(in_ob | found, floor, IMIN))
        out["sid"] = tl._set_drop(out["sid"], widx, torch.where(
            in_ob, out["osid"].index_select(0, oidx), h_sid))
        return out
    return admit


def _pack(np_like):
    def pack(out, opos, perm, spill):
        if np_like == "jax":
            out["ofloor"] = out["ofloor"].at[opos].set(jnp.take(out["floor"], perm),
                                                       mode="drop")
            return out
        out["ofloor"] = tl._set_drop(out["ofloor"], opos, out["floor"].index_select(0, perm))
        return out
    return pack


@pytest.mark.parametrize("seed", range(4))
def test_slot_primitives_equal_jax(seed):
    rng = np.random.default_rng(seed)
    st = slot_state(rng, free=int(rng.integers(0, 8)))
    keys, ok = lanes(rng, 36)
    jk, tk = jnp.asarray(keys), torch.from_numpy(keys)
    jo, to = jnp.asarray(ok), torch.from_numpy(ok)
    assert_same(ttier.slot_lookup(to_t(st)["hkey"], to_t(st)["hused"], tk, to),
                jtier.slot_lookup(jnp.asarray(st["hkey"]), jnp.asarray(st["hused"]), jk, jo),
                "slot_lookup")
    assert_same(tl.claim_free_slots(to_t(st)["hused"], to),
                jtier.slot_alloc(jnp.asarray(st["hused"]), jo), "slot_alloc")
    assert_same(ttier.outbox_find_last(torch.from_numpy(st["okey"]),
                                       torch.tensor(st["ocnt"]), tk, to),
                jtier.outbox_find_last(jnp.asarray(st["okey"]), jnp.asarray(st["ocnt"]),
                                       jk, jo), "outbox_find_last")
    assert_same(tl.outbox_find_last(to_t(st)["okey"], to_t(st)["ocnt"], tk, to),
                jl._outbox_find(to_j(st), jk, jo), "_outbox_find")


@pytest.mark.parametrize("seed", range(4))
def test_slot_directory_resolve_and_evict_equal_jax(seed):
    rng = np.random.default_rng(seed)
    st = slot_state(rng, free=int(rng.integers(0, 10)))
    jt, tt = slot_tiers(rng)
    keys, ok = lanes(rng, 36)

    def shapes(r):
        return [jax.ShapeDtypeStruct((r,), jnp.bool_), jax.ShapeDtypeStruct((r,), jnp.int32),
                jax.ShapeDtypeStruct((r,), jnp.int32)]
    want = jtier.slot_directory_resolve(to_j(st), jnp.asarray(keys), jnp.asarray(ok),
                                        jt.lookup_cb, shapes, _admit("jax"))
    got = ttier.slot_directory_resolve(to_t(st), torch.from_numpy(keys),
                                       torch.from_numpy(ok), tt.lookup, _admit("torch"))
    assert_same(got, want, "resolve")
    assert tt.store.counters() == jt.store.counters()
    evictable = rng.random(H) < 0.7
    disc = rng.random(H) < 0.3
    for hot_target in (0, 6, 18):
        assert_same(ttier.slot_directory_evict(to_t(st), hot_target, torch.from_numpy(evictable),
                                               torch.from_numpy(disc), _pack("torch")),
                    jtier.slot_directory_evict(to_j(st), hot_target, jnp.asarray(evictable),
                                               jnp.asarray(disc), _pack("jax")),
                    f"evict {hot_target}")
    assert ttier.slot_directory_stats(to_t(st)) == jtier.slot_directory_stats(to_j(st))


def test_slot_directory_init_equals_jax():
    want = jtier.slot_directory_init(H, S, {"ofloor": lambda s: jnp.full((s,), IMIN, jnp.int32)})
    got = ttier.slot_directory_init(H, S, {"ofloor": lambda s: torch.full((s,), IMIN,
                                                                          dtype=torch.int32)},
                                    "cpu")
    assert_same(got, want, "init")


@pytest.mark.parametrize("seed", range(4))
def test_slot_alloc_under_the_jax_name_equals_jax(seed):
    """``state/tiered.py::slot_alloc`` (the port computes it as
    ``ops/lookup.py::claim_free_slots``) against the JAX function."""
    rng = np.random.default_rng(100 + seed)
    st = slot_state(rng, free=int(rng.integers(0, 10)))
    _keys, ok = lanes(rng, 36)
    assert_same(ttier.slot_alloc(to_t(st)["hused"], torch.from_numpy(ok)),
                jtier.slot_alloc(jnp.asarray(st["hused"]), jnp.asarray(ok)), "slot_alloc")
    assert "slot_alloc" in ttier.__all__

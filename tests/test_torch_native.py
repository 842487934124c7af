"""The port's native host runtime and record ingest against the JAX package's.

Mirrors ``tests/test_native_ingest.py`` and the ring cases of
``tests/test_native_runtime.py``: the port builds its own copy of the C++
sources (``windflow_tpu_torch/native/csrc``) into ``build/native/``. The
AoS/SoA passes, the key hashing and ``RecordSource`` must equal the JAX
package's bit for bit on the same seeded records; a keyed window over a
``RecordSource`` must give the JAX package's rows and the dense oracle.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import native as jn
from windflow_tpu.basic import win_type_t as jwt
from windflow_tpu.batch import _fnv1a, hash_key_to_slot as j_hash
from windflow_tpu.operators.window import WindowSpec as JSpec
from windflow_tpu_torch import native as tn
from windflow_tpu_torch.batch import hash_key_to_slot as t_hash

CPU = {"device": "cpu"}
DT = np.dtype([("key", "i4"), ("ts", "i8"), ("v", "f4"), ("vec", "f4", (3,)),
               ("tag", "S8"), ("b", "u1"), ("h", "i2")])


def make_records(n, seed=0):
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, DT)
    rec["key"] = rng.integers(0, 57, n)
    rec["ts"] = np.arange(n) * 3
    rec["v"] = rng.random(n).astype(np.float32)
    rec["vec"] = rng.random((n, 3)).astype(np.float32)
    rec["tag"] = [f"k{i % 7}".encode() for i in range(n)]
    rec["b"] = rng.integers(0, 256, n)
    rec["h"] = rng.integers(-30000, 30000, n)
    return rec


def assert_columns_equal(got, want):
    assert list(got) == list(want)
    for f in want:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape, f
        assert got[f].tobytes() == want[f].tobytes(), f


# ---- the library ------------------------------------------------------------------

def test_native_library_builds_into_build_native():
    path = tn.build()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert path.name.startswith("libwfnative-") and path.exists()
    assert tn.native_available()
    assert tn.hardware_concurrency() >= 1


def test_failed_build_raises(monkeypatch, tmp_path):
    """A build that fails raises with the compiler's output: no Python ring
    or numpy pass stands in."""
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tn, "CXX_FLAGS", ("-O3", "-shared", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="native runtime build failed"):
        tn.build()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_spsc_queue_ordered_transfer():
    q = tn.SPSCQueue(64)
    n = 10_000
    out = []

    def consumer():
        for _ in range(n):
            ok, item = q.pop()
            assert ok
            out.append(item)
    t = threading.Thread(target=consumer)
    t.start()
    for i in range(n):
        q.push(("item", i))
    t.join(timeout=60)
    assert not t.is_alive()
    assert [x[1] for x in out] == list(range(n))


def test_spsc_queue_backpressure():
    q = tn.SPSCQueue(4)
    for i in range(4):
        q.push(i, spin=1)
    assert q.size() == 4                     # full: a fifth push would spin
    assert q.pop(spin=1, max_yields=0) == (True, 0)
    assert q.size() == 3


def test_empty_ring_pop_times_out():
    assert tn.SPSCQueue(8).pop(spin=4, max_yields=2) == (False, None)


def test_queue_selfbench_moves_tokens():
    assert tn.queue_selfbench(200_000, 1024) > 1e6


# ---- AoS <-> SoA --------------------------------------------------------------------

def test_unpack_pack_roundtrip_every_field_width_matches_jax():
    rec = make_records(500)
    cols = tn.unpack_records(rec)
    assert_columns_equal(cols, jn.unpack_records(rec))
    for f in DT.names:
        np.testing.assert_array_equal(cols[f], rec[f], err_msg=f)
        assert cols[f].flags["C_CONTIGUOUS"]
    back = tn.pack_records(cols, DT)
    assert back.tobytes() == rec.tobytes()
    assert back.tobytes() == jn.pack_records(cols, DT).tobytes()


@pytest.mark.parametrize("workers", [1, 2, 3, 8])
def test_parallel_unpack_matches_single_pass_and_jax(workers):
    rec = make_records(1001)
    got = tn.parallel_unpack(rec, workers=workers)
    assert_columns_equal(got, tn.unpack_records(rec))
    assert_columns_equal(got, jn.parallel_unpack(rec, workers=workers))


@pytest.mark.parametrize("n", [0, 1, 3])
def test_parallel_unpack_tiny_and_empty(n):
    rec = np.ascontiguousarray(make_records(max(n, 1))[:n])
    assert_columns_equal(tn.parallel_unpack(rec, workers=4), jn.unpack_records(rec))


def test_unpack_noncontiguous_falls_back():
    rec = make_records(200)[::2]                # a strided view
    cols = tn.unpack_records(rec)
    for f in DT.names:
        np.testing.assert_array_equal(cols[f], rec[f], err_msg=f)
    assert_columns_equal(cols, jn.unpack_records(rec))


def test_pack_records_rejects_mismatched_columns():
    cols = {"key": np.arange(10, dtype=np.int32), "ts": np.arange(5, dtype=np.int64)}
    with pytest.raises(ValueError, match="ts"):
        tn.pack_records(cols, np.dtype([("key", "i4"), ("ts", "i8")]))


# ---- key hashing --------------------------------------------------------------------

@pytest.mark.parametrize("num_slots", [7, 64, 977])
def test_hash_parity_int_bytes_unicode(num_slots):
    ints = np.asarray([0, 1, -5, 2**31 - 1, -2**31, 123456789, 2**62 + 3], np.int64)
    want = [(int(k) & 0xFFFFFFFFFFFFFFFF) * 2654435761 % (1 << 64) % num_slots
            for k in ints]
    for arr in (ints, ints.astype(np.uint64), ints[:5].astype(np.int32)):
        got = t_hash(arr, num_slots)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, j_hash(arr, num_slots))
    np.testing.assert_array_equal(tn.hash_keys_native(ints, num_slots), want)

    tags = np.asarray([b"alpha", b"beta", b"x", b""], "S8")
    want = [_fnv1a(t) % num_slots for t in [b"alpha", b"beta", b"x", b""]]
    np.testing.assert_array_equal(t_hash(tags, num_slots), want)
    np.testing.assert_array_equal(t_hash(tags, num_slots), j_hash(tags, num_slots))

    names = np.asarray(["user_1", "user_22", "", "éclair", "user_1"])
    want = [_fnv1a(s.encode()) % num_slots for s in names.tolist()]
    np.testing.assert_array_equal(t_hash(names, num_slots), want)
    np.testing.assert_array_equal(t_hash(names, num_slots), j_hash(names, num_slots))
    np.testing.assert_array_equal(t_hash(names.reshape(5, 1), num_slots),
                                  np.asarray(want).reshape(5, 1))


def test_hash_parity_embedded_nul_bytes():
    tags = np.asarray([b"a\x00b", b"a\x00c", b"a"], "S8")
    got = t_hash(tags, 97)
    np.testing.assert_array_equal(got, [_fnv1a(t) % 97 for t in [b"a\x00b", b"a\x00c", b"a"]])
    np.testing.assert_array_equal(got, j_hash(tags, 97))
    assert got[0] != got[1]


def test_hash_key_to_slot_arrays_take_the_native_pass(monkeypatch):
    """An array of keys goes through one native call; scalars and object
    arrays stay in Python, with the same slots."""
    import windflow_tpu_torch.native as native
    calls = []
    real = native.hash_keys_native
    monkeypatch.setattr(native, "hash_keys_native",
                        lambda a, n: calls.append(a.dtype.kind) or real(a, n))
    arr = np.asarray([f"sensor-{i}" for i in range(50)])
    want = np.asarray([_fnv1a(s.encode()) % 16 for s in arr.tolist()], np.int32)
    np.testing.assert_array_equal(t_hash(arr, 16), want)
    np.testing.assert_array_equal(t_hash(np.arange(9), 16), j_hash(np.arange(9), 16))
    assert calls == ["U", "i"]
    assert t_hash("sensor-3", 16) == want[3]
    np.testing.assert_array_equal(t_hash(arr.astype(object), 16), want)
    assert calls == ["U", "i"]


# ---- RecordSource -------------------------------------------------------------------

DT2 = np.dtype([("key", "i4"), ("ts", "i8"), ("v", "f4")])


def records2(n=500):
    rec = make_records(n)
    r2 = np.zeros(n, DT2)
    for f in DT2.names:
        r2[f] = rec[f]
    return r2


def port_batches(src, batch, **kw):
    return [{"key": b.key.numpy(), "id": b.id.numpy(), "ts": b.ts.numpy(),
             "valid": b.valid.numpy(), **{f"p.{k}": v.numpy() for k, v in b.payload.items()}}
            for b in src.batches(batch, **kw)]


def jax_batches(src, batch, **kw):
    out = []
    for b in src.batches(batch, **kw):
        b = jax.tree.map(np.asarray, b)
        out.append({"key": b.key, "id": b.id, "ts": b.ts, "valid": b.valid,
                    **{f"p.{k}": v for k, v in b.payload.items()}})
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_columns_equal(g, w)


@pytest.mark.parametrize("workers", [1, 4, None])
def test_record_source_batches_equal_jax(workers):
    """framing_workers changes nothing: every batch (control fields hashed
    into slots, ts from a record field, the payload) equals the JAX
    package's RecordSource bit for bit."""
    r2 = records2()

    def chunks():
        for s in range(0, 500, 100):
            yield r2[s:s + 100]
    kw = dict(key_field="key", ts_field="ts", num_keys=8)
    got = port_batches(wt.RecordSource(chunks, DT2, framing_workers=workers, **kw,
                                       **CPU), 128)
    # the JAX package frames int64 ts into int32 the same way
    want = jax_batches(wf.RecordSource(chunks, DT2, **kw), 128)
    assert_batches_equal(got, want)
    assert sum(int(b["valid"].sum()) for b in got) == 500


def test_record_source_cursor_resume():
    r2 = np.zeros(600, np.dtype([("key", "i4"), ("v", "f4")]))
    rec = make_records(600)
    r2["key"], r2["v"] = rec["key"], rec["v"]
    opens = []

    def chunks(from_batch=0):
        opens.append(from_batch)

        def gen():
            for s in range(from_batch * 100, 600, 100):
                yield r2[s:s + 100]
        return gen()
    src = wt.RecordSource(chunks, r2.dtype, key_field="key", num_keys=8, **CPU)
    it = src.batches(100)
    for _ in range(3):
        next(it)
    tok = src.cursor()
    assert tok == {"batch": 3, "next_id": 300}
    rest_a = [{"id": b.id.numpy(), "key": b.key.numpy(), "v": b.payload["v"].numpy()}
              for b in it]
    src2 = wt.RecordSource(chunks, r2.dtype, key_field="key", num_keys=8, **CPU)
    rest_b = [{"id": b.id.numpy(), "key": b.key.numpy(), "v": b.payload["v"].numpy()}
              for b in src2.batches(100, cursor=tok)]
    assert opens[-1] == 3                     # the factory seeked, no replay
    assert_batches_equal(rest_a, rest_b)
    assert len(rest_a) == 3


def test_record_source_rejects_string_payload_field():
    dt = np.dtype([("key", "i4"), ("tag", "S8")])
    with pytest.raises(TypeError, match="tag"):
        wt.RecordSource(lambda: iter(()), dt, key_field="key", **CPU)
    with pytest.raises(ValueError, match="nope"):
        wt.RecordSource(lambda: iter(()), dt, key_field="nope", **CPU)


def test_record_source_payload_spec():
    spec = wt.RecordSource(lambda: iter(()), DT, key_field="tag", ts_field="ts",
                           **CPU).payload_spec()
    assert list(spec) == ["key", "v", "vec", "b", "h"]
    assert spec["vec"].shape == (3,) and spec["vec"].dtype == torch.float32
    assert spec["b"].dtype == torch.uint8 and spec["h"].dtype == torch.int16


def test_record_source_end_to_end_keyed_window():
    """String-keyed records (hashed at ingest) through a TB Win_Seq: the
    rows' keys and window ids equal the JAX package's byte for byte; the
    float32 window sums (at most 20 random values, summed in another order
    by the port's plain K6 than by XLA) within rtol = atol = 1e-6; and the
    dense oracle within 1e-4."""
    total, chunk, K = 240, 60, 8
    rec = make_records(total, seed=3)
    rec["ts"] = np.arange(total)

    def chunks():
        for s in range(0, total, chunk):
            yield rec[s:s + chunk]
    fields = ["key", "id", "payload"]

    def collect(out):
        def cb(view):
            if view is not None:
                out.append({f: np.asarray(view[f]) for f in fields})
        return cb
    port, jax_rows = [], []
    wt.Pipeline(wt.RecordSource(chunks, DT, key_field="tag", ts_field="ts", num_keys=K,
                                **CPU),
                [wt.Win_Seq(lambda wid, it: it.sum("v"),
                            wt.WindowSpec(20, 20, wt.win_type_t.TB), num_keys=K, **CPU)],
                wt.Sink(collect(port), **CPU), batch_size=64, **CPU).run()
    wf.Pipeline(wf.RecordSource(chunks, DT, key_field="tag", ts_field="ts", num_keys=K),
                [wf.Win_Seq(lambda wid, it: it.sum("v"), JSpec(20, 20, jwt.TB),
                            num_keys=K)],
                wf.Sink(collect(jax_rows)), batch_size=64).run()
    assert len(port) == len(jax_rows)
    for p, j in zip(port, jax_rows):
        assert_columns_equal({f: p[f] for f in ("key", "id")},
                             {f: j[f] for f in ("key", "id")})
        np.testing.assert_allclose(p["payload"], j["payload"], rtol=1e-6, atol=1e-6)
    want = {}
    slots = j_hash(rec["tag"], K)
    for i in range(total):
        kk = (int(slots[i]), int(rec["ts"][i]) // 20)
        want[kk] = want.get(kk, 0.0) + float(rec["v"][i])
    got = {(int(k), int(w)): float(r) for p in port
           for k, w, r in zip(p["key"], p["id"], p["payload"])}
    assert set(got) == set(want)
    for kk in want:
        assert abs(got[kk] - want[kk]) < 1e-4, (kk, got[kk], want[kk])

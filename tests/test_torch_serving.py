"""The serving plane in the port (``windflow_tpu_torch/serving/``) against the
JAX package's, on the CPU.

Mirrors ``tests/test_serving.py`` and ``tests/test_serving_observability.py``:
WFS1 frames byte for byte the JAX package's and decoded across the packages
(torn, lying and non-numeric frames resync alike); the JAX ``RecordClient``
driving the port's ``SocketSource`` (tenant dedup, torn bytes, EOS, a killed
peer's overlap re-send, the replay ring's resume and its refusal when
undersized, the wire coordinates); ``FileTailSource``; a served chain with
two tenants, a live swap and a noisy tenant giving the JAX
``ServingRuntime``'s rows, shed counts and ``serving`` section on the same
offered sequence; the configuration, tenant grammar and WF119 problems word
for word; the per-tenant latency rows and their SLO signal; a monitored
serve whose stalled tenant pages with a profile, tightened by ``tenant_rate``
alone (the Reporter ticked by hand); and ``scripts/wf_serve.py`` ``status``
and ``swap`` against the port's artifacts and live endpoint. Socket tests
join with a timeout and assert counts and rows, never latencies.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.observability import MetricsRegistry as JRegistry
from windflow_tpu.serving import RecordClient as JRecordClient
from windflow_tpu.serving import ServingRuntime as JServingRuntime
from windflow_tpu.serving import SocketSource as JSocketSource
from windflow_tpu.serving import config as jconfig
from windflow_tpu.serving import framing as jframing
from windflow_tpu.serving import tenants as jtenants
from windflow_tpu_torch.observability import MonitoringConfig, profiling
from windflow_tpu_torch.observability import metrics as tmetrics
from windflow_tpu_torch.observability import names as tnames
from windflow_tpu_torch.observability import slo as tslo
from windflow_tpu_torch.serving import (FileTailSource, RecordClient, RecordFrameDecoder,
                                        ServingConfig, ServingRuntime, SocketSource,
                                        TenantSpec, encode_record_frame)
from windflow_tpu_torch.serving import config as tconfig
from windflow_tpu_torch.serving import framing as tframing
from windflow_tpu_torch.serving import tenants as ttenants
from windflow_tpu_torch.serving.runtime import _states_compatible

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WF_SERVE_CLI = os.path.join(REPO, "scripts", "wf_serve.py")
BATCH = 32
DT = np.dtype([("key", np.int32), ("ts", np.int64), ("v", np.float32)])
CPU = {"device": "cpu"}
FRAMING = {"jax": jframing, "port": tframing}
CONFIG = {"jax": jconfig, "port": tconfig}
TENANTS = {"jax": jtenants, "port": ttenants}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("WF_SERVE", "WF_SERVE_ENDPOINT", "WF_TENANTS", "WF_MONITORING", "WF_SLO",
              "WF_PROFILE", "WF_REMEDIATION", "WF_TELEMETRY"):
        monkeypatch.delenv(k, raising=False)


def _chunks(n, base=0.0, batch=BATCH):
    out = []
    for i in range(n):
        rec = np.zeros(batch, dtype=DT)
        rec["key"] = np.arange(batch) % 4
        rec["ts"] = np.arange(i * batch, (i + 1) * batch)
        rec["v"] = base + np.arange(i * batch, (i + 1) * batch, dtype=np.float32)
        out.append(rec)
    return out


def _ops(pkg="port"):
    if pkg == "jax":
        return [wf.Map(lambda t: {"v": t.v * 2.0 + 1.0})]
    return [wt.Map(lambda t: {"v": t.v * 2.0 + 1.0}, **CPU)]


def _collect(acc):
    def cb(view):
        if view is not None:
            acc.extend(zip(view["id"].tolist(), np.asarray(view["payload"]["v"]).tolist()))
    return cb


def _source(pkg, **kw):
    if pkg == "jax":
        return JSocketSource("tcp://127.0.0.1:0", DT, key_field="key", ts_field="ts",
                             num_keys=4, **kw)
    return SocketSource("tcp://127.0.0.1:0", DT, key_field="key", ts_field="ts",
                        num_keys=4, device="cpu", **kw)


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


# ---------------------------------------------------------------- framing

def _frames():
    rec = _chunks(1)[0].tobytes()
    return [dict(records=rec, tenant="a", seq=7),
            dict(records=rec, tenant="b", seq=0, t_send=123.25, span="b/0"),
            dict(records=b"", tenant="a", seq=8, kind="eos"),
            dict(records=b"", tenant="", seq=0, kind="swap", graph="v2")]


def test_frames_byte_identical_to_the_jax_packages():
    for kw in _frames():
        assert tframing.encode_record_frame(**kw) == jframing.encode_record_frame(**kw)
    for name in ("MAGIC", "MAX_FRAME_BYTES", "FRAME_KINDS", "DEFAULT_TENANT"):
        assert getattr(tframing, name) == getattr(jframing, name), name
    assert tframing.MAX_FRAME_BYTES == 64 << 20


def test_decoders_agree_byte_by_byte_and_through_garbage():
    """Either package's decoder reads either package's frames, dribbled a
    byte at a time or cut by garbage, truncation, a lying nbytes and
    non-numeric meta fields, with the same counters."""
    rec = _chunks(1)[0].tobytes()
    a = jframing.encode_record_frame(rec, tenant="a", seq=0)
    b = tframing.encode_record_frame(rec, tenant="b", seq=0)
    liar = a.replace(b'"nbytes": %d' % len(rec), b'"nbytes": %d' % (len(rec) - 1))

    def raw(meta, records=b"xyz"):
        payload = json.dumps(meta).encode() + b"\n" + records
        return jframing.MAGIC + b"%08x" % len(payload) + b"\n" + payload + b"\n"
    wire = (b"NOT A FRAME " * 4 + a + b[:len(b) // 2] + a[:10] + b + liar
            + raw({"kind": "data", "nbytes": None, "seq": 0})
            + raw({"kind": "data", "nbytes": 3, "seq": [1]}) + a)
    got = {}
    for pkg in ("jax", "port"):
        dec = FRAMING[pkg].RecordFrameDecoder()
        whole = dec.feed(wire)
        dec2 = FRAMING[pkg].RecordFrameDecoder()
        dribbled = []
        for i in range(len(b)):
            dribbled += dec2.feed(b[i:i + 1])
        got[pkg] = (whole, dec.frames_decoded, dec.frames_torn, dribbled)
    assert got["jax"] == got["port"]
    whole = got["port"][0]
    assert [m["tenant"] for m, _ in whole] == ["a", "b", "a"]
    assert all(blob == rec for _, blob in whole)


def test_frame_stamp_and_unknown_meta_forward_compat():
    rec = b"r" * 24
    dec = RecordFrameDecoder()
    (meta, blob), = dec.feed(encode_record_frame(rec, tenant="a", seq=3, t_send=123.25,
                                                 span="a/3"))
    assert (meta["t_send"], meta["span"], blob) == (123.25, "a/3", rec)
    fut = {"tenant": "a", "seq": 4, "kind": "data", "nbytes": len(rec), "hop_count": 3}
    payload = json.dumps(fut).encode() + b"\n" + rec
    (meta2, _), = dec.feed(tframing.MAGIC + b"%08x" % len(payload) + b"\n" + payload
                           + b"\n")
    assert meta2["hop_count"] == 3
    (meta3, _), = dec.feed(encode_record_frame(rec, tenant="a", seq=5))
    assert "t_send" not in meta3 and "span" not in meta3
    assert RecordClient("tcp://127.0.0.1:1", stamp=False).stamp is False


@pytest.mark.parametrize("ep", ["tcp://127.0.0.1:9500", "127.0.0.1:0",
                                "unix:///tmp/wf.sock", "unix:/tmp/wf.sock", "",
                                "tcp://nohost", "tcp://h:notaport", "tcp://h:99999",
                                "unix://"])
def test_parse_endpoint_grammar(ep):
    got = []
    for pkg in ("jax", "port"):
        try:
            got.append(FRAMING[pkg].parse_endpoint(ep))
        except ValueError as e:
            got.append(("err", str(e)))
    assert got[0] == got[1]


# ----------------------------------------------------------- socket source

def _drain(src, out):
    for b in src.batches(BATCH):
        v = b.payload["v"][b.valid].tolist()
        out.append((src.last_tenant, v))


def test_jax_client_drives_the_ports_socket_source():
    """The JAX ``RecordClient`` against the port's ``SocketSource``: tenant
    attribution, a duplicate seq dropped, garbage resynced, EOS."""
    chunks = _chunks(3)
    src = _source("port").start()
    client = JRecordClient(src.endpoint)
    client.send(chunks[0].tobytes(), tenant="a")
    client.send_garbage(b"GARBAGE IN THE STREAM " * 3)
    client.send(chunks[1].tobytes(), tenant="b")
    client.send(chunks[0].tobytes(), tenant="a", seq=0)
    client.send(chunks[2].tobytes(), tenant="a")
    client.send_eos("a")
    client.close()
    got = []
    _drain(src, got)
    src.close()
    assert [t for t, _ in got] == ["a", "b", "a"]
    assert got[0][1] == chunks[0]["v"].tolist() and got[2][1] == chunks[2]["v"].tolist()
    assert src.frames_dup == 1 and src.frames_torn >= 1 and src.clients_seen == 1


def test_peer_kill_overlap_resend_degrades_to_replay():
    chunks = _chunks(6)
    src = _source("port", replay=32).start()
    client = RecordClient(src.endpoint)
    sent = [(client.send(c.tobytes(), tenant="a"), c.tobytes()) for c in chunks[:3]]
    assert _wait(lambda: src.frames_decoded >= 3)
    client.kill()
    client.reconnect()
    for seq, blob in sent:
        client.send(blob, tenant="a", seq=seq)
    for c in chunks[3:]:
        client.send(c.tobytes(), tenant="a")
    client.send_eos("a")
    client.close()
    got = []
    _drain(src, got)
    src.close()
    assert [v for _, v in got] == [c["v"].tolist() for c in chunks]
    assert src.frames_dup == 3


def test_replay_ring_resume_redrives_gap_and_refuses_undersized():
    chunks = _chunks(5)
    for replay in (8, 2):
        src = _source("port", replay=replay).start()
        client = RecordClient(src.endpoint)
        for c in chunks:
            client.send(c.tobytes(), tenant="a")
        client.send_eos("a")
        client.close()
        assert _wait(lambda: src._next_chunk == len(chunks))
        if replay == 8:
            got = [rec["v"].tolist() for rec in src._chunks_from_ring(from_batch=2)]
            assert got == [c["v"].tolist() for c in chunks[2:]]
        else:
            with pytest.raises(RuntimeError, match="replay ring starts at"):
                next(src._chunks_from_ring(from_batch=1))
        src.close()


def test_socket_source_records_wire_coordinates():
    chunks = _chunks(1)
    for stamp in (True, False):
        src = _source("port").start()
        client = RecordClient(src.endpoint, stamp=stamp)
        t_before = time.time()
        client.send(chunks[0].tobytes(), tenant="a")
        client.send_eos("a")
        client.close()
        wires = [dict(src.last_wire or {}) for _b in src.batches(BATCH)]
        src.close()
        (w,) = wires
        assert w["seq"] == 0 and t_before <= w["t_recv"] <= time.time()
        if stamp:
            assert w["span"] == "a/0" and t_before <= w["t_send"] <= w["t_recv"]
        else:
            assert w["t_send"] is None and w["span"] is None


def _oracle(chunks):
    out = []
    wt.Pipeline(wt.RecordSource(lambda: iter(chunks), DT, key_field="key", ts_field="ts",
                                num_keys=4, **CPU),
                _ops(), wt.Sink(_collect(out), **CPU), batch_size=BATCH, **CPU).run()
    return out


def test_file_tail_source_follows_appends(tmp_path):
    chunks = _chunks(4)
    path = str(tmp_path / "records.bin")
    open(path, "wb").close()

    def writer():
        with open(path, "ab") as f:
            for c in chunks:
                f.write(c.tobytes())
                f.flush()
                time.sleep(0.01)
        open(path + ".eos", "w").close()
    t = threading.Thread(target=writer)
    t.start()
    got = []
    src = FileTailSource(path, DT, batch_records=BATCH, key_field="key", ts_field="ts",
                         num_keys=4, poll_s=0.005, **CPU)
    wt.Pipeline(src, _ops(), wt.Sink(_collect(got), **CPU), batch_size=BATCH, **CPU).run()
    t.join()
    assert sorted(got) == sorted(_oracle(chunks)) and got


# ---------------------------------------------------------------- runtime

def _serve(pkg, tmp_path, tenants, chunks, tenant_of, *, swap=None, eos_tenant="a",
           register=("v2",), mon=None):
    """Serve ``chunks`` through ``pkg``'s ServingRuntime from one JAX
    ``RecordClient`` (the same offered sequence for both packages)."""
    mon = mon or str(tmp_path / f"mon-{pkg}")
    got = []
    src = _source(pkg, replay=len(chunks) + 8)
    if pkg == "jax":
        rt = JServingRuntime(src, _ops("jax"), wf.Sink(_collect(got)), batch_size=BATCH,
                             serving={"tenants": tenants}, monitoring=mon)
    else:
        rt = ServingRuntime(src, _ops(), wt.Sink(_collect(got), **CPU), batch_size=BATCH,
                            serving={"tenants": tenants}, monitoring=mon, **CPU)
    for label in register:
        rt.register_graph(label, _ops(pkg))
    src.start()
    thread = rt.run_background()
    client = JRecordClient(src.endpoint)
    for i, c in enumerate(chunks):
        client.send(c.tobytes(), tenant=tenant_of[i])
        if swap is not None and i == swap[0]:
            client.send_swap(swap[1])
    client.send_eos(eos_tenant)
    client.close()
    thread.join(timeout=60.0)
    assert not thread.is_alive()
    if rt.background_error is not None:
        raise rt.background_error
    return got, rt, mon


def _section(rt):
    sec = rt.serving_section()
    sec.pop("endpoint")
    return sec


def test_served_rows_and_sections_equal_jax(tmp_path):
    """Two tenants, a live wire swap and a noisy tenant over its own bucket:
    the port gives the JAX ``ServingRuntime``'s rows, shed counts and
    ``serving`` section on the same offered sequence, the swap journaled
    warmed with its state carried."""
    quiet, noisy = _chunks(8, base=10_000.0), _chunks(8, base=0.0)
    mixed, tenant_of = [], []
    for q, n in zip(quiet, noisy):
        mixed += [q, n]
        tenant_of += ["quiet", "noisy"]
    tenants = [{"id": "quiet"}, {"id": "noisy", "refill_per_batch": 4.0,
                                 "burst": float(BATCH)}]
    got = {}
    for pkg in ("jax", "port"):
        rows, rt, mon = _serve(pkg, tmp_path, tenants, mixed, tenant_of, swap=(7, "v2"),
                               eos_tenant="quiet")
        got[pkg] = (sorted(rows), _section(rt))
        events = [json.loads(line) for line in open(os.path.join(mon, "events.jsonl"))]
        swaps = [e for e in events if e.get("event") == "graph_swap" and e.get("applied")]
        assert len(swaps) == 1 and swaps[0]["warmed"] and swaps[0]["carried_state"]
        kinds = {e["event"] for e in events}
        assert {"serving_start", "serving_end", "graph_swap"} <= kinds
        snap = json.load(open(os.path.join(mon, "snapshot.json")))
        assert snap["serving"]["graph"] == "v2"
    assert got["port"] == got["jax"]
    rows, sec = got["port"]
    assert sec["tenants"]["noisy"]["shed"] > 0 and sec["tenants"]["quiet"]["shed"] == 0
    assert sec["swaps_applied"] == 1 and sec["graph"] == "v2"
    assert len([v for _, v in rows if v >= 2 * 10_000]) == sum(len(c) for c in quiet)


def test_wire_swap_to_unregistered_graph_is_rejected(tmp_path):
    chunks = _chunks(4)
    got, rt, _ = _serve("port", tmp_path, [{"id": "a"}], chunks, ["a"] * 4,
                        swap=(1, "nope"))
    assert rt.swaps_rejected == 1 and rt.swaps_applied == 0 and rt.graph_label != "nope"
    assert sorted(got) == sorted(_oracle(chunks))


def test_states_compatible_compares_port_state_trees():
    """Carrying state across a swap needs the same tree: containers, keys,
    and each leaf's shape and dtype."""
    from windflow_tpu_torch.benchmarks import ysb
    spec = {"ad_id": torch.empty((), dtype=torch.int32, device="meta"),
            "event_type": torch.empty((), dtype=torch.int32, device="meta")}

    def chain(**geom):
        return wt.CompiledChain(ysb.make_ops(device="cpu", **geom), spec,
                                batch_capacity=64, device="cpu")
    a, b = chain(pane_capacity=8, max_wins=8), chain(pane_capacity=8, max_wins=8)
    assert _states_compatible(a.states, b.states)
    assert not _states_compatible(a.states, chain(pane_capacity=16, max_wins=8).states)
    assert not _states_compatible([{"x": torch.zeros(2)}], [{"y": torch.zeros(2)}])
    assert not _states_compatible([torch.zeros(2)], [torch.zeros(2, dtype=torch.int32)])


def test_drop_oldest_ts_held_batches_are_not_counted_shed():
    class _B:
        capacity = BATCH
    spec = [{"id": "a", "refill_per_batch": 1.0, "burst": float(BATCH),
             "shed_policy": "drop_oldest_ts"}]
    out = {}
    for pkg in ("jax", "port"):
        reg = TENANTS[pkg].build_registry(spec, base_capacity=BATCH)
        trace = [len(reg.offer("a", _B())) for _ in range(4)]
        trace.append(reg.counters()["a"]["shed_tuples"])
        trace.append(len(reg.drain()))
        reg2 = TENANTS[pkg].build_registry(spec, base_capacity=BATCH)
        reg2.set_state(reg.state())
        out[pkg] = (trace, reg.counters(), reg2.counters()["a"]["shed_tuples"])
    assert out["port"] == out["jax"]
    assert out["port"][1]["a"]["shed"] == 1 and out["port"][2] == BATCH


def test_registry_scale_rate_targets_one_tenant():
    reg = ttenants.build_registry([{"id": "a", "refill_per_batch": 8.0}, {"id": "b"}],
                                  base_capacity=BATCH)
    assert reg.scale_rate("a", 0.5)["tenant"] == "a"
    assert reg.counters()["a"]["rate"] == 4.0 and "rate" not in reg.counters()["b"]
    for t in ("b", "ghost"):
        with pytest.raises(ValueError):
            reg.scale_rate(t, 0.5)


# ------------------------------------------------------ config + WF119

def test_serving_config_resolve_grammar(monkeypatch, tmp_path):
    p = tmp_path / "s.json"
    p.write_text('{"endpoint": "tcp://h:5", "swap_warm": false}')
    for form in (None, False, True, "tcp://h:5", '{"replay": 9}', str(p), "0", "1"):
        got = [CONFIG[k].ServingConfig.resolve(form) for k in ("jax", "port")]
        assert (got[0] is None) == (got[1] is None)
        if got[1] is not None:
            import dataclasses
            assert dataclasses.asdict(got[0]) == dataclasses.asdict(got[1]), form
    assert ServingConfig.resolve(True).replay == 256
    monkeypatch.setenv("WF_SERVE", "1")
    monkeypatch.setenv("WF_SERVE_ENDPOINT", "tcp://e:7")
    assert ServingConfig.resolve(None).resolved_endpoint() == "tcp://e:7"
    monkeypatch.setenv("WF_TENANTS", '[{"id": "a"}]')
    assert ServingConfig.resolve(None).resolved_tenants() == '[{"id": "a"}]'


def test_serving_problems_catalogue(tmp_path):
    """The WF119 problems are the JAX package's, word for word."""
    mon = str(tmp_path / "mon")
    cases = [
        (dict(tenants=[{"id": "a"}]), dict(monitoring=mon)),
        (dict(tenants=[{"id": "a"}]), dict(monitoring=None)),
        (dict(endpoint="not an endpoint", replay=0, swap_warm=False,
              tenants=[{"id": "a"}, {"id": "a"}, {"id": "b", "rate_tps": 5.0}]),
         dict(monitoring=mon, supervised=True)),
    ]
    for cfg_kw, kw in cases:
        got = [CONFIG[p].serving_problems(CONFIG[p].ServingConfig(**cfg_kw), **kw)
               for p in ("jax", "port")]
        assert got[0] == got[1]
    probs = got[1]
    blob = "\n".join(probs)
    for frag in ("unparseable serving endpoint", "replay must be >= 1", "swap_warm=false",
                 "duplicate", "rate_tps"):
        assert frag in blob, frag
    specs = {p: [m.SLOSpec("iso", "tenant_drop_ratio", target=0.1, tenant="ghost")]
             for p, m in (("jax", __import__("windflow_tpu.observability.slo",
                                             fromlist=["x"])), ("port", tslo))}
    got = [CONFIG[p].serving_problems(CONFIG[p].ServingConfig(tenants=[{"id": "a"}]),
                                      monitoring=mon, slo_specs=specs[p])
           for p in ("jax", "port")]
    assert got[0] == got[1] and any("ghost" in p for p in got[1])


def test_constructor_mirrors_wf119(tmp_path):
    mon = str(tmp_path / "mon")
    for kw in ({"serving": True},
               {"monitoring": mon, "serving": {"tenants": [{"id": "a"}, {"id": "a"}]}},
               {"monitoring": mon, "supervised": True,
                "serving": {"tenants": [{"id": "a", "rate_tps": 9.0}]}}):
        errs = []
        for pkg in ("jax", "port"):
            src = _source(pkg)
            R = JServingRuntime if pkg == "jax" else ServingRuntime
            extra = {} if pkg == "jax" else CPU
            with pytest.raises(ValueError, match="WF119") as e:
                R(src, _ops(pkg), **kw, **extra)
            errs.append(str(e.value))
            src.close()
        assert errs[0] == errs[1]


def test_runtime_runs_on_the_sources_device(tmp_path):
    """The entry point runs on the card unless the caller passes
    ``device="cpu"``: a CPU source under the default device is refused."""
    src = _source("port")
    with pytest.raises(ValueError, match="lives on cpu"):
        ServingRuntime(src, _ops(), monitoring=str(tmp_path / "m"),
                       device=torch.device("meta"))
    src.close()


def test_tenant_grammar_and_registry_problems():
    forms = ['[{"id": "a", "refill_per_batch": 2}]', None,
             [{"id": "a", "rate_tps": 1.0, "refill_per_batch": 1.0}]]
    for form in forms:
        got = [TENANTS[p].resolve_tenants(form) for p in ("jax", "port")]
        import dataclasses
        rows = [None if g is None else [dataclasses.asdict(s) for s in g] for g in got]
        assert rows[0] == rows[1]
        if got[1]:
            assert TENANTS["jax"].registry_problems(got[0]) == \
                TENANTS["port"].registry_problems(got[1])
    both = ttenants.resolve_tenants(forms[2])
    with pytest.raises(ValueError, match="WF119"):
        ttenants.build_registry(both, base_capacity=BATCH)
    got = [TENANTS[p].registry_problems([TENANTS[p].TenantSpec("a", rate_tps=5.0)],
                                        supervised=True) for p in ("jax", "port")]
    assert got[0] == got[1] and "rate_tps" in got[1][0]
    assert TenantSpec("a").id == "a"


# ----------------------------------------------------- observability glue

def test_gauge_help_lockstep():
    from windflow_tpu.observability import metrics as jmetrics
    assert set(tmetrics._SERVING_HELP) == set(tnames.SERVING_GAUGES)
    assert set(tmetrics._TENANT_HELP) == set(tnames.TENANT_GAUGES)
    assert tmetrics._SERVING_HELP == jmetrics._SERVING_HELP
    assert tmetrics._TENANT_HELP == jmetrics._TENANT_HELP
    for ev in ("serving_start", "serving_end", "graph_swap"):
        assert ev in tnames.JOURNAL_EVENTS


def test_registry_tenant_latency_rows_and_prometheus_equal_jax():
    """Per-tenant latency rows, their windowed p99 and the exposition equal
    the JAX registry's on the same samples."""
    out = []
    for Reg in (JRegistry, wt.observability.MetricsRegistry):
        reg = Reg("g")
        reg.attach_serving(lambda: {"graph": "v1", "swaps_applied": 0,
                                    "tenants": {"a": {"offered": 2, "shed": 0}}})
        snaps = [reg.snapshot()["serving"]]
        reg.record_tenant_e2e("a", 0.050, exemplar=0x123)
        snaps.append(reg.snapshot()["serving"])
        reg.record_tenant_e2e("a", 0.001)
        s = reg.snapshot()
        snaps.append(s["serving"])
        prom = [ln for ln in reg.to_prometheus(s).splitlines()
                if "tenant" in ln or "serving" in ln]
        out.append((snaps, prom))
    assert out[0] == out[1]
    row = out[1][0][2]["tenants"]["a"]
    assert row["e2e_samples"] == 2 and row["e2e_samples_tick"] == 1
    assert row["e2e_p99_tick_ms"] < row["e2e_p99_ms"]
    assert 'windflow_tenant_e2e_samples{graph="g",tenant="a"} 2' in out[1][1]


def test_tenant_slo_signals_read_tenant_rows():
    def snap(offered, shed, shed_tuples):
        return {"serving": {"tenants": {"a": {"offered": offered, "shed": shed,
                                              "shed_tuples": shed_tuples}}}}
    fn, mode = tslo.TENANT_SIGNALS["tenant_drop_ratio"]
    assert mode == "max" and fn(snap(10, 5, 160), snap(0, 0, 0), "a") == pytest.approx(0.5)
    assert fn(snap(10, 5, 160), snap(10, 5, 160), "a") is None
    fn2, _ = tslo.TENANT_SIGNALS["tenant_shed_tuples"]
    assert fn2(snap(10, 5, 160), snap(8, 3, 100), "a") == 60.0
    fn3, _ = tslo.TENANT_SIGNALS["tenant_e2e_p99_ms"]
    row = {"e2e_samples": 9, "e2e_p99_ms": 500.0, "e2e_samples_tick": 3,
           "e2e_p99_tick_ms": 4.0}
    assert fn3({"serving": {"tenants": {"a": row}}}, {}, "a") == 4.0
    assert fn3({"serving": {"tenants": {"a": dict(row, e2e_samples_tick=0)}}}, {},
               "a") is None


# ------------------------------------------------ the paging serve

def test_stalled_tenant_pages_with_profile_and_tenant_rate(tmp_path):
    """A monitored serve with a latency SLO a tenant, profile-on-page and
    ``tenant_rate`` remediation, the Reporter ticked by hand after each
    pair of frames has reached the sink: the noisy tenant's frames, stamped
    five seconds in the past (a wire stall), drive its SLO OK -> WARN -> PAGE ->
    OK;
    the quiet tenant never leaves OK; exactly one bundle commits
    ``profile.json`` (a real capture) before its manifest; only the noisy
    tenant's bucket tightens."""
    mon = str(tmp_path / "mon")
    spec = dict(signal="tenant_e2e_p99_ms", target=1000.0, objective=0.5, fast_window=2,
                slow_window=4, warn_burn=1.0, page_burn=2.0)
    big = float(1 << 30)
    cfg = MonitoringConfig(
        out_dir=mon, interval_s=3600.0, e2e_sample_every=1,
        slo=[dict(spec, name="lat-noisy", tenant="noisy"),
             dict(spec, name="lat-quiet", tenant="quiet")],
        profile=profiling.ProfileConfig(window_ms=2.0, max_captures=1),
        remediation=[{"name": "noisy-rate", "slo": "lat-noisy", "actuator": "tenant_rate",
                      "factor": 0.5}], remediation_cooldown_s=3600.0)
    got = []
    collect = _collect(got)
    delivered = {"n": 0}

    def cb(view):
        collect(view)
        if view is not None:
            delivered["n"] += 1
    src = _source("port", replay=64)
    rt = ServingRuntime(src, _ops(), wt.Sink(cb, **CPU), batch_size=BATCH,
                        serving={"tenants": [{"id": "quiet", "refill_per_batch": big},
                                             {"id": "noisy", "refill_per_batch": big}]},
                        monitoring=cfg, **CPU)
    rates0 = {t: r["rate"] for t, r in rt.registry.counters().items()}
    src.start()
    thread = rt.run_background()
    sock = tframing.connect(src.endpoint)
    quiet, noisy = _chunks(12, base=10_000.0), _chunks(12)
    states = []
    try:
        assert _wait(lambda: rt._monitor is not None)
        for i in range(12):
            stall = 5.0 if 2 <= i < 8 else 0.0
            sock.sendall(encode_record_frame(quiet[i].tobytes(), tenant="quiet", seq=i,
                                             t_send=time.time(), span=f"quiet/{i}"))
            sock.sendall(encode_record_frame(noisy[i].tobytes(), tenant="noisy", seq=i,
                                             t_send=time.time() - stall, span=f"noisy/{i}"))
            assert _wait(lambda: delivered["n"] == 2 * (i + 1))
            snap = rt._monitor.reporter.emit()
            states.append((snap["slo"]["lat-noisy"]["state"],
                           snap["slo"]["lat-quiet"]["state"]))
        sock.sendall(encode_record_frame(b"", tenant="quiet", seq=12, kind="eos"))
    finally:
        sock.close()
    thread.join(timeout=60.0)
    assert not thread.is_alive()
    if rt.background_error is not None:
        raise rt.background_error
    noisy_states = [n for n, _ in states]
    assert noisy_states[:2] == ["ok", "ok"] and noisy_states[-1] == "ok"
    assert noisy_states.index("warn") < noisy_states.index("page")
    assert "page" not in noisy_states[noisy_states.index("ok", noisy_states.index("page")):]
    assert {q for _, q in states} == {"ok"}
    bundles, torn = tslo.list_incidents(mon)
    assert len(bundles) == 1 and not torn
    man = bundles[0]
    assert man["slo"] == "lat-noisy" and man["files"][-1] == "profile.json"
    prof = profiling.load_profile(man["path"])
    assert [f["name"] for f in prof["files"]] == ["trace.json"]
    assert os.path.getmtime(os.path.join(man["path"], "profile.json")) <= \
        os.path.getmtime(os.path.join(man["path"], "manifest.json"))
    rates = {t: r["rate"] for t, r in rt.registry.counters().items()}
    assert rates["noisy"] == rates0["noisy"] / 2 and rates["quiet"] == rates0["quiet"]
    assert json.load(open(os.path.join(man["path"], "remediation.json")))["applied"] == 1
    assert len(got) == 24 * BATCH
    final = json.load(open(os.path.join(mon, "snapshot.json")))["serving"]["tenants"]
    assert final["noisy"]["e2e_p99_ms"] > final["quiet"]["e2e_p99_ms"]
    assert final["noisy"]["e2e_samples"] > 0


# ------------------------------------------------------------------- CLI

def test_wf_serve_status_and_swap_against_the_port(tmp_path):
    """``scripts/wf_serve.py`` (unchanged, stdlib only): ``swap`` sends its
    control frame to the port's live endpoint and the runtime cuts over;
    ``status`` reads the port's monitoring directory."""
    mon = str(tmp_path / "mon")
    got = []
    src = _source("port", replay=32)
    rt = ServingRuntime(src, _ops(), wt.Sink(_collect(got), **CPU), batch_size=BATCH,
                        serving={"tenants": [{"id": "a"}]}, monitoring=mon, **CPU)
    rt.register_graph("v2", _ops())
    src.start()
    thread = rt.run_background()
    chunks = _chunks(4)
    client = RecordClient(src.endpoint)
    env = {k: v for k, v in os.environ.items() if not k.startswith("WF_")}
    try:
        for c in chunks[:2]:
            client.send(c.tobytes(), tenant="a")
        r = subprocess.run([sys.executable, WF_SERVE_CLI, "swap", "--endpoint",
                            src.endpoint, "--graph", "v2"], capture_output=True, text=True,
                           env=env, timeout=120)
        assert r.returncode == 0, r.stderr
        assert _wait(lambda: src.frames_decoded >= 3)
        for c in chunks[2:]:
            client.send(c.tobytes(), tenant="a")
        client.send_eos("a")
    finally:
        client.close()
    thread.join(timeout=60.0)
    assert not thread.is_alive() and rt.background_error is None
    assert rt.swaps_applied == 1 and rt.graph_label == "v2"
    assert sorted(got) == sorted(_oracle(chunks))
    r = subprocess.run([sys.executable, WF_SERVE_CLI, "status", "--monitoring-dir", mon,
                        "--json"], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout)
    assert out["tenants"]["a"]["offered"] == 4
    r = subprocess.run([sys.executable, WF_SERVE_CLI, "status", "--monitoring-dir",
                        str(tmp_path / "nope")], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 2

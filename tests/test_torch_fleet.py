"""Fleet telemetry in the port (``windflow_tpu_torch/observability/fleet.py``
and the fleet merge of ``device_health.py``) against the JAX package's, on
the CPU.

Mirrors ``tests/test_fleet.py`` and the fleet folds of
``tests/test_serving_observability.py``: WFT1 frames byte for byte the JAX
package's, decoded across the packages (split, torn and oversize cases);
the endpoint grammar; the agent's bounded drop-oldest outbox and its
refusals (the JAX package's errors, word for word); the gauge and event
registries; ``merge_snapshots`` of the same snapshots equal to the JAX
package's (schema provenance, SLO, tenant latency and shard folds); agents
of either package streaming to an aggregator of either package over
loopback; an aggregator surviving garbage; ``telemetry=`` leaving every
driver's rows unchanged; and two host processes of the port (this file run
as a script) streaming to one aggregator, read by ``scripts/wf_fleet.py``.
Loops that wait on sockets join with a timeout and assert counts, never
latencies.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WF_FLEET_CLI = os.path.join(REPO, "scripts", "wf_fleet.py")
CPU = {"device": "cpu"}


def _snap(tick, graph="t", **over):
    from windflow_tpu_torch.observability import device_health as tdh
    s = {"graph": graph, "schema": tdh.SNAPSHOT_SCHEMA,
         "wall_time": 1000.0 + tick, "uptime_s": float(tick),
         "operators": [{"name": "map", "role": "map", "outputs_sent": 32 * (tick + 1),
                        "service_time_us": {"p50": 10.0}}],
         "totals": {"outputs_sent": 32 * (tick + 1)},
         "e2e_latency_us": {"p50": 100.0, "p99": 200.0},
         "queues": {"a->b": tick % 3}, "ordering": {}, "recovery": {},
         "control": {"counters": {}}}
    s.update(over)
    return s


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def _host_main(endpoint, tag, mon):
    """One fleet host (run as ``python tests/test_torch_fleet.py host ...``):
    q3 through the port's Pipeline with telemetry to ``endpoint``."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.nexmark import make_query
    from windflow_tpu_torch.observability import MonitoringConfig
    os.environ["WF_TELEMETRY_HOST"] = tag
    src, ops = make_query("q3_enrich_join", 600, **CPU)
    rows = []
    cfg = MonitoringConfig(out_dir=mon, interval_s=0.05, telemetry=endpoint, slo=True)
    wt.Pipeline(src, ops, wt.Sink(lambda v: rows.append(0) if v is not None else None,
                                  **CPU), batch_size=32, monitoring=cfg, **CPU).run()
    print(f"FLEET-HOST-OK {tag} batches={len(rows)}", flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["host"]:
    sys.path.insert(0, REPO)
    _host_main(*sys.argv[2:5])
    sys.exit(0)


import windflow_tpu_torch as wt  # noqa: E402
from windflow_tpu.observability import device_health as jdh  # noqa: E402
from windflow_tpu.observability import fleet as jfleet  # noqa: E402
from windflow_tpu_torch.nexmark import make_query  # noqa: E402
from windflow_tpu_torch.observability import MonitoringConfig  # noqa: E402
from windflow_tpu_torch.observability import device_health as tdh  # noqa: E402
from windflow_tpu_torch.observability import fleet as tfleet  # noqa: E402
from windflow_tpu_torch.observability import metrics as tmetrics  # noqa: E402
from windflow_tpu_torch.observability import names as tnames  # noqa: E402

FLEET = {"jax": jfleet, "port": tfleet}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("WF_MONITORING", "WF_TELEMETRY", "WF_TELEMETRY_ENDPOINT",
              "WF_TELEMETRY_OUTBOX", "WF_TELEMETRY_HOST", "WF_SLO"):
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------ wire framing

def test_frames_byte_identical_and_cross_decoded():
    """The port's WFT1 frames are the JAX package's byte for byte, and each
    package's decoder reads the other's stream."""
    frames = [{"kind": "snap", "host": f"h{i}", "snap": _snap(i)} for i in range(3)]
    for f in frames:
        assert tfleet.encode_frame(f) == jfleet.encode_frame(f)
    assert tfleet.MAGIC == jfleet.MAGIC and tfleet.MAX_FRAME_BYTES == jfleet.MAX_FRAME_BYTES
    blob = b"".join(jfleet.encode_frame(f) for f in frames)
    dec = tfleet.FrameDecoder()
    assert dec.feed(blob) == frames and dec.frames_decoded == 3 and dec.frames_torn == 0
    jdec = jfleet.FrameDecoder()
    assert jdec.feed(b"".join(tfleet.encode_frame(f) for f in frames)) == frames


def test_frame_split_feed():
    blob = tfleet.encode_frame({"kind": "snap", "host": "h", "seq": 1})
    dec = tfleet.FrameDecoder()
    out = []
    for i in range(len(blob)):
        out += dec.feed(blob[i:i + 1])
    assert out == [{"kind": "snap", "host": "h", "seq": 1}]


def test_frame_torn_resync():
    good = tfleet.encode_frame({"kind": "snap", "host": "ok"})
    got = []
    for mod in (jfleet, tfleet):
        dec = mod.FrameDecoder()
        out = dec.feed(b"garbage-prefix" + good[7:] + good)
        dec2 = mod.FrameDecoder()
        out2 = dec2.feed(mod.MAGIC + b"zzzzzzzz\n" + b"{}\n" + good)
        got.append((out, dec.frames_torn, out2, dec2.frames_torn))
    assert got[0] == got[1]
    assert got[1][0] == [{"kind": "snap", "host": "ok"}] and got[1][1] >= 1


def test_frame_oversize_refused():
    with pytest.raises(ValueError):
        tfleet.encode_frame({"blob": "x" * (tfleet.MAX_FRAME_BYTES + 1)})


@pytest.mark.parametrize("ep", [
    "tcp://127.0.0.1:9900", "127.0.0.1:0", "tcp://[::1]:80", "unix:///tmp/x.sock",
    "unix:/tmp/y.sock", "", "nohost", "tcp://:12", "tcp://h:xx", "tcp://h:99999",
    "unix://"])
def test_parse_endpoint_matches_jax(ep):
    got = []
    for mod in (jfleet, tfleet):
        try:
            got.append(mod.parse_endpoint(ep))
        except ValueError as e:
            got.append(("err", str(e)))
    assert got[0] == got[1]


# ------------------------------------------------------------ agent outbox

def test_outbox_drop_oldest():
    agent = tfleet.TelemetryAgent("127.0.0.1:1", host="h", outbox=3)
    for i in range(5):
        agent.offer(_snap(i))
    st = agent.stats()
    assert (st["frames_dropped"], st["outbox_depth"], st["frames_sent"],
            st["connected"]) == (2, 3, 0, 0)
    agent.close(flush_s=0.0)


@pytest.mark.parametrize("kw", [{"endpoint": "127.0.0.1:1", "outbox": 0},
                                {"endpoint": "not-an-endpoint"}])
def test_agent_rejects_unhonorable_config(kw):
    errs = []
    for mod in (jfleet, tfleet):
        with pytest.raises(ValueError) as e:
            mod.TelemetryAgent(host="h", **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_monitor_raises_on_unhonorable_telemetry(tmp_path):
    from windflow_tpu.observability import Monitor as JMonitor
    from windflow_tpu.observability import MonitoringConfig as JM
    errs = []
    for M, Mon in ((JM, JMonitor), (MonitoringConfig, wt.observability.Monitor)):
        cfg = M(out_dir=str(tmp_path / "m"), telemetry="not-an-endpoint")
        with pytest.raises(ValueError) as e:
            Mon(cfg)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_telemetry_host_tag(monkeypatch):
    """``WF_TELEMETRY_HOST`` first; ``host0`` in one process, as the JAX
    package's ``jax.process_index()`` gives."""
    from windflow_tpu_torch.observability import _telemetry_host_tag
    assert _telemetry_host_tag() == "host0"
    monkeypatch.setenv("WF_TELEMETRY_HOST", "edge-7")
    assert _telemetry_host_tag() == "edge-7"


# ----------------------------------------------------- name registries

def test_telemetry_gauge_names_lockstep():
    assert set(tnames.TELEMETRY_GAUGES) == set(tmetrics._TELEMETRY_HELP)
    assert set(tnames.FLEET_GAUGES) == set(tfleet._FLEET_HELP)
    assert tfleet._FLEET_HELP == jfleet._FLEET_HELP
    for ev in ("telemetry_connect", "telemetry_lost", "fleet_host_join",
               "fleet_host_leave"):
        assert ev in tnames.JOURNAL_EVENTS, ev


def test_snapshot_schema_stamp():
    assert tmetrics.MetricsRegistry("t").snapshot()["schema"] == tdh.SNAPSHOT_SCHEMA \
        == jdh.SNAPSHOT_SCHEMA


# ----------------------------------------------------------- the fleet fold

def _fold_cases():
    a, b = _snap(1), _snap(1)
    b["schema"] = tdh.SNAPSHOT_SCHEMA + 1

    def tenant(p99, samples, ex, offered):
        return _snap(2, serving={"graph": "v1", "swaps_applied": 1, "tenants": {"a": {
            "offered": offered, "shed": 0, "shed_tuples": 0, "e2e_p50_ms": p99 / 4,
            "e2e_p95_ms": p99 / 2, "e2e_p99_ms": p99, "e2e_samples": samples,
            "e2e_p99_exemplar": ex, "e2e_samples_tick": samples,
            "e2e_p99_tick_ms": p99, "rate": 8.0}}})

    def shards(occ):
        return _snap(3, shards={"0": {"occupancy_tuples": occ, "restarts": 1},
                                "1": {"occupancy_tuples": 2 * occ, "restarts": 0}})
    return {"mixed_schema": [a, b], "same_schema": [_snap(1), _snap(1)],
            "tenant_latency": [tenant(20.0, 10, 111, 6), tenant(50.0, 3, 222, 4)],
            "shards": [shards(5), shards(7)],
            "telemetry": [_snap(4, telemetry={"frames_sent": 3, "frames_dropped": 1}),
                          _snap(4, telemetry={"frames_sent": 5, "frames_dropped": 0})]}


@pytest.mark.parametrize("case", sorted(_fold_cases()))
def test_merge_snapshots_matches_jax(case):
    """``merge_snapshots`` of the same snapshots gives the JAX package's
    output: schema provenance flagged, tenant latency folded MAX with the
    worst host's exemplar, shards host-tagged, counters summed."""
    snaps = _fold_cases()[case]
    tags = ["h0", "h1"]
    got = [mod.merge_snapshots(json.loads(json.dumps(snaps)), hosts=tags)
           for mod in (jdh, tdh)]
    assert got[0] == got[1]
    out = got[1]
    if case == "mixed_schema":
        assert out["schema_mismatch"] == {"h0": tdh.SNAPSHOT_SCHEMA,
                                          "h1": tdh.SNAPSHOT_SCHEMA + 1}
    if case == "tenant_latency":
        row = out["serving"]["tenants"]["a"]
        assert (row["e2e_p99_ms"], row["e2e_samples"], row["e2e_p99_exemplar"],
                row["offered"]) == (50.0, 13, 222, 10)
    errs = []
    for mod in (jdh, tdh):
        with pytest.raises(ValueError) as e:
            mod.merge_snapshots([])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ------------------------------------------------------------ loopback

def _stream(agent_mod, agg_mod, tmp_path, n=5):
    out = str(tmp_path / "fleet")
    agg = agg_mod.FleetAggregator("127.0.0.1:0", out, max_skew_s=0.2)
    agg.start()
    agent = agent_mod.TelemetryAgent(agg.endpoint, host="h0", outbox=8)
    agent.start()
    try:
        for i in range(n):
            agent.offer(_snap(i))
        assert _wait(lambda: agg.stats()["frames_received"] >= n)
    finally:
        st = agent.stats()
        agent.close()
        agg.stop()
    return out, st, agg


@pytest.mark.parametrize("agent_pkg, agg_pkg", [("port", "port"), ("jax", "port"),
                                                ("port", "jax")])
def test_agent_aggregator_loopback(tmp_path, agent_pkg, agg_pkg):
    """Agents of either package stream to aggregators of either package
    over loopback TCP: every frame lands, none drops, and the fleet
    directory is in the Reporter's schema."""
    out, st, agg = _stream(FLEET[agent_pkg], FLEET[agg_pkg], tmp_path)
    assert (st["frames_sent"], st["frames_dropped"], st["connected"]) == (5, 0, 1)
    latest, series = tdh.load_snapshots(out)
    assert latest["merged_from"] == 1
    assert latest["fleet"]["frames_received"] == 5 and latest["fleet"]["frames_torn"] == 0
    assert latest["queues"]["a->b"] == 4 % 3
    assert len(series) == agg.stats()["ticks"]
    events = [e["event"] for e in tdh.load_journal(out)]
    assert "fleet_host_join" in events and "fleet_host_leave" in events
    assert "windflow_fleet_hosts_seen" in open(os.path.join(out, "metrics.prom")).read()


def test_aggregator_survives_torn_and_garbage(tmp_path):
    import socket as socket_mod
    out = str(tmp_path / "fleet")
    agg = tfleet.FleetAggregator("127.0.0.1:0", out, max_skew_s=0.2)
    agg.start()
    try:
        _, host, port = tfleet.parse_endpoint(agg.endpoint)
        sk = socket_mod.create_connection((host, port), timeout=2)
        sk.sendall(b"NOT A FRAME AT ALL\n" * 4)
        sk.close()
        agent = tfleet.TelemetryAgent(agg.endpoint, host="h0", outbox=8)
        agent.start()
        agent.offer(_snap(0))
        assert _wait(lambda: agg.stats()["frames_received"] >= 1)
        agent.close()
    finally:
        agg.stop()
    assert agg.stats()["frames_received"] == 1
    assert tdh.load_snapshots(out)[0]["merged_from"] == 1


def test_render_prometheus_matches_jax():
    snap = tdh.merge_snapshots([_snap(1), _snap(2)], hosts=["h0", "h1"])
    snap["fleet"] = {"hosts_connected": 2, "hosts_seen": 2, "frames_received": 4,
                     "frames_torn": 0, "ticks": 2}
    assert tfleet.render_prometheus(snap) == jfleet.render_prometheus(snap)


# ------------------------------------------------ off-path hermeticity

def _run_q3(driver, monitoring=False):
    src, ops = make_query("q3_enrich_join", 512, **CPU)
    rows = []

    def cb(view):
        if view is None:
            return
        rows.append((np.asarray(view["key"]).tolist(), np.asarray(view["id"]).tolist(),
                     np.asarray(view["ts"]).tolist()))
    sink = wt.Sink(cb, **CPU)
    if driver == "plain":
        wt.Pipeline(src, ops, sink, batch_size=64, monitoring=monitoring, **CPU).run()
    else:
        g = wt.PipeGraph(batch_size=64, monitoring=monitoring, **CPU)
        mp = g.add_source(src)
        for op in ops:
            mp.add(op)
        mp.add_sink(sink)
        if driver == "graph":
            g.run()
        elif driver == "graph-threaded":
            g.run(threaded=True)
        else:
            g.run_supervised(checkpoint_every=2, backoff_base=0.001, backoff_cap=0.01)
    return rows


@pytest.mark.parametrize("driver", ["plain", "graph", "graph-threaded",
                                    "graph-supervised"])
def test_telemetry_on_results_byte_identical(tmp_path, driver):
    """telemetry= on, streaming to a live loopback aggregator, changes no
    row of any driver, and the run's final emit streams its frame."""
    base = _run_q3(driver)
    agg = tfleet.FleetAggregator("127.0.0.1:0", str(tmp_path / f"fleet-{driver}"),
                                 max_skew_s=0.2)
    agg.start()
    try:
        cfg = MonitoringConfig(out_dir=str(tmp_path / f"m-{driver}"), interval_s=30.0,
                               telemetry=agg.endpoint)
        on = _run_q3(driver, monitoring=cfg)
        assert _wait(lambda: agg.stats()["frames_received"] >= 1)
    finally:
        agg.stop()
    assert on == base
    with open(tmp_path / f"m-{driver}" / "snapshot.json") as f:
        tel = json.load(f)["telemetry"]
    assert set(tel) >= set(tnames.TELEMETRY_GAUGES)


# --------------------------------------------------------- two hosts

def test_two_port_hosts_stream_to_one_aggregator(tmp_path):
    """Two host processes of the port (this file run as a script, each a
    monitored q3 with ``slo=`` and telemetry) stream to one aggregator:
    both host tags join, the merged view folds both, the SLO sections fold
    per host, and ``scripts/wf_fleet.py status`` and ``wf_slo.py`` read the
    aggregator's directory (exit 0)."""
    out = str(tmp_path / "fleet")
    agg = tfleet.FleetAggregator("127.0.0.1:0", out, max_skew_s=0.3)
    agg.start()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "host",
                               agg.endpoint, f"host{i}", str(tmp_path / f"m{i}")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
        assert _wait(lambda: agg.stats()["hosts_seen"] >= 2, timeout=10.0)
        assert _wait(lambda: agg.stats()["ticks"] >= 1, timeout=10.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        agg.stop()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
        assert "FLEET-HOST-OK" in so
    events = [e for e in tdh.load_journal(out) if e["event"] == "fleet_host_join"]
    assert {e["host"] for e in events} == {"host0", "host1"}
    latest, _series = tdh.load_snapshots(out)
    assert latest["fleet"]["hosts_seen"] == 2 and latest["fleet"]["frames_torn"] == 0
    merged = [tdh.merge_monitoring_dirs([str(tmp_path / f"m{i}") for i in range(2)])
              for _ in range(1)][0]
    assert merged == jdh.merge_monitoring_dirs([str(tmp_path / f"m{i}") for i in range(2)])
    env = {k: v for k, v in os.environ.items() if not k.startswith("WF_")}
    r = subprocess.run([sys.executable, WF_FLEET_CLI, "status", "--monitoring-dir", out,
                        "--json"], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["fleet"]["hosts_seen"] == 2

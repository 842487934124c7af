"""Monitoring in the port (``windflow_tpu_torch/observability``) against the
JAX package, on the CPU.

Mirrors ``tests/test_observability.py`` and ``tests/test_device_health.py``.
Each scenario (YSB, Nexmark q3, q5 over a stream with tuples later than the
session allowance) runs monitored through both packages, by the environment
(``WF_MONITORING``, ``WF_MONITORING_EVENT_TIME``, ``WF_MONITORING_HEALTH``,
``WF_TRACE``) so every driver of both packages picks it up the same way, and
the artifacts must agree:

- the final ``snapshot.json`` once its timing fields are dropped (wall and
  uptime, rates, latency percentiles and exemplars, the device-time split,
  build durations) and the fields a CPU-only port cannot give: XLA's cost
  analysis (``executables``, the compile records' cost columns), the live
  jax array walk (``live_buffer_*``: the port reads the CUDA allocator,
  empty without CUDA) and the JAX kernel registry's ``kernel_resolve``
  records (the port journals a hand kernel's first build, on the card only);
- the Prometheus metric names and label sets;
- ``topology.json`` (timing aside) and the ``events.jsonl`` records.

Drivers: ``Pipeline``, ``ThreadedPipeline``, ``PipeGraph`` (serial and
threaded), ``SupervisedPipeline`` and ``PipeGraph.run_supervised``. The
JAX ``ThreadedPipeline`` reads the event-time toggle from the environment
only, which is why the environment drives every case. Then the
``MonitoringConfig`` forms, the refusals of ROADMAP Queue 1 items 15 and
16b, the health section's CPU rows and capture ledger, and the JAX
package's analysis scripts run on both packages' artifacts.
"""

import functools
import json
import os
import re
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import control as jcontrol
from windflow_tpu.benchmarks import ysb as jysb
from windflow_tpu.nexmark import generators as jgen
from windflow_tpu.nexmark import make_query as jmake
from windflow_tpu.observability import journal as jjournal
from windflow_tpu.observability import tracing as jtracing
from windflow_tpu.runtime import faults as jfaults
from windflow_tpu_torch import control as tcontrol
from windflow_tpu_torch.benchmarks import ysb as tysb
from windflow_tpu_torch.nexmark import generators as tgen
from windflow_tpu_torch.nexmark import make_query as tmake
from windflow_tpu_torch.observability import MonitoringConfig
from windflow_tpu_torch.observability import journal as tjournal
from windflow_tpu_torch.observability import tracing as ttracing
from windflow_tpu_torch.operators.source import DeviceSource as TDeviceSource
from windflow_tpu_torch.runtime import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}
DEADLINE_S = 60.0
SCENARIOS = ("ysb", "q3", "q5")
#: events a scenario streams and its batch capacity (YSB: 10 events a tick)
SIZES = {"ysb": (1500, 128), "q3": (400, 50), "q5": (400, 50)}
ENV = ("WF_MONITORING", "WF_MONITORING_EVENT_TIME", "WF_MONITORING_HEALTH",
       "WF_MONITORING_INTERVAL", "WF_TRACE", "WF_TRACE_SAMPLE", "WF_DISPATCH",
       "WF_SLO", "WF_PROFILE", "WF_TELEMETRY", "WF_REMEDIATION", "WF_CONTROL",
       "WF_FAULT_PLAN", "WF_SHARDS", "WF_HEALTH_SAMPLE", "WF_SNAPSHOT_KEEP")


# ------------------------------------------------------------- the scenarios

def late_ts(pkg, i):
    """q5's event time with stragglers: one event in 13 arrives 40 ticks
    late, behind its session's floor, so the session window drops it as
    OLD (the ``lateness_drop`` records)."""
    late = (i * 7919) % 13 == 0
    if pkg == "jax":
        return i // 8 - jnp.where(late, 40, 0)
    return i // 8 - torch.where(late, 40, 0)


def scenario(pkg, name):
    """``(source, ops)`` of one scenario in one package."""
    total, _ = SIZES[name]
    kw = {} if pkg == "jax" else CPU
    if name == "ysb":
        y = jysb if pkg == "jax" else tysb
        return y.make_source(total, **kw), y.make_ops(**kw)
    make = jmake if pkg == "jax" else tmake
    if name == "q3":
        return make("q3_enrich_join", total, **kw)
    _src, ops = make("q5_session", total, **kw)
    g = jgen if pkg == "jax" else tgen
    if pkg == "jax":
        from windflow_tpu.operators.source import DeviceSource
    else:
        DeviceSource = TDeviceSource

    def gen(i):
        return {"auction": g.bid_auction(i), "bidder": g.bid_bidder(i),
                "price": g.bid_price(i)}
    src = DeviceSource(gen, total=total, name="nexmark_late_bids",
                       key_fn=g.bid_auction, ts_fn=lambda i: late_ts(pkg, i), **kw)
    return src, ops


def rows_into(out):
    def cb(view):
        if view is not None:
            out.append(view_bytes(view))
    return cb


def view_bytes(view):
    flat = {}

    def walk(x, prefix):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{prefix}.{k}")
        else:
            flat[prefix] = np.asarray(x).tobytes()
    walk(view, "")
    return tuple(sorted(flat.items()))


def within_deadline(fn):
    box = {}

    def body():
        try:
            box["result"] = fn()
        except BaseException as e:      # noqa: BLE001 — raised in the test
            box["error"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(DEADLINE_S)
    if t.is_alive():
        pytest.fail(f"driver still running after {DEADLINE_S} s (a hang)")
    if "error" in box:
        raise box["error"]
    return box.get("result")


def drive(pkg, name, driver, faults=None):
    """Run one scenario through one driver of one package, monitoring as the
    environment says. Returns (rows in delivery order, the chains)."""
    m = wf if pkg == "jax" else wt
    kw = {} if pkg == "jax" else CPU
    total, batch = SIZES[name]
    src, ops = scenario(pkg, name)
    rows = []
    sink = m.Sink(rows_into(rows), **kw)
    if driver in ("plain", "dispatch"):
        p = m.Pipeline(src, ops, sink, batch_size=batch,
                       dispatch=4 if driver == "dispatch" else None, **kw)
        p.run()
        return rows, [p.chain]
    if driver == "threaded":
        tkw = {} if pkg == "jax" else {"pin": False, **CPU}
        tp = m.ThreadedPipeline(src, [ops], sink, batch_size=batch, **tkw)
        within_deadline(tp.run)
        return rows, tp.chains
    if driver == "supervised":
        sp = m.SupervisedPipeline(src, ops, sink, batch_size=batch, checkpoint_every=3,
                                  backoff_base=0.0, faults=faults, **kw)
        sp.run()
        return rows, [sp.chain]
    g = m.PipeGraph(f"{name}_graph", batch_size=batch, **kw)
    mp = g.add_source(src)
    for op in ops:
        mp.add(op)
    mp.add_sink(sink)
    if driver == "graph_supervised":
        g.run_supervised(checkpoint_every=3, backoff_base=0.0, faults=faults)
    else:
        within_deadline(lambda: g.run(threaded=driver == "graph_threaded"))
    return rows, [p._chain for p in g._all_pipes() if p._chain is not None]


def reset_process_counters():
    for m in (jcontrol._state, tcontrol):
        m.reset()
    for m in (jfaults, tfaults):
        m.set_active(None)
        m.reset_counters()
    for m in (jjournal, tjournal, jtracing, ttracing):
        m.set_active(None)


def monitored(pkg, name, driver, out, *, health=True, trace=True, faults=None,
              journal=None):
    """One monitored run with the artifacts under ``out``; restores the
    environment after. ``journal``: a path for an explicit journal (the
    drivers that start no Monitor)."""
    saved = {k: os.environ.get(k) for k in ENV}
    try:
        for k in ENV:
            os.environ.pop(k, None)
        os.environ.update({"WF_MONITORING": os.path.join(out, "mon"),
                           "WF_MONITORING_EVENT_TIME": "1",
                           "WF_MONITORING_INTERVAL": "60",
                           "WF_MONITORING_HEALTH": "1" if health else "0"})
        if trace:
            os.environ["WF_TRACE"] = os.path.join(out, "trace")
        reset_process_counters()
        if journal is None:
            return drive(pkg, name, driver, faults=faults)
        jmod = jjournal if pkg == "jax" else tjournal
        j = jmod.EventJournal(journal)
        jmod.set_active(j)
        try:
            return drive(pkg, name, driver, faults=faults)
        finally:
            jmod.set_active(None)
            j.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_process_counters()


@functools.lru_cache(maxsize=None)
def both(name, driver, root):
    """Both packages' monitored runs of one (scenario, driver), cached for
    the tests that read different artifacts of the same runs."""
    out = {}
    for pkg in ("jax", "port"):
        d = os.path.join(root, f"{name}_{driver}_{pkg}")
        rows, chains = monitored(pkg, name, driver, d)
        out[pkg] = {"dir": d, "rows": rows, "chains": chains}
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("monitoring"))


# -------------------------------------------------------- artifact readers

#: snapshot keys holding times, rates or timing-dependent picks
TIMING_KEYS = {"wall_time", "uptime_s", "rate_in_tps", "rate_out_tps",
               "rate_batches_in_per_s", "rate_bytes_in_per_s", "p50", "p95", "p99",
               "mean", "max", "p99_exemplar", "p99_tick", "samples_tick",
               "device_ms", "dispatch_ms", "dispatch_ratio", "dispatch_bound",
               "compile_s", "compile_s_total", "backoff_seconds", "recovery_seconds",
               "last_recovery_s", "service_s", "t", "wall", "dur_s", "stalled_s"}
#: fields the CPU-only port cannot give (module docstring)
CPU_ONLY_KEYS = {"executables", "live_buffer_bytes", "live_buffer_count",
                 "kernel_resolves", "flops", "bytes_accessed", "argument_bytes",
                 "output_bytes", "temp_bytes", "code_bytes"}


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in TIMING_KEYS | CPU_ONLY_KEYS}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def snapshot(d):
    with open(os.path.join(d, "mon", "snapshot.json")) as f:
        snap = strip(json.load(f))
    # ring depths are a race of the stage threads: the edges, not the depths
    snap["queues"] = sorted(snap["queues"])
    if "health" in snap:
        # the tests' JAX process lists 8 virtual CPU devices, the port its one
        snap["health"]["devices"] = snap["health"]["devices"][:1]
    return snap


def events(d):
    recs = [strip(r) for r in tjournal.read_journal(os.path.join(d, "mon", "events.jsonl"))
            if r["event"] != "kernel_resolve"]
    return recs


def prom_names(d):
    """(metric, label names) of every sample line, but the live-buffer gauges
    (the JAX package's live jax array walk, which the port has only on the
    card)."""
    out = set()
    with open(os.path.join(d, "mon", "metrics.prom")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            m = re.match(r"([A-Za-z_:][A-Za-z0-9_:]*)(\{([^}]*)\})?", line)
            if m.group(1).startswith("windflow_health_live_buffer_"):
                continue
            out.add((m.group(1), tuple(sorted(re.findall(r'(\w+)="', m.group(3) or "")))))
    return out


LIVE = ("plain", "threaded", "graph", "graph_threaded")
SUPERVISED = ("supervised", "graph_supervised")


@pytest.mark.parametrize("driver", LIVE + SUPERVISED)
@pytest.mark.parametrize("name", SCENARIOS)
def test_monitored_rows_and_snapshot_equal_jax(name, driver, root):
    """Rows and the final snapshot (timing aside) equal the JAX package's:
    operator counters, watermarks, event-time sections with their lateness
    histograms, state occupancy, the health section's ledger and
    footprints, the recovery and control sections. The supervised
    ``SupervisedPipeline`` has no Monitor in either package (it takes no
    ``monitoring=``): there the rows and the journal are compared."""
    r = both(name, driver, root)
    assert r["port"]["rows"] == r["jax"]["rows"] and r["port"]["rows"]
    if driver == "supervised":
        return
    assert snapshot(r["port"]["dir"]) == snapshot(r["jax"]["dir"])


@pytest.mark.parametrize("driver", LIVE + SUPERVISED)
@pytest.mark.parametrize("name", SCENARIOS)
def test_monitored_journal_equal_jax(name, driver, root):
    """``events.jsonl``, record for record (timing aside): monitoring and
    trace lifecycle, sampled ``launch`` records, ``lateness_drop`` records
    with trace coordinates, ``compile`` records of the capture ledger,
    checkpoints, EOS. A ``SupervisedPipeline`` journals into the env
    Monitor of neither package, so it runs under an explicit journal."""
    if driver == "supervised":
        got = {}
        for pkg in ("jax", "port"):
            path = os.path.join(root, f"sup_{name}_{pkg}.jsonl")
            monitored(pkg, name, driver, os.path.join(root, f"sup_{name}_{pkg}"),
                      journal=path)
            got[pkg] = [strip(r) for r in tjournal.read_journal(path)
                        if r["event"] != "kernel_resolve"]
        assert got["port"] == got["jax"] and got["port"]
        return
    r = both(name, driver, root)
    assert events(r["port"]["dir"]) == events(r["jax"]["dir"])


@pytest.mark.parametrize("driver", LIVE + ("graph_supervised",))
@pytest.mark.parametrize("name", SCENARIOS)
def test_prometheus_names_and_topology_equal_jax(name, driver, root):
    """The Prometheus metric names and label sets, and (Pipeline and
    PipeGraph: ``ThreadedPipeline``'s Monitor writes none in either
    package) ``topology.json`` and ``topology.dot`` timing aside."""
    r = both(name, driver, root)
    assert prom_names(r["port"]["dir"]) == prom_names(r["jax"]["dir"])
    if driver == "threaded":
        assert not os.path.exists(os.path.join(r["port"]["dir"], "mon", "topology.json"))
        return
    topo = {}
    for pkg in ("jax", "port"):
        with open(os.path.join(r[pkg]["dir"], "mon", "topology.json")) as f:
            topo[pkg] = strip(json.load(f))
        topo[pkg]["health"]["devices"] = topo[pkg]["health"]["devices"][:1]
    assert topo["port"] == topo["jax"]
    dots = [open(os.path.join(r[pkg]["dir"], "mon", "topology.dot")).read()
            for pkg in ("jax", "port")]
    strip_rate = lambda s: re.sub(r"\\n[0-9.]+[kM]? t/s", "", s)  # noqa: E731
    assert strip_rate(dots[0]) == strip_rate(dots[1])


# ------------------------------------------------------------ configuration

def test_monitoring_config_resolves_like_jax(monkeypatch):
    from windflow_tpu.observability import MonitoringConfig as JM
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for arg in (None, False, True, "/x/out"):
        a, b = JM.resolve(arg), MonitoringConfig.resolve(arg)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.out_dir, a.interval_s, a.event_time, a.health) == \
                (b.out_dir, b.interval_s, b.event_time, b.health)
    monkeypatch.setenv("WF_MONITORING", "/y")
    monkeypatch.setenv("WF_MONITORING_INTERVAL", "0.25")
    monkeypatch.setenv("WF_MONITORING_EVENT_TIME", "1")
    monkeypatch.setenv("WF_MONITORING_HEALTH", "1")
    monkeypatch.setenv("WF_HEALTH_SAMPLE", "3")
    monkeypatch.setenv("WF_SNAPSHOT_KEEP", "5")
    a, b = JM.resolve(None), MonitoringConfig.resolve(None)
    for f in ("out_dir", "interval_s", "event_time", "health", "health_sample",
              "snapshot_keep"):
        assert getattr(a, f) == getattr(b, f), f
    assert wt.observability.event_time_enabled(None)
    monkeypatch.setenv("WF_HEALTH_SAMPLE", "0")
    with pytest.raises(ValueError, match="health_sample"):
        MonitoringConfig.resolve(None)


@pytest.mark.parametrize("field, var, item", [
    ("slo", "WF_SLO", "16b"), ("profile", "WF_PROFILE", "16b"),
    ("telemetry", "WF_TELEMETRY", "16b"), ("remediation", "WF_REMEDIATION", "15")])
def test_unported_sub_toggles_refused_by_name(monkeypatch, field, var, item):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        MonitoringConfig.resolve(MonitoringConfig(**{field: True}))
    monkeypatch.setenv(var, "1")
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        MonitoringConfig.resolve(True)


def test_control_refused_by_name():
    src, ops = scenario("port", "q3")
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        wt.Pipeline(src, ops, control=True, **CPU)


# -------------------------------------------------------------- device health

def test_health_section_on_the_cpu(tmp_path):
    """On the CPU the memory rows are the JAX package's CPU row (identity,
    no numbers), the capture ledger counts one compile a program and no
    recapture, the state footprints are the JAX ones, and the device-time
    split has the chain's stage."""
    r = monitored("port", "ysb", "dispatch", str(tmp_path))[1][0]
    snap = json.load(open(tmp_path / "mon" / "snapshot.json"))
    h = snap["health"]
    assert h["devices"] == [{"device": "cpu:0", "kind": "cpu"}]
    assert "live_buffer_count" not in h
    assert h["compile"]["retraces_unexpected"] == 0 and h["compile"]["compiles"] >= 2
    assert {(c["kind"], c["cause"]) for c in h["compile_log"]} >= {
        ("step", "warm"), ("scan", "push_many")}
    assert h["state_bytes"] == r.state_footprints()
    assert "chain" in h["device_time"]
    assert h["executables"] == {}


def test_unexpected_recapture_is_journaled(tmp_path):
    """A program noted again under a signature already seen (a chain built
    anew under the same stage label) is an unexpected recapture."""
    from windflow_tpu_torch.observability import device_health as dh
    led = dh.HealthLedger()
    j = tjournal.EventJournal(str(tmp_path / "e.jsonl"))
    tjournal.set_active(j)
    dh.set_active(led)
    try:
        for _ in range(2):
            src, ops = scenario("port", "q3")
            wt.Pipeline(src, ops, wt.Sink(lambda v: None, **CPU), batch_size=50,
                        **CPU).run()
    finally:
        dh.set_active(None)
        tjournal.set_active(None)
        j.close()
    assert led.retraces_unexpected >= 1
    assert "retrace_unexpected" in {r["event"] for r in
                                    tjournal.read_journal(str(tmp_path / "e.jsonl"))}


def test_monitoring_off_adds_no_record_and_no_wait(monkeypatch, tmp_path):
    """Off, a push journals nothing and only every 16th push waits: the
    early samples (pushes 2, 4, 8) ride only an active journal or ledger."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    src, ops = scenario("port", "q3")
    p = wt.Pipeline(src, ops, wt.Sink(lambda v: None, **CPU), batch_size=25, **CPU)
    p.run()
    rec = p.chain.ops[0].get_StatsRecords()[0]
    assert rec.service_hist.count == rec.num_kernels // 16
    assert not any(isinstance(st, dict) and "lat_hist" in st for st in p.chain.states)


# ------------------------------------------------------ the analysis scripts

def run_script(script, *args):
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts", script), *args],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    return res.stdout


#: report lines of what only the JAX package gives on a CPU (module
#: docstring), and the dispatch-bound summary (a ratio of two times)
JAX_CPU_ONLY_LINES = ("live buffers:", "executable footprints", "  kernel resolutions:",
                      "dispatch-bound stage(s)")


def report_lines(text):
    """A report's distinct lines, sorted (the slowest-batch drill-down
    follows the run's times; the tests' JAX process lists 8 virtual CPU
    devices, the port one), without its numbers and ids, the dispatch-bound
    tag (a ratio of two times), the cost columns and the lines of
    :data:`JAX_CPU_ONLY_LINES`."""
    out = []
    for line in text.splitlines():
        if any(t in line for t in JAX_CPU_ONLY_LINES) or re.search(r"arg=.*code=", line):
            continue
        line = re.sub(r"\s+\[DISPATCH-BOUND[^\]]*\]", "", line)
        line = re.sub(r"\s+[\d.]+ Mflop/[\d.]+ MB", "", line)
        line = re.sub(r"0x[0-9a-f]+|-?\d+(\.\d+)?(e-?\d+)?", "<n>", line)
        out.append(re.sub(r"\s+", " ", line).strip())     # the numbers' padding
    return sorted(set(out))


@pytest.mark.parametrize("script, args", [
    ("wf_state.py", ("--monitoring-dir", "{mon}")),
    ("wf_health.py", ("--monitoring-dir", "{mon}")),
    ("wf_trace.py", ("--trace-dir", "{trace}", "--monitoring-dir", "{mon}", "--report",
                     "--out", "{trace}/chrome.json")),
])
def test_jax_analysis_scripts_read_port_artifacts(script, args, root):
    """The JAX package's stdlib CLIs (run as they are) give the same report
    on the port's artifacts as on the JAX package's, times aside
    (:func:`report_lines`)."""
    r = both("q5", "plain", root)
    reports = {}
    for pkg in ("jax", "port"):
        d = r[pkg]["dir"]
        out = run_script(script, *[a.format(mon=os.path.join(d, "mon"),
                                            trace=os.path.join(d, "trace"))
                                   for a in args])
        reports[pkg] = report_lines(out.replace(d, "<dir>"))
    assert reports["port"] == reports["jax"]


def test_name_registries_equal_jax():
    """Every registry the port copies from ``windflow_tpu/observability/
    names.py`` is the JAX package's tuple."""
    from windflow_tpu.observability import names as jnames
    from windflow_tpu_torch.observability import names as tnames
    copied = [k for k in dir(tnames) if k.isupper()]
    assert {"CONTROL_COUNTERS", "EVENT_TIME_GAUGES", "HEALTH_GAUGES", "STAGE_COUNTERS",
            "STAGE_GAUGES", "SHARD_GAUGES", "RECOVERY_COUNTERS"} <= set(copied)
    for k in copied:
        assert getattr(tnames, k) == getattr(jnames, k), k
    assert set(tcontrol.counters()) == set(tnames.CONTROL_COUNTERS)

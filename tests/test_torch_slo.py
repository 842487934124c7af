"""The SLO engine in the port (``windflow_tpu_torch/observability/slo.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_slo.py``: the registries, spec resolution and legality,
the multi-window burn state machine over every signal family, incident
bundles with their cooldown and cap and their manifest-last commit, the
windowed e2e percentile, the Reporter's SLO tick and its survival of a
broken engine, the fleet fold of SLO sections, and ``scripts/wf_slo.py``
over the port's artifacts. Each package runs the same snapshot series under
the same injected clock, and the reports, the ``slo_page``/``slo_recover``
records and the bundle files must agree. The acceptance loop ticks the
Reporter by hand (no wall-clock cadence), and ``slo=`` on leaves the rows of
every driver unchanged.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import windflow_tpu_torch as wt
from windflow_tpu.observability import device_health as jdh
from windflow_tpu.observability import journal as jjournal
from windflow_tpu.observability import metrics as jmetrics
from windflow_tpu.observability import slo as jslo
from windflow_tpu_torch.nexmark import make_query
from windflow_tpu_torch.observability import MonitoringConfig
from windflow_tpu_torch.observability import device_health as tdh
from windflow_tpu_torch.observability import journal as tjournal
from windflow_tpu_torch.observability import metrics as tmetrics
from windflow_tpu_torch.observability import names as tnames
from windflow_tpu_torch.observability import slo as tslo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WF_SLO_CLI = os.path.join(REPO, "scripts", "wf_slo.py")
CPU = {"device": "cpu"}
SLO = {"jax": jslo, "port": tslo}
JOURNAL = {"jax": jjournal, "port": tjournal}
METRICS = {"jax": jmetrics, "port": tmetrics}
TIMING = {"t", "wall", "dur_s"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("WF_MONITORING", "WF_SLO", "WF_SLO_COOLDOWN_S", "WF_SLO_MAX_INCIDENTS",
              "WF_SNAPSHOT_KEEP", "WF_PROFILE", "WF_TELEMETRY", "WF_REMEDIATION"):
        monkeypatch.delenv(k, raising=False)
    yield
    for j in JOURNAL.values():
        j.set_active(None)


def _spec(pkg, **kw):
    base = dict(name="latency", signal="e2e_p99_ms", target=30.0, objective=0.5,
                fast_window=3, slow_window=6, warn_burn=1.0, page_burn=2.0)
    base.update(kw)
    return SLO[pkg].SLOSpec(**base)


def _snap_p99(p99_ms, samples=5):
    return {"graph": "t", "operators": [],
            "e2e_latency_us": {"p99": p99_ms * 1e3, "p99_tick": p99_ms * 1e3,
                               "samples": samples, "samples_tick": samples}}


def _snap_headroom(pct):
    return {"graph": "t", "operators": [],
            "health": {"devices": [{"device": "d0", "bytes_limit": 100,
                                    "headroom_bytes": int(pct)}]}}


def _snap_drops(dropped, offered):
    return {"graph": "t",
            "operators": [{"name": "op", "inputs_received": offered,
                           "counters": {"overflow_drops": dropped}}],
            "totals": {"tuples_dropped_old": 0}}


def _snap_tenant(p99_ms, samples=4):
    return {"graph": "t", "operators": [],
            "serving": {"tenants": {"a": {"offered": samples, "shed": 0,
                                          "e2e_samples": samples,
                                          "e2e_samples_tick": samples,
                                          "e2e_p99_ms": p99_ms,
                                          "e2e_p99_tick_ms": p99_ms}}}}


#: (spec overrides, snapshot series): the same series goes through both engines
SERIES = {
    "spike_then_sustain": (
        {}, [_snap_p99(1.0)] * 6 + [_snap_p99(500.0)] * 2 + [_snap_p99(1.0)] * 4
        + [_snap_p99(500.0)] * 7 + [_snap_p99(1.0)] * 3),
    "signal_absent": (
        {}, [_snap_p99(500.0)] * 8 + [{"graph": "t", "operators": [], "e2e_latency_us": {
            "p99": 1.0, "samples": 5, "samples_tick": 0, "p99_tick": 0.0}}] * 4),
    "min_mode_headroom": (
        dict(name="headroom", signal="hbm_headroom_pct", target=20.0, fast_window=2,
             slow_window=4), [_snap_headroom(50)] * 4 + [_snap_headroom(5)] * 4),
    "drop_ratio": (
        dict(name="drops", signal="drop_ratio", target=0.1, fast_window=2, slow_window=4),
        [_snap_drops(0, 100), _snap_drops(0, 200), _snap_drops(50, 300),
         _snap_drops(100, 400), _snap_drops(150, 500), _snap_drops(200, 600)]),
    "tenant_latency": (
        dict(name="tenant", signal="tenant_e2e_p99_ms", tenant="a", fast_window=2,
             slow_window=4), [_snap_tenant(5.0)] * 3 + [_snap_tenant(90.0)] * 5
        + [_snap_tenant(5.0)] * 3),
}


def _run_series(pkg, tmp_path, name, cooldown_s=0.0):
    """One engine over ``SERIES[name]`` with a journal and bundles under a
    fake clock: (report, transition records, bundles, states per tick)."""
    over, series = SERIES[name]
    jpath = tmp_path / f"{pkg}-{name}.jsonl"
    j = JOURNAL[pkg].EventJournal(str(jpath))
    JOURNAL[pkg].set_active(j)
    clock = {"t": 0.0}
    eng = SLO[pkg].SLOEngine([_spec(pkg, **over)], out_dir=str(tmp_path / f"{pkg}-{name}"),
                             cooldown_s=cooldown_s, clock=lambda: clock["t"],
                             journal_path=str(jpath))
    states = []
    try:
        for snap in series:
            clock["t"] += 1.0
            row = next(iter(eng.observe(json.loads(json.dumps(snap)))["slo"].values()))
            states.append(row["state"])
    finally:
        JOURNAL[pkg].set_active(None)
        j.close()
    recs = [{k: v for k, v in r.items() if k not in TIMING}
            for r in JOURNAL[pkg].read_journal(str(jpath))]
    bundles, torn = SLO[pkg].list_incidents(str(tmp_path / f"{pkg}-{name}"))
    files = [(sorted(b["files"]), {k: v for k, v in b.items()
                                   if k not in ("path", "wall")}) for b in bundles]
    burns = [json.load(open(os.path.join(b["path"], "burn.json"))) for b in bundles]
    return eng.report(), recs, files, burns, torn, states


# -------------------------------------------------------------- registries

def test_slo_gauges_registry_lockstep():
    assert set(tmetrics._SLO_HELP) == set(tnames.SLO_GAUGES) == set(jmetrics._SLO_HELP)
    assert tmetrics._SLO_HELP == jmetrics._SLO_HELP


def test_slo_events_registered():
    assert {"slo_page", "slo_recover"} <= set(tnames.JOURNAL_EVENTS)
    assert "recovery_seconds" in tnames.RECOVERY_COUNTERS


# -------------------------------------------------------- spec resolution

def _as_rows(specs):
    import dataclasses
    return None if specs is None else [dataclasses.asdict(s) for s in specs]


def test_resolve_specs_forms(tmp_path):
    """Every form resolves to the same specs in both packages, and every
    malformed form raises the same error."""
    p = tmp_path / "specs.json"
    p.write_text(json.dumps({"specs": [{"name": "y", "signal": "recovery_s",
                                        "target": 2.0}]}))
    forms = [None, False, "", "0", True, "1",
             '[{"name": "x", "signal": "drop_ratio", "target": 0.5}]', str(p),
             [{"name": "z", "signal": "retrace_rate", "target": 0.0}]]
    for form in forms:
        assert _as_rows(tslo.resolve_specs(form)) == _as_rows(jslo.resolve_specs(form)), form
    for bad in ('{"specs": 17}', [{"name": "q", "signal": "drop_ratio", "target": 1,
                                   "bogus_field": 2}], [3], 3.5):
        errs = []
        for mod in (jslo, tslo):
            with pytest.raises(ValueError) as e:
                mod.resolve_specs(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_monitoring_config_env_resolution(monkeypatch):
    from windflow_tpu.observability import MonitoringConfig as JM
    monkeypatch.setenv("WF_MONITORING", "1")
    for value, want in (("1", True), ("0", False)):
        monkeypatch.setenv("WF_SLO", value)
        assert MonitoringConfig.resolve(None).slo is want is JM.resolve(None).slo
    monkeypatch.setenv("WF_SLO", '[{"name":"a","signal":"drop_ratio","target":1}]')
    monkeypatch.setenv("WF_SLO_COOLDOWN_S", "7.5")
    monkeypatch.setenv("WF_SLO_MAX_INCIDENTS", "3")
    monkeypatch.setenv("WF_SNAPSHOT_KEEP", "11")
    a, b = JM.resolve(None), MonitoringConfig.resolve(None)
    for f in ("slo", "slo_cooldown_s", "slo_max_incidents", "snapshot_keep"):
        assert getattr(a, f) == getattr(b, f), f
    assert (b.slo_cooldown_s, b.slo_max_incidents, b.snapshot_keep) == (7.5, 3, 11)
    monkeypatch.setenv("WF_SNAPSHOT_KEEP", "-2")
    errs = []
    for M in (JM, MonitoringConfig):
        with pytest.raises(ValueError) as e:
            M.resolve(None)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("over", [
    {}, {"signal": "nope"}, {"fast_window": 6, "slow_window": 6}, {"objective": 1.0},
    {"warn_burn": 3.0, "page_burn": 2.0}, {"mode": "sideways"},
    {"signal": "tenant_drop_ratio"}, {"signal": "drop_ratio", "tenant": "a"}])
def test_spec_problems(over):
    """The legality check gives the JAX package's problems word for word,
    and the engine refuses a bad or duplicated spec with its message."""
    probs = [SLO[p].spec_problems(_spec(p, **over)) for p in ("jax", "port")]
    assert probs[0] == probs[1]
    assert bool(probs[1]) == bool(over)
    errs = []
    for p in ("jax", "port"):
        specs = [_spec(p, **over)] + ([] if over else [_spec(p)])
        with pytest.raises(ValueError) as e:
            SLO[p].SLOEngine(specs, out_dir=None)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -------------------------------------------------- the state machine

@pytest.mark.parametrize("name", sorted(SERIES))
def test_engine_matches_jax_on_the_same_series(tmp_path, name):
    """The same snapshot series and clock give equal ``report()`` rows,
    transition records and bundle file lists (every bundle's manifest and
    burn timeline too)."""
    got = {p: _run_series(p, tmp_path, name) for p in ("jax", "port")}
    assert got["port"] == got["jax"]
    report, recs, files, _burns, torn, states = got["port"]
    assert not torn
    if name == "spike_then_sustain":
        assert states[7] == "warn" and "page" in states and states[-1] == "ok"
        # the spike's WARN clears with a recover record, then the page
        assert [r["event"] for r in recs] == ["slo_recover", "slo_page", "slo_recover"]
        assert len(files) == 1
        assert files[0][0] == ["burn.json", "config.json", "journal_tail.jsonl",
                               "sections.json"]
    if name in ("signal_absent", "min_mode_headroom"):
        assert states[-1] == "page"
    if name == "drop_ratio":
        row = report["drops"]
        assert row["history"][2]["value"] == pytest.approx(0.5)


def test_transient_spike_warns_sustained_burn_pages():
    """THE multi-window contract on the port: a spike that fills only the
    fast window WARNs and clears; a sustained burn PAGEs, sticky until the
    fast window is clean."""
    eng = tslo.SLOEngine([_spec("port")], out_dir=None, journal=False)
    states = [eng.observe(s)["slo"]["latency"]["state"]
              for s in SERIES["spike_then_sustain"][1]]
    assert "page" not in states[:12] and "warn" in states[:12]
    assert states[11] == "ok" and states[18] == "page" and states[-1] == "ok"
    rep = eng.report()["latency"]
    assert rep["pages"] == 1 and not rep["burning"]
    trs = [(t["from"], t["to"]) for t in rep["transitions"]]
    assert ("ok", "warn") in trs and ("page", "ok") in trs


def test_page_capture_cooldown_and_cap(tmp_path):
    """Rate limit under a page storm, in both packages alike: one bundle a
    cooldown window, a hard cap a run, every suppression counted, each
    bundle committed manifest-last."""
    out = {}
    for pkg in ("jax", "port"):
        clock = {"t": 0.0}
        d = tmp_path / pkg
        eng = SLO[pkg].SLOEngine([_spec(pkg, fast_window=2, slow_window=4)],
                                 out_dir=str(d), cooldown_s=60.0, max_incidents=2,
                                 journal=False, clock=lambda: clock["t"])

        def page_cycle():
            for _ in range(4):
                eng.observe(_snap_p99(500.0))
            for _ in range(2):
                eng.observe(_snap_p99(1.0))
        counts = []
        for t in (0.0, 0.0, 120.0, 300.0):
            clock["t"] = t
            page_cycle()
            counts.append((len(SLO[pkg].list_incidents(str(d))[0]),
                           eng.incidents_suppressed))
        bundles, _ = SLO[pkg].list_incidents(str(d))
        man = bundles[-1]
        assert not man["missing"]
        for fname in man["files"]:
            assert os.path.getsize(os.path.join(man["path"], fname)) > 0
        out[pkg] = (counts, eng.report()["latency"]["pages"],
                    json.load(open(os.path.join(man["path"], "burn.json"))))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [(1, 0), (1, 1), (2, 1), (2, 2)] and out["port"][1] == 4


def test_torn_bundle_detected(tmp_path):
    eng = tslo.SLOEngine([_spec("port", fast_window=2, slow_window=4)],
                         out_dir=str(tmp_path), journal=False, clock=lambda: 0.0)
    for _ in range(4):
        eng.observe(_snap_p99(500.0))
    bundles, torn = tslo.list_incidents(str(tmp_path))
    assert len(bundles) == 1 and not torn
    os.unlink(os.path.join(bundles[0]["path"], "manifest.json"))
    bundles, torn = tslo.list_incidents(str(tmp_path))
    assert not bundles and len(torn) == 1
    assert tslo.incidents_summary(str(tmp_path)) == jslo.incidents_summary(str(tmp_path))
    assert tslo.incidents_summary(str(tmp_path))["torn"] == 1


def test_evaluate_series_and_burning_match_jax():
    series = SERIES["spike_then_sustain"][1][:19]
    rep = [SLO[p].evaluate_series([_spec(p)], series) for p in ("jax", "port")]
    assert rep[0] == rep[1]
    assert tslo.burning(rep[1]) == jslo.burning(rep[0]) == ["latency"]


# ----------------------------------------------------------- reporter

def _hand_ticked(pkg, out, e2e_seconds_by_tick):
    """A registry, an SLO engine and a Reporter that never ticks by itself:
    each tick records its e2e samples, then emits by hand."""
    from windflow_tpu.observability import MetricsRegistry as JReg, Reporter as JRep
    Reg = JReg if pkg == "jax" else wt.observability.MetricsRegistry
    Rep = JRep if pkg == "jax" else wt.observability.Reporter
    jpath = os.path.join(out, "events.jsonl")
    os.makedirs(out, exist_ok=True)
    j = JOURNAL[pkg].EventJournal(jpath)
    JOURNAL[pkg].set_active(j)
    clock = {"t": 0.0}
    eng = SLO[pkg].SLOEngine([_spec(pkg)], out_dir=out, cooldown_s=60.0,
                             journal_path=jpath, clock=lambda: clock["t"])
    reg = Reg("t")
    rep = Rep(reg, out, interval_s=3600.0, slo_engine=eng)
    states = []
    try:
        for samples in e2e_seconds_by_tick:
            clock["t"] += 1.0
            for s in samples:
                reg.record_e2e(s)
            states.append(rep.emit()["slo"]["latency"]["state"])
    finally:
        JOURNAL[pkg].set_active(None)
        j.close()
    recs = [{k: v for k, v in r.items() if k not in TIMING}
            for r in JOURNAL[pkg].read_journal(jpath)]
    return states, recs, tslo.list_incidents(out)


def test_acceptance_queue_stall_pages_and_recovers(tmp_path):
    """THE acceptance loop, with the Reporter ticked by hand: a stalled
    phase (e2e samples of 200 ms) drives the latency SLO OK -> WARN -> PAGE,
    the healthy tail recovers it to OK, and exactly one bundle commits —
    in both packages alike, records and states equal."""
    ticks = [[0.001] * 4] * 3 + [[0.2] * 4] * 8 + [[0.001] * 4] * 5
    got = {p: _hand_ticked(p, str(tmp_path / p), ticks) for p in ("jax", "port")}
    states, recs, (bundles, torn) = got["port"]
    assert states == got["jax"][0] and recs == got["jax"][1]
    assert states[0] == "ok" and states.index("warn") < states.index("page")
    assert states[-1] == "ok" and "page" not in states[states.index("ok", 5):]
    assert [r["event"] for r in recs] == ["slo_page", "slo_recover"]
    assert len(bundles) == 1 and not torn and bundles[0]["slo"] == "latency"
    with open(tmp_path / "port" / "snapshot.json") as f:
        snap = json.load(f)
    assert snap["slo"]["latency"]["pages"] == 1
    prom = open(tmp_path / "port" / "metrics.prom").read()
    assert 'windflow_slo_state{graph="t",slo="latency"} 0' in prom
    assert "# HELP windflow_slo_burn_fast" in prom


def run_q3(driver, monitoring=False):
    src, ops = make_query("q3_enrich_join", 300, **CPU)
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
def test_slo_on_results_byte_identical(tmp_path, driver):
    """slo= on changes no row of any driver: the engine is Reporter work."""
    base = run_q3(driver)
    cfg = MonitoringConfig(out_dir=str(tmp_path / f"m-{driver}"), interval_s=30.0,
                           slo=True)
    assert run_q3(driver, monitoring=cfg) == base
    with open(tmp_path / f"m-{driver}" / "snapshot.json") as f:
        assert set(json.load(f)["slo"]) == {s.name for s in tslo.default_specs()}


def test_e2e_p99_tick_windows_per_snapshot():
    """The per-tick e2e percentile reads only the samples since the previous
    snapshot, as the JAX registry does."""
    from windflow_tpu.observability import MetricsRegistry as JReg
    out = []
    for Reg in (JReg, wt.observability.MetricsRegistry):
        reg = Reg("t")
        for _ in range(20):
            reg.record_e2e(0.500)
        s1 = reg.snapshot()
        for _ in range(20):
            reg.record_e2e(0.001)
        s2, s3 = reg.snapshot(), reg.snapshot()
        out.append(("samples_tick" in s1["e2e_latency_us"],
                    {k: s2["e2e_latency_us"][k] for k in ("samples_tick", "p99", "p99_tick")},
                    s3["e2e_latency_us"]["samples_tick"]))
    assert out[0] == out[1]
    assert out[1][1]["p99"] > 100e3 and out[1][1]["p99_tick"] < 10e3


def test_reporter_survives_engine_failure(tmp_path, capsys):
    class _Boom:
        def observe(self, snap):
            raise RuntimeError("bad extractor")
    reg = wt.observability.MetricsRegistry("t")
    rep = wt.observability.Reporter(reg, str(tmp_path), interval_s=30.0,
                                    slo_engine=_Boom())
    rep.emit()
    rep.emit()
    assert rep.slo_errors == 2
    with open(tmp_path / "snapshot.json") as f:
        snap = json.load(f)
    assert snap["slo_error"]["count"] == 2 and "RuntimeError" in snap["slo_error"]["error"]
    assert capsys.readouterr().err.count("burn-rate alerting is degraded") == 1


def test_merge_snapshots_folds_slo_sections():
    """The fleet fold of SLO sections equals the JAX package's: worst state
    wins, burns MAX, pages summed and host-tagged, min-sense signals keep
    the paging host's value."""
    def row(state, code, bf, bs, sig, target, pages):
        return {"state": state, "code": code, "burn_fast": bf, "burn_slow": bs,
                "signal": sig, "target": target, "pages": pages}
    hosts = [{"graph": "g", "operators": [], "slo": {
        "latency": row(*r), "headroom": row(*h)}}
        for r, h in ((("ok", 0, 0.2, 0.1, 5.0, 30.0, 0), ("page", 2, 4.0, 3.0, 3.0, 10.0, 1)),
                     (("page", 2, 3.0, 2.5, 80.0, 30.0, 2), ("ok", 0, 0.0, 0.0, 85.0, 10.0, 0)),
                     (("warn", 1, 1.5, 0.5, 40.0, 30.0, 1), ("ok", 0, 0.0, 0.0, 60.0, 10.0, 0)))]
    tags = ["h0", "h1", "h2"]
    m = [mod.merge_snapshots(json.loads(json.dumps(hosts)), hosts=tags)
         for mod in (jdh, tdh)]
    assert m[0] == m[1]
    lat, head = m[1]["slo"]["latency"], m[1]["slo"]["headroom"]
    assert lat["state"] == "page" and lat["worst_host"] == "h1" and lat["pages"] == 3
    assert lat["pages_by_host"] == {"h1": 2, "h2": 1}
    assert head["signal"] == 3.0 and head["worst_host"] == "h0"


def test_wf_slo_reads_the_ports_artifacts(tmp_path):
    """``scripts/wf_slo.py`` (unchanged, stdlib only) over a monitored port
    run with ``slo=`` and live remediation: the burn table of the run's
    specs, exit 0 when nothing burns at the end, and the remediation report
    renders; a missing directory is exit 2."""
    out = str(tmp_path / "mon")
    spec = [{"name": "lat", "signal": "e2e_p99_ms", "target": 1e9}]
    src, ops = make_query("q3_enrich_join", 300, **CPU)
    cfg = MonitoringConfig(out_dir=out, interval_s=30.0, slo=spec, remediation=[
        {"name": "shed", "slo": "lat", "actuator": "admission_rate"}],
        remediation_cooldown_s=60.0, e2e_sample_every=1)
    wt.Pipeline(src, ops, wt.Sink(lambda v: None, **CPU), batch_size=64, monitoring=cfg,
                **CPU).run()
    env = {k: v for k, v in os.environ.items() if not k.startswith("WF_")}
    for extra, want in (([], "1 SLO spec(s), all OK"),
                        (["--report", "remediation"], "actions=[shed]"),
                        (["--json"], '"lat"')):
        r = subprocess.run([sys.executable, WF_SLO_CLI, "--monitoring-dir", out,
                            "--specs", json.dumps(spec), *extra],
                           capture_output=True, text=True, env=env, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        assert want in r.stdout, r.stdout
    r = subprocess.run([sys.executable, WF_SLO_CLI, "--monitoring-dir",
                        str(tmp_path / "nope")], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 2


def test_device_health_loaders_match_jax(tmp_path):
    """``load_snapshots``/``load_journal`` and ``merge_monitoring_dirs``
    over two of the port's monitoring directories give the JAX package's
    results."""
    dirs = []
    for i in range(2):
        out = str(tmp_path / f"h{i}")
        src, ops = make_query("q3_enrich_join", 200 + 64 * i, **CPU)
        wt.Pipeline(src, ops, wt.Sink(lambda v: None, **CPU), batch_size=64,
                    monitoring=MonitoringConfig(out_dir=out, interval_s=30.0, slo=True),
                    **CPU).run()
        dirs.append(out)
        assert tdh.load_snapshots(out) == jdh.load_snapshots(out)
        assert tdh.load_journal(out) == jdh.load_journal(out)
    merged = [mod.merge_monitoring_dirs(dirs) for mod in (jdh, tdh)]
    assert merged[0] == merged[1]

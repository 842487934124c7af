"""Profile-on-page in the port (``windflow_tpu_torch/observability/
profiling.py`` and ``stats.xprof_trace`` on ``torch.profiler``) against the
JAX package's, on the CPU.

Mirrors the profile-on-page cases of ``tests/test_serving_observability.py``
and the ``xprof_trace`` session pins of ``tests/test_tracing.py`` and
``tests/test_stats_and_guards.py``: a capture around a port run writes a
Chrome trace; the one-session guard names the holder, chains an outside
session's error and clears after either; the configuration resolves and
validates as the JAX package's does, word for word; the SLO engine commits
``profile.json`` into a bundle before its manifest (a failing hook is a
recorded skip); ``ProfileOnPage`` turns a held session, its capture budget
and a card without CUPTI into skip reasons; and ``scripts/wf_profile.py``
summarizes the port's bundles. The port's own guard for Kineto's
first-session thread (F27): a first capture with CUDA activity off the main
thread is refused with the reason (``wf_profile --capture`` exits 2), and
``profiler_init`` (run by ``Monitor.start`` with profile-on-page, and by
the first capture on the main thread) opens that session once, on the main
thread.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu.observability import MonitoringConfig as JMonitoringConfig
from windflow_tpu.observability import profiling as jprof
from windflow_tpu_torch import stats
from windflow_tpu_torch.observability import MonitoringConfig, Monitor
from windflow_tpu_torch.observability import profiling as tprof
from windflow_tpu_torch.observability import slo as tslo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}
ENVS = ("WF_PROFILE", "WF_PROFILE_WINDOW_MS", "WF_PROFILE_MAX_CAPTURES", "WF_MONITORING",
        "WF_SLO", "WF_MONITORING_INTERVAL")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ENVS:
        monkeypatch.delenv(k, raising=False)


def _graph_run():
    g = wt.PipeGraph("prof", batch_size=32, **CPU)
    g.add_source(wt.Source(lambda i: {"v": i.to(torch.int32)}, total=64, **CPU)) \
     .add(wt.ReduceSink(lambda t: t.v, name="s", **CPU))
    return g.run()


def _lat_spec():
    return tslo.SLOSpec(name="latency", signal="e2e_p99_ms", target=30.0, objective=0.5,
                        fast_window=2, slow_window=4, warn_burn=1.0, page_burn=2.0)


def _snap_p99(p99_ms, samples=5):
    return {"graph": "t", "operators": [],
            "e2e_latency_us": {"p99": p99_ms * 1e3, "p99_tick": p99_ms * 1e3,
                               "samples": samples, "samples_tick": samples}}


# ------------------------------------------------------------- xprof_trace

def test_xprof_trace_produces_a_capture(tmp_path):
    """``wt.xprof_trace`` around a port run writes a Chrome trace with the
    run's CPU operators."""
    logdir = str(tmp_path / "trace")
    with wt.xprof_trace(logdir) as d:
        res = _graph_run()
    assert d == logdir and int(res["s"]) == sum(range(64))
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert tprof.trace_kernels(os.path.join(logdir, "trace.json")) == []   # no card


def test_xprof_trace_nested_session_clear_error(tmp_path):
    """A nested session raises naming the holder; the guard clears after,
    so a fresh session opens."""
    a = str(tmp_path / "a")
    with stats.xprof_trace(a):
        with pytest.raises(RuntimeError, match="already active") as e:
            with stats.xprof_trace(str(tmp_path / "b")):
                pass
        assert repr(a) in str(e.value)
    with stats.xprof_trace(str(tmp_path / "c")):
        pass
    assert os.path.exists(tmp_path / "c" / "trace.json")
    assert not os.path.exists(tmp_path / "b")


def test_xprof_trace_external_session_chained_error(tmp_path, monkeypatch):
    """A profiler that refuses to start (a session opened outside the
    wrapper) surfaces as the guard's error with the original chained, and
    the guard does not latch."""
    def boom(self):
        raise RuntimeError("Profiler is already enabled on this thread")
    monkeypatch.setattr(torch.profiler.profile, "start", boom)
    with pytest.raises(RuntimeError, match="another profiler session") as ei:
        with stats.xprof_trace(str(tmp_path / "x")):
            pass
    assert isinstance(ei.value.__cause__, RuntimeError)
    monkeypatch.undo()
    with stats.xprof_trace(str(tmp_path / "y")):
        pass


# --------------------------------------------------------- configuration

def test_profile_config_resolution(monkeypatch):
    """``resolve_profile`` and ``ProfileConfig`` follow the JAX package's
    forms and environment."""
    for mod in (jprof, tprof):
        assert mod.resolve_profile(None) is None and mod.resolve_profile(False) is None
        assert mod.resolve_profile(True).window_ms == mod.DEFAULT_WINDOW_MS
    assert (tprof.DEFAULT_WINDOW_MS, tprof.DEFAULT_MAX_CAPTURES) == \
        (jprof.DEFAULT_WINDOW_MS, jprof.DEFAULT_MAX_CAPTURES)
    monkeypatch.setenv("WF_PROFILE", "1")
    monkeypatch.setenv("WF_PROFILE_WINDOW_MS", "7.5")
    monkeypatch.setenv("WF_PROFILE_MAX_CAPTURES", "5")
    cfg = tprof.resolve_profile(None)
    assert (cfg.window_ms, cfg.max_captures) == (7.5, 5)
    j = jprof.resolve_profile(None)
    assert (j.window_ms, j.max_captures) == (7.5, 5)
    monkeypatch.setenv("WF_PROFILE", "0")
    assert tprof.resolve_profile(None) is None
    for kw in ({"window_ms": 0.0}, {"max_captures": 0}):
        errs = []
        for mod in (jprof, tprof):
            with pytest.raises(ValueError) as e:
                mod.ProfileConfig(**kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("kw", [
    {"profile": True},
    {"interval_s": 0.1, "slo": True, "profile": "window250"},
    {"slo": True, "profile": "window5"}])
def test_monitoring_config_profile_validation_matches_jax(tmp_path, kw):
    """Profile without the SLO engine, and a window reaching the reporter
    interval, raise the JAX package's ValueError (WF120) word for word; a
    window under the interval resolves."""
    out = []
    for M, mod in ((JMonitoringConfig, jprof), (MonitoringConfig, tprof)):
        k = dict(kw)
        if isinstance(k["profile"], str):
            k["profile"] = mod.ProfileConfig(window_ms=float(k["profile"][6:]))
        try:
            cfg = M.resolve(M(out_dir=str(tmp_path / "m"), **k))
            out.append(("ok", cfg.profile.window_ms))
        except ValueError as e:
            out.append(("err", str(e)))
    assert out[0] == out[1]
    assert (out[1][0] == "ok") == (kw.get("profile") == "window5")
    if out[1][0] == "err":
        assert "WF120" in out[1][1]


def test_profile_problems_match_jax():
    """The structural problems (no SLO engine, a window at the interval) are
    the JAX package's; the port's availability probe asks torch.profiler."""
    for cfg_kw, slo_on, interval in (({}, False, 1.0), ({"window_ms": 250.0}, True, 0.1),
                                     ({"window_ms": 5.0}, True, 1.0)):
        got = [mod.profile_problems(mod.ProfileConfig(**cfg_kw), slo_on=slo_on,
                                    interval_s=interval) for mod in (jprof, tprof)]
        assert [p for p in got[0] if "not importable" not in p] == got[1]
    assert tprof.profile_problems(None, slo_on=False, interval_s=1.0) == []


def test_monitor_binds_profile_on_page(tmp_path):
    """A Monitor with slo and profile on binds ``ProfileOnPage`` as the SLO
    engine's profiler, with the resolved window."""
    cfg = MonitoringConfig.resolve(MonitoringConfig(
        out_dir=str(tmp_path / "m"), slo=True, profile=tprof.ProfileConfig(window_ms=5.0)))
    mon = Monitor(cfg, "g")
    try:
        assert isinstance(mon.slo.profiler, tprof.ProfileOnPage)
        assert mon.slo.profiler.config.window_ms == 5.0
    finally:
        mon.finish()


# ------------------------------------------------------------ the bundle

def test_engine_commits_profiler_evidence_before_manifest(tmp_path):
    """The hook's summary lands as ``profile.json`` inside the committed
    bundle, listed in the manifest (written last); a hook that raises is a
    recorded skip, never a failed tick or a torn bundle."""
    eng = tslo.SLOEngine([_lat_spec()], str(tmp_path / "a"), journal=False,
                         clock=lambda: 0.0)
    seen = []
    eng.profiler = lambda d: (seen.append(d), {"window_ms": 1.0, "logdir": d,
                                               "files": [{"name": "x", "bytes": 3}]})[1]
    for _ in range(4):
        eng.observe(_snap_p99(500.0))
    bundles, torn = tslo.list_incidents(str(tmp_path / "a"))
    assert len(bundles) == 1 and not torn
    man = bundles[0]
    assert man["files"][-1] == "profile.json" and not man["missing"]
    assert tprof.load_profile(man["path"])["files"][0]["name"] == "x"
    assert seen == [os.path.join(man["path"], "profile")]

    class _Boom:
        def __call__(self, d):
            raise RuntimeError("device went away")
    eng2 = tslo.SLOEngine([_lat_spec()], str(tmp_path / "b"), journal=False,
                          clock=lambda: 0.0)
    eng2.profiler = _Boom()
    for _ in range(4):
        eng2.observe(_snap_p99(500.0))
    bundles2, torn2 = tslo.list_incidents(str(tmp_path / "b"))
    assert len(bundles2) == 1 and not torn2
    assert "device went away" in tprof.load_profile(bundles2[0]["path"])["profile_skipped"]


def test_profile_on_page_captures_a_window(tmp_path):
    """A real capture on the CPU: the JAX package's summary keys plus the
    activities and the kernels the trace names."""
    hook = tprof.ProfileOnPage(tprof.ProfileConfig(window_ms=5.0, max_captures=1))
    prof = hook(str(tmp_path / "p"))
    assert {"logdir", "window_ms", "files"} <= set(prof)
    assert prof["activities"] == ["cpu"] and prof["kernels"] == []
    assert [f["name"] for f in prof["files"]] == ["trace.json"]
    assert prof["files"][0]["bytes"] > 0 and hook.captures == 1


def test_profile_on_page_respects_the_one_session_guard(tmp_path):
    """A held ``xprof_trace`` is a skip naming the holder out of
    ProfileOnPage and a raised RuntimeError out of ``profile_window``;
    skipped attempts count against ``max_captures``."""
    outer = str(tmp_path / "outer")
    hook = tprof.ProfileOnPage(tprof.ProfileConfig(window_ms=1.0, max_captures=2))
    with stats.xprof_trace(outer):
        prof = hook(str(tmp_path / "p1"))
        assert "profile_skipped" in prof and "outer" in prof["profile_skipped"]
        with pytest.raises(RuntimeError, match="already"):
            tprof.profile_window(str(tmp_path / "p2"), window_ms=1.0)
    assert hook.captures == 1
    assert "files" in hook(str(tmp_path / "p3"))
    prof4 = hook(str(tmp_path / "p4"))
    assert prof4["profile_skipped"].startswith("max captures")
    assert hook.captures == 2


def test_profile_on_page_skips_without_cupti(tmp_path, monkeypatch):
    """A process on the card whose profiler cannot record CUDA activity gets
    a recorded skip, never a CPU-only capture that reads as success."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    hook = tprof.ProfileOnPage(tprof.ProfileConfig(window_ms=1.0))
    prof = hook(str(tmp_path / "p"))
    assert "CUPTI unavailable" in prof["profile_skipped"]
    assert not os.path.exists(tmp_path / "p")


def test_wf_profile_summarizes_the_ports_bundles(tmp_path):
    """``scripts/wf_profile.py`` (unchanged, summary mode) over a bundle the
    port's engine committed with a real capture: exit 0, the capture
    listed; a missing directory is exit 2."""
    mon = tmp_path / "mon"
    eng = tslo.SLOEngine([_lat_spec()], str(mon), journal=False, clock=lambda: 0.0)
    eng.profiler = tprof.ProfileOnPage(tprof.ProfileConfig(window_ms=2.0))
    for _ in range(4):
        eng.observe(_snap_p99(500.0))
    with open(mon / "snapshot.json", "w") as f:
        json.dump(_snap_p99(500.0), f)
    env = {k: v for k, v in os.environ.items() if not k.startswith("WF_")}
    cli = os.path.join(REPO, "scripts", "wf_profile.py")
    r = subprocess.run([sys.executable, cli, "--monitoring-dir", str(mon)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1 with device captures" in r.stdout and "trace.json" in r.stdout
    r = subprocess.run([sys.executable, cli, "--monitoring-dir", str(mon), "--json"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0
    assert json.loads(r.stdout)["bundles"][0]["profile"]["activities"] == ["cpu"]
    r = subprocess.run([sys.executable, cli, "--monitoring-dir", str(tmp_path / "nope")],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 2


# ------------------------------------------ the first session (Kineto's thread)

@pytest.fixture
def cuda_profiler(monkeypatch):
    """``profiler_activities`` as on the card (CPU and CUDA), no session
    opened yet, and the first-session opener recording its thread instead
    of touching a card; yields that record."""
    from torch.profiler import ProfilerActivity
    opened = []
    monkeypatch.setattr(stats, "profiler_activities",
                        lambda: [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    monkeypatch.setattr(stats, "_profiler_thread", None)
    monkeypatch.setattr(stats, "_first_session",
                        lambda acts: opened.append(threading.get_ident()))
    return opened


def _on_a_worker(fn):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — handed to the test
            box["err"] = e
    th = threading.Thread(target=run, name="capture-worker")
    th.start()
    th.join(60)
    return box


def _capture(logdir):
    with stats.xprof_trace(logdir):
        pass
    return os.path.exists(os.path.join(logdir, "trace.json"))


def test_first_cuda_capture_off_the_main_thread_is_refused(tmp_path, cuda_profiler, capsys):
    """Before any init, a capture with CUDA activity on a worker thread
    raises a RuntimeError naming Kineto's first-session thread and the fix,
    opens no session and leaves the guard free; ``wf_profile --capture``
    there exits 2 with that message."""
    box = _on_a_worker(lambda: _capture(str(tmp_path / "w")))
    err = box.get("err")
    assert isinstance(err, RuntimeError), box
    assert "Kineto" in str(err) and "profiler_init()" in str(err)
    assert "capture-worker" in str(err) and "does not count" in str(err)
    assert cuda_profiler == [] and stats._xprof_logdir is None
    assert not os.path.exists(tmp_path / "w" / "trace.json")
    from windflow_tpu_torch.scripts import wf_profile
    box = _on_a_worker(lambda: wf_profile.main(["--capture", str(tmp_path / "c"),
                                                "--window-ms", "1"]))
    assert box.get("out") == 2, box
    assert "capture refused" in capsys.readouterr().err
    assert cuda_profiler == [] and stats._profiler_thread is None


def test_profiler_init_on_the_main_thread_lets_a_worker_capture(tmp_path, cuda_profiler):
    """``profiler_init`` on the main thread opens the first session there,
    once, and records the thread; a worker's capture then passes the guard
    and writes its trace. Off the main thread the init opens nothing."""
    assert _on_a_worker(stats.profiler_init).get("out") is False
    assert cuda_profiler == []
    assert stats.profiler_init() is True and stats.profiler_init() is False
    assert cuda_profiler == [threading.get_ident()] == [stats._profiler_thread]
    assert _on_a_worker(lambda: _capture(str(tmp_path / "w"))) == {"out": True}
    assert cuda_profiler == [threading.get_ident()]


def test_first_cuda_capture_on_the_main_thread_runs_the_init(tmp_path, cuda_profiler,
                                                             monkeypatch):
    """A first capture with CUDA activity on the main thread runs the init
    itself, once, before its own session; without CUDA activity nothing is
    opened first, on any thread."""
    assert _capture(str(tmp_path / "a")) and cuda_profiler == [threading.get_ident()]
    assert _capture(str(tmp_path / "b")) and len(cuda_profiler) == 1
    from torch.profiler import ProfilerActivity
    monkeypatch.setattr(stats, "profiler_activities", lambda: [ProfilerActivity.CPU])
    monkeypatch.setattr(stats, "_profiler_thread", None)
    assert stats.profiler_init() is False
    assert _on_a_worker(lambda: _capture(str(tmp_path / "c"))) == {"out": True}
    assert len(cuda_profiler) == 1 and stats._profiler_thread is None


def test_monitor_start_runs_the_profiler_init_on_its_thread(tmp_path, cuda_profiler):
    """``Monitor.start`` with profile-on-page opens the first session once,
    on the thread that starts it (not the Reporter's); without
    profile-on-page it opens none."""
    plain = Monitor(MonitoringConfig.resolve(MonitoringConfig(
        out_dir=str(tmp_path / "p"), slo=True)), "g")
    plain.start()
    plain.finish()
    assert cuda_profiler == []
    cfg = MonitoringConfig.resolve(MonitoringConfig(
        out_dir=str(tmp_path / "m"), slo=True, profile=tprof.ProfileConfig(window_ms=5.0)))
    mon = Monitor(cfg, "g")
    try:
        mon.start()
        assert cuda_profiler == [threading.get_ident()] == [stats._profiler_thread]
    finally:
        mon.finish()
    mon2 = Monitor(cfg, "g2")
    mon2.start()
    mon2.finish()
    assert len(cuda_profiler) == 1

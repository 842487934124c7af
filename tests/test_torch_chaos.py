"""The port's chaos sweep and profile CLI (``windflow_tpu_torch/scripts/``)
against the JAX package's ``scripts/chaos_sweep.py`` and
``scripts/wf_profile.py``, on the CPU.

The JAX chaos script is loaded by path, as it stands. Each driver's
fault-free baseline rows equal the JAX script's; for seeds 0 and 1 each
supervised driver's chaos rows equal its baseline and it fires the same
faults, at the same sites, occurrences and contexts, in the same order, as
the JAX run under the same plan (both injectors draw from one
``random.Random`` a spec and count occurrences a site, and the drivers reach
the sites in the same order). Every mode exits 0 through ``main`` at the
JAX test's size, the serving leg with the JAX leg's kill chunk, torn and
duplicate frames. ``wf_profile``'s summary equals the JAX CLI's over one
bundle, numbers aside; ``--capture`` writes a trace, and a held session
guard exits 2.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

from windflow_tpu import control as jcontrol
from windflow_tpu_torch import control as tcontrol
from windflow_tpu_torch import stats
from windflow_tpu_torch.observability import profiling as tprof
from windflow_tpu_torch.observability import slo as tslo
from windflow_tpu_torch.runtime import faults as tfaults
from windflow_tpu_torch.scripts import chaos_sweep as tchaos
from windflow_tpu_torch.scripts import wf_profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL, BATCH = 200, 20
SIZE = ["--seeds", "1", "--total", str(TOTAL), "--batch", str(BATCH), "--device", "cpu"]
SUPERVISED = ("pipeline", "graph", "graph_det")


def _load_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_sweep", os.path.join(REPO, "scripts", "chaos_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load_jax_script()
JRUNNERS = {"pipeline": J.run_pipeline, "graph": J.run_graph,
            "graph_det": J.run_graph_det, "threaded": J.run_threaded}


@pytest.fixture(autouse=True)
def _clean_process_state():
    for mod in (tfaults, J.faults_mod):
        mod.set_active(None)
        mod.reset_counters()
    jcontrol.reset()
    tcontrol.reset()
    yield
    for mod in (tfaults, J.faults_mod):
        mod.set_active(None)


_BASELINES = {}


def port_baseline(name):
    if name not in _BASELINES:
        _BASELINES[name] = tchaos.RUNNERS[name](TOTAL, BATCH, device="cpu")
    return _BASELINES[name]


@pytest.mark.parametrize("name", tchaos.DRIVERS)
def test_baseline_rows_match_jax(name):
    got = port_baseline(name)
    assert got and got == JRUNNERS[name](TOTAL, BATCH)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", SUPERVISED)
def test_chaos_rows_and_fired_faults_match_jax(name, seed):
    tinj = tchaos.FaultInjector(tchaos.plan_for(seed))
    jinj = J.FaultInjector(J.plan_for(seed))
    assert tchaos.plan_for(seed).to_json() == J.plan_for(seed).to_json()
    got = tchaos.RUNNERS[name](TOTAL, BATCH, faults=tinj, device="cpu")
    want = JRUNNERS[name](TOTAL, BATCH, faults=jinj)
    assert got == port_baseline(name) == want
    assert tinj.fired == jinj.fired
    if seed == 1:
        assert tinj.fired                    # the plan reaches every driver


def _main(argv, capsys):
    rc = tchaos.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("mode", [["--controller"], ["--dispatch", "4"],
                                  ["--shards", "4"], ["--remediate"]])
def test_modes_exit_zero_through_main(mode, capsys):
    rc, out = _main(SIZE + mode, capsys)
    assert rc == 0, out
    assert out.rstrip().endswith(
        "PASS: all chaos runs byte-identical to the fault-free baselines")
    runs = re.findall(r"^\[seed 0\] (\w+): (\d+) faults injected, OK", out, re.M)
    assert [n for n, _ in runs] == list(tchaos.DRIVERS)
    if mode == ["--shards", "4"]:
        # the shard drills widen the supervised plans
        assert sum(int(k) for n, k in runs if n in SUPERVISED) > 0
    if mode == ["--remediate"]:
        assert "[closed-loop] threaded:" in out
        assert "remediation action(s), OK" in out


def test_serve_mode_matches_the_jax_leg(capsys):
    rc, out = _main(["--serve", "--seeds", "1", "--device", "cpu"], capsys)
    assert rc == 0, out
    m = re.search(r"\[seed 0\] serve: kill@chunk (\d+), (\d+) decoded / (\d+) torn / "
                  r"(\d+) dup, OK", out)
    assert m, out
    problems, ctr = J.run_serve_loop(0)
    assert not problems
    assert [int(m.group(i)) for i in (1, 3, 4)] == [ctr["kill_at"], ctr["torn"], ctr["dup"]]


def test_shards_exclude_dispatch(capsys):
    with pytest.raises(SystemExit) as e:
        tchaos.main(["--shards", "4", "--dispatch", "4", "--device", "cpu"])
    assert e.value.code == 2
    assert "WF115" in capsys.readouterr().err


def test_driver_defaults_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tchaos.main(["--seeds", "1"])


# ------------------------------------------------------------- wf_profile


def _port_bundle(mon):
    """A monitoring dir holding one bundle the port's SLO engine committed
    with a real capture, and its snapshot."""
    spec = tslo.SLOSpec(name="latency", signal="e2e_p99_ms", target=30.0, objective=0.5,
                        fast_window=2, slow_window=4, warn_burn=1.0, page_burn=2.0)
    snap = {"graph": "t", "operators": [],
            "e2e_latency_us": {"p99": 5e5, "p99_tick": 5e5, "samples": 5,
                               "samples_tick": 5},
            "health": {"device_time": {"t/op0": {"device_ms": 0.5, "dispatch_ms": 0.4,
                                                 "samples": 3, "dispatch_ratio": 0.8}},
                       "dispatch_bound": {"t/op0": 0.8}}}
    eng = tslo.SLOEngine([spec], str(mon), journal=False, clock=lambda: 0.0)
    eng.profiler = tprof.ProfileOnPage(tprof.ProfileConfig(window_ms=2.0))
    for _ in range(4):
        eng.observe(snap)
    with open(mon / "snapshot.json", "w") as f:
        json.dump(snap, f)


def _numbers_aside(text):
    return [re.sub(r"\s+", " ", re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "<n>", ln)).strip()
            for ln in text.splitlines()]


def test_wf_profile_summary_equals_the_jax_cli(tmp_path, capsys):
    mon = tmp_path / "mon"
    _port_bundle(mon)
    env = {k: v for k, v in os.environ.items() if not k.startswith("WF_")}
    cli = os.path.join(REPO, "scripts", "wf_profile.py")
    for extra in ([], ["--json"]):
        want = subprocess.run([sys.executable, cli, "--monitoring-dir", str(mon), *extra],
                              capture_output=True, text=True, env=env, timeout=120)
        assert want.returncode == 0, want.stderr
        assert wf_profile.main(["--monitoring-dir", str(mon), *extra]) == 0
        got = capsys.readouterr().out
        assert _numbers_aside(got) == _numbers_aside(want.stdout)
    assert "1 with device captures" in got or '"activities"' in got
    assert wf_profile.main(["--monitoring-dir", str(tmp_path / "nope")]) == 2
    assert wf_profile.main(["--bundle", str(tmp_path)]) == 2


def test_wf_profile_capture_writes_a_trace(tmp_path, capsys):
    logdir = tmp_path / "cap"
    assert wf_profile.main(["--capture", str(logdir), "--window-ms", "5", "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["logdir"] == str(logdir) and summary["activities"] == ["cpu"]
    assert [f["name"] for f in summary["files"]] == ["trace.json"]
    with open(logdir / "trace.json") as f:
        assert json.load(f)["traceEvents"] is not None


def test_wf_profile_capture_held_guard_exits_2(tmp_path, capsys):
    with stats.xprof_trace(str(tmp_path / "outer")):
        rc = wf_profile.main(["--capture", str(tmp_path / "inner"), "--window-ms", "1"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "capture refused" in err and "outer" in err and "torch.profiler" in err
    assert not (tmp_path / "inner" / "trace.json").exists()


def test_operator_less_chain_captures_no_graph(monkeypatch):
    """F24: under dispatch a PipeGraph warms each source pipe's chain before
    the merge; a chain with no operator has nothing to capture, and on the
    card its capture was an empty CUDA graph. ``warm_scan`` now leaves it
    alone (the CPU stands in for the card's device type here)."""
    import torch
    import windflow_tpu_torch as wt
    src = wt.Source(lambda i: {"v": i.float()}, total=64, device="cpu")
    chain = wt.CompiledChain([], src.payload_spec(), batch_capacity=16, device="cpu")
    chain.device = torch.device("cuda")

    def no_capture(*a, **k):
        raise AssertionError("an operator-less chain was captured")
    monkeypatch.setattr(chain, "_graph", no_capture)
    monkeypatch.setattr(chain, "_warm", lambda from_op, capacity: None)
    chain.warm_scan(4, 16)


def test_blocked_ring_ends_nap_instead_of_spinning():
    """F25: a stage blocked on an empty or full ring spun and yielded for as
    long as it waited, taking a core from the stage threads that work; on
    the card every CUDA call of those slowed several-fold, and the
    remediation leg's steady latency sat at its SLO target. Past its first
    rounds a blocked end now naps, so it uses a small share of the wall
    time it waits."""
    import threading
    import time
    from windflow_tpu_torch.native import SPSCQueue

    q = SPSCQueue(2)
    box = {}

    def blocked_pop():
        w, c = time.perf_counter(), time.thread_time()
        box["pop"] = q.pop(spin=256, max_yields=16_000)
        box["pop_cpu"] = (time.thread_time() - c) / (time.perf_counter() - w)

    t = threading.Thread(target=blocked_pop)
    t.start()
    t.join(30)
    assert box["pop"] == (False, None)
    assert box["pop_cpu"] < 0.25, box

    q.push("a")
    q.push("b")                                  # full: capacity 2

    def blocked_push():
        w, c = time.perf_counter(), time.thread_time()
        q.push("c")
        box["push_cpu"] = (time.thread_time() - c) / (time.perf_counter() - w)

    t = threading.Thread(target=blocked_push)
    t.start()
    time.sleep(0.2)
    assert q.pop() == (True, "a")
    t.join(30)
    assert box["push_cpu"] < 0.25, box
    assert q.pop() == (True, "b") and q.pop() == (True, "c")

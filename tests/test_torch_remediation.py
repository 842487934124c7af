"""Remediation in the port (``windflow_tpu_torch/control/remediation.py``
and the supervised drivers' barrier remediation) against the JAX package's,
on the CPU.

Mirrors ``tests/test_remediation.py``: the policy grammar and its
resolution, the live engine on synthetic snapshots (cooldown, budgets,
damping, gates, advisory actuators, skips journaled on transitions only,
contained actuator errors), the barrier engine (windows, frozen windows,
damping, state round trip), the actuator edge cases (a rate change while
batches are held, a re-climb during a settle blackout or after
convergence), the supervised integration (remediation fires, a faulted
replay takes the same decisions) and the arbitration against
``reshard="auto"``. The unit tests run each package's module through the
same calls and compare what they decide; the driver tests compare rows,
decision states and the ``remediation_apply``/``remediation_skip`` and
``reshard`` records. The live engine is driven by snapshots built here,
and then by the SLO engine in the live drivers: ``Pipeline.run`` binds
``admission_rate`` and ``autotune_reclimb``, ``ThreadedPipeline``
``admission_rate`` (``ServingRuntime``'s ``tenant_rate`` is in
``tests/test_torch_serving.py``).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import control as jcontrol
from windflow_tpu.control import remediation as jrem
from windflow_tpu.observability import journal as jjournal
from windflow_tpu.runtime import faults as jfaults
from windflow_tpu_torch import control as tcontrol
from windflow_tpu_torch.control import remediation as trem
from windflow_tpu_torch.observability import journal as tjournal
from windflow_tpu_torch.observability import names as tnames
from windflow_tpu_torch.runtime import faults as tfaults

PKGS = ("jax", "port")
REM = {"jax": jrem, "port": trem}
CTL = {"jax": jcontrol, "port": tcontrol}
JOURNAL = {"jax": jjournal, "port": tjournal}
FAULTS = {"jax": jfaults, "port": tfaults}
X = {"jax": wf, "port": wt}
KW = {"jax": {}, "port": {"device": "cpu"}}
TIMING = {"t", "wall", "dur_s"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("WF_REMEDIATION", "WF_REMEDIATION_COOLDOWN_S", "WF_REMEDIATION_MAX_ACTIONS",
              "WF_CONTROL", "WF_SHARDS", "WF_RESHARD", "WF_DISPATCH", "WF_MONITORING"):
        monkeypatch.delenv(k, raising=False)
    for pkg in PKGS:
        CTL[pkg].reset()
        FAULTS[pkg].reset_counters()
    yield
    for pkg in PKGS:
        CTL[pkg].reset()
        FAULTS[pkg].reset_counters()
        JOURNAL[pkg].set_active(None)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Journal:
    def __init__(self, pkg, path):
        self.mod, self.path = JOURNAL[pkg], str(path)
        self.j = self.mod.EventJournal(self.path)

    def __enter__(self):
        self.mod.set_active(self.j)
        return self

    def __exit__(self, *exc):
        self.mod.set_active(None)
        self.j.close()

    def records(self, prefixes=("remediation_", "reshard", "tuning_reclimb")):
        return [{k: v for k, v in r.items() if k not in TIMING}
                for r in self.mod.read_journal(self.path)
                if r["event"].startswith(prefixes)]


def _page_snap(slo="lat", burn=3.0, code=2, **extra):
    snap = {"slo": {slo: {"state": {2: "page", 1: "warn", 0: "ok"}[code], "code": code,
                          "burn_fast": burn, "burn_slow": burn}}}
    snap.update(extra)
    return snap


def _action(rem, **kw):
    return rem.RemediationAction(**dict(dict(name="a", slo="lat", actuator="admission_rate"),
                                        **kw))


def _mkbatch(pkg, n, start=0):
    i = np.arange(start, start + n, dtype=np.int32)
    if pkg == "jax":
        return wf.Batch(key=jnp.asarray(i % 4), id=jnp.asarray(i), ts=jnp.asarray(i),
                        payload={"v": jnp.asarray(i, jnp.float32)}, valid=jnp.ones(n, bool))
    t = torch.from_numpy(i)
    return wt.Batch(key=t % 4, id=t.clone(), ts=t.clone(), payload={"v": t.float()},
                    valid=torch.ones(n, dtype=torch.bool))


def _first_ids(batches):
    return [int(np.asarray(b.id)[0]) for b in batches]


# ------------------------------------------------------------ names, grammar

def test_remediation_names_registered():
    for ev in ("remediation_apply", "remediation_skip", "tuning_reclimb"):
        assert ev in tnames.JOURNAL_EVENTS
    for c in ("remediation_actions", "remediation_skips"):
        assert c in tnames.CONTROL_COUNTERS
    for g in ("bucket_rate", "remediation_hot_capacity", "remediation_recommended_delay"):
        assert g in tnames.CONTROL_GAUGES
    assert trem.ACTUATORS == jrem.ACTUATORS and trem.BARRIER_SIGNALS == jrem.BARRIER_SIGNALS


@pytest.mark.parametrize("pkg", PKGS)
def test_resolve_policy_forms(pkg, tmp_path):
    rem = REM[pkg]
    for off in (None, False, "0", ""):
        assert rem.resolve_policy(off) is None
    for on in (True, 1, "1"):
        assert rem.resolve_policy(on) == rem.default_policy()
    d = {"name": "x", "slo": "lat", "actuator": "admission_rate", "factor": 0.5}
    assert rem.resolve_policy([d]).actions[0].factor == 0.5
    assert rem.resolve_policy({"actions": [d]}).actions[0].name == "x"
    inline = json.dumps([d])
    assert rem.resolve_policy(inline).actions[0].name == "x"
    f = tmp_path / "pol.json"
    f.write_text(inline)
    assert rem.resolve_policy(str(f)).actions[0].name == "x"
    existing = rem.default_policy()
    assert rem.resolve_policy(existing) is existing


def test_policy_errors_are_the_jax_packages():
    """Every malformed policy raises in both packages, with the same message."""
    bad = ["{not json",
           [{"name": "x", "slo": "lat", "actuator": "warp_drive"}],
           [{"name": "x", "slo": "lat", "actuator": "admission_rate", "flavor": "sour"}],
           [{"name": "x", "slo": "lat", "actuator": "admission_rate", "factor": 0.0}],
           [{"name": "x", "slo": "lat", "actuator": "admission_rate",
             "gate": "dispatch_ratio!!0.5"}],
           [{"name": "d", "slo": "lat", "actuator": "admission_rate"}] * 2]
    for arg in bad:
        msgs = []
        for pkg in PKGS:
            with pytest.raises(ValueError) as e:
                REM[pkg].resolve_policy(arg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_policy_problems_checks_spec_names(pkg):
    rem = REM[pkg]
    p = rem.RemediationPolicy((_action(rem, slo="lat"),))
    assert rem.policy_problems(p, spec_names=["lat"]) == []
    probs = rem.policy_problems(p, spec_names=["other"])
    assert probs and "lat" in probs[0]


def test_resolve_barrier_policy_ownership():
    for pkg in PKGS:
        rem = REM[pkg]
        p = rem.resolve_barrier_policy(True, admission=True, shards=1)
        assert [a.actuator for a in p.actions] == ["admission_rate"]
        p = rem.resolve_barrier_policy(True, admission=True, shards=4)
        assert sorted(a.actuator for a in p.actions) == ["admission_rate", "reshard"]
        p = rem.resolve_barrier_policy(True, admission=False, shards=4)
        assert [a.actuator for a in p.actions] == ["reshard"]
        assert rem.resolve_barrier_policy(None, admission=True, shards=1) is None
    for arg, kw in ((True, dict(admission=False, shards=1)),
                    ([{"name": "x", "slo": "lat", "actuator": "autotune_reclimb"}],
                     dict(admission=True, shards=1)),
                    ([{"name": "x", "slo": "shards", "actuator": "reshard"}],
                     dict(admission=True, shards=1))):
        msgs = []
        for pkg in PKGS:
            with pytest.raises(ValueError) as e:
                REM[pkg].resolve_barrier_policy(arg, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------------------ the live engine (unit)

def _live(pkg, tmp_path, script):
    """Run ``script(rem, clock, engine_factory)`` under a journal; returns
    what it returns and the remediation records."""
    rem = REM[pkg]
    with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
        out = script(rem, FakeClock())
    return out, j.records(), CTL[pkg].counters(), CTL[pkg].gauges()


def _both_live(tmp_path, script):
    got = {pkg: _live(pkg, tmp_path, script) for pkg in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


def test_live_engine_fires_on_page_only(tmp_path):
    def script(rem, clk):
        eng = rem.RemediationEngine(rem.RemediationPolicy((_action(rem),)), cooldown_s=1.0,
                                    clock=clk)
        calls = []
        eng.bind("admission_rate", lambda a: calls.append(a.name) or {})
        eng.on_verdicts(_page_snap(code=0))
        eng.on_verdicts(_page_snap(code=1))
        assert calls == [] and eng.applied == 0
        snap = _page_snap(code=2)
        eng.on_verdicts(snap)
        assert calls == ["a"] and eng.applied == 1
        assert snap["remediation"]["bound"] == ["admission_rate"]
        return snap["remediation"]
    sec, recs, *_ = _both_live(tmp_path, script)
    assert sec["ledger"][-1]["action"] == "a" and recs[0]["event"] == "remediation_apply"


def test_live_engine_cooldown_budget_and_damping(tmp_path):
    def script(rem, clk):
        eng = rem.RemediationEngine(rem.RemediationPolicy((_action(rem, max_applies=4),)),
                                    cooldown_s=10.0, max_actions=8, clock=clk)
        eng.bind("admission_rate", lambda a: {})
        seq = []
        for adv, burn in ((0, 4.0), (0, 4.0), (11, 2.0), (11, 1.9), (11, 0.1)):
            clk.advance(adv)
            eng.on_verdicts(_page_snap(burn=burn))
            seq.append((eng.applied, eng._per["a"]["last_skip"], eng._per["a"]["stopped"]))
        return seq
    seq, *_ = _both_live(tmp_path, script)
    assert [s[0] for s in seq] == [1, 1, 2, 2, 2] and seq[1][1] == "cooldown" and seq[-1][2]


def test_live_engine_run_budget(tmp_path):
    def script(rem, clk):
        acts = tuple(_action(rem, name=f"a{k}", max_applies=9) for k in range(3))
        eng = rem.RemediationEngine(rem.RemediationPolicy(acts), cooldown_s=0.0,
                                    max_actions=2, clock=clk)
        eng.bind("admission_rate", lambda a: {})
        eng.on_verdicts(_page_snap())
        return eng.applied, eng._per["a2"]["last_skip"]
    assert _both_live(tmp_path, script)[0] == (2, "run_budget")


def test_live_engine_unbound_and_gate(tmp_path):
    def script(rem, clk):
        eng = rem.RemediationEngine(rem.RemediationPolicy((
            _action(rem, name="loose", actuator="autotune_reclimb"),
            _action(rem, name="gated", gate="dispatch_ratio>=0.5"))), cooldown_s=0.0,
            clock=clk)
        eng.bind("admission_rate", lambda a: {})
        out = []
        for health in (None, 0.2, 0.8):
            extra = {} if health is None else {
                "health": {"device_time": {"s0": {"dispatch_ratio": health}}}}
            eng.on_verdicts(_page_snap(**extra))
            out.append((eng.applied, eng._per["loose"]["last_skip"],
                        eng._per["gated"]["last_skip"]))
        return out
    out, *_ = _both_live(tmp_path, script)
    assert out == [(0, "unbound", "gate_unobserved"), (0, "unbound", "gate"),
                   (1, "unbound", None)]


def test_live_engine_advisory_hot_capacity_sets_gauge(tmp_path):
    def script(rem, clk):
        eng = rem.RemediationEngine(rem.RemediationPolicy((_action(
            rem, name="grow", actuator="hot_capacity", factor=0.5, floor=1.0),)),
            cooldown_s=0.0, clock=clk)
        eng.on_verdicts(_page_snap())
        skip = eng._per["grow"]["last_skip"]
        eng.on_verdicts(_page_snap(control={"gauges": {"hot_capacity": 64.0}}))
        return skip, eng.applied, eng._ledger[-1]
    (skip, applied, last), _recs, _c, gauges = _both_live(tmp_path, script)
    assert (skip, applied) == ("unobserved", 1)
    assert last["recommended"] == 128.0 and last["advisory"] is True
    assert gauges["remediation_hot_capacity"] == 128.0


def test_live_engine_skip_journals_on_transitions_only(tmp_path):
    def script(rem, clk):
        eng = rem.RemediationEngine(rem.RemediationPolicy(
            (_action(rem, actuator="autotune_reclimb"),)), cooldown_s=0.0, clock=clk)
        for _ in range(5):
            eng.on_verdicts(_page_snap())
        return eng.skipped
    skipped, recs, counters, _g = _both_live(tmp_path, script)
    assert skipped == 5 and counters["remediation_skips"] == 5
    assert [r["reason"] for r in recs] == ["unbound"]


def test_live_engine_actuator_exception_is_contained(tmp_path):
    def script(rem, clk):
        eng = rem.RemediationEngine(rem.RemediationPolicy((_action(rem),)), cooldown_s=0.0,
                                    clock=clk)

        def boom(a):
            raise RuntimeError("knob fell off")
        eng.bind("admission_rate", boom)
        eng.on_verdicts(_page_snap())
        return eng.applied, eng._per["a"]["last_skip"]
    assert _both_live(tmp_path, script)[0] == (0, "actuator_error:RuntimeError")


# ---------------------------------------------------- the barrier engine (unit)

def _barrier_eng(rem, **kw):
    pol = rem.RemediationPolicy((_action(rem, name="shed", slo="drops",
                                         actuator="admission_rate", target=0.1, window=3,
                                         max_applies=4),))
    return rem.BarrierRemediation(pol, **dict(dict(cooldown_barriers=2, max_actions=8), **kw))


def _both(fn):
    got = {pkg: fn(REM[pkg]) for pkg in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


def test_barrier_window_and_fire():
    def run(rem):
        eng = _barrier_eng(rem)
        return [d for pos in range(5) for d in eng.on_barrier(pos, {"drop_ratio": 0.5})]
    fired = [d for d in _both(run) if d.get("applied")]
    assert len(fired) == 1 and fired[0]["pos"] == 2
    assert (fired[0]["actuator"], fired[0]["factor"], fired[0]["floor"]) == \
        ("admission_rate", 0.7, 1.0)


def test_barrier_missing_signal_freezes_window():
    def run(rem):
        eng, eng2 = _barrier_eng(rem), _barrier_eng(rem)
        for pos, s in enumerate(({"drop_ratio": 0.5}, {}, {"drop_ratio": 0.5})):
            eng.on_barrier(pos, s)
        for pos, v in enumerate((0.5, 0.0, 0.5)):
            eng2.on_barrier(pos, {"drop_ratio": v})
        return eng.on_barrier(3, {"drop_ratio": 0.5}), eng2.on_barrier(3, {"drop_ratio": 0.5})
    frozen, reset = _both(run)
    assert frozen[0]["applied"] and not reset


def test_barrier_damping_emits_skip_decision():
    def run(rem):
        eng = _barrier_eng(rem, cooldown_barriers=1)
        out = [d for pos in range(12) for d in eng.on_barrier(pos, {"drop_ratio": 0.5})]
        return out, eng.state()
    out, st = _both(run)
    assert len([d for d in out if d.get("applied")]) == 1
    assert [d for d in out if d.get("reason") == "damped"] and st["per"]["shed"]["stopped"]


def test_barrier_state_roundtrip_determinism():
    sigs = [{"drop_ratio": v} for v in (0.5, 0.5, 0.0, 0.5, 0.5, 0.5, 0.2, 0.5, 0.5, 0.5)]

    def run(rem):
        eng1 = _barrier_eng(rem)
        out1 = [eng1.on_barrier(p, s) for p, s in enumerate(sigs)]
        eng2 = _barrier_eng(rem)
        for p, s in enumerate(sigs[:4]):
            eng2.on_barrier(p, s)
        eng3 = _barrier_eng(rem)
        eng3.set_state(json.loads(json.dumps(eng2.state())))
        out3 = [eng3.on_barrier(p + 4, s) for p, s in enumerate(sigs[4:])]
        assert [d for o in out1[4:] for d in o] == [d for o in out3 for d in o]
        assert eng1.state() == eng3.state()
        return out1, eng1.state()
    _both(run)


# ----------------------------------------------------- actuator edge cases

def test_rate_change_mid_held_batch_drop_oldest_ts():
    got = {}
    for pkg in PKGS:
        ctl, clk = CTL[pkg], FakeClock()
        adm = ctl.AdmissionController(ctl.TokenBucket(rate=0.0, burst=10.0, clock=clk),
                                      "drop_oldest_ts", hold_max=4)
        b0, b1, b2 = (_mkbatch(pkg, 10, 100 * k) for k in range(3))
        steps = [_first_ids(adm.offer(b0)), _first_ids(adm.offer(b1)),
                 _first_ids(adm.offer(b2)), len(adm.held)]
        steps.append(adm.scale_rate(0.5, floor=40.0))
        steps.append((len(adm.held), ctl.gauges()["bucket_rate"]))
        clk.advance(0.25)
        steps.append(_first_ids(adm.offer(_mkbatch(pkg, 10, 300))))
        steps.append(_first_ids(b for b, *_ in adm.held))
        clk.advance(0.25)
        steps.append(_first_ids(adm.offer(_mkbatch(pkg, 10, 400))))
        steps.append(_first_ids(adm.drain()))
        steps.append((adm.admitted, adm.shed, sorted(adm.state()["bucket"])))
        got[pkg] = steps
    assert got["port"] == got["jax"]
    assert got["port"] == [[0], [], [], 2, {"rate": 40.0, "prev_rate": 0.0}, (2, 40.0),
                           [100], [200, 300], [200], [300, 400], (5, 0, ["tokens"])]


def _climb(ctl, clk, tuner, rates, stop):
    for _ in range(300):
        cap = tuner.capacity
        clk.advance(cap / rates[cap])
        tuner.on_batch(cap)
        if stop(tuner):
            return


def test_reclimb_noop_during_settle_blackout(tmp_path):
    def run(pkg):
        ctl, clk = CTL[pkg], FakeClock()
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            tuner = ctl.CapacityAutotuner([16, 32, 64], start_capacity=16, decide_every=2,
                                          settle_batches=3, clock=clk)
            _climb(ctl, clk, tuner, {16: 1000.0, 32: 3000.0, 64: 2000.0},
                   lambda t: t.capacity != 16)
            before = (tuner.capacity, tuner._settle > 0, tuner.converged, tuner._phase)
            tuner.request_reclimb()
            clk.advance(0.001)
            tuner.on_batch(tuner.capacity)
            after = (tuner.converged, tuner._phase, tuner.reclimb())
        return before, after, j.records()
    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"] == ((32, True, False, "up"), (False, "up", False), [])


def test_reclimb_after_convergence_journals_and_reexplores(tmp_path):
    def run(pkg):
        ctl, clk = CTL[pkg], FakeClock()
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            tuner = ctl.CapacityAutotuner([16, 32, 64], start_capacity=16, decide_every=2,
                                          settle_batches=1, clock=clk, name="t")
            _climb(ctl, clk, tuner, {16: 1000.0, 32: 4000.0, 64: 2000.0},
                   lambda t: t.converged)
            converged = (tuner.converged, tuner.capacity)
            tuner.request_reclimb()
            clk.advance(0.001)
            tuner.on_batch(tuner.capacity)
        return converged, tuner.converged, j.records()
    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ((True, 32), False) and got["port"][2][0]["event"] == \
        "tuning_reclimb"


# ------------------------------------------------------ supervised integration

def _src(pkg, total, num_keys):
    f32 = (lambda a: a.astype(jnp.float32)) if pkg == "jax" else (lambda a: a.float())
    return X[pkg].Source(lambda i: {"v": f32(i % 13)}, total=total, num_keys=num_keys,
                         **KW[pkg])


def _op(pkg, num_keys):
    Xm = X[pkg]
    return Xm.Win_Seq(lambda wid, it: it.sum("v"), Xm.WindowSpec(10, 10, Xm.win_type_t.TB),
                      num_keys=num_keys, **KW[pkg])


def _collect(acc):
    def cb(view):
        if view is None:
            return
        acc.extend(zip(np.asarray(view["key"]).tolist(), np.asarray(view["id"]).tolist(),
                       np.asarray(view["payload"]).tolist()))
    return cb


def _sup_run(pkg, total=400, batch=20, faults=None, remediation=True):
    got = []
    p = X[pkg].SupervisedPipeline(
        _src(pkg, total, 4), [_op(pkg, 4)], X[pkg].Sink(_collect(got), **KW[pkg]),
        batch_size=batch, checkpoint_every=2, max_restarts=16, backoff_base=0.001,
        backoff_cap=0.01, faults=faults, remediation=remediation,
        control=CTL[pkg].ControlConfig(autotune=False, backpressure=False, admission=True,
                                       refill_per_batch=0.5 * batch, burst_tuples=2 * batch),
        **KW[pkg])
    p.run()
    return sorted(got), p


def test_supervised_remediation_fires_and_replays_byte_identical(tmp_path):
    """shed_harder fires at the same barriers in both packages, and a run
    under a seeded fault plan replays to the same rows and decision state
    (``remediation_apply`` records equal, ``pos`` and the scaled rate
    included)."""
    got = {}
    for pkg in PKGS:
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            base, p = _sup_run(pkg)
        st = p._remediation.state()
        assert st["applied"] >= 1
        fm = FAULTS[pkg]
        chaos, pc = _sup_run(pkg, faults=fm.FaultInjector(fm.FaultPlan(
            [fm.FaultSpec("chain.step", p=0.15)], seed=7)))
        assert chaos == base and pc._remediation.state() == st
        got[pkg] = (base, st, j.records())
    assert got["port"] == got["jax"]
    applies = [r for r in got["port"][2] if r["event"] == "remediation_apply"]
    assert applies and applies[0]["action"] == "shed_harder"
    assert {"pos", "rate", "prev_rate"} <= set(applies[0])


def test_supervised_remediation_off_is_inert():
    for pkg in PKGS:
        _, p = _sup_run(pkg, total=200, remediation=None)
        assert p._remediation is None
        assert set(p._admission.state()) == {"bucket", "admitted", "shed"}
        assert set(p._admission.state()["bucket"]) == {"tokens"}


def test_supervised_construction_rejects_unusable_config(monkeypatch):
    for pkg in PKGS:
        Xm, kw = X[pkg], KW[pkg]
        with pytest.raises(ValueError):
            Xm.SupervisedPipeline(_src(pkg, 100, 4), [_op(pkg, 4)],
                                  Xm.Sink(lambda v: None, **kw), batch_size=20,
                                  remediation=True, **kw)
        with pytest.raises(ValueError, match="WF118"):
            Xm.SupervisedPipeline(
                _src(pkg, 100, 4), [_op(pkg, 4)], Xm.Sink(lambda v: None, **kw),
                batch_size=20, remediation=[{"name": "x", "slo": "lat",
                                             "actuator": "widen_delay"}],
                control=CTL[pkg].ControlConfig(autotune=False, admission=True,
                                               refill_per_batch=16.0), **kw)
        monkeypatch.setenv("WF_REMEDIATION", "1")         # the environment form
        with pytest.raises(ValueError, match="owns no barrier actuator"):
            Xm.SupervisedPipeline(_src(pkg, 100, 4), [_op(pkg, 4)],
                                  Xm.Sink(lambda v: None, **kw), batch_size=20, **kw)
        monkeypatch.delenv("WF_REMEDIATION")


def _sharded(pkg, tmp_path, name, remediation, reshard="auto"):
    got = []
    with Journal(pkg, tmp_path / f"{pkg}_{name}.jsonl") as j:
        p = X[pkg].SupervisedPipeline(
            _src(pkg, 300, 3), [_op(pkg, 3)], X[pkg].Sink(_collect(got), **KW[pkg]),
            batch_size=20, checkpoint_every=1, max_restarts=4, backoff_base=0.001,
            backoff_cap=0.01, shards=2, reshard=reshard, remediation=remediation,
            **KW[pkg])
        p.run()
    recs = [{k: r.get(k) for k in ("event", "phase", "action", "reason", "pos", "at_pos",
                                   "from_shards", "to_shards", "aborted", "error")}
            for r in j.records()]
    return sorted(got), recs, p


def test_remediation_vs_auto_reshard_arbitration(tmp_path):
    """Both want the same barrier: the armed auto reshard owns it and the
    remediation stands down (``arbitration`` skips). Rows equal the
    remediation-free run's, the decisions repeat, and both packages agree on
    rows, the remediation records and the reshard records."""
    pol = [{"name": "split", "slo": "shards", "actuator": "reshard", "target": 0.55,
            "window": 1, "max_applies": 2}]
    got = {}
    for pkg in PKGS:
        out_rem, evs1, p = _sharded(pkg, tmp_path, "arb1", pol)
        out_rem2, evs2, _ = _sharded(pkg, tmp_path, "arb2", pol)
        out_off, evs_off, _ = _sharded(pkg, tmp_path, "arb3", None)
        assert out_rem == out_off and (out_rem2, evs2) == (out_rem, evs1)
        skips = [e for e in evs1 if e["event"] == "remediation_skip"]
        assert skips and all(e["reason"] == "arbitration" for e in skips)
        assert not [e for e in evs1 if e["event"] == "remediation_apply"]
        got[pkg] = (out_rem, evs1, evs_off, sorted(p.shard_report()))
    assert got["port"] == got["jax"]


def test_auto_reshard_gives_the_unsharded_rows(tmp_path):
    """``reshard="auto"`` over a skewed key space (3 keys on 2 shards) plans
    a doubling from the committed loads; the rows equal the unsharded run's
    and the reshard records (the doubling, the no-improvement stop) equal
    the JAX package's."""
    got = {}
    for pkg in PKGS:
        rows, recs, p = _sharded(pkg, tmp_path, "auto", None)
        plain = []
        X[pkg].SupervisedPipeline(_src(pkg, 300, 3), [_op(pkg, 3)],
                                  X[pkg].Sink(_collect(plain), **KW[pkg]), batch_size=20,
                                  **KW[pkg]).run()
        assert rows == sorted(plain) and rows
        got[pkg] = (rows, recs, sorted(p.shard_report()))
    assert got["port"] == got["jax"]
    assert any(r["event"] == "reshard" and r.get("to_shards") == 4 for r in got["port"][1])


def test_remediation_reshard_applies_without_auto(tmp_path):
    """Without ``reshard="auto"`` a remediation reshard owns the barrier: it
    plans through ``recommend_reshard`` and the plan lands at the same
    barrier, as in the JAX package."""
    pol = [{"name": "split", "slo": "shards", "actuator": "reshard", "target": 0.55,
            "window": 1, "max_applies": 1}]
    got = {}
    for pkg in PKGS:
        rows, recs, p = _sharded(pkg, tmp_path, "rem", pol, reshard=None)
        got[pkg] = (rows, recs, p._sharded.rem.state(), sorted(p.shard_report()))
    assert got["port"] == got["jax"]
    assert [r for r in got["port"][1] if r["event"] == "remediation_apply"]


# ------------------------------------------------ live bind sites (SLO engine)

def _live_cfg(pkg, out, actions):
    """Monitoring with the SLO engine on ``drop_ratio`` (a page after two
    violating ticks) and ``actions``; the reporter never ticks by itself
    (the sinks below tick it by hand, once a batch)."""
    if pkg == "jax":
        from windflow_tpu.observability import MonitoringConfig as M
    else:
        M = wt.observability.MonitoringConfig
    spec = {"name": "drops", "signal": "drop_ratio", "target": 0.1, "objective": 0.5,
            "fast_window": 1, "slow_window": 2}
    return M(out_dir=str(out), interval_s=3600.0, slo=[spec], remediation=actions,
             remediation_cooldown_s=3600.0)


def _live_run(pkg, tmp_path, driver, actions, autotune=False):
    """Win_Seq over 20 batches of 20 under admission (a positional bucket of
    half a batch a batch: every other batch shed) through ``driver``, the
    sink ticking the reporter after every delivery. Returns (rows,
    remediation records, the run's monitor)."""
    got, holder = [], {}
    collect = _collect(got)

    def cb(view):
        collect(view)
        if view is not None:
            holder["p"]._monitor.reporter.emit()
    Xm, kw = X[pkg], KW[pkg]
    ctl = CTL[pkg].ControlConfig(autotune=autotune, backpressure=False, admission=True,
                                 refill_per_batch=10.0, burst_tuples=40.0,
                                 decide_every=2, settle_batches=0)
    mon = _live_cfg(pkg, tmp_path / f"{pkg}-{driver}", actions)
    with Journal(pkg, tmp_path / f"{pkg}-{driver}.jsonl") as j:
        if driver == "pipeline":
            p = Xm.Pipeline(_src(pkg, 400, 4), [_op(pkg, 4)], Xm.Sink(cb, **kw),
                            batch_size=20, control=ctl, monitoring=mon, **kw)
        else:
            p = Xm.ThreadedPipeline(_src(pkg, 400, 4), [[_op(pkg, 4)]], Xm.Sink(cb, **kw),
                                    batch_size=20, control=ctl, monitoring=mon, **kw)
        holder["p"] = p
        p.run()
        # the monitor's journal holds the records the engine wrote
        recs = [{k: v for k, v in r.items() if k not in TIMING}
                for r in JOURNAL[pkg].read_journal(
                    str(tmp_path / f"{pkg}-{driver}" / "events.jsonl"))
                if r["event"].startswith(("remediation_", "slo_"))]
    assert not j.records()           # nothing went to the outer journal
    return sorted(got), recs, p._monitor


def test_pipeline_binds_admission_rate_live(tmp_path):
    """``Pipeline.run`` binds ``admission_rate``: the drops SLO pages, the
    action halves the bucket's refill, and the rows, the ``slo_page`` and
    ``remediation_*`` records and the engine's ledger equal the JAX
    package's."""
    action = [{"name": "shed_harder", "slo": "drops", "actuator": "admission_rate",
               "factor": 0.5, "floor": 1.0}]
    got = {}
    for pkg in PKGS:
        rows, recs, mon = _live_run(pkg, tmp_path, "pipeline", action)
        assert mon.remediation.bound() == ["admission_rate"]
        got[pkg] = (rows, recs, mon.remediation.section()["ledger"])
    assert got["port"] == got["jax"]
    applies = [r for r in got["port"][1] if r["event"] == "remediation_apply"]
    assert len(applies) == 1 and applies[0]["rate"] == 5.0
    assert applies[0]["prev_rate"] == 10.0
    assert any(r["event"] == "slo_page" for r in got["port"][1])


def test_pipeline_binds_autotune_reclimb_live(tmp_path):
    """With the capacity autotuner on, ``Pipeline.run`` binds
    ``autotune_reclimb`` too: the page re-climbs the tuner, as in the JAX
    package (the tuner's wall-clock decisions aside)."""
    action = [{"name": "reclimb", "slo": "drops", "actuator": "autotune_reclimb"}]
    got = {}
    for pkg in PKGS:
        _rows, recs, mon = _live_run(pkg, tmp_path, "pipeline", action, autotune=True)
        assert sorted(mon.remediation.bound()) == ["admission_rate", "autotune_reclimb"]
        got[pkg] = [{k: r[k] for k in ("event", "action", "actuator", "applied", "tuners")
                     if k in r} for r in recs if r["event"] == "remediation_apply"]
    assert got["port"] == got["jax"]
    assert got["port"] and got["port"][0]["tuners"] == ["source-pipeline"]


def test_threaded_pipeline_binds_admission_rate_live(tmp_path):
    """``ThreadedPipeline`` binds ``admission_rate``: the drops SLO pages
    and the action halves the bucket, in both packages (where the source
    thread stands when it fires is a matter of timing, so the rows are not
    compared)."""
    action = [{"name": "shed_harder", "slo": "drops", "actuator": "admission_rate",
               "factor": 0.5, "floor": 1.0}]
    got = {}
    for pkg in PKGS:
        _rows, recs, mon = _live_run(pkg, tmp_path, "threaded", action)
        assert mon.remediation.bound() == ["admission_rate"]
        got[pkg] = [{k: r[k] for k in ("event", "action", "actuator", "rate", "prev_rate")}
                    for r in recs if r["event"] == "remediation_apply"]
    assert got["port"] == got["jax"] == [{"event": "remediation_apply",
                                         "action": "shed_harder",
                                         "actuator": "admission_rate", "rate": 5.0,
                                         "prev_rate": 10.0}]

"""The port's control plane (``windflow_tpu_torch/control/`` and the drivers'
``control=``) against the JAX package's, on the CPU.

Mirrors ``tests/test_control.py`` (all but the sweep's adaptive rows, ROADMAP
item 7): the primitives under fake clocks (rebatching, both buckets, both
shed policies, the hill-climb, the tuning cache, the governor), the
controller-on/off byte identity under forced rung switches, the overload
demonstration on the threaded driver, the supervised admission under a
seeded fault plan, and the supervised warm start. Each is run through both
packages with the same calls, and what they decide must agree: the rows, the
control counters and gauges, the journal records (``shed``,
``capacity_switch``, ``tuning_converged``, ``tuning_warm_start``) and the
tuning-cache files, byte for byte (both device kinds are ``cpu:cpu``; the
wall time in an entry is frozen). The wall-clock tuners run on a clock that
advances one second a read, so a window's rate is a function of its batches
and both packages climb the same ladder. Then YSB, Nexmark q3 and the
``graph_windows`` graph through every driver under control.
"""

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import control as jcontrol
from windflow_tpu.benchmarks import ysb as jysb
from windflow_tpu.nexmark import make_query as jmake
from windflow_tpu.observability import journal as jjournal
from windflow_tpu.runtime import faults as jfaults
from windflow_tpu_torch import control as tcontrol
from windflow_tpu_torch.benchmarks import ysb as tysb
from windflow_tpu_torch.nexmark import make_query as tmake
from windflow_tpu_torch.observability import MetricsRegistry
from windflow_tpu_torch.observability import journal as tjournal
from windflow_tpu_torch.runtime import faults as tfaults

CPU = {"device": "cpu"}
PKGS = ("jax", "port")
CTL = {"jax": jcontrol, "port": tcontrol}
JOURNAL = {"jax": jjournal, "port": tjournal}
FAULTS = {"jax": jfaults, "port": tfaults}
X = {"jax": wf, "port": wt}
KW = {"jax": {}, "port": CPU}
#: journal records whose content both packages decide alike
CONTROL_EVENTS = ("shed", "capacity_switch", "tuning_converged", "tuning_warm_start")
TIMING = {"t", "wall", "dur_s", "waited_s"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("WF_CONTROL", "WF_DISPATCH", "WF_DISPATCH_K", "WF_MONITORING",
              "WF_TRACE", "WF_FAULT_PLAN", "WF_SHARDS", "WF_RESHARD", "WF_REMEDIATION"):
        monkeypatch.delenv(k, raising=False)
    for pkg in PKGS:
        CTL[pkg].reset()
        FAULTS[pkg].reset_counters()
        JOURNAL[pkg].set_active(None)
    yield
    for pkg in PKGS:
        CTL[pkg].reset()
        FAULTS[pkg].reset_counters()
        FAULTS[pkg].set_active(None)
        JOURNAL[pkg].set_active(None)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def counting_tuners(monkeypatch):
    """Both packages' drivers build their tuners on a clock that advances one
    second a read: rates become functions of the batches."""
    for ctl in CTL.values():
        class Tuner(ctl.CapacityAutotuner):
            def __init__(self, *a, **kw):
                t = [0.0]

                def clock():
                    t[0] += 1.0
                    return t[0]
                super().__init__(*a, **dict(kw, clock=clock))
        monkeypatch.setattr(ctl, "CapacityAutotuner", Tuner)


@pytest.fixture
def frozen_wall(monkeypatch):
    """The wall time a tuning-cache entry carries, frozen in both packages."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)


def _mkbatch(pkg, n, start=0):
    i = np.arange(start, start + n, dtype=np.int32)
    if pkg == "jax":
        return wf.Batch(key=jnp.asarray(i % 4), id=jnp.asarray(i), ts=jnp.asarray(i),
                        payload={"v": jnp.asarray(i, jnp.float32)},
                        valid=jnp.ones(n, bool))
    t = torch.from_numpy(i)
    return wt.Batch(key=t % 4, id=t.clone(), ts=t.clone(), payload={"v": t.float()},
                    valid=torch.ones(n, dtype=torch.bool))


def _ids(b):
    return np.asarray(b.id).tolist()


class Journal:
    """An event journal active in one package for a block; ``records()`` the
    control records without their timing fields."""

    def __init__(self, pkg, path):
        self.mod = JOURNAL[pkg]
        self.path = str(path)
        self.j = self.mod.EventJournal(self.path)

    def __enter__(self):
        self.mod.set_active(self.j)
        return self

    def __exit__(self, *exc):
        self.mod.set_active(None)
        self.j.close()

    def records(self, kinds=CONTROL_EVENTS):
        return [{k: v for k, v in r.items() if k not in TIMING}
                for r in self.mod.read_journal(self.path) if r["event"] in kinds]


def _state(pkg):
    return CTL[pkg].counters(), CTL[pkg].gauges()


# ---------------------------------------------------------------- primitives

def test_split_concat_roundtrip():
    b = _mkbatch("port", 32)
    parts = wt.split_batch(b, 8)
    jparts = wf.batch.split_batch(_mkbatch("jax", 32), 8)
    assert [p.capacity for p in parts] == [p.capacity for p in jparts] == [8] * 4
    back = parts[0]
    for p in parts[1:]:
        back = wt.concat_batches(back, p)
    for x, y in zip((b.key, b.id, b.ts, b.payload["v"], b.valid),
                    (back.key, back.id, back.ts, back.payload["v"], back.valid)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        wt.split_batch(b, 5)


def test_build_ladder_divisibility_and_bounds():
    for args, kw in (((64,), dict(up=2, down=2)), ((40,), dict(up=1, down=3)),
                     ((24,), dict(up=0, down=5, min_capacity=8)), ((7,), dict(up=0, down=3)),
                     ((64,), dict(up=3, max_capacity=256))):
        assert tcontrol.build_ladder(*args, **kw) == jcontrol.build_ladder(*args, **kw)
    assert tcontrol.build_ladder(64, up=2, down=2) == [16, 32, 64, 128, 256]


@pytest.mark.parametrize("pkg", PKGS)
def test_rebatcher_up_down_and_drain(pkg):
    rb = CTL[pkg].Rebatcher(8)
    b0, b1, b2 = (_mkbatch(pkg, 8, s) for s in (0, 8, 16))
    assert rb.feed(b0) == [b0]
    rb.set_target(16)
    assert rb.feed(b1) == []
    out = rb.feed(b2)
    assert len(out) == 1 and out[0].capacity == 16 and _ids(out[0]) == list(range(8, 24))
    rb.set_target(4)
    assert [o.capacity for o in rb.feed(_mkbatch(pkg, 8, 24))] == [4, 4]
    rb.set_target(16)
    assert rb.feed(_mkbatch(pkg, 8, 32)) == []
    tail = rb.drain()
    assert len(tail) == 1 and tail[0].capacity == 8 and _ids(tail[0]) == list(range(32, 40))
    with pytest.raises(ValueError):
        rb.set_target(12)


def _admission_run(pkg, tmp_path, make, offers):
    with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
        adm, step = make(CTL[pkg])
        out = []
        for n, b in enumerate(offers(pkg)):
            out.append([_ids(x)[0] for x in adm.offer(b, pos=n)])
            step()
        out.append([_ids(x)[0] for x in adm.drain()])
    return out, adm.shed, adm.admitted, _state(pkg), j.records()


def _same_in_both(tmp_path, make, offers):
    got = {pkg: _admission_run(pkg, tmp_path, make, offers) for pkg in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


def test_token_bucket_fake_clock_shed_pattern(tmp_path):
    def make(ctl):
        clk = FakeClock()
        adm = ctl.AdmissionController(ctl.TokenBucket(rate=10.0, burst=20.0, clock=clk),
                                      "drop_newest", driver="t")
        return adm, lambda: clk.advance(0.5)
    out, shed, admitted, (c, _g), recs = _same_in_both(
        tmp_path, make, lambda pkg: [_mkbatch(pkg, 10)] * 6)
    assert [bool(x) for x in out[:-1]] == [True, True, True, False, True, False]
    assert (shed, admitted) == (2, 4)
    assert (c["shed_batches"], c["shed_tuples"], c["admitted_batches"]) == (2, 20, 4)
    assert [r["pos"] for r in recs] == [3, 5]


def test_position_bucket_is_deterministic(tmp_path):
    def make(ctl):
        return ctl.AdmissionController(ctl.PositionBucket(refill_per_batch=6, burst=10),
                                       "drop_newest"), lambda: None
    out, shed, *_ = _same_in_both(tmp_path, make, lambda pkg: [_mkbatch(pkg, 10)] * 8)
    assert shed > 0 and out == _admission_run("port", tmp_path, make,
                                              lambda pkg: [_mkbatch(pkg, 10)] * 8)[0]


def test_drop_oldest_ts_sheds_stale_holds_fresh(tmp_path):
    def make(ctl):
        clk = FakeClock()
        return ctl.AdmissionController(ctl.TokenBucket(rate=0.0, burst=10.0, clock=clk),
                                       "drop_oldest_ts", hold_max=2), lambda: None
    out, shed, *_ = _same_in_both(
        tmp_path, make, lambda pkg: [_mkbatch(pkg, 10, 100 * k) for k in range(4)])
    assert out == [[0], [], [], [], [200, 300]] and shed == 1


def test_admission_state_roundtrip():
    states = {}
    for pkg in PKGS:
        ctl = CTL[pkg]
        adm = ctl.AdmissionController(ctl.PositionBucket(4, 12), "drop_newest")
        for k in range(5):
            adm.offer(_mkbatch(pkg, 8, 8 * k))
        st = adm.state()
        adm2 = ctl.AdmissionController(ctl.PositionBucket(4, 12), "drop_newest")
        adm2.set_state(json.loads(json.dumps(st)))
        a = [bool(adm.offer(_mkbatch(pkg, 8, 99))) for _ in range(6)]
        b = [bool(adm2.offer(_mkbatch(pkg, 8, 99))) for _ in range(6)]
        assert a == b
        states[pkg] = (st, a)
    assert states["port"] == states["jax"]


RATES = {16: 1000.0, 32: 3000.0, 64: 5000.0, 128: 9000.0, 256: 7000.0}


def _drive_tuner(tuner, clk, rates, max_batches=500):
    for _ in range(max_batches):
        cap = tuner.capacity
        clk.advance(cap / rates[cap])
        tuner.on_batch(cap)
        if tuner.converged:
            return
    raise AssertionError("tuner did not converge")


def test_hill_climb_converges_to_best_rung(tmp_path, frozen_wall):
    got = {}
    for pkg in PKGS:
        ctl, clk = CTL[pkg], FakeClock()
        cache = ctl.TuningCache(str(tmp_path / f"{pkg}.json"))
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            tuner = ctl.CapacityAutotuner(sorted(RATES), start_capacity=64, decide_every=4,
                                          settle_batches=1, clock=clk, cache=cache,
                                          cache_key="k1", name="t")
            _drive_tuner(tuner, clk, RATES)
        assert tuner.capacity == 128
        assert tuner.plan()["rates"][128] >= 0.9 * max(tuner.plan()["rates"].values())
        got[pkg] = (tuner.plan(), _state(pkg), j.records(),
                    open(cache.path, "rb").read())
    assert got["port"] == got["jax"]
    assert json.loads(got["port"][3])["k1"]["capacity"] == 128


def test_cache_warm_start_begins_at_optimum(tmp_path):
    got = {}
    for pkg in PKGS:
        ctl = CTL[pkg]
        cache = ctl.TuningCache(str(tmp_path / f"{pkg}.json"))
        cache.put("k1", {"capacity": 128, "tps": 9000.0})
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            tuner = ctl.CapacityAutotuner(sorted(RATES), start_capacity=64, cache=cache,
                                          cache_key="k1")
        assert tuner.converged and tuner.capacity == 128 and tuner.on_batch(128) is None
        got[pkg] = (_state(pkg), j.records())
    assert got["port"] == got["jax"]
    assert got["port"][0][0]["tuning_cache_hits"] == 1


def test_tuner_never_retraces_unknown_rungs():
    seen = {}
    for pkg in PKGS:
        clk = FakeClock()
        tuner = CTL[pkg].CapacityAutotuner([32, 64, 128], start_capacity=32, decide_every=2,
                                           settle_batches=0, clock=clk)
        seen[pkg] = []
        for _ in range(200):
            seen[pkg].append(tuner.capacity)
            clk.advance(1.0)
            tuner.on_batch(tuner.capacity)
            if tuner.converged:
                break
    assert seen["port"] == seen["jax"] and set(seen["port"]) <= {32, 64, 128}


def test_governor_throttles_until_low_watermark(tmp_path):
    gov = tcontrol.BackpressureGovernor(high_watermark=0.5, low_watermark=0.25,
                                        poll_s=0.001)
    depth = [8]
    gov.watch("edge", lambda: depth[0], capacity=8)       # hi=4, lo=2
    released = []

    def drainer():
        time.sleep(0.05)
        depth[0] = 2
        released.append(gov.pause_event.is_set())
    t = threading.Thread(target=drainer)
    with Journal("port", tmp_path / "g.jsonl") as j:
        t.start()
        waited = gov.throttle()
        t.join()
    assert waited > 0 and gov.throttles == 1 and released == [True]
    assert not gov.pause_event.is_set() and gov.throttle() == 0.0
    c, g = _state("port")
    assert c["throttle_events"] == 1 and c["throttle_seconds"] > 0
    assert (g["governor_high_watermark"], g["governor_low_watermark"]) == (0.5, 0.25)
    recs = j.records(("throttle", "throttle_end"))
    assert recs == [{"event": "throttle", "edge": "edge", "depth": 8, "high": 4},
                    {"event": "throttle_end", "edge": "edge"}]


def test_governor_stop_unblocks():
    gov = tcontrol.BackpressureGovernor(high_watermark=0.5, low_watermark=0.25)
    gov.watch("edge", lambda: 8, capacity=8)
    t = threading.Thread(target=gov.throttle)
    t.start()
    time.sleep(0.02)
    gov.stop()
    t.join(timeout=5)
    assert not t.is_alive()


def test_prefetch_pause_event_suspends_worker():
    pulled = [0]

    def it():
        for s in range(20):
            pulled[0] += 1
            yield {"v": np.full(4, s, np.float32)}
    src = wt.GeneratorSource(it, {"v": np.zeros((), np.float32)}, **CPU)
    pause = threading.Event()
    pause.set()
    batches = src.batches_prefetched(4, depth=1, pause_event=pause)
    time.sleep(0.1)
    assert pulled[0] <= 1
    pause.clear()
    assert len(list(batches)) == 20 and pulled[0] == 20


def test_wf_control_env_resolution(monkeypatch, tmp_path):
    for pkg in PKGS:
        C = CTL[pkg].ControlConfig
        monkeypatch.delenv("WF_CONTROL", raising=False)
        assert C.resolve(None) is None and C.resolve(False) is None
        monkeypatch.setenv("WF_CONTROL", "0")
        assert C.resolve(None) is None
        monkeypatch.setenv("WF_CONTROL", "1")
        assert C.resolve(None) == C()
        text = '{"admission": true, "rate_tps": 123.0, "shed_policy": "drop_oldest_ts"}'
        monkeypatch.setenv("WF_CONTROL", text)
        cfg = C.resolve(None)
        assert cfg.rate_tps == 123.0 and cfg.shed_policy == "drop_oldest_ts"
        path = tmp_path / "ctl.json"
        path.write_text(text)
        assert C.resolve(str(path)) == cfg
        with pytest.raises(ValueError):
            C(shed_policy="nope")
        with pytest.raises(ValueError):
            C(high_watermark=0.2, low_watermark=0.5)
    assert dataclasses.asdict(tcontrol.ControlConfig()) == \
        dataclasses.asdict(jcontrol.ControlConfig())


def test_per_edge_queue_capacities_and_exposure():
    src = wt.Source(lambda i: {"v": i.float()}, total=64, **CPU)
    tp = wt.ThreadedPipeline(
        src, [[wt.Map(lambda t: {"v": t.v}, **CPU)], [wt.Map(lambda t: {"v": t.v}, **CPU)]],
        wt.Sink(lambda v: None, **CPU), batch_size=16, pin=False,
        queue_capacity={"src->seg0": 2, "seg1->sink": 32}, **CPU)
    assert tp.edge_names == ["src->seg0", "seg0->seg1", "seg1->sink"]
    assert tp.edge_capacities == {"src->seg0": 2, "seg0->seg1": 8, "seg1->sink": 32}
    tp2 = wt.ThreadedPipeline(src, [[wt.Map(lambda t: {"v": t.v}, **CPU)]], None,
                              batch_size=16, pin=False, queue_capacity=lambda n, i: 4 + i,
                              **CPU)
    assert tp2.edge_capacities == {"src->seg0": 4, "seg0->sink": 5}
    reg = MetricsRegistry("t")
    for name, q in zip(tp2.edge_names, tp2.queues):
        reg.attach_queue_gauge(name, q.size, capacity=tp2.edge_capacities[name])
    snap = reg.snapshot()
    assert snap["queue_capacity"] == tp2.edge_capacities
    assert "windflow_queue_capacity" in reg.to_prometheus(snap)


# ------------------------------------------ regression: byte-identical on/off

TOTAL, K = 240, 3

MP_CASES = {
    "win_seq_tb": lambda X, kw: [X.Win_Seq(lambda wid, it: it.sum("v"),
                                           X.WindowSpec(12, 6, X.win_type_t.TB),
                                           num_keys=K, **kw)],
    "key_ffat_cb": lambda X, kw: [X.Key_FFAT(lambda t: t.v,
                                             jnp.add if X is wf else torch.add,
                                             spec=X.WindowSpec(8, 2, X.win_type_t.CB),
                                             num_keys=K, **kw)],
}


def _lane_rows(out):
    def cb(view):
        if view is None:
            return
        leaves = jax.tree.leaves(view["payload"])
        for i, (k, w) in enumerate(zip(np.asarray(view["key"]).tolist(),
                                       np.asarray(view["id"]).tolist())):
            out.append((k, w) + tuple(round(float(np.asarray(a)[i]), 3) for a in leaves))
    return cb


def _run_mp_case(pkg, make_ops, control, tmp_path=None):
    Xm, kw = X[pkg], KW[pkg]
    f32 = (lambda a: a.astype(jnp.float32)) if pkg == "jax" else (lambda a: a.float())
    src = Xm.Source(lambda i: {"v": f32((i * 13) % 23)}, total=TOTAL, num_keys=K, **kw)
    rows = []
    Xm.Pipeline(src, make_ops(Xm, kw), Xm.Sink(_lane_rows(rows), **kw), batch_size=16,
                control=control, **kw).run()
    return sorted(rows)


@pytest.mark.parametrize("case", sorted(MP_CASES))
def test_controller_on_off_byte_identical(case, tmp_path, counting_tuners, frozen_wall):
    """The rung switches (forced by a tiny decide window) change no result,
    and both packages switch at the same batches: the same records, counters,
    gauges and tuning-cache bytes."""
    got = {}
    for pkg in PKGS:
        off = _run_mp_case(pkg, MP_CASES[case], False)
        CTL[pkg].reset()
        cfg = CTL[pkg].ControlConfig(autotune=True, decide_every=2, settle_batches=0,
                                     admission=False, ladder_up=1, ladder_down=0,
                                     cache_path=str(tmp_path / f"{pkg}.json"))
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            on = _run_mp_case(pkg, MP_CASES[case], cfg)
        assert on == off and off
        got[pkg] = (on, _state(pkg), j.records(), open(cfg.cache_path, "rb").read())
    assert got["port"] == got["jax"]
    assert got["port"][1][0]["capacity_switches"] > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_control_off_is_default_and_inert(pkg):
    Xm, kw = X[pkg], KW[pkg]
    f32 = (lambda a: a.astype(jnp.float32)) if pkg == "jax" else (lambda a: a.float())
    src = Xm.Source(lambda i: {"v": f32(i)}, total=64, **kw)
    p = Xm.Pipeline(src, [Xm.Map(lambda t: {"v": t.v}, **kw)], Xm.Sink(lambda v: None, **kw),
                    batch_size=16, **kw)
    assert p._control is None and p._ladder is None
    p.run()
    assert not any(CTL[pkg].counters().values())


def test_warm_touches_no_state():
    """``CompiledChain.warm`` at every rung leaves the state bytes as they
    were, for a window chain and YSB's chain, after some batches."""
    from windflow_tpu_torch import convert
    for make in (lambda: MP_CASES["win_seq_tb"](wt, CPU), lambda: tysb.make_ops(**CPU)):
        src = (wt.Source(lambda i: {"v": ((i * 13) % 23).float()}, total=64, num_keys=K,
                         **CPU) if len(make()) == 1 else tysb.make_source(320, **CPU))
        chain = wt.CompiledChain(make(), src.payload_spec(), batch_capacity=64, **CPU)
        for b in list(src.batches(16))[:3]:
            chain.push(b)
        before = [jax.tree.leaves(s) for s in convert.chain_states_to_numpy(chain)]
        for c in tcontrol.build_ladder(16, up=2, down=1):
            chain.warm(c)
        after = [jax.tree.leaves(s) for s in convert.chain_states_to_numpy(chain)]
        for a, b in zip(before, after):
            for x, y in zip(a, b):
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        assert {c for _, c in chain._warmed} == {8, 16, 32, 64}


# --------------------------------------- overload: bounded vs pegged backlog

def _overload_run(control):
    got, max_depth = [], [0]
    src = wt.Source(lambda i: {"v": i.float()}, total=50 * 32, **CPU)
    tp = wt.ThreadedPipeline(
        src, [[wt.Map(lambda t: {"v": t.v}, **CPU)]],
        wt.Sink(lambda v: (time.sleep(0.004), got.extend(np.asarray(v["payload"]["v"]).tolist()))
                if v is not None else None, **CPU),
        batch_size=32, pin=False, queue_capacity=8, control=control, **CPU)
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            max_depth[0] = max(max_depth[0], *tp.queue_depths().values())
            time.sleep(0.0005)
    w = threading.Thread(target=watch)
    w.start()
    tp.run()
    stop.set()
    w.join()
    return got, max_depth[0]


def test_overload_bounded_with_control_pegged_without():
    on = wt.ControlConfig(autotune=False, backpressure=True, high_watermark=0.5,
                          low_watermark=0.25, admission=True, rate_tps=3000.0,
                          burst_tuples=64.0)
    got_on, depth_on = _overload_run(on)
    c = tcontrol.counters()
    assert depth_on <= 5, f"rings exceeded the high watermark: {depth_on}"
    assert c["shed_batches"] > 0 and len(got_on) < 50 * 32
    snap = MetricsRegistry("overload").snapshot()
    assert snap["control"]["counters"]["shed_batches"] > 0
    prom = MetricsRegistry("overload").to_prometheus(snap)
    assert "windflow_control_shed_batches_total" in prom
    assert "windflow_control_throttle_events_total" in prom
    tcontrol.reset()
    got_off, depth_off = _overload_run(False)
    assert len(got_off) == 50 * 32 and depth_off > 4
    assert not any(tcontrol.counters().values())


# ----------------------------------------------- chaos: controller x fault plan

def _sup_control(ctl, batch):
    return ctl.ControlConfig(autotune=False, backpressure=False, admission=True,
                             refill_per_batch=0.75 * batch, burst_tuples=2.0 * batch)


def _run_supervised(pkg, faults=None, batch=16):
    Xm, kw = X[pkg], KW[pkg]
    f32 = (lambda a: a.astype(jnp.float32)) if pkg == "jax" else (lambda a: a.float())
    rows = []
    src = Xm.Source(lambda i: {"v": f32(i % 13)}, total=TOTAL, num_keys=4, **kw)
    op = Xm.Win_Seq(lambda wid, it: it.sum("v"), Xm.WindowSpec(10, 10, Xm.win_type_t.TB),
                    num_keys=4, **kw)
    Xm.SupervisedPipeline(src, [op], Xm.Sink(_lane_rows(rows), **kw), batch_size=batch,
                          checkpoint_every=3, max_restarts=8, backoff_base=0.001,
                          backoff_cap=0.01, faults=faults,
                          control=_sup_control(CTL[pkg], batch), **kw).run()
    return sorted(rows)


def _plan(pkg, specs, seed):
    fm = FAULTS[pkg]
    return fm.FaultInjector(fm.FaultPlan([fm.FaultSpec(*s, **k) for s, k in specs],
                                         seed=seed))


def test_supervised_admission_replays_shed_decisions_under_faults():
    """The positional bucket rides the checkpoints: the faulted run's rows
    are the clean run's, in both packages, which also agree on every shed
    decision."""
    specs = [(("source.next",), {"p": 0.06}), (("chain.step",), {"p": 0.10}),
             (("sink.consume",), {"p": 0.10})]
    got = {}
    for pkg in PKGS:
        base = _run_supervised(pkg)
        CTL[pkg].reset()
        faulted = _run_supervised(pkg, _plan(pkg, specs, 11))
        assert faulted == base and base
        got[pkg] = (base, CTL[pkg].counters()["shed_batches"] > 0)
    assert got["port"] == got["jax"] and got["port"][1]


def _graph_ctl(pkg, faults=None):
    Xm, kw = X[pkg], KW[pkg]
    f32 = (lambda a: a.astype(jnp.float32)) if pkg == "jax" else (lambda a: a.float())
    rows = []
    g = Xm.PipeGraph("ctl", batch_size=12, **kw)
    a = g.add_source(Xm.Source(lambda i: {"v": f32(i % 9)}, total=144, num_keys=3,
                               name="a", **kw))
    b = g.add_source(Xm.Source(lambda i: {"v": f32(i % 7)}, total=72, num_keys=3,
                               name="b", **kw))
    (a.merge(b).add(Xm.Map(lambda t: {"v": t.v + 1.0}, **kw))
     .add_sink(Xm.Sink(_lane_rows(rows), **kw)))
    g.run_supervised(checkpoint_every=3, max_restarts=8, backoff_base=0.001,
                     backoff_cap=0.01, faults=faults, control=_sup_control(CTL[pkg], 12))
    return sorted(rows)


def test_graph_supervised_admission_under_faults(tmp_path):
    specs = [(("chain.step",), {"p": 0.08}), (("sink.consume",), {"p": 0.08})]
    got = {}
    for pkg in PKGS:
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            base = _graph_ctl(pkg)
        recs = j.records()
        faulted = _graph_ctl(pkg, _plan(pkg, specs, 5))
        assert faulted == base and base
        got[pkg] = (base, recs)
    assert got["port"] == got["jax"] and got["port"][1]


@pytest.mark.parametrize("pkg", PKGS)
def test_supervised_rejects_nondeterministic_admission(pkg):
    Xm, kw, ctl = X[pkg], KW[pkg], CTL[pkg]
    src = Xm.Source(lambda i: {"v": i}, total=32, **kw)
    with pytest.raises(ValueError, match="refill_per_batch"):
        Xm.SupervisedPipeline(src, [Xm.Map(lambda t: {"v": t.v}, **kw)], batch_size=16,
                              control=ctl.ControlConfig(admission=True, rate_tps=100.0), **kw)
    with pytest.raises(ValueError, match="drop_newest"):
        Xm.SupervisedPipeline(src, [Xm.Map(lambda t: {"v": t.v}, **kw)], batch_size=16,
                              control=ctl.ControlConfig(admission=True, refill_per_batch=8.0,
                                                        shed_policy="drop_oldest_ts"), **kw)


def test_supervised_warm_starts_from_tuning_cache(tmp_path):
    """A plan a live Pipeline persisted is read by the supervised driver: the
    same chain gives the same key in both packages (``cpu:cpu``)."""
    got = {}
    for pkg in PKGS:
        Xm, kw, ctl = X[pkg], KW[pkg], CTL[pkg]
        f32 = (lambda a: a.astype(jnp.float32)) if pkg == "jax" else (lambda a: a.float())
        path = str(tmp_path / f"{pkg}.json")
        src = Xm.Source(lambda i: {"v": f32(i)}, total=64, **kw)
        ops = [Xm.Map(lambda t: {"v": t.v * 2.0}, **kw)]
        key = ctl.tuning_key(ctl.chain_signature(ops), ctl.payload_signature(src.payload_spec()),
                             ctl.device_kind())
        ctl.TuningCache(path).put(key, {"capacity": 32, "tps": 1.0})
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            sp = Xm.SupervisedPipeline(src, ops, batch_size=16,
                                       control=ctl.ControlConfig(autotune=True, cache_path=path),
                                       **kw)
        assert sp.batch_size == 32 and ctl.counters()["tuning_cache_hits"] == 1
        got[pkg] = (key, j.records())
    assert got["port"] == got["jax"]
    assert tcontrol.device_kind() == jcontrol.device_kind() == "cpu:cpu"


# --------------------------------------- YSB, q3 and graph_windows, every driver

YSB_TOTAL, Q3_TOTAL = 1500, 400


def _scenario(pkg, name):
    kw = KW[pkg]
    if name == "ysb":
        y = jysb if pkg == "jax" else tysb
        return y.make_source(YSB_TOTAL, **kw), y.make_ops(**kw), 128
    src, ops = (jmake if pkg == "jax" else tmake)("q3_enrich_join", Q3_TOTAL, **kw)
    return src, ops, 50


def _graph_windows(pkg, cb, control):
    """split (id % 3) -> branches 0 and 1 merged partially (DETERMINISTIC)
    -> CB Win_Seq sum -> Sink; branch 2 into a ReduceSink."""
    Xm, kw = X[pkg], KW[pkg]
    if pkg == "jax":
        from windflow_tpu.operators.source import DeviceSource
        f32, i32 = (lambda a: a.astype(jnp.float32)), (lambda a: a.astype(jnp.int32))
        one = lambda t: jnp.ones((), jnp.int32)  # noqa: E731
    else:
        DeviceSource = wt.DeviceSource
        f32, i32 = (lambda a: a.to(torch.float32)), (lambda a: a.to(torch.int32))
        one = lambda t: torch.ones((), dtype=torch.int32)  # noqa: E731
    g = Xm.PipeGraph("graph_windows", mode=Xm.Mode.DETERMINISTIC, batch_size=32,
                     control=control, **kw)
    mp = g.add_source(DeviceSource(lambda i: {"v": f32(i % 97)}, total=600, num_keys=4,
                                   **kw))
    mp.split(lambda t: i32(t.id % 3), 3)
    b0 = mp.select(0).chain(Xm.Map(lambda t: {"v": t.v + 0.0}, name="b0", **kw))
    b1 = mp.select(1).chain(Xm.Map(lambda t: {"v": t.v * 1.0}, name="b1", **kw))
    mp.select(2).add(Xm.ReduceSink(one, name="rest", **kw))
    b0.merge(b1).add(Xm.Win_Seq(lambda wid, it: it.sum("v"),
                                Xm.WindowSpec(16, 8, Xm.win_type_t.CB), num_keys=4,
                                **kw)).add_sink(Xm.Sink(cb, **kw))
    return g


def _drive(pkg, driver, name, control):
    """Rows (sorted lanes) of one scenario through one driver under
    ``control``."""
    Xm, kw = X[pkg], KW[pkg]
    rows = []
    sink = Xm.Sink(_lane_rows(rows), **kw)
    if name == "graph_windows":
        g = _graph_windows(pkg, _lane_rows(rows), control)
        if driver == "graph_supervised":
            g.run_supervised(checkpoint_every=3, backoff_base=0.0)
        else:
            g.run(threaded=driver == "graph_threaded")
        return sorted(rows)
    src, ops, batch = _scenario(pkg, name)
    if driver == "pipeline":
        Xm.Pipeline(src, ops, sink, batch_size=batch, control=control, **kw).run()
    elif driver == "threaded":
        tkw = {} if pkg == "jax" else {"pin": False, **CPU}
        Xm.ThreadedPipeline(src, [ops], sink, batch_size=batch, control=control,
                            **tkw).run()
    elif driver == "supervised":
        Xm.SupervisedPipeline(src, ops, sink, batch_size=batch, checkpoint_every=3,
                              backoff_base=0.0, control=control, **kw).run()
    else:
        g = Xm.PipeGraph(f"{name}_graph", batch_size=batch, control=control, **kw)
        mp = g.add_source(src)
        for op in ops:
            mp.add(op)
        mp.add_sink(sink)
        if driver == "graph_supervised":
            g.run_supervised(checkpoint_every=3, backoff_base=0.0)
        else:
            g.run(threaded=driver == "graph_threaded")
    return sorted(rows)


def _control(pkg, driver, batch, cache):
    """Admission by the positional bucket in every driver (deterministic);
    with the Pipeline also the capacity ladder, on the counting clock."""
    live = driver in ("pipeline", "threaded", "graph", "graph_threaded")
    return CTL[pkg].ControlConfig(
        autotune=driver == "pipeline", ladder_up=1, ladder_down=1, decide_every=2,
        settle_batches=0, cache_path=cache if driver == "pipeline" else None,
        backpressure=live, high_watermark=0.75, low_watermark=0.25,
        admission=True, refill_per_batch=0.8 * batch, burst_tuples=2.0 * batch)


CASES = ([(d, n) for n in ("ysb", "q3")
          for d in ("pipeline", "threaded", "graph", "graph_threaded", "supervised",
                    "graph_supervised")]
         + [(d, "graph_windows") for d in ("graph", "graph_threaded", "graph_supervised")])


@pytest.mark.parametrize("driver, name", CASES)
def test_driver_under_control_matches_jax(driver, name, tmp_path, counting_tuners,
                                          frozen_wall):
    """Both packages under the same control config: the same rows, shed
    decisions (journal and counters), capacity switches, gauges and (the
    Pipeline's) tuning-cache bytes. Throttles depend on the threads' timing
    and are not compared."""
    batch = {"ysb": 128, "q3": 50, "graph_windows": 32}[name]
    got = {}
    for pkg in PKGS:
        cache = str(tmp_path / f"{pkg}.json")
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            rows = _drive(pkg, driver, name, _control(pkg, driver, batch, cache))
        c, g = _state(pkg)
        c = {k: v for k, v in c.items() if not k.startswith("throttle")}
        # the port's ThreadedPipeline syncs its chains' stats at the end (the
        # JAX one does not), which publishes q3's join-table version
        g = {k: v for k, v in g.items() if k != "join_table_version" or driver != "threaded"}
        got[pkg] = (rows, c, g, j.records(),
                    open(cache, "rb").read() if os.path.exists(cache) else None)
    assert got["port"][0] == got["jax"][0] and got["port"][0]
    assert got["port"][1:] == got["jax"][1:]
    assert got["port"][1]["shed_batches"] > 0
    if driver == "pipeline":
        assert got["port"][1]["capacity_switches"] > 0


def test_pipeline_dispatch_k_and_capacity_tuners_match_jax(tmp_path, counting_tuners,
                                                           frozen_wall):
    """Both tuners at once (the K ladder on ``dispatch={"k": 4}``, the
    capacity ladder): rows equal dispatch off, and both packages take the
    same K and capacity decisions and write the same cache."""
    got = {}
    for pkg in PKGS:
        Xm, kw = X[pkg], KW[pkg]
        src, ops, batch = _scenario(pkg, "ysb")
        base = []
        Xm.Pipeline(src, ops, Xm.Sink(_lane_rows(base), **kw), batch_size=batch, **kw).run()
        CTL[pkg].reset()
        src, ops, batch = _scenario(pkg, "ysb")
        cfg = CTL[pkg].ControlConfig(ladder_up=1, ladder_down=1, decide_every=2,
                                     settle_batches=0, cache_path=str(tmp_path / f"{pkg}.json"))
        rows = []
        with Journal(pkg, tmp_path / f"{pkg}.jsonl") as j:
            Xm.Pipeline(src, ops, Xm.Sink(_lane_rows(rows), **kw), batch_size=batch,
                        control=cfg, dispatch={"k": 4}, **kw).run()
        assert sorted(rows) == sorted(base)
        got[pkg] = (sorted(rows), _state(pkg), j.records(),
                    open(cfg.cache_path, "rb").read())
    assert got["port"] == got["jax"]
    tuners = {r["tuner"] for r in got["port"][2]}
    assert len(tuners) == 2 and any(t.endswith("-dispatch-k") for t in tuners)

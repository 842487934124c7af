"""``windflow_tpu_torch.analysis.validate`` against the JAX package's
``validate``: every scenario of ``tests/test_analysis_validate.py`` is built
in both packages from the same description, and both reports must hold the
same ``(code, severity, where)`` set. Codes with no torch counterpart are
checked the other way (WF102: the JAX package fires, the port is silent).
The port's own checks (WF109 over captured graphs, WF114's K5 geometry,
WF119 on a ``ServingRuntime``, the progcheck hook) are held on their own.

Both packages validate with ``progcheck=False`` in the parity cases: the
device-program audits differ by design (``test_torch_progcheck.py``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.analysis import validate as jvalidate
from windflow_tpu.basic import win_type_t as jwin
from windflow_tpu_torch.analysis import ValidationError
from windflow_tpu_torch.analysis import validate as tvalidate
from windflow_tpu_torch.basic import win_type_t as twin


class _J:
    """The JAX package's spelling of the scenario vocabulary."""
    m, kw, validate, CB, TB = wf, {}, staticmethod(jvalidate), jwin.CB, jwin.TB
    add = staticmethod(jnp.add)
    f32 = staticmethod(lambda x: x.astype(jnp.float32))
    i32 = staticmethod(lambda x: x.astype(jnp.int32))
    ones_i32 = staticmethod(lambda: jnp.ones((), jnp.int32))
    stack = staticmethod(jnp.stack)
    zeros_f32 = staticmethod(lambda: jnp.zeros((), jnp.float32))
    const = staticmethod(lambda v: jnp.asarray(v))          # weakly typed in JAX

    @staticmethod
    def trace(ids):
        from windflow_tpu.observability import TraceConfig
        return TraceConfig(ids=ids)

    @staticmethod
    def serving():
        from windflow_tpu import serving
        from windflow_tpu.observability import MonitoringConfig
        return serving, MonitoringConfig


class _T:
    """The port's spelling of the same vocabulary (every object on the CPU)."""
    m, kw, validate, CB, TB = wt, {"device": "cpu"}, staticmethod(tvalidate), twin.CB, twin.TB
    add = staticmethod(torch.add)
    f32 = staticmethod(lambda x: x.float())
    i32 = staticmethod(lambda x: x.int())
    ones_i32 = staticmethod(lambda: torch.ones((), dtype=torch.int32))
    stack = staticmethod(torch.stack)
    zeros_f32 = staticmethod(lambda: torch.zeros((), dtype=torch.float32, device="meta"))
    const = staticmethod(lambda v: torch.tensor(v))

    @staticmethod
    def trace(ids):
        from windflow_tpu_torch.observability import TraceConfig
        return TraceConfig(ids=ids)

    @staticmethod
    def serving():
        from windflow_tpu_torch import serving
        from windflow_tpu_torch.observability import MonitoringConfig
        return serving, MonitoringConfig


def _src(X, total=200, num_keys=1):
    return X.m.Source(lambda i: {"v": X.f32((i * 13) % 23)}, total=total,
                      num_keys=num_keys, **X.kw)


def _sink(X):
    return X.m.Sink(lambda view: None, **X.kw)


def _map(X, fn):
    return X.m.Map(fn, **X.kw)


def _sig(report):
    return sorted({(d.code, d.severity, d.where) for d in report.diagnostics})


def _both(build, **vkw):
    """Validate ``build(X)`` in both packages: ``(jax report, port report)``;
    ``build`` returns the object or ``(object, extra validate kwargs)``."""
    out = []
    for X in (_J, _T):
        got = build(X)
        obj, extra = got if isinstance(got, tuple) else (got, {})
        out.append(X.validate(obj, progcheck=False, **vkw, **extra))
    return out


def _same(build, **vkw):
    j, t = _both(build, **vkw)
    assert _sig(t) == _sig(j), f"jax:\n{j}\nport:\n{t}"
    return t


# ---------------------------------------------------- positive: repo graphs


def _wordcount(X):
    VOCAB = 50

    def make_words(i):
        return {"w": X.stack([(i * 7) % VOCAB, (i * 13) % VOCAB, (i * 29) % VOCAB])}

    def split_words(t, shipper):
        for j in range(3):
            shipper.push({"word": t.w[j]})

    g = X.m.PipeGraph("wordcount", batch_size=256, **X.kw)
    (g.add_source(X.m.Source(make_words, total=3000, **X.kw))
     .add(X.m.FlatMap(split_words, max_fanout=3, **X.kw))
     .add(_map(X, lambda t: {"one": X.ones_i32(), "word": t.word}))
     .add(X.m.KeyBy(lambda t: t.word, num_keys=VOCAB, **X.kw))
     .add(X.m.Accumulator(lambda t: t.data["one"], init_value=0, num_keys=VOCAB, **X.kw))
     .add_sink(_sink(X)))
    return g


def _ysb(X):
    from windflow_tpu.benchmarks import ysb as jysb
    from windflow_tpu_torch.benchmarks import ysb as tysb
    y = jysb if X is _J else tysb
    return X.m.Pipeline(y.make_source(total=40_000, **X.kw), list(y.make_ops(**X.kw)),
                        _sink(X), batch_size=4096, **X.kw)


def _ckpt_chain(X):
    src = _src(X, total=4000, num_keys=8)
    op = X.m.Key_FFAT(lambda t: t.v, X.add, spec=X.m.WindowSpec(64, 32, X.CB),
                      num_keys=8, **X.kw)
    return X.m.CompiledChain([op], src.payload_spec(), batch_capacity=256, **X.kw)


def _multichip_chain(X):
    src = X.m.Source(lambda i: {"v": X.f32((i * 7) % 31)}, total=8000, num_keys=16, **X.kw)
    op = X.m.Key_FFAT(lambda t: t.v, X.add, spec=X.m.WindowSpec(50, 25, X.TB),
                      num_keys=16, **X.kw)
    return X.m.CompiledChain([op], src.payload_spec(), batch_capacity=512, **X.kw)


def _supervised(X):
    TOT, BATCH, KK = 2000, 100, 4

    def factory(from_batch=0):
        def gen():
            for s in range(from_batch * BATCH, TOT, BATCH):
                ids = np.arange(s, s + BATCH, dtype=np.int32)
                yield ({"v": ((ids * 7) % 31).astype(np.float32)}, ids % KK, ids)
        return gen()

    src = X.m.GeneratorSource(factory, {"v": X.zeros_f32()}, **X.kw)
    op = X.m.Win_Seq(lambda wid, it: it.sum("v"), X.m.WindowSpec(25, 25, X.TB),
                     num_keys=KK, **X.kw)
    return X.m.SupervisedPipeline(src, [op], _sink(X), batch_size=BATCH, **X.kw)


@pytest.mark.parametrize("build", [_wordcount, _ysb, _ckpt_chain, _multichip_chain,
                                   _supervised],
                         ids=["wordcount_graph", "ysb_pipeline", "checkpoint_chain",
                              "multichip_chain", "supervised_pipeline"])
def test_example_topologies_validate_clean_in_both(build):
    """The examples' graphs, built but not run, are clean (no error, no
    warning) in both packages."""
    t = _same(build)
    assert t.ok and not t.warnings, str(t)


#: the mp_test matrix topologies of ``tests/test_mp_matrix.py``, one of each
#: window-pattern family and time base
MP = {
    "win_seq_cb": lambda X, K: X.m.Win_Seq(lambda wid, it: it.sum("v"),
                                           X.m.WindowSpec(8, 4, X.CB), num_keys=K, **X.kw),
    "win_seq_tb": lambda X, K: X.m.Win_Seq(lambda wid, it: it.sum("v"),
                                           X.m.WindowSpec(12, 6, X.TB), num_keys=K, **X.kw),
    "win_farm_cb": lambda X, K: X.m.Win_Farm(lambda wid, it: it.sum("v"),
                                             X.m.WindowSpec(10, 5, X.CB), parallelism=4,
                                             num_keys=K, **X.kw),
    "key_farm_tb": lambda X, K: X.m.Key_Farm(lambda wid, it: it.max("v"),
                                             X.m.WindowSpec(10, 5, X.TB), parallelism=3,
                                             num_keys=K, **X.kw),
    "key_ffat_cb": lambda X, K: X.m.Key_FFAT(lambda t: t.v, X.add,
                                             spec=X.m.WindowSpec(8, 2, X.CB), num_keys=K,
                                             **X.kw),
    "key_ffat_tb": lambda X, K: X.m.Key_FFAT(lambda t: t.v, X.add,
                                             spec=X.m.WindowSpec(10, 5, X.TB), num_keys=K,
                                             **X.kw),
    "pane_farm_tb": lambda X, K: X.m.Pane_Farm(lambda pid, it: it.sum("v"),
                                               lambda wid, it: it.sum(),
                                               X.m.WindowSpec(12, 4, X.TB), num_keys=K,
                                               **X.kw),
    "wmr_cb": lambda X, K: X.m.Win_MapReduce(lambda wid, it: it.sum("v"),
                                             lambda wid, it: it.sum(),
                                             X.m.WindowSpec(8, 8, X.CB), map_parallelism=2,
                                             num_keys=K, **X.kw),
}


@pytest.mark.parametrize("case", sorted(MP))
def test_mp_matrix_topologies_validate_in_both(case):
    t = _same(lambda X: X.m.Pipeline(_src(X, total=240, num_keys=3), [MP[case](X, 3)],
                                     _sink(X), batch_size=48, **X.kw))
    assert t.ok, f"{case}:\n{t}"


def test_threaded_pipeline_with_window_keeps_its_geometry():
    """Validation flows specs only: the bound segment chains keep the window
    archive their construction chose."""
    wins = {}

    def build(X):
        win = X.m.Win_Seq(lambda wid, it: it.sum("v"), X.m.WindowSpec(12, 6, X.TB),
                          num_keys=3, **X.kw)
        tp = X.m.ThreadedPipeline(_src(X, total=192, num_keys=3),
                                  [[_map(X, lambda t: {"v": t.v + 1.0})], [win]],
                                  _sink(X), batch_size=32, control=False, **X.kw)
        wins[X] = (win, win.A)
        return tp
    t = _same(build)
    assert t.ok, str(t)
    for win, a in wins.values():
        assert win.A == a


def test_split_merge_graph_validates_clean():
    def build(X):
        g = X.m.PipeGraph("diamond", batch_size=64, **X.kw)
        mp = g.add_source(_src(X, total=400))
        mp.add(_map(X, lambda t: {"v": t.v + 1.0}))
        mp.split(lambda t: X.i32(t.data["v"] > 10.0), 2)
        b0 = mp.select(0).add(_map(X, lambda t: {"v": t.v * 2.0}))
        b1 = mp.select(1).add(_map(X, lambda t: {"v": t.v * 3.0}))
        b0.merge(b1).add(X.m.Filter(lambda t: t.v > 0.0, **X.kw)).add_sink(_sink(X))
        return g
    t = _same(build)
    assert t.ok and not t.warnings, str(t)


# ------------------------------------------------- negative: each code fires


def test_wf100_empty_graph_and_unknown_object():
    t = _same(lambda X: X.m.PipeGraph("empty", **X.kw))
    assert [d.code for d in t.errors] == ["WF100"]
    t = _same(lambda X: object())
    assert [d.code for d in t.errors] == ["WF100"]


def test_wf101_spec_mismatch_between_chained_operators():
    def build(X):
        g = X.m.PipeGraph("broken", batch_size=64, **X.kw)
        (g.add_source(_src(X))
         .add(_map(X, lambda t: {"x": t.v * 2.0}))
         .add(_map(X, lambda t: {"y": t.v + 1.0}))
         .add_sink(_sink(X)))
        return g
    t = _same(build)
    [err] = t.errors
    assert err.code == "WF101" and "ops[1]" in err.where and "payload" in err.hint


def test_wf101_bad_split_function():
    def build(X):
        g = X.m.PipeGraph("badsplit", batch_size=64, **X.kw)
        mp = g.add_source(_src(X))
        mp.split(lambda t: X.i32(t.data["nope"] > 0), 2)
        for i in range(2):
            mp.select(i).add_sink(_sink(X))
        return g
    t = _same(build)
    assert any(d.code == "WF101" and ".split" in d.where for d in t.errors)


def test_wf102_fires_in_jax_and_cannot_fire_in_the_port():
    """A scalar constant payload leaf is weakly typed in JAX (WF102); torch
    has no weak types, so the port's report holds everything else and no
    WF102. (A bare Python float, the JAX test's leaf, is no tensor for
    ``torch.func.vmap``: the port rejects it as WF101.)"""
    def build(X):
        g = X.m.PipeGraph("weak", batch_size=64, **X.kw)
        (g.add_source(_src(X)).add(_map(X, lambda t: {"v": t.v, "c": X.const(1.0)}))
         .add_sink(_sink(X)))
        return g
    j, t = _both(build)
    assert "WF102" in j.codes() and "WF102" not in t.codes()
    assert _sig(t) == [s for s in _sig(j) if s[0] != "WF102"]
    assert t.ok


def test_wf103_fault_sites():
    def threaded(X):
        plan = X.m.FaultPlan([{"site": "checkpoint.save", "at": [1]}])
        return (X.m.ThreadedPipeline(_src(X), [[_map(X, lambda t: {"v": t.v})]], _sink(X),
                                     batch_size=32, control=False, **X.kw),
                {"faults": plan})
    t = _same(threaded)
    [d] = [d for d in t.diagnostics if d.code == "WF103"]
    assert d.severity == "warning" and "checkpoint.save" in d.message

    def supervised(X):
        plan = X.m.FaultPlan([{"site": "checkpoint.save", "at": [1]}])
        return (X.m.Pipeline(_src(X), [_map(X, lambda t: {"v": t.v})], _sink(X),
                             batch_size=32, control=False, **X.kw),
                {"faults": plan, "supervised": True})
    assert "WF103" not in _same(supervised).codes()

    def unparseable(X):
        return (X.m.Pipeline(_src(X), [_map(X, lambda t: {"v": t.v})], _sink(X),
                             batch_size=32, control=False, **X.kw),
                {"faults": '{"faults": [{"site": "not.a.site"}]}'})
    [d] = [d for d in _same(unparseable).diagnostics if d.code == "WF103"]
    assert d.severity == "error"


def _tp(X, **kw):
    return X.m.ThreadedPipeline(_src(X), [[_map(X, lambda t: {"v": t.v})]], _sink(X),
                                batch_size=32, **X.kw, **kw)


def test_wf104_ring_watermarks():
    def tiny(X):
        return _tp(X, queue_capacity=1,
                   control=X.m.ControlConfig(backpressure=True, autotune=False))
    hits = [d for d in _same(tiny).diagnostics if d.code == "WF104"]
    assert hits and all("capacity 1" in d.message for d in hits)

    def roomy(X):
        return _tp(X, queue_capacity=8,
                   control=X.m.ControlConfig(backpressure=True, autotune=False))
    assert "WF104" not in _same(roomy).codes()

    def badcap(X):
        g = X.m.PipeGraph("badcap", batch_size=64, queue_capacity=0, **X.kw)
        g.add_source(_src(X)).add_sink(_sink(X))
        return g
    [d] = [d for d in _same(badcap, threaded=True).diagnostics if d.code == "WF104"]
    assert d.severity == "error" and "queue_capacity" in d.where
    assert _same(badcap).ok, "push-driver validation must not check rings"


def test_wf105_wall_clock_bucket_under_supervision():
    def p(X):
        return X.m.Pipeline(_src(X), [_map(X, lambda t: {"v": t.v})], _sink(X),
                            batch_size=32, control=False, **X.kw)

    def wall(X):
        return X.m.ControlConfig(admission=True, rate_tps=100.0, autotune=False,
                                 backpressure=False)

    def det(X):
        return X.m.ControlConfig(admission=True, refill_per_batch=32.0, autotune=False,
                                 backpressure=False)
    [d] = _same(lambda X: (p(X), {"control": wall(X), "supervised": True})).errors
    assert d.code == "WF105"
    assert _same(lambda X: (p(X), {"control": det(X), "supervised": True})).ok
    assert _same(lambda X: (p(X), {"control": wall(X)})).ok


def test_wf106_prefetch_exceeds_ring():
    t = _same(lambda X: _tp(X, queue_capacity=4, prefetch=16, control=False))
    [d] = [d for d in t.diagnostics if d.code == "WF106"]
    assert "16" in d.message and d.severity == "warning"


def test_wf107_dangling_branch_and_reduce_sink_terminal():
    def dangle(X):
        g = X.m.PipeGraph("dangle", batch_size=64, **X.kw)
        mp = g.add_source(_src(X))
        mp.split(lambda t: X.i32(t.data["v"] > 3), 2)
        mp.select(0).add_sink(_sink(X))
        mp.select(1).add(_map(X, lambda t: {"v": t.v}))
        return g
    [d] = [d for d in _same(dangle).diagnostics if d.code == "WF107"]
    assert d.severity == "warning"

    def reduce(X):
        g = X.m.PipeGraph("reduce", batch_size=64, **X.kw)
        g.add_source(_src(X)).add(X.m.ReduceSink(lambda t: t.v, name="total", **X.kw))
        return g
    assert "WF107" not in _same(reduce).codes()


def test_raise_if_errors_and_json_roundtrip():
    g = wt.PipeGraph("broken", batch_size=64, device="cpu")
    g.add_source(_src(_T)).add(_map(_T, lambda t: {"y": t.nope})).add_sink(_sink(_T))
    report = tvalidate(g)
    with pytest.raises(ValidationError) as ei:
        report.raise_if_errors()
    assert "WF101" in str(ei.value) and ei.value.report is report
    j = json.loads(json.dumps(tvalidate(wt.PipeGraph("empty", device="cpu")).to_json()))
    assert j["diagnostics"][0]["code"] == "WF100" and j["target"].startswith("PipeGraph")


# ----------------------------------------------------------- WF110 dispatch


def _dp(X, **kw):
    return X.m.Pipeline(_src(X), [_map(X, lambda t: {"v": t.v})], _sink(X), batch_size=32,
                        **X.kw, **kw)


def test_wf110_sequence_ids_with_dispatch_under_supervision():
    t = _same(lambda X: (_dp(X, dispatch=4), {"supervised": True,
                                              "trace": X.trace("sequence")}))
    assert {"WF108", "WF110"} <= set(t.codes())
    assert "WF110" not in _same(lambda X: (_dp(X, dispatch=4), {
        "supervised": True, "trace": X.trace("position")})).codes()
    assert "WF110" not in _same(lambda X: (_dp(X, dispatch=4),
                                           {"trace": X.trace("sequence")})).codes()


def test_wf110_wall_clock_admission_with_dispatch_under_supervision():
    def cfg(X, **kw):
        return X.m.ControlConfig(admission=True, autotune=False, backpressure=False, **kw)
    t = _same(lambda X: (_dp(X, dispatch=8), {"control": cfg(X, rate_tps=50.0),
                                              "supervised": True}))
    assert {"WF105", "WF110"} <= set(t.codes())
    assert "WF110" not in _same(lambda X: (_dp(X, dispatch=8), {
        "control": cfg(X, refill_per_batch=32.0), "supervised": True})).codes()


def test_wf110_k_exceeds_ring_capacity_warns():
    hits = [d for d in _same(lambda X: _tp(X, queue_capacity=4, dispatch=16,
                                           control=False)).diagnostics
            if d.code == "WF110"]
    assert hits and all(d.severity == "warning" for d in hits)
    assert "WF110" not in _same(lambda X: _tp(X, queue_capacity=8, dispatch=4,
                                              control=False)).codes()


def test_wf110_unresolvable_config_k1_and_explicit_override():
    [d] = [d for d in _same(lambda X: _dp(X, dispatch={"k": -2})).diagnostics
           if d.code == "WF110"]
    assert d.severity == "error" and "resolve" in d.message
    assert "WF110" not in _same(lambda X: (_dp(X, dispatch=1),
                                           {"supervised": True})).codes()
    t = _same(lambda X: (_dp(X), {"supervised": True, "dispatch": {"k": 16},
                                  "control": X.m.ControlConfig(
                                      admission=True, rate_tps=10.0, autotune=False,
                                      backpressure=False)}))
    assert "WF110" in t.codes()


# ------------------------------------------------------ the port's own checks


def test_wf109_names_the_captured_graph_that_keeps_a_stale_kernel(monkeypatch):
    """A graph captured under one selection keeps replaying it: after the
    selection changes, WF109 names that graph."""
    from windflow_tpu_torch.ops import registry

    class Graph:
        name = "chain:0:k4:c64"
    g = Graph()
    registry.reset_records()
    monkeypatch.delenv("WF_KERNEL_IMPL", raising=False)
    with registry.capturing(g):
        registry.resolve_impl("lookup", spec_key="C64xK10:int32", device="cpu")
    monkeypatch.setenv("WF_KERNEL_IMPL", "lookup=cuda")
    p = _dp(_T)
    [d] = [d for d in tvalidate(p, progcheck=False).diagnostics if d.code == "WF109"]
    assert d.where == "kernel[lookup]" and "chain:0:k4:c64" in d.message
    monkeypatch.delenv("WF_KERNEL_IMPL")
    assert "WF109" not in tvalidate(p, progcheck=False).codes()
    registry.reset_records()


def test_wf114_names_k5s_shared_memory_table():
    """A tiered join whose hot table outgrows K5's shared-memory table warns
    with the port's kernel geometry; a table that fits is silent."""
    from windflow_tpu_torch.nexmark import queries as q
    from windflow_tpu_torch.ops.lookup import JOIN_PROBE_SMEM_SLOTS

    def report(slots):
        src, ops = q.q3_enrich_join(4096, n_auctions=slots, num_slots=slots,
                                    tiered=dict(), device="cpu")
        return tvalidate(wt.Pipeline(src, ops, _sink(_T), batch_size=64, device="cpu"),
                         progcheck=False)
    big = [d for d in report(JOIN_PROBE_SMEM_SLOTS).diagnostics if d.code == "WF114"]
    assert [d.severity for d in big] == ["warning"]
    assert "JOIN_PROBE_SMEM_SLOTS" in big[0].message
    assert "WF114" not in report(512).codes()


def test_serving_runtime_checks_its_swap_graphs_and_config(tmp_path):
    """A ServingRuntime is a Pipeline to the spec flow, plus WF101 on every
    registered swap graph and WF119 over its resolved serving config
    (construction refuses a fatal one, so it is changed after)."""
    import dataclasses

    def build(X):
        serving, MonitoringConfig = X.serving()
        rt = serving.ServingRuntime(
            _src(X), [_map(X, lambda t: {"v": t.v})], _sink(X), batch_size=32,
            serving=serving.ServingConfig(endpoint="tcp://127.0.0.1:0"),
            monitoring=MonitoringConfig(out_dir=str(tmp_path)), **X.kw)
        return rt
    t = _same(build)
    assert t.target == "ServingRuntime" and t.ok and not t.warnings, str(t)

    def broken(X):
        rt = build(X)
        rt.register_graph("bad", [_map(X, lambda t: {"y": t.nope})])
        rt.config = dataclasses.replace(rt.config, swap_warm=False)
        return rt
    t = _same(broken)
    assert ("WF101", "error", "serving.graph[bad].ops[0]:map") in _sig(t)
    assert "WF119" in t.codes()


def test_progcheck_hook_reports_a_host_read(monkeypatch):
    """validate() appends progcheck's WF302 for a KeyedMap that reads its
    multiplicity on the host; WF_PROGCHECK=0 and progcheck=False skip it."""
    def p():
        km = wt.KeyedMap(lambda t, s: ({"v": t.v + s}, s + t.v), 0.0, num_keys=4,
                         device="cpu")
        return wt.Pipeline(_src(_T, num_keys=4), [km], _sink(_T), batch_size=32,
                           device="cpu")
    monkeypatch.delenv("WF_PROGCHECK", raising=False)
    [d] = [d for d in tvalidate(p()).diagnostics if d.code == "WF302"]
    assert d.severity == "warning" and "map_keyed" in d.message
    monkeypatch.setenv("WF_PROGCHECK", "0")
    assert "WF302" not in tvalidate(p()).codes()
    monkeypatch.delenv("WF_PROGCHECK")
    assert "WF302" not in tvalidate(p(), progcheck=False).codes()

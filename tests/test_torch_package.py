"""Package-level guarantees of the port.

- ``import windflow_tpu_torch`` (and every module of the slice) loads neither
  JAX nor any module of ``windflow_tpu``;
- the entry points default to ``"cuda"`` and raise without CUDA, instead of
  carrying on silently on the CPU;
- the kernel registry names every ported kernel, its source and the Pallas
  function it replaces, and counts launches only in the kernel wrappers;
- every name the JAX package exports at its top level is exported by the
  port, or listed as unported with its ROADMAP item.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.benchmarks import ysb
from windflow_tpu_torch.ops import registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ["windflow_tpu_torch", "windflow_tpu_torch.benchmarks.ysb",
           "windflow_tpu_torch.convert", "windflow_tpu_torch.ops.cuda",
           "windflow_tpu_torch.ops.histogram", "windflow_tpu_torch.ops.lookup",
           "windflow_tpu_torch.ops.segment", "windflow_tpu_torch.ops.bitonic",
           "windflow_tpu_torch.operators.join", "windflow_tpu_torch.operators.rank",
           "windflow_tpu_torch.observability.names", "windflow_tpu_torch.nexmark",
           "windflow_tpu_torch.nexmark.generators", "windflow_tpu_torch.nexmark.queries",
           "windflow_tpu_torch.nexmark.oracles", "windflow_tpu_torch.ops.window_reduce",
           "windflow_tpu_torch.operators.window", "windflow_tpu_torch.operators.win_seq",
           "windflow_tpu_torch.operators.win_patterns", "windflow_tpu_torch.meta",
           "windflow_tpu_torch.runtime.dispatch", "windflow_tpu_torch.runtime.graphs",
           "windflow_tpu_torch.benchmarks", "windflow_tpu_torch.runtime.pipegraph",
           "windflow_tpu_torch.runtime.builders", "windflow_tpu_torch.runtime.async_sink",
           "windflow_tpu_torch.parallel", "windflow_tpu_torch.parallel.ordering",
           "windflow_tpu_torch.parallel.emitters", "windflow_tpu_torch.ops.compaction",
           "windflow_tpu_torch.shipper", "windflow_tpu_torch.stats",
           "windflow_tpu_torch.benchmarks.keyed", "windflow_tpu_torch.operators.accumulator",
           "windflow_tpu_torch.operators.flatmap", "windflow_tpu_torch.native",
           "windflow_tpu_torch.runtime.threaded", "windflow_tpu_torch.runtime.handoff",
           "windflow_tpu_torch.operators.session", "windflow_tpu_torch.runtime.faults",
           "windflow_tpu_torch.runtime.checkpoint", "windflow_tpu_torch.runtime.supervisor",
           "windflow_tpu_torch.observability", "windflow_tpu_torch.observability.journal",
           "windflow_tpu_torch.state", "windflow_tpu_torch.state.host_store",
           "windflow_tpu_torch.state.tiered", "windflow_tpu_torch.ops.cold_probe",
           "windflow_tpu_torch.benchmarks.tiered", "windflow_tpu_torch.control",
           "windflow_tpu_torch.observability.event_time",
           "windflow_tpu_torch.observability.tracing",
           "windflow_tpu_torch.observability.device_health",
           "windflow_tpu_torch.observability.metrics",
           "windflow_tpu_torch.observability.reporter",
           "windflow_tpu_torch.observability.topology",
           "windflow_tpu_torch.control.autotune", "windflow_tpu_torch.control.admission",
           "windflow_tpu_torch.control.governor", "windflow_tpu_torch.control.remediation",
           "windflow_tpu_torch.control.config", "windflow_tpu_torch.ops.registry",
           "windflow_tpu_torch.observability.slo", "windflow_tpu_torch.observability.fleet",
           "windflow_tpu_torch.observability.profiling", "windflow_tpu_torch.serving",
           "windflow_tpu_torch.serving.framing", "windflow_tpu_torch.serving.tenants",
           "windflow_tpu_torch.serving.config", "windflow_tpu_torch.serving.sources",
           "windflow_tpu_torch.serving.runtime", "windflow_tpu_torch.analysis",
           "windflow_tpu_torch.analysis.validate", "windflow_tpu_torch.analysis.lint",
           "windflow_tpu_torch.analysis.concurrency", "windflow_tpu_torch.analysis.progcheck",
           "windflow_tpu_torch.analysis.perfgate", "windflow_tpu_torch.examples",
           "windflow_tpu_torch.examples.ysb_windows", "windflow_tpu_torch.examples.wordcount",
           "windflow_tpu_torch.examples.checkpoint_resume",
           "windflow_tpu_torch.examples.multichip",
           "windflow_tpu_torch.examples.recovery_and_backpressure",
           "windflow_tpu_torch.examples.serving"]


def test_import_loads_no_jax_and_no_jax_package():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'windflow_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_pipeline_defaults_to_cuda_and_raises_without_it(no_cuda):
    src = ysb.make_source(1000, device="cpu")
    ops = ysb.make_ops(device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        wt.Pipeline(src, ops, batch_size=256)
    with pytest.raises(RuntimeError, match="cuda"):
        wt.CompiledChain(ops, src.payload_spec(), batch_capacity=256)
    with pytest.raises(RuntimeError, match="cuda"):
        ysb.make_source(1000)
    with pytest.raises(RuntimeError, match="cuda"):
        ysb.make_ops()
    assert wt.resolve_device("cpu") == torch.device("cpu")


def test_chain_refuses_operators_on_another_device():
    src = ysb.make_source(1000, device="cpu")
    ops = ysb.make_ops(device="cpu")
    ops[1].device = torch.device("meta")
    with pytest.raises(ValueError, match="one device"):
        wt.CompiledChain(ops, src.payload_spec(), batch_capacity=256, device="cpu")


def test_registry_names_every_kernel_and_cpu_runs_launch_none():
    assert set(registry.tpu_kernels()) == {"histogram", "lookup", "segment_fold",
                                           "ordering_merge", "join_probe",
                                           "masked_window_reduce"}
    # the helpers replace no TPU kernel: the fixed-order float fold, the
    # tiered state's cold reads (the probe and the archive tier's fetch) and
    # the upkeep of the store's index mirror they walk
    assert set(registry.KERNELS) - set(registry.tpu_kernels()) == {"segment_fold_float",
                                                                    "cold_probe",
                                                                    "cold_fetch",
                                                                    "cold_scatter"}
    for k in registry.KERNELS.values():
        assert os.path.isfile(os.path.join(REPO, k.source)), k.source
    for k in registry.tpu_kernels().values():
        path, line = k.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            src = f.read().splitlines()[int(line) - 1]
        # the line defines the Pallas function (``_pallas_fast``, ``_join_probe_pallas``)
        assert src.startswith("def _") and "pallas" in src.split("(")[0], src
    registry.reset_launches()
    results = []
    wt.Pipeline(ysb.make_source(2000, device="cpu"), ysb.make_ops_sum(device="cpu"),
                wt.Sink(results.append, device="cpu"), batch_size=512,
                device="cpu").run()
    assert results[-1] is None and len(results) > 1
    # the CPU path runs the plain versions: no kernel launched
    assert set(registry.launch_counts().values()) == {0}


def test_unported_paths_raise(monkeypatch):
    """The multi-host slice helper (item 14) gives the single-process
    slice; the control plane runs;
    the supervised run, unsharded (item 12), sharded on one device (item 14)
    and under ``control=``, gives the plain run's result,
    the interval join's tiered archive (item 13b) builds, and fault
    injection and item 9's operators build."""
    def graph():
        g = wt.PipeGraph(device="cpu")
        g.add_source(wt.Source(lambda i: {"v": i}, total=10, device="cpu")).add(
            wt.ReduceSink(lambda t: t.v, name="tot", device="cpu"))
        return g
    assert int(graph().run_supervised(backoff_base=0.0)["tot"]) == int(graph().run()["tot"])
    assert int(graph().run_supervised(shards=2, backoff_base=0.0)["tot"]) == \
        int(graph().run()["tot"])
    assert int(graph().run_supervised(control=True, backoff_base=0.0)["tot"]) == \
        int(graph().run()["tot"])
    from windflow_tpu_torch.parallel import multihost
    assert multihost.process_shard_slice(4) == (0, 4)
    with monkeypatch.context() as m:
        m.setenv("WF_SHARDS", "2")
        assert int(graph().run_supervised(backoff_base=0.0)["tot"]) == \
            int(graph().run()["tot"])
    src = wt.Source(lambda i: {"v": i}, total=10, device="cpu")
    assert wt.IntervalJoin(lambda t: t.side == 1, 0, 4, tiered=True,
                           device="cpu").tier_controllers() == ()
    assert wt.ThreadedPipeline(src, [], None, device="cpu", control=True)._control
    from windflow_tpu_torch.runtime.faults import FaultPlan
    assert wt.ThreadedPipeline(src, [], None, device="cpu", faults=FaultPlan())
    assert isinstance(wt.FlatMap_Builder(lambda t, shipper: None).withMaxFanout(2)
                      .withDevice("cpu").build(), wt.FlatMap)
    assert wt.Key_FFAT(lambda t: t.v, torch.maximum,
                       spec=wt.WindowSpec(10, 10, wt.win_type_t.TB), device="cpu")


def test_nexmark_cpu_run_launches_no_kernel():
    """q3, q6 and q7 reach K5 and K4 on the card; on the CPU they run the
    plain versions, so the launch counts stay at zero."""
    from windflow_tpu_torch.nexmark import make_query
    registry.reset_launches()
    for name in ("q3_enrich_join", "q6_topn", "q7_distinct"):
        src, ops = make_query(name, 300, device="cpu")
        wt.Pipeline(src, ops, wt.Sink(lambda v: None, device="cpu"), batch_size=64,
                    device="cpu").run()
    assert set(registry.launch_counts().values()) == {0}


def test_nexmark_unported_paths_raise(no_cuda, tmp_path):
    """Every query builds on the CPU and needs CUDA by default; tiered state
    builds, q4's interval join archive (item 13b) included, and event-time
    monitoring builds the operators with lateness histograms; the SLO engine
    runs a monitored q3, and profile-on-page without it raises the JAX
    package's ValueError (WF120)."""
    from windflow_tpu_torch.nexmark import PORTED, QUERIES, make_query
    assert set(PORTED) == set(QUERIES)
    for q in ("q3_enrich_join", "q4_interval_join", "q5_session", "q6_topn",
              "q7_distinct"):
        make_query(q, 100, tiered=True, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            make_query(q, 100)
        make_query(q, 100, device="cpu")
    src, ops = make_query("q3_enrich_join", 100, device="cpu")
    p = wt.Pipeline(src, ops, batch_size=32, device="cpu", event_time=True)
    p.run()
    join = [st for st in p.chain.states if isinstance(st, dict) and "lat_hist" in st]
    assert len(join) == 1 and int(join[0]["lat_hist"].sum()) > 0
    src, ops = make_query("q3_enrich_join", 100, device="cpu")
    chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=32, device="cpu",
                             event_time=True)
    assert any(isinstance(st, dict) and "lat_hist" in st for st in chain.states)
    out = str(tmp_path / "mon")
    src, ops = make_query("q3_enrich_join", 100, device="cpu")
    wt.Pipeline(src, ops, batch_size=32, device="cpu",
                monitoring=wt.observability.MonitoringConfig(out_dir=out, slo=True)).run()
    with open(os.path.join(out, "snapshot.json")) as f:
        assert set(json.load(f)["slo"]) >= {"latency_e2e", "drops"}
    with pytest.raises(ValueError, match="WF120"):
        wt.Pipeline(src, ops, batch_size=32, device="cpu",
                    monitoring=wt.observability.MonitoringConfig(out_dir=out,
                                                                 profile=True)).run()


def _pallas_functions():
    """``file:line`` of the ``def`` of every function of the JAX package whose
    own body calls ``pl.pallas_call``, read from the source text (no import)."""
    found = set()
    root = os.path.join(REPO, "windflow_tpu")
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for fn in ast.walk(tree):
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                nested = {id(n) for inner in ast.walk(fn) if inner is not fn and
                          isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef))
                          for n in ast.walk(inner)}
                if any(isinstance(n, ast.Attribute) and n.attr == "pallas_call"
                       and id(n) not in nested for n in ast.walk(fn)):
                    found.add(f"{os.path.relpath(path, REPO)}:{fn.lineno}")
    return found


def test_registry_covers_every_tpu_kernel():
    """Every function of the JAX package that reaches ``pl.pallas_call`` has a
    registered hand kernel that names it by the line of its ``def``."""
    pallas = _pallas_functions()
    assert len(pallas) == 6, sorted(pallas)
    assert {k.replaces for k in registry.tpu_kernels().values()} == pallas


def test_state_exports_match_the_jax_package():
    """``windflow_tpu_torch.state`` exports the names ``windflow_tpu.state``
    exports (the top level of either package exports none of them)."""
    import windflow_tpu.state as jstate
    import windflow_tpu_torch.state as tstate
    assert tstate.__all__ == jstate.__all__ == ["HostStore", "TierConfig", "TieredTable"]
    for n in jstate.__all__:
        assert hasattr(tstate, n), n


def test_window_operators_default_to_cuda_and_raise_without_it(no_cuda):
    """The window slice's entry points resolve ``device=None`` to the card
    too: without CUDA they raise instead of running on the CPU."""
    spec = wt.WindowSpec(6, 2)
    sum_v = lambda wid, it: it.sum("v")  # noqa: E731
    for make in (lambda: wt.Win_Seq(sum_v, spec),
                 lambda: wt.Key_Farm(sum_v, spec),
                 lambda: wt.Win_Farm(sum_v, spec),
                 lambda: wt.Pane_Farm(sum_v, lambda wid, it: it.sum(), spec),
                 lambda: wt.Win_MapReduce(sum_v, lambda wid, it: it.sum(), spec),
                 lambda: ysb.make_ops_wmr()):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


#: names ``windflow_tpu/__init__.py`` imports that the port does not export
#: yet, each with the ROADMAP Queue 1 item that will port it (none left)
UNPORTED_EXPORTS = {}


def _jax_package_exports():
    """Every name ``windflow_tpu/__init__.py`` binds by import, read from its
    source with ``ast`` (the JAX package is not imported)."""
    path = os.path.join(REPO, "windflow_tpu", "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Import):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
    return names


def test_top_level_exports_match_the_jax_package():
    """Each name the JAX package exports at its top level is an attribute of
    the port's package (no unported name is left): the recovery names
    (checkpoints, fault plans, the supervisor, the journal) and the mesh
    names are exported."""
    names = _jax_package_exports()
    missing = sorted(n for n in names if not hasattr(wt, n) and n not in UNPORTED_EXPORTS)
    assert not missing, f"exported by windflow_tpu, missing from the port: {missing}"
    stale = sorted(n for n in UNPORTED_EXPORTS if hasattr(wt, n) or n not in names)
    assert not stale, f"listed as unported but exported or not a JAX export: {stale}"
    assert not UNPORTED_EXPORTS
    for n in ("save_chain", "load_chain", "CheckpointCorrupt", "FaultPlan", "FaultSpec",
              "FaultInjector", "InjectedFault", "WatchdogTimeout", "DeadLetterQueue",
              "SupervisedPipeline", "RestartExhausted", "EventJournal", "read_journal",
              "ShardedChain", "shard_batch", "make_mesh", "make_mesh_2d"):
        assert n in names and hasattr(wt, n), n


def test_f17_building_a_chain_runs_every_function_on_the_meta_device():
    """F17: the operators' spec probes (``out_spec``, the source's
    ``payload_spec``) run the user functions abstractly, on the meta device,
    as the JAX package's ``jax.eval_shape`` does: building a chain runs no
    function on a real device (on the card it launches no kernel) and
    records no kernel resolution. Pushing a batch then runs them on the
    chain's device."""
    seen = []

    def rec(x):
        seen.append(x.device.type)
        return x

    cpu = {"device": "cpu"}
    src = wt.Source(lambda i: {"v": rec((i % 7).float())}, total=64, num_keys=2, **cpu)
    ops = [wt.Map(lambda t: {"v": rec(t.v) * 2.0}, **cpu),
           wt.Filter(lambda t: rec(t.v) > 1.0, **cpu),
           wt.Accumulator(lambda t: rec(t.v), init_value=0.0, num_keys=2, **cpu),
           wt.Win_Seq(lambda wid, it: rec(it.sum()), wt.WindowSpec(4, 4), num_keys=2,
                      **cpu)]
    registry.reset_records()
    chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=16, **cpu)
    assert seen and set(seen) == {"meta"}, seen
    assert registry.trace_records() == {}
    seen.clear()
    chain.push(next(iter(src.batches(16))))
    assert set(seen) == {"cpu"}, seen


def test_f17_an_op_without_a_meta_kernel_probes_on_the_cpu():
    """An op with no meta kernel (here a library op with a CPU kernel only)
    makes the probe run again on the CPU with the plain versions, never on
    the card; a function that reads a value fails the probe, as under
    ``jax.eval_shape``."""
    from windflow_tpu_torch.batch import abstract_spec
    lib = torch.library.Library("wf_f17_probe", "DEF")
    lib.define("twice(Tensor x) -> Tensor")
    lib.impl("twice", lambda x: x * 2, "CPU")
    seen = []

    def fn(p):
        seen.append(p["v"].device.type)
        return {"v": torch.ops.wf_f17_probe.twice(p["v"])}
    op = wt.BatchMap(fn, device="cpu")
    spec = op.out_spec({"v": torch.empty((3,), dtype=torch.float32, device="meta")})
    assert seen == ["meta", "cpu"]
    assert spec["v"].device.type == "meta" and tuple(spec["v"].shape) == (3,)
    with pytest.raises(RuntimeError, match="meta"):
        abstract_spec(lambda dev: torch.zeros((1,), device=dev).sum().item())

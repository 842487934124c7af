"""Package-level guarantees of the port.

- ``import windflow_tpu_torch`` (and every module of the slice) loads neither
  JAX nor any module of ``windflow_tpu``;
- the entry points default to ``"cuda"`` and raise without CUDA, instead of
  carrying on silently on the CPU;
- the kernel registry names every ported kernel, its source and the Pallas
  function it replaces, and counts launches only in the kernel wrappers.
"""

import ast
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
           "windflow_tpu_torch.shipper", "windflow_tpu_torch.stats"]


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
    assert set(registry.KERNELS) - set(registry.tpu_kernels()) == {"segment_fold_float"}
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


def test_unported_paths_raise():
    from windflow_tpu_torch.ops.lookup import table_lookup
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        wt.Key_FFAT(lambda t: t.v, torch.maximum,
                    spec=wt.WindowSpec(10, 10, wt.win_type_t.TB), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(10, 10),
                    device="cpu").init_state({})
    with pytest.raises(NotImplementedError):
        table_lookup(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int32))
    g = wt.PipeGraph(device="cpu")
    g.add_source(wt.Source(lambda i: {"v": i}, total=10, device="cpu")).add(
        wt.ReduceSink(lambda t: t.v, device="cpu"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        g.run(threaded=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        wt.FlatMap_Builder(lambda t, shipper: None).withMaxFanout(2).build()


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


def test_nexmark_unported_paths_raise(no_cuda):
    from windflow_tpu_torch.nexmark import make_query
    for q in ("q4_interval_join", "q5_session"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            make_query(q, 100, device="cpu")
    for q in ("q3_enrich_join", "q6_topn", "q7_distinct"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            make_query(q, 100, tiered=True, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            make_query(q, 100)
    src, ops = make_query("q3_enrich_join", 100, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        wt.Pipeline(src, ops, batch_size=32, device="cpu", event_time=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        wt.CompiledChain(ops, src.payload_spec(), batch_capacity=32, device="cpu",
                         event_time=True)


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

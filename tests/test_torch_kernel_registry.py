"""The port's kernel registry (``windflow_tpu_torch/ops/registry.py``)
against the JAX package's (``windflow_tpu/ops/registry.py``), on the CPU.

Mirrors ``tests/test_kernel_registry.py``'s selection tests (precedence,
``WF_KERNEL_IMPL`` grammar, the deprecated aliases, tuning-cache warm
starts, trace records, no silencing by re-resolution) over the port's impl
names (``torch``, the plain version; ``cuda``, the hand kernel), and holds
the port's op entry points against the JAX package's on the same inputs:
the same spec keys and trace records (``xla`` read as ``torch``), the same
tuning-cache file bytes, the same results whatever the selection. A CUDA
operand is faked where a test needs the card's default (``device_kind``
stubbed): the kernels themselves run only on the card (``chip_smoke.py``).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu.control.autotune import TuningCache as JTuningCache
from windflow_tpu.ops import bitonic as jbitonic  # noqa: F401 — registrations
from windflow_tpu.ops import registry as jregistry
from windflow_tpu.ops.histogram import keyed_pane_histogram as jhist
from windflow_tpu.ops.lookup import join_probe as jprobe
from windflow_tpu.ops.lookup import table_lookup as jlookup
from windflow_tpu.ops.segment import segment_fold as jfold
from windflow_tpu_torch.control.autotune import TuningCache
from windflow_tpu_torch.observability import names as tnames
from windflow_tpu_torch.ops import registry
from windflow_tpu_torch.ops.histogram import keyed_pane_histogram
from windflow_tpu_torch.ops.lookup import join_probe, table_lookup
from windflow_tpu_torch.ops.segment import segment_fold
from windflow_tpu_torch.parallel.ordering import Ordering_Node

ENV = ("WF_KERNEL_IMPL", "WF_HISTOGRAM_IMPL", "WF_LOOKUP_IMPL")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    registry.reset_records()
    jregistry.REGISTRY.reset_records()
    yield
    registry.reset_records()
    jregistry.REGISTRY.reset_records()


def _mini_registry():
    r = registry.KernelRegistry()
    for k in ("histogram", "lookup"):
        r.register_kernel(k, "torch", reference=True)
        r.register_kernel(k, "cuda", devices=("cuda",))
    return r


# ------------------------------------------------------------------ selection

def test_default_is_reference_on_the_cpu():
    r = _mini_registry()
    assert r.resolve_impl("histogram", device="cpu") == "torch"
    assert r.reference_impl("histogram") == "torch"


def test_default_is_the_hand_kernel_on_the_card(monkeypatch):
    """The standing difference: the JAX default is its reference; the port's
    is the hand kernel for an operand on the card."""
    monkeypatch.setattr(registry, "device_kind", lambda dev=None: "gpu:fake")
    r = _mini_registry()
    assert r.resolve_impl("histogram", device="cuda") == "cuda"
    assert r.trace_records() == {("histogram", "", "gpu:fake"): frozenset({"cuda"})}


def test_explicit_impl_wins_over_env(monkeypatch):
    monkeypatch.setenv("WF_KERNEL_IMPL", "histogram=cuda")
    r = _mini_registry()
    assert r.resolve_impl("histogram", impl="torch", device="cpu") == "torch"


def test_env_per_kernel_beats_global(monkeypatch):
    monkeypatch.setattr(registry, "device_kind", lambda dev=None: "gpu:fake")
    monkeypatch.setenv("WF_KERNEL_IMPL", "torch,histogram=cuda")
    r = _mini_registry()
    assert r.resolve_impl("histogram", device="cuda") == "cuda"
    assert r.resolve_impl("lookup", device="cuda") == "torch"


def test_env_off_values_mean_no_override(monkeypatch):
    for off in ("", "0"):
        monkeypatch.setenv("WF_KERNEL_IMPL", off)
        assert _mini_registry().resolve_impl("histogram", device="cpu") == "torch"


def test_deprecated_alias_still_honored(monkeypatch):
    monkeypatch.setattr(registry, "device_kind", lambda dev=None: "gpu:fake")
    monkeypatch.setenv("WF_HISTOGRAM_IMPL", "torch")
    r = _mini_registry()
    assert r.resolve_impl("histogram", device="cuda") == "torch"
    monkeypatch.setenv("WF_KERNEL_IMPL", "histogram=cuda")     # outranks the alias
    assert r.resolve_impl("histogram", device="cuda") == "cuda"
    monkeypatch.delenv("WF_KERNEL_IMPL")
    for off in ("", "0"):
        monkeypatch.setenv("WF_HISTOGRAM_IMPL", off)
        assert r.resolve_impl("histogram", device="cuda") == "cuda"
    monkeypatch.setenv("WF_LOOKUP_IMPL", "torch")
    assert r.resolve_impl("lookup", device="cuda") == "torch"


def test_unknown_kernel_and_impl_raise():
    """An unknown kernel, an unknown impl and the JAX package's impl names
    raise ValueError listing the port's impls, as the JAX registry does."""
    r = _mini_registry()
    with pytest.raises(ValueError, match="unknown kernel"):
        r.resolve_impl("typo_kernel", device="cpu")
    for name in ("xla", "pallas", "pallas_mm", "triton"):
        with pytest.raises(ValueError, match="registered impls: cuda, torch"):
            r.resolve_impl("histogram", impl=name, device="cpu")
    with pytest.raises(ValueError, match="unknown impl name"):
        r.register_kernel("histogram", "xla")


def test_cuda_on_a_cpu_tensor_raises(monkeypatch):
    """``cuda`` for an operand off the card raises, from every source of the
    choice: it never falls back to the plain version."""
    r = _mini_registry()
    with pytest.raises(ValueError, match="not cpu"):
        r.resolve_impl("histogram", impl="cuda", device="cpu")
    monkeypatch.setenv("WF_KERNEL_IMPL", "cuda")
    with pytest.raises(ValueError, match="not cpu"):
        r.resolve_impl("histogram", device="cpu")
    k, p, v = (torch.zeros(8, dtype=torch.int32),) * 2 + (torch.ones(8, dtype=torch.bool),)
    monkeypatch.delenv("WF_KERNEL_IMPL")
    with pytest.raises(ValueError, match="not cpu"):
        keyed_pane_histogram(k, p, v, 2, 4, impl="cuda")
    with pytest.raises(ValueError, match="not cpu"):
        table_lookup(torch.arange(4), k, impl="cuda")
    with pytest.raises(ValueError, match="not cpu"):
        segment_fold(k, k, v, 2, impl="cuda")
    with pytest.raises(ValueError, match="not cpu"):
        join_probe(k, k, k, v, impl="cuda")
    with pytest.raises(ValueError, match="not cpu"):
        Ordering_Node(2, device="cpu", merge_impl="cuda")


def test_tuning_cache_warm_start_and_file_bytes(tmp_path, monkeypatch):
    """``persist_winner``, then a fresh registry on the same cache resolves
    the winner; the cache file is byte for byte the JAX package's (both
    device kinds ``cpu:cpu``, ``xla`` read as ``torch``)."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    paths = {p: str(tmp_path / f"{p}.json") for p in ("jax", "port")}
    jr = jregistry.KernelRegistry()
    jr.register_kernel("histogram", "xla", reference=True, default=True)
    jr.register_kernel("histogram", "pallas")
    jr.attach_tuning_cache(JTuningCache(paths["jax"]))
    jr.persist_winner("histogram", "C1024", "xla", tps=1e8)
    r = _mini_registry()
    r.attach_tuning_cache(TuningCache(paths["port"]))
    r.persist_winner("histogram", "C1024", "torch", tps=1e8, device="cpu")
    jtext = open(paths["jax"]).read()
    assert open(paths["port"]).read() == jtext.replace('"xla"', '"torch"')
    r2 = _mini_registry()
    r2.attach_tuning_cache(TuningCache(paths["port"]))
    monkeypatch.setattr(registry, "device_kind",
                        lambda dev=None: "cpu:cpu" if str(dev) == "cpu" else "gpu:fake")
    assert r2.resolve_impl("histogram", spec_key="C1024", device="cpu") == "torch"
    # a winner written for the card: its key holds the card's device kind
    r2.persist_winner("histogram", "C2048", "torch", device="cuda")
    assert r2.resolve_impl("histogram", spec_key="C2048", device="cuda") == "torch"
    assert r2.resolve_impl("histogram", spec_key="C4096", device="cuda") == "cuda"
    monkeypatch.setenv("WF_KERNEL_IMPL", "histogram=cuda")   # env outranks the cache
    assert r2.resolve_impl("histogram", spec_key="C2048", device="cuda") == "cuda"


def test_explicit_impl_not_recorded():
    r = _mini_registry()
    r.resolve_impl("histogram", spec_key="s", impl="torch", device="cpu")
    assert r.trace_records() == {}
    r.resolve_impl("histogram", spec_key="s", device="cpu")
    assert list(r.trace_records().values()) == [frozenset({"torch"})]


def test_stale_selection_not_silenced_by_re_resolution(monkeypatch):
    """Records keep every impl a key resolved: a resolution after an env
    change does not hide the earlier one (a captured graph may still replay
    it), the same entries as the JAX registry's with ``xla`` read as
    ``torch`` and ``pallas`` as ``cuda``."""
    monkeypatch.setattr(registry, "device_kind", lambda dev=None: "cpu:cpu")
    r = _mini_registry()
    r.register_kernel("histogram", "cuda", devices=("cpu", "cuda"))   # a CPU-run stand-in
    jr = jregistry.KernelRegistry()
    jr.register_kernel("histogram", "xla", reference=True, default=True)
    jr.register_kernel("histogram", "pallas")
    r.resolve_impl("histogram", spec_key="s", device="cpu")
    jr.resolve_impl("histogram", spec_key="s")
    monkeypatch.setenv("WF_KERNEL_IMPL", "histogram=cuda")
    r.resolve_impl("histogram", spec_key="s", device="cpu")
    monkeypatch.setenv("WF_KERNEL_IMPL", "histogram=pallas")
    jr.resolve_impl("histogram", spec_key="s")
    monkeypatch.setenv("WF_KERNEL_IMPL", "histogram=cuda")
    [rec] = r.stale_selections()
    monkeypatch.setenv("WF_KERNEL_IMPL", "histogram=pallas")
    [jrec] = jr.stale_selections()
    assert rec == dict(jrec, recorded="torch", current="cuda")
    assert "graphs" not in rec


def test_memoized_resolution_follows_env_and_cache(tmp_path, monkeypatch):
    """A repeated resolution is a memo hit, and an env change or a newly
    persisted winner is seen at the next call."""
    monkeypatch.setattr(registry, "device_kind", lambda dev=None: "gpu:fake")
    r = _mini_registry()
    assert r.resolve_impl("lookup", spec_key="k", device="cuda") == "cuda"
    n = len(r._memo)
    assert r.resolve_impl("lookup", spec_key="k", device="cuda") == "cuda"
    assert len(r._memo) == n
    monkeypatch.setenv("WF_LOOKUP_IMPL", "torch")
    assert r.resolve_impl("lookup", spec_key="k", device="cuda") == "torch"
    monkeypatch.delenv("WF_LOOKUP_IMPL")
    r.attach_tuning_cache(TuningCache(str(tmp_path / "t.json")))
    r.persist_winner("lookup", "k", "torch", device="cuda")
    assert r.resolve_impl("lookup", spec_key="k", device="cuda") == "torch"


def test_capture_keeps_its_selection_and_is_reported_stale(monkeypatch):
    """A capture keeps the resolutions made while capturing; after the
    selection changes, ``stale_selections`` names the graph, and the
    graph's own launch counts (what a replay adds) stay those captured."""
    monkeypatch.setattr(registry, "device_kind", lambda dev=None: "gpu:fake")
    r = _mini_registry()
    monkeypatch.setattr(registry, "REGISTRY", r)

    class Graph:
        name = "chain:0:k2:c64"
    g = Graph()
    with registry.capturing(g):
        r.resolve_impl("histogram", spec_key="C64", device="cuda")
    assert g.selections == {("histogram", "C64", "gpu:fake"): "cuda"}
    assert r.stale_selections() == []
    monkeypatch.setenv("WF_KERNEL_IMPL", "torch")
    [rec] = r.stale_selections()
    assert rec["graphs"] == ["chain:0:k2:c64"]
    assert (rec["recorded"], rec["current"]) == ("cuda", "torch")
    del g
    import gc
    gc.collect()
    [rec] = r.stale_selections()                 # the record stays, the graph went
    assert "graphs" not in rec


def test_global_registry_covers_names_registry():
    """Every family of ``names.py::KERNELS`` (the JAX registry's) registers
    the port's two impls, ``torch`` the reference."""
    assert set(tnames.KERNELS) == set(registry.REGISTRY.kernels())
    assert registry.IMPLS == tnames.KERNEL_IMPLS
    for k in tnames.KERNELS:
        assert registry.REGISTRY.impls(k) == ("cuda", "torch")
        assert registry.REGISTRY.reference_impl(k) == "torch"
    assert set(registry.REGISTRY.kernels()) == set(jregistry.REGISTRY.kernels())


# ------------------------------------------------- the op entry points vs JAX

def _inputs(seed=0, C=2048, K=12):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, K, C).astype(np.int32)
    pane = rng.integers(0, 9, C).astype(np.int32)
    valid = rng.random(C) < 0.8
    return key, pane, valid


def _records(r, mapping):
    return {k: frozenset(mapping.get(i, i) for i in v) for k, v in r.trace_records().items()}


def test_entry_points_record_the_jax_spec_keys():
    """The five families through the same calls in both packages: equal
    results, and equal trace records (kernel, spec key, device kind) with
    ``xla`` read as ``torch``."""
    key, pane, valid = _inputs()
    tk, tp, tv = map(torch.from_numpy, (key, pane, valid))
    jk, jp, jv = map(jnp.asarray, (key, pane, valid))
    got = keyed_pane_histogram(tk, tp, tv, 12, 8)
    want = jhist(jk, jp, jv, 12, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keyed_pane_histogram(tk[:100], tp[:100], tv[:100], 12, 8)   # not a chunk multiple
    jhist(jk[:100], jp[:100], jv[:100], 12, 8)
    table = np.arange(300, dtype=np.float32) * 0.5
    idx = np.random.default_rng(1).integers(-5, 310, 2048).astype(np.int32)
    np.testing.assert_array_equal(
        table_lookup(torch.from_numpy(table), torch.from_numpy(idx)).numpy(),
        np.asarray(jlookup(jnp.asarray(table), jnp.asarray(idx))))
    vals = np.random.default_rng(2).integers(-1000, 1000, 2048).astype(np.int32)
    np.testing.assert_array_equal(
        segment_fold(torch.from_numpy(vals), tk, tv, 12).numpy(),
        np.asarray(jfold(jnp.asarray(vals), jk, jv, 12)))
    fvals = vals.astype(np.float32)
    segment_fold(torch.from_numpy(fvals), tk, tv, 12)
    jfold(jnp.asarray(fvals), jk, jv, 12)
    tkeys = np.arange(64, dtype=np.int32) * 3
    tvals = np.arange(64, dtype=np.int32) + 7
    probe = np.random.default_rng(3).integers(0, 200, 2048).astype(np.int32)
    tvv, thit = join_probe(torch.from_numpy(tkeys), torch.from_numpy(tvals),
                           torch.from_numpy(probe), tv)
    jvv, jhit = jprobe(jnp.asarray(tkeys), jnp.asarray(tvals), jnp.asarray(probe), jv)
    np.testing.assert_array_equal(tvv.numpy(), np.asarray(jvv))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    from windflow_tpu.basic import ordering_mode_t as jmode
    from windflow_tpu.parallel.ordering import Ordering_Node as JOrdering_Node
    from windflow_tpu_torch.basic import ordering_mode_t
    Ordering_Node(2, ordering_mode_t.TS, device="cpu")
    JOrdering_Node(2, jmode.TS)
    port = _records(registry.REGISTRY, {})
    jax_ = _records(jregistry.REGISTRY, {"xla": "torch"})
    assert port == jax_
    assert {k[0] for k in port} == set(tnames.KERNELS)
    assert all(k[2] == "cpu:cpu" for k in port)


def test_forced_impl_gives_the_same_results_and_no_launch(monkeypatch):
    """Under ``WF_KERNEL_IMPL=torch`` (and the aliases) the entry points give
    the default's results on the CPU and launch no kernel."""
    key, pane, valid = _inputs(4)
    tk, tp, tv = map(torch.from_numpy, (key, pane, valid))
    base = keyed_pane_histogram(tk, tp, tv, 12, 8)
    registry.reset_launches()
    monkeypatch.setenv("WF_KERNEL_IMPL", "torch")
    assert torch.equal(keyed_pane_histogram(tk, tp, tv, 12, 8), base)
    monkeypatch.setenv("WF_KERNEL_IMPL", "histogram=torch,lookup=torch")
    assert torch.equal(keyed_pane_histogram(tk, tp, tv, 12, 8, impl="torch"), base)
    assert set(registry.launch_counts().values()) == {0}
    monkeypatch.setenv("WF_KERNEL_IMPL", "xla")
    with pytest.raises(ValueError, match="registered impls: cuda, torch"):
        keyed_pane_histogram(tk, tp, tv, 12, 8)


def test_ordering_node_resolves_once_with_the_jax_spec_key():
    """``Ordering_Node`` resolves ``ordering_merge`` once (spec key
    ``mode=<mode>``), as the JAX node does at construction."""
    from windflow_tpu_torch.basic import ordering_mode_t
    node = Ordering_Node(3, ordering_mode_t.ID, device="cpu")
    assert node.merge_impl == "torch"
    assert registry.trace_records() == {("ordering_merge", "mode=ID", "cpu:cpu"):
                                        frozenset({"torch"})}

"""The port's hermetic perf gate (``windflow_tpu_torch/analysis/
perfgate.py``): ``compare()`` gives the JAX package's findings on the same
dicts, the repo gate is green against the port's checked-in pins (logical
costs of the traced steps: aten ops, bytes, FLOPs), proxy rows cover every
registered kernel family, the dispatch counts show one program per K
batches, and the CLI follows the 0/1/2 exit contract. Device-free: every
number here is traced over fake tensors or timed on the CPU."""

import copy
import json
import math
import os

import pytest

from windflow_tpu.analysis import perfgate as jperfgate
from windflow_tpu_torch.analysis import perfgate
from windflow_tpu_torch.observability.names import KERNELS, PERF_PROXY_FAMILIES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def measurement():
    """ONE measurement shared by the module (proxy reps kept minimal)."""
    return perfgate.measure(reps=1)


def test_repo_gate_green_against_checked_in_baseline(measurement):
    base = perfgate.load_baseline(perfgate.baseline_path(ROOT))
    findings = perfgate.compare(measurement, base)
    assert findings == [], json.dumps(findings, indent=1)
    assert base["torch"]                       # the pins name their torch version


def test_measurement_shape(measurement):
    names = set(perfgate.WORKLOADS) | set(perfgate.SCAN_WORKLOADS) | {"reshard_pack"}
    assert set(measurement["workloads"]) == names
    for name in perfgate.WORKLOADS:
        row = measurement["workloads"][name]
        assert row["aten_ops"] > 0 and row["bytes_accessed"] > 0 and row["flops"] >= 0
        assert row["capacity"] == perfgate.WORKLOAD_CAPACITY[name]


def test_proxy_covers_every_registered_family(measurement):
    assert set(measurement["proxy"]) == set(KERNELS + PERF_PROXY_FAMILIES)
    for row in measurement["proxy"].values():
        assert row["ns_per_elem"] > 0
    pruned = {"workloads": measurement["workloads"],
              "proxy": {k: v for k, v in measurement["proxy"].items() if k != "lookup"}}
    assert [f["workload"] for f in perfgate.compare(pruned, pruned)
            if f["kind"] == "proxy-coverage"] == ["lookup"]


def test_scan_program_is_k_chain_steps(measurement):
    """The K-step program holds the K chain steps unrolled (plus the stacking
    of the K batches): about K times the single chain step."""
    scan = measurement["workloads"]["ysb_scan_k8"]
    single = perfgate.chain_step_cost("ysb")
    assert scan["k"] == 8 and scan["capacity"] == single["capacity"]
    assert 8 * single["aten_ops"] <= scan["aten_ops"] <= 8 * single["aten_ops"] * 1.1


# -------------------------------------------------- compare() semantics


def _synth():
    current = {"workloads": {"ysb": {"flops": 1000.0, "bytes_accessed": 500.0,
                                     "capacity": 2048}}}
    return current, copy.deepcopy(current)


def _regression(c, b):
    c["workloads"]["ysb"]["flops"] *= 1.10


def _inside_rtol(c, b):
    c["workloads"]["ysb"]["flops"] *= 1.01


def _stale_pin(c, b):
    c["workloads"]["ysb"]["bytes_accessed"] *= 0.80


def _unpinned_and_stale(c, b):
    c["workloads"]["nexmark"] = {"flops": 1.0, "bytes_accessed": 1.0, "capacity": 64}
    del b["workloads"]["ysb"]
    b["workloads"]["retired"] = {"flops": 2.0, "bytes_accessed": 2.0, "capacity": 64}


def _capacity_drift(c, b):
    c["workloads"]["ysb"]["capacity"] = 4096


def _k_drift(c, b):
    c["workloads"]["ysb"]["k"] = 16
    b["workloads"]["ysb"]["k"] = 8


def _proxy(c, b):
    c["proxy"] = {k: {"ns_per_elem": 100.0, "elems": 1} for k in KERNELS + PERF_PROXY_FAMILIES}
    b["proxy"] = {"histogram": {"ns_per_elem": 10.0}}


def _proxy_pruned(c, b):
    _proxy(c, b)
    del c["proxy"]["dispatch"]


@pytest.mark.parametrize("edit", [_regression, _inside_rtol, _stale_pin, _unpinned_and_stale,
                                  _capacity_drift, _k_drift, _proxy, _proxy_pruned])
@pytest.mark.parametrize("strict", [False, True])
def test_compare_equals_the_jax_packages_compare(edit, strict):
    c, b = _synth()
    edit(c, b)

    def facts(findings):                    # every field but the message's wording
        return [{k: v for k, v in f.items() if k != "message"} for f in findings]
    got = perfgate.compare(copy.deepcopy(c), copy.deepcopy(b), strict_proxy=strict)
    assert facts(got) == facts(jperfgate.compare(c, b, strict_proxy=strict))
    assert facts(perfgate.compare(c, None)) == facts(jperfgate.compare(c, None))


# ------------------------------------------------------ the instruments


def test_dispatch_launch_counts_one_program_per_group():
    for k, n in ((8, 20), (3, 7), (1, 5)):
        row = perfgate.dispatch_launch_counts(k=k, capacity=128, n_batches=n)
        assert row["batches"] == n and row["launches"] == math.ceil(n / k), row
        assert row["aten_ops"] > 0


def test_stage_costs_rows_per_operator():
    chain, _step, cap = perfgate.WORKLOADS["mp_matrix"]()
    rows = perfgate.stage_costs(chain, cap)
    assert [r["op"] for r in rows] == [op.getName() for op in chain.ops]
    for row in rows:
        assert "error" not in row and row["aten_ops"] > 0 and row["bytes_accessed"] > 0
    assert rows[0]["capacity"] == cap


# --------------------------------------------------------- CLI contract


@pytest.fixture
def one_workload(monkeypatch):
    """The gate over the YSB step alone, so each CLI call measures quickly."""
    monkeypatch.setattr(perfgate, "WORKLOADS", {"ysb": perfgate.WORKLOADS["ysb"]})
    monkeypatch.setattr(perfgate, "SCAN_WORKLOADS", {})
    monkeypatch.setenv("WF_PERFGATE_BASELINE", "")


def test_cli_update_then_green_then_regression(tmp_path, one_workload, monkeypatch, capsys):
    bpath = tmp_path / "perfgate_baseline.json"
    monkeypatch.setenv("WF_PERFGATE_BASELINE", str(bpath))
    assert perfgate.main(["--update-baseline", "--skip-proxy"]) == 0
    assert perfgate.main(["--skip-proxy"]) == 0
    doc = json.loads(bpath.read_text())
    for row in doc["workloads"].values():
        row["aten_ops"] *= 0.5
    bpath.write_text(json.dumps(doc))
    assert perfgate.main(["--skip-proxy"]) == 1
    assert "regression" in capsys.readouterr().out


def test_cli_exit_2_on_missing_explicit_baseline(tmp_path, one_workload, capsys):
    assert perfgate.main(["--skip-proxy", "--baseline", str(tmp_path / "typo.json")]) == 2
    assert "internal error" in capsys.readouterr().err

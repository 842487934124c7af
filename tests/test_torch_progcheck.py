"""The port's device-program analyzer (``windflow_tpu_torch/analysis/
progcheck.py``): ``torch.fx`` graphs of the chains' steps traced over fake
tensors under the registry's plain selection. WF300, WF302 and WF305 fire
on minimal programs; the fingerprint is stable across processes, blind to
object addresses and sensitive to constant values; a baseline entry without
a rationale fails the gate; the repo's audit targets are clean against the
checked-in baseline; ``validate(progcheck=...)`` and ``WF_PROGCHECK``
behave as in the JAX package."""

import json
import os
import subprocess
import sys

import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.analysis import progcheck as pc
from windflow_tpu_torch.analysis import validate
from windflow_tpu_torch.ops import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}


def _src(num_keys=3):
    return wt.Source(lambda i: {"v": ((i * 13) % 23).float()}, total=480,
                     num_keys=num_keys, **CPU)


def _chain(ops, cap=48, num_keys=3):
    return wt.CompiledChain(ops, _src(num_keys).payload_spec(), batch_capacity=cap, **CPU)


def _ffat_cb():
    return wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(8, 2, wt.win_type_t.CB),
                       num_keys=3, **CPU)


def _codes(findings):
    return sorted({f.code for f in findings})


@pytest.fixture(scope="module")
def repo_gate():
    """ONE trace of every audit target against the checked-in baseline."""
    return pc.progcheck_repo(ROOT)


def test_repo_audit_targets_clean_against_the_baseline(repo_gate):
    fresh, suppressed, problems = repo_gate
    assert not fresh, "\n".join(x.render() for x in fresh)
    assert not problems
    assert {x.code for x in suppressed} <= {"WF300", "WF305"}


def test_every_baseline_entry_still_matches_and_carries_a_rationale(repo_gate):
    _fresh, suppressed, _problems = repo_gate
    counts, problems = pc.load_baseline(pc.baseline_path(ROOT))
    assert not problems
    assert sum(counts.values()) == len(suppressed)


def test_wf300_float_scatter_add_under_replay_only():
    chain = _chain([_ffat_cb()])
    assert "WF300" in _codes(pc.analyze_programs(pc.chain_programs(chain, replay=True)))
    assert "WF300" not in _codes(pc.analyze_programs(pc.chain_programs(chain)))


def test_wf305_float_reduction_under_k_or_shards_only():
    chain = _chain([_ffat_cb()])
    for kw in ({"k": 4}, {"shards": 2}):
        progs = pc.chain_programs(chain, **kw)
        assert "WF305" in _codes(pc.analyze_programs(progs)), kw
    assert "WF305" not in _codes(pc.analyze_programs(pc.chain_programs(chain)))
    # integer reductions are exact: a count window never fires it
    count = wt.Key_FFAT(lambda t: torch.ones((), dtype=torch.int32), torch.add,
                        spec=wt.WindowSpec(8, 2, wt.win_type_t.CB), num_keys=3, **CPU)
    progs = pc.chain_programs(_chain([count]), k=4, shards=2)
    assert "WF305" not in _codes(pc.analyze_programs(progs))


def test_wf302_names_the_host_read_and_its_operator():
    """A KeyedMap without max_key_multiplicity=1 reads the batch's largest
    key multiplicity on the host every push (a site the JAX package does
    not have): the step is traced operator by operator, the reading one is
    reported, the others are analyzed. With the promise it traces whole."""
    km = wt.KeyedMap(lambda t, s: ({"v": t.v + s}, s + t.v), 0.0, num_keys=3, **CPU)
    m = wt.Map(lambda t: {"v": t.v * 2.0}, **CPU)
    progs = pc.chain_programs(_chain([m, km]), k=2)
    step = progs[0]
    assert step.gm is None and [g is not None for _, g in step.parts] == [True, False]
    [f] = [f for f in pc.analyze_programs(progs) if f.code == "WF302"]
    assert "aten._local_scalar_dense" in f.message and "ops[1]:map_keyed" in f.message
    km1 = wt.KeyedMap(lambda t, s: ({"v": t.v + s}, s + t.v), 0.0, num_keys=3,
                      max_key_multiplicity=1, **CPU)
    progs = pc.chain_programs(_chain([km1]), k=2)
    assert all(p.gm is not None for p in progs)
    assert "WF302" not in _codes(pc.analyze_programs(progs))


def test_trace_is_abstract_and_unrecorded():
    """Tracing reads no state value, writes no state, runs no kernel and
    records no kernel resolution; on the CPU it would launch none."""
    chain = _chain([_ffat_cb()])
    before = [t.clone() for t in pc._flat(chain.states) if isinstance(t, torch.Tensor)]
    registry.reset_records()
    registry.reset_launches()
    progs = pc.chain_programs(chain, k=3)
    assert registry.trace_records() == {}
    assert not any(registry.launch_counts().values())
    assert all(p.kernels == () for p in progs)
    after = [t for t in pc._flat(chain.states) if isinstance(t, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_fingerprint_ignores_addresses_and_sees_constants():
    def build(table):
        tbl = torch.tensor(table)
        return _chain([wt.Map(lambda t: {"v": t.v + tbl[t.key.long() % 3]}, **CPU)])
    a = pc.step_fingerprint(build([1.0, 2.0, 3.0]))
    assert pc.step_fingerprint(build([1.0, 2.0, 3.0])) == a     # new closures, same program
    assert pc.step_fingerprint(build([1.0, 2.0, 4.0])) != a     # one constant differs
    assert pc.step_fingerprint(_chain([_ffat_cb()])) != a


def test_fingerprint_is_stable_across_processes():
    code = ("import torch, windflow_tpu_torch as wt\n"
            "from windflow_tpu_torch.analysis import progcheck as pc\n"
            "from windflow_tpu_torch.benchmarks import ysb\n"
            "src = ysb.make_source(2048, device='cpu')\n"
            "ch = wt.CompiledChain(ysb.make_ops(device='cpu'), src.payload_spec(),\n"
            "                      batch_capacity=1024, device='cpu')\n"
            "print(pc.step_fingerprint(ch))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    from windflow_tpu_torch.benchmarks import ysb
    src = ysb.make_source(2048, **CPU)
    ch = wt.CompiledChain(ysb.make_ops(**CPU), src.payload_spec(), batch_capacity=1024, **CPU)
    assert r.stdout.strip() == pc.step_fingerprint(ch)


def test_baseline_entry_without_a_rationale_fails_the_gate(tmp_path, monkeypatch, capsys):
    path = tmp_path / "base.json"
    findings = pc.analyze_programs(pc.chain_programs(_chain([_ffat_cb()]), replay=True,
                                                     target="mp:key_ffat_cb"))
    pc.save_baseline(str(path), findings)
    counts, problems = pc.load_baseline(str(path))
    assert problems and not counts
    doc = json.loads(path.read_text())
    for e in doc["findings"]:
        e["rationale"] = "audited"
    path.write_text(json.dumps(doc))
    pc.save_baseline(str(path), findings)              # rationales survive a rewrite
    counts, problems = pc.load_baseline(str(path))
    assert not problems and sum(counts.values()) == len(findings)
    assert not pc.apply_baseline(findings, counts)
    doc["findings"][0]["rationale"] = " "
    path.write_text(json.dumps(doc))
    monkeypatch.setenv("WF_PROGCHECK_BASELINE", "")
    assert pc.main(["--targets", "examples", "--baseline", str(path)]) == 1
    assert "WITHOUT a rationale" in capsys.readouterr().out


def test_cli_exit_codes(capsys):
    assert pc.main(["--targets", "examples", "--fingerprints"]) == 0
    out = capsys.readouterr().out
    assert "example:wordcount/step" in out
    assert pc.main(["--targets", "nope"]) == 2
    assert pc.main(["--select", "WF999"]) == 2
    assert pc.main(["--explain", "WF302"]) == 0
    assert "_local_scalar_dense" in capsys.readouterr().out


def test_validate_runs_progcheck_under_the_resolved_config(monkeypatch):
    """validate() appends the device-program findings under the object's
    resolved dispatch K / shards / supervision; ``progcheck=False`` or
    ``WF_PROGCHECK=0`` skips them, and a report with errors skips them."""
    monkeypatch.delenv("WF_PROGCHECK", raising=False)

    def sp():
        return wt.SupervisedPipeline(_src(), [_ffat_cb()], wt.Sink(lambda v: None, **CPU),
                                     batch_size=48, **CPU)
    assert "WF300" in validate(sp()).codes()          # supervised => replay program
    assert "WF300" not in validate(sp(), progcheck=False).codes()
    monkeypatch.setenv("WF_PROGCHECK", "0")
    assert "WF300" not in validate(sp()).codes()
    monkeypatch.setenv("WF_PROGCHECK", "1")
    p = wt.Pipeline(_src(), [_ffat_cb()], wt.Sink(lambda v: None, **CPU), batch_size=48,
                    dispatch=4, **CPU)
    assert "WF305" in validate(p).codes()
    assert "WF300" not in validate(p).codes()
    chain = _chain([_ffat_cb()])
    report = validate(chain, supervised=True, faults='{"faults": [{"site": "x.y"}]}')
    assert "WF103" in report.codes() and "WF300" not in report.codes()

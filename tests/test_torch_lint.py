"""The port's invariant linter and concurrency pass
(``windflow_tpu_torch/analysis/lint.py``, ``concurrency.py``) against the
JAX package's: the same rule tables, the same findings on the same fixture
trees (each WF2xx/WF26x code fires on a minimal violation in both), the
port's tree clean against its checked-in baseline, and the CLI's exit codes
(0 clean, 1 findings, 2 internal error)."""

import json
import os
import textwrap

import pytest

from windflow_tpu.analysis import concurrency as jconc
from windflow_tpu.analysis import lint as jlint
from windflow_tpu_torch.analysis import concurrency as tconc
from windflow_tpu_torch.analysis import lint as tlint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_findings():
    """ONE whole-tree run of the port's linter (concurrency pass included)."""
    return tlint.run_lint(cfg=tlint.LintConfig(root=ROOT))


def test_rule_tables_equal_the_jax_packages():
    assert tlint.RULES == jlint.RULES
    assert tconc.ROLES == jconc.ROLES
    assert tlint.SEVERITIES == jlint.SEVERITIES


def test_port_tree_lints_clean_against_its_baseline(port_findings):
    cfg = tlint.LintConfig(root=ROOT)
    fresh, _suppressed = tlint.split_baseline(cfg, port_findings)
    assert not fresh, "\n".join(x.render() for x in fresh)
    live: dict = {}
    for x in port_findings:
        live[x.key()] = live.get(x.key(), 0) + 1
    base = tlint.load_baseline(tlint.baseline_path(cfg))
    assert not sorted(k for k, n in base.items() if n > live.get(k, 0)), "stale entries"
    with open(tlint.baseline_path(cfg)) as f:
        for e in json.load(f)["findings"]:
            assert str(e.get("rationale", "")).strip(), e


def test_port_scans_its_package_and_the_smoke_script(port_findings):
    cfg = tlint.LintConfig(root=ROOT)
    paths = {os.path.relpath(p, ROOT).replace(os.sep, "/")
             for p in tlint._walk_py(ROOT, cfg.package_dirs)}
    assert "chip_smoke.py" in paths
    assert "windflow_tpu_torch/runtime/threaded.py" in paths
    assert not any(p.startswith("windflow_tpu/") for p in paths)


def test_stage_threads_carry_the_stage_role():
    """The spawn-site annotations of the threaded drivers seed the stage
    role, as in the JAX package."""
    conc = tlint.concurrency_module()          # the instance run_lint indexed with
    roles = conc.inferred_roles(ROOT, tlint.LintConfig().package_dirs)
    assert roles["windflow_tpu_torch/runtime/threaded.py::ThreadedPipeline._segment_body"] \
        == ["stage"]
    assert "stage" in roles["windflow_tpu_torch/parallel/ordering.py::Ordering_Node.settle"]


# ----------------------------------------------------------- rule fixtures


_NAMES_PY = textwrap.dedent('''\
    JOURNAL_EVENTS = ("good_event",)
    RECOVERY_COUNTERS = ("good_counter",)
    CONTROL_COUNTERS = ("good_control",)
    CONTROL_GAUGES = ("good_gauge",)
    KERNELS = ("histogram",)
    KERNEL_IMPLS = ("torch", "xla")
''')

_ENV_DOC = textwrap.dedent('''\
    | flag | read at | where | meaning |
    |---|---|---|---|
    | `WF_DOCUMENTED` | run time | somewhere | fine. |
    | `WF_NO_TIME` | whenever | somewhere | row lacks a read-time word. |
''')

#: one minimal violation (and its annotated twin where the rule has one)
FIXTURES = {
    "WF200": "def broken(:\n",
    "WF201": '''
        import os
        X = os.environ.get("WF_UNDOCUMENTED", "")
        Y = os.environ.get("WF_DOCUMENTED", "")
    ''',
    "WF210": '''
        import time as _t
        from random import random
        def f():
            a = _t.monotonic()
            b = random()
            c = _t.perf_counter()  # wf-lint: allow[wall-clock]
            return a, b, c
    ''',
    "WF220": '''
        import threading
        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self.items = []  # wf-lint: guarded-by[_lock]
            def ok(self):
                with self._lock:
                    return len(self.items)
            def bad(self):
                return len(self.items)
    ''',
    "WF230": '''
        def f(g):
            try:
                g()
            except Exception:
                pass
            try:
                g()
            except Exception:  # noqa: BLE001 — the reason
                pass
            try:
                g()
            except Exception:
                raise
    ''',
    "WF240": '''
        from . import journal
        def f():
            journal.record("good_event")
            journal.record("bad_event")
    ''',
    "WF241": '''
        from . import faults as flt
        def f():
            flt.bump("good_counter")
            flt.bump("bad_counter")
    ''',
    "WF250": '''
        def f(register_kernel, resolve_impl):
            register_kernel("histogram", "xla")
            register_kernel("histgram", "pallas")
            resolve_impl("lookup")
    ''',
    "WF260": '''
        import threading
        class Box:
            def __init__(self):
                self.items = []
            def _body(self):
                self.items.append(1)
            def run(self):
                t = threading.Thread(  # wf-lint: thread-role[stage]
                    target=self._body)
                t.start()
                return len(self.items)
    ''',
    "WF261": '''
        import threading
        class Node:
            def settle(self):  # wf-lint: thread-role[driver]
                return 0
        class Driver:
            def __init__(self, node: Node):
                self._node = node
            def _body(self):
                self._node.settle()
            def run(self):
                t = threading.Thread(target=self._body)
                t.start()
                t.join()
    ''',
    "WF262": '''
        from jax.experimental import io_callback
        def cb(k):
            return k
        def probe_missing(shapes, keys):
            return io_callback(cb, shapes, keys)
        def probe_ok(shapes, keys):
            return io_callback(cb, shapes, keys, ordered=True)
    ''',
    "WF263": '''
        import threading
        class AB:
            def __init__(self):
                self.lock_a = threading.Lock()
                self.lock_b = threading.Lock()
            def ab(self):
                with self.lock_a:
                    with self.lock_b:
                        return 1
            def ba(self):
                with self.lock_b:
                    with self.lock_a:
                        return 2
    ''',
    "WF264": '''
        import threading
        def fire_and_forget(fn):
            t = threading.Thread(target=fn)
            t.start()
    ''',
    "WF265": '''
        def f():  # wf-lint: thread-role[nobody]
            return 1
    ''',
}


def _tree(tmp_path, src):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (tmp_path / "docs").mkdir()
    (pkg / "names.py").write_text(_NAMES_PY)
    (tmp_path / "docs" / "ENV_FLAGS.md").write_text(_ENV_DOC)
    (pkg / "mod.py").write_text(textwrap.dedent(src))
    return dict(root=str(tmp_path), package_dirs=("pkg",), env_extra_dirs=(),
                env_extra_files=(), deterministic_modules=("pkg/mod.py",),
                names_file="pkg/names.py", baseline="pkg/baseline.json",
                replay_modules=("pkg/mod.py",))


def _rows(findings):
    return [(x.code, x.severity, x.path, x.line, x.text) for x in findings]


@pytest.mark.parametrize("code", sorted(FIXTURES))
def test_rule_fixture_gives_the_same_findings_in_both_packages(tmp_path, code):
    kw = _tree(tmp_path, FIXTURES[code])
    got = _rows(tlint.run_lint(cfg=tlint.LintConfig(**kw)))
    assert got == _rows(jlint.run_lint(cfg=jlint.LintConfig(**kw)))
    assert code in [r[0] for r in got], got


def test_baseline_keeps_written_rationales_and_counts(tmp_path):
    kw = _tree(tmp_path, FIXTURES["WF230"] + FIXTURES["WF230"].replace("def f", "def g"))
    cfg = tlint.LintConfig(**kw)
    findings = [x for x in tlint.run_lint(cfg=cfg) if x.code == "WF230"]
    assert len(findings) == 2
    path = str(tmp_path / "base.json")
    tlint.save_baseline(path, findings[:1])
    doc = json.load(open(path))
    doc["findings"][0]["rationale"] = "audited"
    json.dump(doc, open(path, "w"))
    tlint.save_baseline(path, findings[:1])
    assert json.load(open(path))["findings"][0]["rationale"] == "audited"
    # one baselined occurrence does not mask its duplicate
    assert len(tlint.apply_baseline(findings, tlint.load_baseline(path))) == 1


# --------------------------------------------------------------------- CLI


def test_cli_exit_codes(tmp_path, capsys):
    assert tlint.main(["--select", "WF23x"]) == 0
    capsys.readouterr()
    kw = _tree(tmp_path, FIXTURES["WF264"])
    port_tree = tmp_path / "windflow_tpu_torch"
    os.rename(tmp_path / "pkg", port_tree)
    (port_tree / "observability").mkdir()
    os.rename(port_tree / "names.py", port_tree / "observability" / "names.py")
    assert tlint.main(["--root", kw["root"], "--no-baseline", "--format=json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["code"] for f in out["findings"]] == ["WF202", "WF264"]   # the fixture doc's row
    assert tlint.main(["--select", "WF999"]) == 2
    assert tlint.main(["--select", "x"]) == 2
    assert tlint.main(["--update-baseline", "--select", "WF230"]) == 2
    assert tlint.main(["--explain", "WF262"]) == 0
    assert "cannot fire" in capsys.readouterr().out
    assert tlint.main(["--explain", "WF305"]) == 0
    assert "sum" in capsys.readouterr().out


def test_cli_exit_2_on_missing_explicit_baseline(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("WF_LINT_BASELINE", "")      # restored after the CLI sets it
    kw = _tree(tmp_path, FIXTURES["WF264"])
    assert tlint.main(["--root", kw["root"], "--baseline",
                       str(tmp_path / "typo.json")]) == 2
    assert "internal error" in capsys.readouterr().err

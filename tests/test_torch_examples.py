"""The port's examples (``windflow_tpu_torch/examples/``) against the JAX
package's (``examples/0N_*.py``), on the CPU.

Mirrors ``tests/test_examples.py``: each case runs the JAX example
(``WF_CPU=1``) and the port's (``--device cpu``) as subprocesses, side by
side. Both must exit 0 and print "OK" (each checks itself against its
oracle), and the integers of their result lines must be equal. Without a
card and without ``--device cpu`` every port example raises.
"""

import importlib
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from windflow_tpu_torch.examples import EXAMPLES
from windflow_tpu_torch.ops import registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the port's example -> the JAX package's
PAIRS = {"wordcount": "01_wordcount.py", "ysb_windows": "02_ysb_windows.py",
         "checkpoint_resume": "03_checkpoint_resume.py", "multichip": "04_multichip.py",
         "recovery_and_backpressure": "05_recovery_and_backpressure.py",
         "serving": "06_serving.py"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _result_lines(stdout: str):
    """The lines after the last launch line's JSON is taken out."""
    return [ln for ln in stdout.splitlines() if ln.strip() and not ln.startswith("{")]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_port_example_matches_the_jax_example(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    jax_p = subprocess.Popen([sys.executable, os.path.join(REPO, "examples", PAIRS[name])],
                             cwd=REPO, env=dict(env, WF_CPU="1"), text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    port_p = subprocess.Popen([sys.executable, "-m", f"windflow_tpu_torch.examples.{name}",
                               "--device", "cpu"], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    outs = {}
    for which, p in (("jax", jax_p), ("port", port_p)):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"{which} {name} failed:\n{out}\n{err}"
        assert "OK" in out, out
        outs[which] = out
    port_lines = outs["port"].splitlines()
    # one launch line before the last line: no kernel launches on the CPU
    assert json.loads(port_lines[-2]) == {"launches": {}}
    ints = {w: [re.findall(r"-?\d+", ln) for ln in _result_lines(o)] for w, o in outs.items()}
    assert ints["port"] == ints["jax"] and any(ints["port"])


def test_examples_need_the_card_by_default(no_cuda):
    """Without ``--device cpu`` an example's entry point resolves ``cuda``
    and raises on a machine without a card: no fallback to the CPU."""
    assert sorted(EXAMPLES) == sorted(PAIRS)
    for name in EXAMPLES:
        mod = importlib.import_module(f"windflow_tpu_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])


def test_example_kernels_are_registry_kernels():
    """Every kernel an example names (``chip_smoke.py`` requires a launch of
    each on the card) is a kernel of the registry; YSB reaches K1 and K2."""
    for name, kernels in EXAMPLES.items():
        assert set(kernels) <= set(registry.KERNELS), name
    assert {"histogram", "lookup"} <= set(EXAMPLES["ysb_windows"])
    assert EXAMPLES["serving"] == ()

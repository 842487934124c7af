"""Static analysis of the port: shift-left validation of graphs, framework
invariants and device programs.

Counterpart of ``windflow_tpu/analysis/``, with the same exports, codes and
baselines' format, and no JAX:

- :func:`validate` (``validate.py``, WF1xx): per-tuple specs flowed through
  a built-but-not-run driver on the meta device, and the run configuration
  checked, before anything launches.
- the invariant linter (``lint.py``, WF2xx) and the whole-repo concurrency
  pass (``concurrency.py``, WF26x): stdlib ``ast`` rules over
  ``windflow_tpu_torch/`` and ``chip_smoke.py``, gated against
  ``baseline.json``.
- the device-program analyzer (``progcheck.py``, WF30x): ``torch.fx``
  graphs of the chains' steps traced over fake tensors, with
  ``program_fingerprint``.
- the hermetic perf gate (``perfgate.py``): logical costs of the traced
  steps (aten ops, bytes, FLOPs) pinned in ``perfgate_baseline.json``.

CLIs: ``python -m windflow_tpu_torch.analysis.lint``, ``.progcheck`` and
``.perfgate`` (exit 0 clean, 1 findings, 2 internal error).
"""

from .validate import (Diagnostic, ValidationError, ValidationReport,
                       validate)

#: names served from ``lint.py`` on first use, so ``python -m
#: windflow_tpu_torch.analysis.lint`` runs the module once, as ``__main__``
_LINT_NAMES = ("Finding", "LintConfig", "apply_baseline", "lint_repo",
               "load_baseline", "run_lint", "save_baseline")


def __getattr__(name):
    if name in _LINT_NAMES:
        from . import lint
        return getattr(lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "validate", "ValidationReport", "ValidationError", "Diagnostic",
    "run_lint", "lint_repo", "Finding", "LintConfig",
    "load_baseline", "save_baseline", "apply_baseline",
]

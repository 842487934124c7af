"""Framework invariant linter — Pillar 2 of the port's static-analysis layer.

Counterpart of ``windflow_tpu/analysis/lint.py``, with the same rules and
codes, pointed at the port: it walks ``windflow_tpu_torch/`` and
``chip_smoke.py`` with stdlib ``ast``/``re`` ONLY (no torch import in the
rules; the sibling ``concurrency.py`` is loaded by path) and enforces the
codebase invariants the port carries as conventions. The WF201/WF202 rules
read ``docs/ENV_FLAGS.md``, the flag inventory both packages share, and
never write it. CLI: ``python -m windflow_tpu_torch.analysis.lint``.

====== ========= =====================================================
code   severity  invariant
====== ========= =====================================================
WF116  error     SLO config the run cannot honor (a validate()-time
                 code, registered in RULES for --explain/--select):
                 ``WF_SLO`` set while monitoring itself resolves off
                 (the engine could never evaluate), a spec set that
                 does not resolve (malformed JSON / unreadable file /
                 unknown field), an unknown signal name (see
                 ``observability/slo.py::SIGNALS``), or burn-window
                 geometry the math rejects (``fast_window >=
                 slow_window``, objective outside (0, 1),
                 ``warn_burn > page_burn``) — fix hints name the
                 registered signals and the window contract
WF117  error     telemetry config the run cannot honor (a
                 validate()-time code, registered in RULES for
                 --explain/--select): ``WF_TELEMETRY`` set while
                 monitoring itself resolves off (the agent rides the
                 Reporter tick — no frames could ever stream), an
                 endpoint that does not parse (``tcp://HOST:PORT`` /
                 ``unix:///path.sock``), or an outbox capacity < 1
WF118  error     remediation config the run cannot honor (a
                 validate()-time code, registered in RULES for
                 --explain/--select): ``WF_REMEDIATION`` set while
                 monitoring/SLO resolve off, an unresolvable policy,
                 an action naming an actuator the run config does not
                 own, a sub-tick cooldown, or a non-barrier actuator
                 under the supervised drivers
WF119  error     serving config the run cannot honor (a
                 validate()-time code, registered in RULES for
                 --explain/--select): serving on while monitoring
                 resolves off, an unparseable endpoint, duplicate
                 tenant ids, wall-clock tenant buckets under
                 supervision, replay < 1, ``swap_warm=False``, or an
                 SLO ``tenant=`` label naming an undeclared tenant
WF200  error     scanned file fails to parse (the linter cannot see it)
WF201  error     ``WF_*`` env read missing from ``docs/ENV_FLAGS.md``
WF202  error     ENV_FLAGS.md row does not state WHEN the flag is read
                 (trace time / run time / process start — the cached-
                 executable footgun the inventory exists to prevent)
WF210  error     wall-clock / ``random`` use inside a deterministic-
                 replay module without ``# wf-lint: allow[wall-clock]``
WF220  error     attribute declared ``# wf-lint: guarded-by[_lock]``
                 accessed outside ``with self._lock:``
WF230  warning   bare ``except:`` / ``except Exception`` without a
                 ``noqa`` rationale (handlers that re-raise are exempt)
WF240  error     journal event/span name not in the central registry
                 (``observability/names.py::JOURNAL_EVENTS``)
WF241  error     counter/gauge name not in the central registries
                 (``RECOVERY_COUNTERS`` / ``CONTROL_COUNTERS`` /
                 ``CONTROL_GAUGES``)
WF250  error     kernel/impl name at a ``register_kernel``/
                 ``resolve_impl`` call site not in the central
                 registries (``observability/names.py::KERNELS`` /
                 ``KERNEL_IMPLS``) — a typo'd kernel name silently
                 forks the env-override/tuning-cache/WF109 namespaces
WF26x  —         the whole-repo static CONCURRENCY pass (thread-role
                 inference, inferred lock discipline WF260, role
                 constraints WF261, ordered effects WF262, lock-order
                 cycles WF263, unjoined threads WF264, grammar WF265)
                 — implemented in the sibling ``concurrency.py``
                 (loaded by path, no torch), run by ``run_lint``
                 by default, findings ride this module's baseline
====== ========= =====================================================

Annotation grammar (one per physical line; for a multi-line statement the
annotation goes on the line of the flagged name; declarations may also sit on
the line directly above the assignment):

- ``# wf-lint: allow[<tag>{,<tag>}]`` — suppress a rule at this line.
  Tags: ``wall-clock`` (WF210), ``unguarded`` (WF220),
  ``broad-except`` (WF230 — but prefer the repo's ``noqa: BLE001`` idiom).
- ``# wf-lint: guarded-by[<lock_attr>]`` — trailing an attribute assignment
  inside a class body: declares ``self.<attr>`` as guarded by
  ``self.<lock_attr>``; every access outside a ``with self.<lock_attr>:``
  block (``__init__`` excepted) is a WF220.

Baseline: ``windflow_tpu_torch/analysis/baseline.json`` suppresses audited
findings so the gate (``tests/test_torch_lint.py``) fails only on
REGRESSIONS.
Baseline entries match on ``(code, path, stripped source line)`` — stable
across unrelated line-number drift. ``WF_LINT_BASELINE`` overrides the path;
``python -m windflow_tpu_torch.analysis.lint --update-baseline`` rewrites
it.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------- findings

SEVERITIES = ("error", "warning")

#: THE lint rule table — one row per diagnostic code, shared by this module,
#: the concurrency pass (``analysis/concurrency.py``, the WF26x family), and
#: the CLI's ``--select``/``--ignore``/``--explain`` surface, so the help
#: text can never drift from the registered codes.  Values:
#: ``(severity, one-line summary)``.
RULES: Dict[str, Tuple[str, str]] = {
    # WF116 is a validate()-time code (analysis/validate.py::_check_slo),
    # registered here so --explain/--select know it — the linter itself
    # never emits it (pre-run config legality needs the live env/config)
    "WF116": ("error", "SLO config the run cannot honor (WF_SLO while "
                       "monitoring off, malformed spec set, unknown "
                       "signal name, fast_window >= slow_window)"),
    # WF117 is likewise validate()-time (validate.py::_check_telemetry)
    "WF117": ("error", "telemetry config the run cannot honor "
                       "(WF_TELEMETRY while monitoring off, "
                       "missing/unparseable endpoint, outbox < 1)"),
    # WF118 is likewise validate()-time (validate.py::_check_remediation /
    # _check_remediation_supervised)
    "WF118": ("error", "remediation config the run cannot honor "
                       "(WF_REMEDIATION while monitoring/SLO off, "
                       "unresolvable policy, unowned actuator, "
                       "sub-tick cooldown, non-barrier actuator under "
                       "supervision)"),
    # WF119 is likewise validate()-time (validate.py::_check_serving,
    # sharing serving/config.py::serving_problems with the ServingRuntime
    # constructor)
    "WF119": ("error", "serving config the run cannot honor "
                       "(WF_SERVE while monitoring off, unparseable "
                       "endpoint, duplicate tenant ids, wall-clock "
                       "tenant buckets under supervision, replay < 1, "
                       "swap_warm=false, SLO tenant= label naming an "
                       "undeclared tenant)"),
    "WF200": ("error", "scanned file fails to parse (the linter cannot "
                       "see it)"),
    "WF201": ("error", "WF_* env read missing from docs/ENV_FLAGS.md"),
    "WF202": ("error", "ENV_FLAGS.md row does not state WHEN the flag is "
                       "read (trace time / run time / process start)"),
    "WF210": ("error", "wall-clock / random use inside a deterministic-"
                       "replay module without allow[wall-clock]"),
    "WF220": ("error", "attribute declared guarded-by[<lock>] accessed "
                       "outside `with self.<lock>:`"),
    "WF230": ("warning", "bare except / except Exception without a "
                         "noqa: BLE001 rationale"),
    "WF240": ("error", "journal event/span name not in "
                       "names.py::JOURNAL_EVENTS"),
    "WF241": ("error", "counter/gauge name not in the central names.py "
                       "registries"),
    "WF250": ("error", "kernel/impl name at register_kernel/resolve_impl "
                       "not in names.py::KERNELS / KERNEL_IMPLS"),
    # -- the WF26x concurrency family (analysis/concurrency.py) -----------
    "WF260": ("error", "cross-thread-role mutable attribute without one "
                       "consistent lock or a guarded-by/single-writer "
                       "annotation"),
    "WF261": ("error", "function reachable from a thread role outside its "
                       "declared thread-role[...] set (e.g. a driver-"
                       "thread-only API called from a spawned thread)"),
    "WF262": ("error", "io_callback in a deterministic-replay module "
                       "without a literal ordered=True, or with an "
                       "unresolvable callback"),
    "WF263": ("warning", "lock-order cycle (potential deadlock) in the "
                         "lock-acquisition graph"),
    "WF264": ("warning", "non-daemon thread started with no reachable "
                         "join() on the shutdown path"),
    "WF265": ("error", "wf-lint concurrency annotation grammar error "
                       "(unknown role / empty role list)"),
    # -- the WF30x device-program family (analysis/progcheck.py) ----------
    # progcheck-time codes: emitted by the torch.fx program analyzer
    # (analysis/progcheck.py), registered here with the JAX package's text
    # so --explain/--select know them and the two tables stay equal — this
    # linter never emits them.  --explain reads the analyzer's docstring
    # (the torch terms of each rule) via progcheck_doc() WITHOUT importing
    # it.
    "WF300": ("error", "order-dependent float accumulation (scatter-add "
                       "with possibly-duplicate indices on a float dtype) "
                       "in a deterministic-replay program"),
    "WF301": ("error", "unordered host effect (io_callback/debug_callback "
                       "without ordered=True) reachable from a compiled "
                       "step/scan body — the jaxpr-level complement of "
                       "WF262"),
    "WF302": ("warning", "host-sync in the per-push hot path: a callback "
                         "primitive forcing a blocking D2H round trip "
                         "outside the maintain/settle surfaces (a fusion "
                         "candidate next to wf_health's dispatch_ratio)"),
    "WF303": ("warning", "retrace-signature hazard from actual avals: "
                         "weak-typed program inputs/consts or Python-"
                         "scalar promotions that retrace per call value "
                         "(subsumes the WF102 heuristic)"),
    "WF304": ("error", "donated-buffer aliasing: a donated input read "
                       "after the equation XLA aliases it into, or "
                       "aliased into two outputs"),
    "WF305": ("warning", "shard/K-variant float reduction: accumulation "
                         "grouping that can change with shard count or "
                         "dispatch K (the static evidence for retiring "
                         "WF115 pairings)"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation, pinned to ``path:line`` with a stable code."""

    code: str
    severity: str
    path: str                    # repo-relative, posix separators
    line: int
    message: str
    text: str = ""               # stripped source line (baseline match key)

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line numbers drift, (code, path, text) do not."""
        return (self.code, self.path, self.text)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.code} [{self.severity}] "
                f"{self.message}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintConfig:
    """Scan roots + per-rule scope. Tests override fields to point the rules
    at fixture trees; the defaults describe THIS repository."""

    root: str = "."
    #: directories (or single files) scanned by every rule
    package_dirs: Sequence[str] = ("windflow_tpu_torch", "chip_smoke.py")
    #: extra scan surface for the env-flag rule only
    env_extra_dirs: Sequence[str] = ()
    env_extra_files: Sequence[str] = ()
    env_doc: str = os.path.join("docs", "ENV_FLAGS.md")
    #: modules on the deterministic-replay path: checkpoint replay must
    #: reproduce their decisions exactly, so wall-clock/random reads need an
    #: explicit allow[wall-clock] annotation arguing why they are safe
    deterministic_modules: Sequence[str] = (
        os.path.join("windflow_tpu_torch", "runtime", "supervisor.py"),
        os.path.join("windflow_tpu_torch", "runtime", "checkpoint.py"),
        os.path.join("windflow_tpu_torch", "control", "admission.py"),
        # tiered keyed state: tier assignments and host-store content must
        # replay exactly (the spill/readmit protocol is position-driven)
        os.path.join("windflow_tpu_torch", "state", "tiered.py"),
        os.path.join("windflow_tpu_torch", "state", "host_store.py"),
        # the serving plane: admission, framing and replay decisions feed
        # the supervised drivers, so they must replay position-driven
        os.path.join("windflow_tpu_torch", "serving", "framing.py"),
        os.path.join("windflow_tpu_torch", "serving", "sources.py"),
        os.path.join("windflow_tpu_torch", "serving", "tenants.py"),
        os.path.join("windflow_tpu_torch", "serving", "runtime.py"),
        # fleet aggregation windows feed SLO verdicts that remediation
        # acts on — wall-clock reads need an argued allow[wall-clock]
        os.path.join("windflow_tpu_torch", "observability", "fleet.py"),
    )
    #: the central name registries (parsed with ast, never imported)
    names_file: str = os.path.join("windflow_tpu_torch", "observability", "names.py")
    baseline: str = os.path.join("windflow_tpu_torch", "analysis", "baseline.json")
    #: replay-sensitive modules for the WF262 ordered-effect rule — None =
    #: the concurrency pass's default (the deterministic set above plus the
    #: two operator modules whose JAX counterparts embed host callbacks);
    #: fixture tests point it at their module under test
    replay_modules: Optional[Sequence[str]] = None
    #: run the whole-repo concurrency pass (analysis/concurrency.py,
    #: WF26x) as part of run_lint — on by default; fixture tests for the
    #: WF2xx rules may disable it to stay single-concern
    concurrency: bool = True


_ALLOW_RE = re.compile(r"#\s*wf-lint:\s*allow\[([a-z0-9_,\- ]+)\]")
_GUARDED_RE = re.compile(r"#\s*wf-lint:\s*guarded-by\[([A-Za-z_]\w*)\]")
#: the WF230 opt-out requires the BLE001 code (the repo idiom is
#: ``# noqa: BLE001 — <why>``) — a bare ``# noqa`` or an unrelated code
#: (``# noqa: E501``) does not silence the broad-except rule
_NOQA_RE = re.compile(r"#\s*noqa:\s*BLE001\b")

# same patterns as the original tests/test_env_flags.py scanner (now the
# single source of truth; the test delegates here)
_READ_LINE = re.compile(r"environ|getenv|var\s*:\s*str\s*=\s*\"WF_")
_FLAG = re.compile(r"WF_[A-Z][A-Z0-9_]*")
_DOC_ROW = re.compile(r"\|\s*`(WF_[A-Z0-9_]+)`\s*\|([^|]*)\|")
_READ_TIME = re.compile(r"trace|run time|process start|start", re.I)

#: wall-clock attribute reads flagged by WF210 (``random.<anything>`` too)
_WALL_CLOCK_TIME_ATTRS = ("time", "monotonic", "monotonic_ns", "time_ns",
                          "perf_counter", "perf_counter_ns")


def _allows(line: str, tag: str) -> bool:
    m = _ALLOW_RE.search(line)
    if not m:
        return False
    tags = [t.strip() for t in m.group(1).split(",")]
    return tag in tags


# --------------------------------------------------------------- file model


class _File:
    """One parsed python file: source lines + AST (or a parse failure)."""

    def __init__(self, abspath: str, relpath: str):
        self.rel = relpath.replace(os.sep, "/")
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            with open(abspath, encoding="utf-8") as f:
                self.source = f.read()
        except UnicodeDecodeError as e:
            # a non-UTF-8 file is a WF200 like any other unparseable file —
            # it must never crash the gate into 'internal error'
            self.source = ""
            self.parse_error = f"not UTF-8: {e.reason} at byte {e.start}"
        self.lines = self.source.splitlines()
        if self.parse_error is None:
            try:
                self.tree = ast.parse(self.source)
            except SyntaxError as e:
                self.parse_error = (f"{type(e).__name__}: {e.msg} "
                                    f"(line {e.lineno})")

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def allows(self, lineno: int, tag: str) -> bool:
        return _allows(self.line(lineno), tag)

    def finding(self, code: str, severity: str, lineno: int,
                message: str) -> Finding:
        return Finding(code=code, severity=severity, path=self.rel,
                       line=lineno, message=message,
                       text=self.line(lineno).strip())


def _walk_py(root: str, rel_dirs: Sequence[str],
             rel_files: Sequence[str] = ()) -> List[str]:
    out = []
    for d in rel_dirs:
        top = os.path.join(root, d)
        if d.endswith(".py"):                  # a single file of the scan
            if os.path.isfile(top):
                out.append(top)
            continue
        for dirpath, dirnames, names in os.walk(top):
            dirnames[:] = [x for x in dirnames if x != "__pycache__"]
            out += [os.path.join(dirpath, n) for n in sorted(names)
                    if n.endswith(".py")]
    for f in rel_files:
        p = os.path.join(root, f)
        if os.path.exists(p):
            out.append(p)
    return out


def _load_files(root: str, rel_dirs: Sequence[str],
                rel_files: Sequence[str] = ()) -> List[_File]:
    return [_File(p, os.path.relpath(p, root))
            for p in _walk_py(root, rel_dirs, rel_files)]


# ------------------------------------------------------------ rule: WF20x env


def parse_env_doc(doc_path: str) -> Dict[str, Tuple[int, str]]:
    """ENV_FLAGS.md table rows: ``{flag: (line_no, read-at cell)}``."""
    rows: Dict[str, Tuple[int, str]] = {}
    with open(doc_path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            m = _DOC_ROW.match(line)
            if m:
                rows[m.group(1)] = (lineno, m.group(2).strip())
    return rows


def env_flags_read(root: str, cfg: LintConfig) -> Dict[str, Tuple[str, int]]:
    """Every ``WF_*`` flag the tree reads: ``{flag: (relpath, line)}`` (first
    site). A line is a read when it touches the environment (``os.environ`` /
    ``getenv``) or declares the default env-var name a reader resolves later
    (``var: str = "WF_..."`` — the FaultPlan.from_env idiom)."""
    found: Dict[str, Tuple[str, int]] = {}
    scan = list(cfg.package_dirs) + list(cfg.env_extra_dirs)
    for path in _walk_py(root, scan, cfg.env_extra_files):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        # scan-only pass: a stray non-UTF-8 byte must not kill the rule
        with open(path, encoding="utf-8", errors="replace") as f:
            for lineno, line in enumerate(f, 1):
                if not _READ_LINE.search(line):
                    continue
                for flag in _FLAG.findall(line):
                    found.setdefault(flag, (rel, lineno))
    return found


def rule_env_flags(cfg: LintConfig) -> List[Finding]:
    out: List[Finding] = []
    doc_path = os.path.join(cfg.root, cfg.env_doc)
    doc_rel = cfg.env_doc.replace(os.sep, "/")
    if not os.path.exists(doc_path):
        return [Finding("WF201", "error", doc_rel, 1,
                        "docs/ENV_FLAGS.md is missing — every WF_* env read "
                        "must be documented there", "")]
    docs = parse_env_doc(doc_path)
    read = env_flags_read(cfg.root, cfg)
    for flag, (rel, lineno) in sorted(read.items()):
        if flag not in docs:
            out.append(Finding(
                "WF201", "error", rel, lineno,
                f"env flag {flag} is read here but has no row in "
                f"{doc_rel} (add the row — including the read-at column — "
                f"in the same commit)", text=flag))
    for flag, (lineno, cell) in sorted(docs.items()):
        if not _READ_TIME.search(cell):
            out.append(Finding(
                "WF202", "error", doc_rel, lineno,
                f"{doc_rel} row for {flag} does not state WHEN the flag is "
                f"read (trace time / run time / process start) — trace-time "
                f"reads are baked into cached executables", text=flag))
    return out


# ----------------------------------------------------- rule: WF210 wall clock


def _wall_clock_names(tree) -> Tuple[set, set, set]:
    """Per-file alias resolution for the WF210 rule: ``import time as _t`` /
    ``from time import monotonic`` must not escape the gate.  Returns
    (aliases of the time module, aliases of the random module, bare names
    from-imported from either that are wall-clock reads)."""
    time_mods, random_mods, bare = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    time_mods.add(a.asname or "time")
                elif a.name == "random":
                    random_mods.add(a.asname or "random")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time":
                for a in node.names:
                    if a.name in _WALL_CLOCK_TIME_ATTRS:
                        bare.add(a.asname or a.name)
            elif node.module == "random":
                for a in node.names:
                    bare.add(a.asname or a.name)
    return time_mods, random_mods, bare


def rule_wall_clock(cfg: LintConfig, files: List[_File]) -> List[Finding]:
    """No ``time.time``/``time.monotonic``/``random.*`` (under any import
    alias) in deterministic-replay modules except at
    ``# wf-lint: allow[wall-clock]`` lines: replay re-drives these modules'
    decisions from checkpoints, and a wall-clock or RNG dependency silently
    forks the replayed stream from the original."""
    det = {p.replace(os.sep, "/") for p in cfg.deterministic_modules}
    out: List[Finding] = []
    for f in files:
        if f.rel not in det or f.tree is None:
            continue
        time_mods, random_mods, bare = _wall_clock_names(f.tree)

        def flag(node, what):
            if f.allows(node.lineno, "wall-clock"):
                return
            out.append(f.finding(
                "WF210", "error", node.lineno,
                f"{what} inside deterministic-replay module {f.rel} — "
                f"replay must reproduce this module's decisions exactly; "
                f"if this use is timing-only (never data), annotate the "
                f"line with `# wf-lint: allow[wall-clock]` and say why"))

        for node in ast.walk(f.tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name):
                base = node.value.id
                if (base in time_mods
                        and node.attr in _WALL_CLOCK_TIME_ATTRS) \
                        or base in random_mods:
                    flag(node, f"{base}.{node.attr}")
            elif isinstance(node, ast.Name) and node.id in bare \
                    and isinstance(node.ctx, ast.Load):
                flag(node, node.id)
    return out


# ------------------------------------------------------ rule: WF220 lock use


def _guarded_decls(f: _File, cls: ast.ClassDef) -> Dict[str, str]:
    """``{attr: lock_attr}`` for declarations annotated guarded-by inside
    ``cls`` (annotation on the assignment line or the line directly above)."""
    decls: Dict[str, str] = {}
    for node in ast.walk(cls):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        for t in targets:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                m = _GUARDED_RE.search(f.line(node.lineno))
                if m is None:
                    # line-above form, ONLY on a pure comment line — a
                    # trailing annotation on the previous assignment must
                    # not leak onto this one
                    above = f.line(node.lineno - 1).strip()
                    if above.startswith("#"):
                        m = _GUARDED_RE.search(above)
                if m:
                    decls[t.attr] = m.group(1)
    return decls


def _with_locks(node: ast.With) -> List[str]:
    """Lock attribute names taken by ``with self.<lock>:`` items."""
    out = []
    for item in node.items:
        e = item.context_expr
        if (isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name)
                and e.value.id == "self"):
            out.append(e.attr)
    return out


def rule_lock_guard(cfg: LintConfig, files: List[_File]) -> List[Finding]:
    """Attributes declared ``# wf-lint: guarded-by[<lock>]`` may only be
    touched inside ``with self.<lock>:`` (``__init__`` excepted — the lock is
    being built there). Catches the classic drift: a new method reads a
    shared dict without the lock the rest of the class holds."""
    out: List[Finding] = []
    for f in files:
        if f.tree is None:
            continue
        for cls in [n for n in ast.walk(f.tree)
                    if isinstance(n, ast.ClassDef)]:
            decls = _guarded_decls(f, cls)
            if not decls:
                continue
            for method in cls.body:
                if not isinstance(method, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                    continue
                if method.name == "__init__":
                    continue

                def visit(node, held):
                    if isinstance(node, ast.With):
                        held = held | set(_with_locks(node))
                    elif isinstance(node, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.Lambda)) and node is not method:
                        # a nested function/lambda DEFINED under the lock
                        # does not RUN under it — a deferred callback
                        # touching the attribute races exactly like any
                        # other unlocked access
                        held = frozenset()
                    if (isinstance(node, ast.Attribute)
                            and isinstance(node.value, ast.Name)
                            and node.value.id == "self"
                            and node.attr in decls
                            and decls[node.attr] not in held
                            and not f.allows(node.lineno, "unguarded")):
                        out.append(f.finding(
                            "WF220", "error", node.lineno,
                            f"{cls.name}.{method.name} touches "
                            f"self.{node.attr} outside `with "
                            f"self.{decls[node.attr]}:` — the attribute is "
                            f"declared guarded-by[{decls[node.attr]}]"))
                    for child in ast.iter_child_nodes(node):
                        visit(child, held)

                visit(method, frozenset())
    return out


# -------------------------------------------------- rule: WF230 broad except


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    """A handler that re-raises (bare ``raise`` or ``raise <bound name>``) is
    a cleanup handler, not a swallow — exempt."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True
            if (handler.name and isinstance(node.exc, ast.Name)
                    and node.exc.id == handler.name):
                return True
    return False


def _broad_names(type_node) -> List[str]:
    names = []
    nodes = (type_node.elts if isinstance(type_node, ast.Tuple)
             else [type_node])
    for n in nodes:
        if isinstance(n, ast.Name) and n.id in ("Exception", "BaseException"):
            names.append(n.id)
    return names


def rule_broad_except(cfg: LintConfig, files: List[_File]) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if f.tree is None:
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                what = "bare `except:`"
            else:
                broad = _broad_names(node.type)
                if not broad:
                    continue
                what = f"`except {'/'.join(broad)}`"
            line = f.line(node.lineno)
            if _NOQA_RE.search(line) or _allows(line, "broad-except"):
                continue
            if _handler_reraises(node):
                continue
            out.append(f.finding(
                "WF230", "warning", node.lineno,
                f"{what} without a `# noqa: BLE001 — <why>` rationale "
                f"swallows unexpected failures (KeyboardInterrupt, injected "
                f"chaos faults, real bugs); catch the concrete errors or "
                f"state why broad is correct here"))
    return out


# -------------------------------------------- rules: WF240/241 emitted names


def load_name_registries(cfg: LintConfig) -> Dict[str, frozenset]:
    """Parse ``observability/names.py`` with ``ast.literal_eval`` — the
    linter never imports the package."""
    path = os.path.join(cfg.root, cfg.names_file)
    wanted = {"JOURNAL_EVENTS", "RECOVERY_COUNTERS", "CONTROL_COUNTERS",
              "CONTROL_GAUGES"}
    # optional registries (WF250): absent in minimal fixture trees — the
    # rule then simply has nothing to check against
    optional = {"KERNELS", "KERNEL_IMPLS"}
    regs: Dict[str, frozenset] = {}
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in (wanted | optional)):
            regs[node.targets[0].id] = frozenset(
                ast.literal_eval(node.value))
    missing = wanted - set(regs)
    if missing:
        raise ValueError(f"{cfg.names_file} is missing registries: "
                         f"{sorted(missing)}")
    return regs


#: in-module ``bump("...")`` calls resolve by the defining file
_BUMP_FILES = {"windflow_tpu_torch/runtime/faults.py": "RECOVERY_COUNTERS",
               "windflow_tpu_torch/control/_state.py": "CONTROL_COUNTERS"}

#: counter-emitting module basenames -> registry
_COUNTER_MODULES = {"faults": "RECOVERY_COUNTERS",
                    "_state": "CONTROL_COUNTERS"}


def _counter_aliases(tree) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Per-file alias resolution for the WF241 rule: which registry a
    ``bump``/``set_gauge`` call charges, under ANY import spelling
    (``from . import faults as flt``, ``import windflow_tpu_torch.control._state
    as cs``, ``from ..runtime.faults import bump``).  Returns
    (module alias -> registry, directly-imported function name -> registry).
    """
    mod_alias: Dict[str, str] = {}
    func_alias: Dict[str, str] = {}

    def reg_of(dotted: Optional[str]) -> Optional[str]:
        if not dotted:
            return None
        return _COUNTER_MODULES.get(dotted.rsplit(".", 1)[-1])

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                r = reg_of(a.name)
                if r:
                    # `import pkg.faults` binds `pkg`; only an asname gives
                    # a usable single-name base for the call-site check
                    mod_alias[a.asname or a.name.split(".")[0]] = r
        elif isinstance(node, ast.ImportFrom):
            from_reg = reg_of(node.module)
            for a in node.names:
                r = reg_of(a.name)
                if r:                       # from ..runtime import faults as X
                    mod_alias[a.asname or a.name] = r
                elif from_reg and a.name == "bump":
                    func_alias[a.asname or a.name] = from_reg
                elif from_reg and a.name == "set_gauge":
                    func_alias[a.asname or a.name] = "CONTROL_GAUGES"
    return mod_alias, func_alias


def _const_str_arg(node: ast.Call) -> Optional[str]:
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def rule_emitted_names(cfg: LintConfig, files: List[_File]) -> List[Finding]:
    regs = load_name_registries(cfg)
    events = regs["JOURNAL_EVENTS"]
    names_rel = cfg.names_file.replace(os.sep, "/")
    out: List[Finding] = []
    for f in files:
        if f.tree is None or f.rel == names_rel:
            continue
        mod_alias, func_alias = _counter_aliases(f.tree)
        for node in ast.walk(f.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            base = node.func.value
            base_name = base.id if isinstance(base, ast.Name) else \
                (base.attr if isinstance(base, ast.Attribute) else None)
            name = _const_str_arg(node)
            if name is None:
                continue
            is_journal_call = (
                (attr in ("record", "span", "event")
                 and base_name in ("journal", "_journal"))
                # known wrapper that forwards a constant event name to
                # journal.record (parallel/ordering.py::_journal_release) —
                # the direct call site passes a variable, so check the
                # wrapper's callers instead
                or attr == "_journal_release")
            if is_journal_call:
                if name not in events:
                    out.append(f.finding(
                        "WF240", "error", node.lineno,
                        f"journal {attr} name {name!r} is not in "
                        f"{names_rel}::JOURNAL_EVENTS — register it there "
                        f"(one source of truth for dashboards/tests) or fix "
                        f"the typo"))
            elif attr == "bump":
                reg = (mod_alias.get(base_name)
                       if base_name else None) or _BUMP_FILES.get(f.rel)
                if reg and name not in regs[reg]:
                    out.append(f.finding(
                        "WF241", "error", node.lineno,
                        f"counter {name!r} is not in {names_rel}::{reg} — "
                        f"an undeclared counter never appears in snapshots "
                        f"initialized from the registry"))
            elif attr == "set_gauge" and (base_name in mod_alias
                                          or f.rel in _BUMP_FILES):
                if name not in regs["CONTROL_GAUGES"]:
                    out.append(f.finding(
                        "WF241", "error", node.lineno,
                        f"gauge {name!r} is not in "
                        f"{names_rel}::CONTROL_GAUGES"))
        # bare bump("...")/set_gauge("...") calls: directly-imported
        # functions (any alias) and in-module calls in faults.py/_state.py
        for node in ast.walk(f.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            fname = node.func.id
            name = _const_str_arg(node)
            if name is None:
                continue
            target = func_alias.get(fname)
            if target is None and f.rel in _BUMP_FILES:
                if fname == "bump":
                    target = _BUMP_FILES[f.rel]
                elif fname == "set_gauge":
                    target = "CONTROL_GAUGES"
            if target is None or name in regs[target]:
                continue
            out.append(f.finding(
                "WF241", "error", node.lineno,
                f"{'gauge' if target == 'CONTROL_GAUGES' else 'counter'} "
                f"{name!r} is not in {names_rel}::{target}"))
    return out


# -------------------------------------------- rule: WF250 kernel registry


#: call names the WF250 rule inspects (module functions of ``ops/registry.py``
#: and the ``KernelRegistry`` methods — both spellings appear at call sites)
_KERNEL_CALLS = ("register_kernel", "resolve_impl")


def rule_kernel_names(cfg: LintConfig, files: List[_File]) -> List[Finding]:
    """Every LITERAL kernel name passed to ``register_kernel``/
    ``resolve_impl`` must be in ``names.py::KERNELS`` (and a literal impl
    name at a ``register_kernel`` site in ``KERNEL_IMPLS``) — the same
    one-source-of-truth discipline as WF240/241, for the per-backend kernel
    registry's selection/autotune/WF109 namespaces."""
    regs = load_name_registries(cfg)
    kernels = regs.get("KERNELS")
    impls = regs.get("KERNEL_IMPLS", frozenset())
    names_rel = cfg.names_file.replace(os.sep, "/")
    if kernels is None:
        return []                  # minimal tree without a kernel registry
    out: List[Finding] = []
    for f in files:
        if f.tree is None or f.rel == names_rel:
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            called = (fn.id if isinstance(fn, ast.Name)
                      else (fn.attr if isinstance(fn, ast.Attribute)
                            else None))
            if called not in _KERNEL_CALLS:
                continue
            name = _const_str_arg(node)
            if name is not None and name not in kernels:
                out.append(f.finding(
                    "WF250", "error", node.lineno,
                    f"kernel {name!r} is not in {names_rel}::KERNELS — "
                    f"register it there (env overrides, tuning-cache "
                    f"entries, and WF109 records key on this name) or fix "
                    f"the typo"))
            if (called == "register_kernel" and len(node.args) > 1
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)
                    and node.args[1].value not in impls):
                out.append(f.finding(
                    "WF250", "error", node.lineno,
                    f"kernel impl {node.args[1].value!r} is not in "
                    f"{names_rel}::KERNEL_IMPLS"))
    return out


# --------------------------------------------------------------- the driver


def rule_parse_errors(cfg: LintConfig, files: List[_File]) -> List[Finding]:
    return [f.finding("WF200", "error", 1,
                      f"cannot parse {f.rel}: {f.parse_error}")
            for f in files if f.parse_error is not None]


_CONCURRENCY_MOD = None


def concurrency_module():
    """Load the sibling ``concurrency.py`` by file path (NOT via the
    package, whose ``__init__`` imports torch: the rules need only the
    stdlib)."""
    global _CONCURRENCY_MOD
    if _CONCURRENCY_MOD is None:
        import importlib.util
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "concurrency.py")
        spec = importlib.util.spec_from_file_location(
            "wf_torch_analysis_concurrency", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["wf_torch_analysis_concurrency"] = mod
        spec.loader.exec_module(mod)
        _CONCURRENCY_MOD = mod
    return _CONCURRENCY_MOD


def progcheck_doc() -> str:
    """The docstring of the sibling ``progcheck.py`` — parsed with ast,
    NEVER imported (progcheck traces torch programs; ``--explain WF30x``
    needs only its text)."""
    import ast
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "progcheck.py")
    with open(path, encoding="utf-8") as f:
        return ast.get_docstring(ast.parse(f.read())) or ""


def rule_concurrency(cfg: LintConfig) -> List[Finding]:
    """The WF26x whole-repo concurrency pass (thread-role inference,
    inferred lock discipline, ordered effects, lock order, unjoined
    threads) — implemented in ``analysis/concurrency.py``, surfaced here so
    its findings ride the same baseline ratchet and CLI as WF2xx."""
    conc = concurrency_module()
    return [Finding(**d) for d in conc.run_rules(
        cfg.root, cfg.package_dirs, replay_modules=cfg.replay_modules)]


def run_lint(root: str = None, cfg: LintConfig = None) -> List[Finding]:
    """Run every rule over the tree; findings sorted by (path, line, code)."""
    if cfg is None:
        cfg = LintConfig(root=root or ".")
    elif root is not None:
        cfg.root = root
    files = _load_files(cfg.root, cfg.package_dirs)
    findings: List[Finding] = []
    findings += rule_parse_errors(cfg, files)
    findings += rule_env_flags(cfg)
    findings += rule_wall_clock(cfg, files)
    findings += rule_lock_guard(cfg, files)
    findings += rule_broad_except(cfg, files)
    findings += rule_emitted_names(cfg, files)
    findings += rule_kernel_names(cfg, files)
    if cfg.concurrency:
        findings += rule_concurrency(cfg)
    return sorted(findings, key=lambda x: (x.path, x.line, x.code))


# --------------------------------------------------------------- baseline


def baseline_path(cfg: LintConfig) -> str:
    """``WF_LINT_BASELINE`` (run time, CLI/test invocation) overrides the
    checked-in ``windflow_tpu_torch/analysis/baseline.json`` — point a gate at an
    alternate suppression set without editing the tree."""
    override = os.environ.get("WF_LINT_BASELINE", "")
    if override:
        return override if os.path.isabs(override) \
            else os.path.join(cfg.root, override)
    return os.path.join(cfg.root, cfg.baseline)


def load_baseline(path: str) -> Dict[tuple, int]:
    """Suppression keys -> occurrence count from a baseline file; empty when
    absent. Counts matter: two identical ``except Exception:`` lines in one
    file share a key, and a baseline holding ONE must not also suppress a
    newly added second."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    counts: Dict[tuple, int] = {}
    for e in data.get("findings", ()):
        k = (e["code"], e["path"], e.get("text", ""))
        counts[k] = counts.get(k, 0) + 1
    return counts


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Write the baseline from ``findings``, keeping the ``rationale`` already
    written for an entry that still matches."""
    old: Dict[tuple, List[str]] = {}
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            for e in json.load(f).get("findings", ()):
                r = str(e.get("rationale", "")).strip()
                if r:
                    old.setdefault((e["code"], e["path"], e.get("text", "")),
                                   []).append(r)
    payload = {
        "comment": "audited wf-lint findings of the port suppressed from the "
                   "gate, each with its rationale; regenerate with python -m "
                   "windflow_tpu_torch.analysis.lint --update-baseline (entries "
                   "match on code+path+source text, so unrelated line drift "
                   "does not invalidate them; rationales already written are "
                   "kept)",
        "findings": [{"code": x.code, "path": x.path, "text": x.text,
                      "message": x.message,
                      "rationale": (old.get(x.key()) or [""]).pop(0)}
                     for x in findings],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=False)
        f.write("\n")


def apply_baseline(findings: Sequence[Finding],
                   baseline: Dict[tuple, int]) -> List[Finding]:
    """Findings NOT suppressed by the baseline (the gate fails on these).
    Each baseline entry suppresses ONE occurrence of its key, in order — a
    new duplicate of a baselined line is a fresh finding."""
    remaining = dict(baseline)
    fresh = []
    for x in findings:
        k = x.key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
        else:
            fresh.append(x)
    return fresh


def split_baseline(cfg: LintConfig, findings: Sequence[Finding],
                   ) -> Tuple[List[Finding], List[Finding]]:
    """(fresh, suppressed) split of ``findings`` against the resolved
    baseline — THE gate semantics, shared by :func:`lint_repo` and the CLI
    so the two can never disagree on what is suppressed."""
    path = baseline_path(cfg)
    if os.environ.get("WF_LINT_BASELINE", "") and not os.path.exists(path):
        # an EXPLICIT override pointing nowhere must fail loudly (CLI exit
        # 2), not resurface the whole baseline as a misleading gate failure
        raise FileNotFoundError(
            f"WF_LINT_BASELINE points at a missing baseline file: {path}")
    base = load_baseline(path)
    fresh = apply_baseline(findings, base)
    fresh_ids = {id(x) for x in fresh}
    return fresh, [x for x in findings if id(x) not in fresh_ids]


def lint_repo(root: str = None, cfg: LintConfig = None,
              ) -> Tuple[List[Finding], List[Finding]]:
    """(fresh, suppressed) findings for the gate: run + baseline filter."""
    if cfg is None:
        cfg = LintConfig(root=root or ".")
    elif root is not None:
        cfg.root = root
    return split_baseline(cfg, run_lint(cfg=cfg))


# --------------------------------------------------------------- the CLI


def parse_codes(text: str, rules=None) -> set:
    """``--select``/``--ignore`` tokens -> concrete code set. A trailing
    ``x`` matches a family by prefix (``WF26x``, ``WF2x``; the prefix must
    be ``WF`` plus at least one digit); an exact token must name a
    registered rule. Anything else raises ``ValueError`` (exit 2)."""
    rules = RULES if rules is None else rules
    codes = set()
    for tok in [t.strip() for t in text.split(",") if t.strip()]:
        if re.fullmatch(r"WF\d+x", tok):
            fam = [c for c in rules if c.startswith(tok[:-1])]
            if not fam:
                raise ValueError(f"unknown rule family {tok!r}")
            codes.update(fam)
        elif tok in rules:
            codes.add(tok)
        else:
            raise ValueError(f"unknown rule code {tok!r} (see --explain, or "
                             f"the RULES table in analysis/lint.py)")
    return codes


def explain(code: str, prog: str = "lint") -> int:
    """Print a code's RULES row and its block of the implementing module's
    docstring (WF26x: ``concurrency.py``; WF30x: ``progcheck.py``, read
    with ``ast``). 2 for an unknown code."""
    if code not in RULES:
        print(f"{prog}: unknown rule code {code!r}; registered codes: "
              f"{', '.join(sorted(RULES))}", file=sys.stderr)
        return 2
    severity, summary = RULES[code]
    print(f"{code} [{severity}] {summary}")
    if code.startswith("WF26"):
        doc = concurrency_module().__doc__ or ""
    elif code.startswith("WF30"):
        doc = progcheck_doc()
    else:
        doc = __doc__ or ""
    in_block = False
    for line in doc.splitlines():
        if line.strip().startswith(code):
            in_block = True
        elif in_block and (line.strip().startswith("WF")
                           or line.strip().startswith("=====")):
            break
        if in_block:
            print(line)
    return 0


def main(argv=None) -> int:
    """``python -m windflow_tpu_torch.analysis.lint``: the flags and exit
    codes of the JAX package's ``scripts/wf_lint.py`` (0 clean, 1
    findings, 2 internal error or broken invocation)."""
    import argparse
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(
        prog="python -m windflow_tpu_torch.analysis.lint",
        description="the port's framework invariant linter")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--root", default=repo,
                    help="repository root to lint (default: this checkout)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file overriding analysis/baseline.json "
                         "(WF_LINT_BASELINE env does the same)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "(written rationales kept) and exit 0")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--select", default=None, metavar="CODES",
                    help="comma-separated codes/families to run in "
                         "isolation (WF230 or WF26x)")
    ap.add_argument("--ignore", default=None, metavar="CODES",
                    help="comma-separated codes/families to drop")
    ap.add_argument("--explain", default=None, metavar="WFnnn",
                    help="print what a rule code means and exit")
    args = ap.parse_args(argv)
    try:
        if args.explain:
            return explain(args.explain)
        if args.update_baseline and (args.select or args.ignore):
            print("lint: refusing --update-baseline with --select/--ignore "
                  "(a partial baseline would drop the other codes' "
                  "suppressions)", file=sys.stderr)
            return 2
        keep = parse_codes(args.select) if args.select else None
        drop = parse_codes(args.ignore) if args.ignore else None
        cfg = LintConfig(root=args.root)
        wf26x = {c for c in RULES if c.startswith("WF26")}
        if (keep is not None and not (keep & wf26x)) \
                or (drop is not None and wf26x <= drop):
            cfg.concurrency = False
        if args.baseline:
            os.environ["WF_LINT_BASELINE"] = os.path.abspath(args.baseline)
        findings = run_lint(cfg=cfg)
        if keep is not None:
            findings = [x for x in findings if x.code in keep]
        if drop is not None:
            findings = [x for x in findings if x.code not in drop]
        bpath = baseline_path(cfg)
        if args.update_baseline:
            save_baseline(bpath, findings)
            print(f"lint: wrote {len(findings)} finding(s) to {bpath}")
            return 0
        if args.no_baseline:
            fresh, suppressed = findings, []
        else:
            fresh, suppressed = split_baseline(cfg, findings)
    except Exception as e:  # noqa: BLE001 — a broken linter must exit 2,
        #                     never masquerade as a clean (0) or dirty (1) run
        print(f"lint: internal error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps({"findings": [x.to_dict() for x in fresh],
                          "suppressed": len(suppressed)}, indent=1))
    else:
        for x in fresh:
            print(x.render())
        print(f"lint: {len(fresh)} finding(s) ({len(suppressed)} baselined)")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())

"""Whole-repo static concurrency analyzer — Pillar 3 of the port's
static-analysis layer (the WF26x family).

Counterpart of ``windflow_tpu/analysis/concurrency.py``: the same rules, the
same annotation grammar and the same ``ROLES`` tuple, run over
``windflow_tpu_torch/``. The port's runtime is one host thread a stage over
its native SPSC rings, plus a reporter thread, step-timeout watchdog
workers, a sharded-checkpoint thread pool, prefetch workers, telemetry and
serving threads. The port has no ``io_callback`` (its cold tier is read by a
kernel through mapped host memory, ``ops/cold_probe.py``): WF262 and the
``jax-callback`` role stay registered, so the two packages' tables stay
equal, but they cannot fire on the port's tree; a fixture that calls an
``io_callback`` still exercises them. The load-bearing cross-thread
contracts ("``settle()`` is driver-thread-only") would otherwise live in
docstrings; this pass makes them CHECKED. Stdlib ``ast`` only, loadable by
file path without torch (the ``lint.py`` convention) — ``analysis/lint.py``
runs it as part of ``run_lint`` and its findings ride the same
``baseline.json`` ratchet.

Four pillars:

====== ========= =====================================================
code   severity  invariant
====== ========= =====================================================
WF260  error     inferred shared-state discipline: a ``self.<attr>``
                 written under one thread role and read/written under
                 another must be accessed inside ``with self.<lock>:``
                 everywhere (one consistent lock), or carry an explicit
                 ``guarded-by[<lock>]`` / ``single-writer[<roles>]``
                 annotation stating why the race is benign
WF261  error     a function annotated ``thread-role[<roles>]`` (a
                 role-constrained API, e.g. the driver-thread-only
                 ``Ordering_Node.settle``) is reachable — through the
                 spawn-site/call-graph role inference — from a role
                 outside its declared set
WF262  error     an ``io_callback`` in a deterministic-replay module
                 must pass a LITERAL ``ordered=True`` (an unordered
                 callback reorders host effects under scan fusion and
                 silently breaks byte-identical replay) and its callback
                 must resolve to a known function (which then carries
                 the ``jax-callback`` role, so WF260 checks its shared
                 state). The port has no ``io_callback``: registered,
                 it cannot fire on the port's tree
WF263  warning   lock-order cycle: the lock-acquisition graph (nested
                 ``with`` blocks + locks acquired by callees while a
                 lock is held) contains a cycle — a potential deadlock
WF264  warning   a non-daemon ``threading.Thread`` is started with no
                 reachable ``join()`` (enclosing function, its direct
                 callees, or a method of the same class) — a leaked
                 thread on the shutdown path
WF265  error     wf-lint concurrency annotation grammar error (unknown
                 role, empty role list)
====== ========= =====================================================

Thread roles
------------

Every function is classified by the set of ROLES it can run on:

- ``driver``          — the user/main thread driving a pipeline run
- ``stage``           — a per-stage/per-pipe worker of the threaded drivers
- ``reporter``        — the metrics reporter tick thread
- ``watchdog``        — a heartbeat/monitor thread (detection only)
- ``checkpoint-pool`` — a sharded-checkpoint ``ThreadPoolExecutor`` worker
- ``jax-callback``    — a JAX ``io_callback`` host-callback thread
- ``prefetch``        — the double-buffered H2D ingest worker
- ``telemetry``       — fleet telemetry plane threads (agent sender,
  aggregator accept/reader/ticker)
- ``ingest``          — serving front-door network threads (SocketSource
  accept loop + per-client frame decoders)
- ``native``          — short-lived native record-framing workers
- ``thread``          — an UNANNOTATED spawned thread (unknown worker)

Inference: spawn sites seed roles (``threading.Thread(target=f)`` seeds
``f`` with the spawn line's ``thread-role[...]`` annotation, else the
``thread`` default; ``ThreadPoolExecutor.submit``/``.map`` seeds
``checkpoint-pool``; a callable passed to ``io_callback`` seeds
``jax-callback``), ``thread-role`` annotations on ``def`` lines seed their
declared roles, and roles propagate through a module-level call graph.
Functions never reached by any spawned role default to ``driver`` (code
only the main thread can reach) and propagate ``driver`` onward.  Call
resolution is deliberately conservative: ``self.m()`` resolves within the
class (+ in-repo bases), locals/attributes constructed from a repo class
resolve precisely, and a bare-name method fallback applies only when the
name is unambiguous (one class) or every definition carries a
``thread-role`` annotation — an unresolved call adds NO edge, so the
analysis under-approximates reachability rather than drowning real
findings in phantom ones.

Annotation grammar (one per physical line; a declaration may also sit on a
pure-comment line directly above):

- ``# wf-lint: thread-role[<role>{,<role>}]``
  * on a ``def`` line: the COMPLETE set of roles this function may run on
    — it both seeds inference and is enforced (WF261 fires when inference
    finds an extra role);
  * on a spawn line (``threading.Thread(...)`` / ``.submit(...)``): the
    role the spawned target runs as (overrides the defaults above).
- ``# wf-lint: single-writer[<role>{,<role>}]`` — on an attribute
  assignment inside a class body (or on the ``class`` line, covering every
  attribute): mutation of the attribute is confined to one owning thread
  (whose role is one of those listed); cross-role readers tolerate
  GIL-atomic staleness.  Suppresses WF260 for the attribute — the roles
  name the writers for the reader of the code, and unknown role names are
  rejected (WF265).
- ``# wf-lint: guarded-by[<lock>]`` — unchanged from WF220 (lint.py
  enforces every access under the lock); WF260 skips declared attributes.
- ``# wf-lint: allow[unguarded]`` — per-line WF260/WF220 escape.
- ``# wf-lint: allow[unordered]`` — per-line WF262 escape.
- ``# wf-lint: allow[lock-order]`` — on a ``with`` line: WF263 escape.
- ``# wf-lint: allow[unjoined]`` — on a spawn line: WF264 escape.

Known limitations (documented, deliberate): attribute PROPERTY loads do
not create call edges (``o.last_release_count`` invoking ``settle`` is
invisible); callables stashed in containers/registries (metrics gauge
closures) are not traced; module-level globals are out of WF260's scope
(they have their own module locks and the WF210/WF241 rules).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

# ------------------------------------------------------------------ grammar

ROLES = ("driver", "stage", "reporter", "watchdog", "checkpoint-pool",
         "jax-callback", "prefetch", "telemetry", "ingest", "native",
         "thread")

#: default role a spawn seeds when the spawn line carries no annotation
DEFAULT_THREAD_ROLE = "thread"
DEFAULT_POOL_ROLE = "checkpoint-pool"
CALLBACK_ROLE = "jax-callback"

_ROLE_RE = re.compile(r"#\s*wf-lint:\s*thread-role\[([a-z0-9_,\- ]*)\]")
_SINGLE_WRITER_RE = re.compile(r"#\s*wf-lint:\s*single-writer"
                               r"\[([a-z0-9_,\- ]*)\]")
_GUARDED_RE = re.compile(r"#\s*wf-lint:\s*guarded-by\[([A-Za-z_]\w*)\]")
_ALLOW_RE = re.compile(r"#\s*wf-lint:\s*allow\[([a-z0-9_,\- ]+)\]")

#: constructors whose product is intrinsically thread-safe (or IS the lock):
#: an attribute initialized from one of these is exempt from WF260
_THREADSAFE_CTORS = frozenset({
    "Lock", "RLock", "Condition", "Event", "Semaphore", "BoundedSemaphore",
    "Barrier", "local", "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
    "SPSCQueue",
})

#: method names treated as MUTATING their receiver (``self.x.append(...)``
#: counts as a write to ``x`` — heuristic, the common stdlib mutators)
_MUTATOR_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popleft", "appendleft",
    "clear", "update", "setdefault", "add", "discard", "put", "put_nowait",
    "sort", "reverse", "write",
})

#: names the global ``obj.m()`` fallback must NEVER resolve by name alone:
#: ubiquitous container/stdlib method names would otherwise alias onto the
#: one repo class that happens to define them (``entries.pop(0)`` is a list
#: pop, not ``SPSCQueue.pop``) and spray phantom roles/lock edges
_FALLBACK_BLOCKLIST = _MUTATOR_METHODS | frozenset({
    "get", "keys", "values", "items", "copy", "index", "count", "join",
    "start", "close", "run", "read", "readline", "open", "next", "send",
    "wait", "set", "is_set", "acquire", "release", "notify", "notify_all",
    "tolist", "item", "sum", "max", "min", "mean", "reshape", "astype",
    "push",
})

#: replay-sensitive modules for the WF262 ordered-effect rule (relative,
#: posix) — the lint.py deterministic set plus the two operator modules
#: whose compiled programs embed host callbacks
DEFAULT_REPLAY_MODULES = (
    "windflow_tpu_torch/runtime/supervisor.py",
    "windflow_tpu_torch/runtime/checkpoint.py",
    "windflow_tpu_torch/control/admission.py",
    "windflow_tpu_torch/state/tiered.py",
    "windflow_tpu_torch/state/host_store.py",
    "windflow_tpu_torch/ops/lookup.py",
    "windflow_tpu_torch/operators/join.py",
    # the serving plane and fleet aggregation: their admission decisions
    # ride the same deterministic-replay path as the supervised drivers
    # they feed
    "windflow_tpu_torch/serving/framing.py",
    "windflow_tpu_torch/serving/sources.py",
    "windflow_tpu_torch/serving/tenants.py",
    "windflow_tpu_torch/serving/runtime.py",
    "windflow_tpu_torch/observability/fleet.py",
)


def _parse_roles(text: str, regex) -> Optional[List[str]]:
    m = regex.search(text)
    if m is None:
        return None
    return [r.strip() for r in m.group(1).split(",")]


def _allows(line: str, tag: str) -> bool:
    m = _ALLOW_RE.search(line)
    return bool(m) and tag in [t.strip() for t in m.group(1).split(",")]


# --------------------------------------------------------------- file model


class _File:
    """One parsed python file (the lint.py shape, self-contained here so the
    module loads by path without importing lint)."""

    def __init__(self, abspath: str, relpath: str):
        self.rel = relpath.replace(os.sep, "/")
        self.tree: Optional[ast.AST] = None
        try:
            with open(abspath, encoding="utf-8") as f:
                self.source = f.read()
        except UnicodeDecodeError:
            self.source = ""              # WF200 is lint.py's job
        self.lines = self.source.splitlines()
        try:
            self.tree = ast.parse(self.source)
        except SyntaxError:
            self.tree = None              # ditto

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def ann(self, lineno: int, regex) -> Optional[List[str]]:
        """Annotation on ``lineno`` or on a pure-comment line directly
        above (the guarded-by convention)."""
        got = _parse_roles(self.line(lineno), regex)
        if got is None:
            above = self.line(lineno - 1).strip()
            if above.startswith("#"):
                got = _parse_roles(above, regex)
        return got

    def allows(self, lineno: int, tag: str) -> bool:
        return _allows(self.line(lineno), tag)


def _walk_py(root: str, rel_dirs: Sequence[str]) -> List[str]:
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
    return out


# ------------------------------------------------------------ function index


class _Func:
    """One function/method/lambda definition."""

    __slots__ = ("qual", "node", "file", "cls", "name", "lineno",
                 "decl_roles", "roles", "provenance",
                 "calls", "call_sites", "entry_held", "local_types",
                 "spawns", "accesses", "acquires",
                 "has_join", "resolved_sites", "edges")

    def __init__(self, qual: str, node, file: _File, cls: Optional[str],
                 name: str):
        self.qual = qual
        self.node = node
        self.file = file
        self.cls = cls                      # innermost enclosing class name
        self.name = name
        self.lineno = getattr(node, "lineno", 1)
        #: declared allowed-role set (thread-role[...] on the def line)
        self.decl_roles: Optional[List[str]] = None
        #: inferred roles + how each was first reached (for the message)
        self.roles: Set[str] = set()
        self.provenance: Dict[str, str] = {}
        #: raw call specs: ("name", id, node) / ("attr", base, attr, node)
        #: / ("selfattr", attr_of_self, method, node)
        self.calls: List[tuple] = []
        #: every call with the locks held at the call site: (held, spec)
        self.call_sites: List[tuple] = []
        #: locks PROVABLY held at entry (every resolved call site holds
        #: them — the must-analysis that lets ``_append_row`` inherit the
        #: ``upsert`` lock); filled by _effective_held
        self.entry_held: frozenset = frozenset()
        #: local var -> repo class name, from in-body constructor bindings
        #: (``acc = MicrobatchAccumulator(...)``) and with-as bindings —
        #: consulted by _resolve_call for ``obj.m()`` receivers
        self.local_types: Dict[str, str] = {}
        #: call sites RESOLVED once per index build (``_indexed``):
        #: ``[(held, spec, [callee quals])]`` — _infer_roles,
        #: _effective_held, _rule_lock_order, and _join_reachable all
        #: consume this instead of re-resolving the whole-repo graph
        self.resolved_sites: List[tuple] = []
        #: flattened unique callee quals of resolved_sites
        self.edges: List[str] = []
        #: spawn records: (kind, target_expr, role, node) with kind in
        #: {"thread", "pool", "iocb"}; role already annotation-resolved
        self.spawns: List[tuple] = []
        #: self-attribute accesses: (attr, is_write, lineno, frozenset(held))
        self.accesses: List[tuple] = []
        #: lock acquisitions: (lock_key, frozenset(held_before), lineno)
        self.acquires: List[tuple] = []
        self.has_join = False


class _Class:
    __slots__ = ("name", "file", "node", "bases", "methods", "attr_types",
                 "threadsafe_attrs", "guarded", "single_writer",
                 "class_single_writer", "lock_attrs", "lock_kinds")

    def __init__(self, name: str, file: _File, node: ast.ClassDef):
        self.name = name
        self.file = file
        self.node = node
        self.bases: List[str] = []
        self.methods: Dict[str, _Func] = {}
        #: self.<attr> -> repo class name (from ``self.x = ClassName(...)``)
        self.attr_types: Dict[str, str] = {}
        self.threadsafe_attrs: Set[str] = set()
        self.guarded: Dict[str, str] = {}          # guarded-by decls
        self.single_writer: Dict[str, List[str]] = {}
        self.class_single_writer: Optional[List[str]] = None
        self.lock_attrs: Set[str] = set()
        self.lock_kinds: Dict[str, str] = {}       # attr -> Lock/RLock/...


class _Index:
    """Whole-tree index: functions, classes, per-file import aliases."""

    def __init__(self):
        self.funcs: List[_Func] = []
        self.by_qual: Dict[str, _Func] = {}
        self.classes: Dict[str, _Class] = {}       # class name -> _Class
        self.module_funcs: Dict[Tuple[str, str], _Func] = {}  # (rel, name)
        self.methods_by_name: Dict[str, List[_Func]] = {}
        self.funcs_by_name: Dict[str, List[_Func]] = {}
        #: per file: local alias -> module basename ("_faults" -> "faults")
        self.mod_alias: Dict[str, Dict[str, str]] = {}
        #: per file: imported name -> (module basename, original name)
        self.from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: module basename -> rel path (ambiguous basenames dropped)
        self.module_files: Dict[str, str] = {}
        #: per file: names bound to threading.Thread / ThreadPoolExecutor /
        #: io_callback via from-imports
        self.thread_names: Dict[str, Set[str]] = {}
        self.pool_names: Dict[str, Set[str]] = {}
        self.iocb_names: Dict[str, Set[str]] = {}
        #: module-level locks: (rel, var) present in ``with var:`` handling
        self.module_locks: Dict[Tuple[str, str], str] = {}
        self.findings: List[dict] = []
        #: snapshot of the indexing-time (WF265 grammar) findings, so cached
        #: re-runs re-emit them exactly once (filled by _indexed)
        self.grammar_findings: List[dict] = []

    def finding(self, code: str, severity: str, file: _File, lineno: int,
                message: str) -> None:
        self.findings.append({
            "code": code, "severity": severity, "path": file.rel,
            "line": lineno, "message": message,
            "text": file.line(lineno).strip()})


# ---------------------------------------------------------------- indexing


def _ctor_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _index_imports(idx: _Index, f: _File) -> None:
    mods: Dict[str, str] = {}
    froms: Dict[str, Tuple[str, str]] = {}
    threads, pools, iocbs = set(), set(), set()
    for node in ast.walk(f.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                base = a.name.split(".")[-1]
                mods[a.asname or a.name.split(".")[0]] = base
        elif isinstance(node, ast.ImportFrom):
            mod = (node.module or "").split(".")[-1]
            for a in node.names:
                local = a.asname or a.name
                if node.module == "threading" and a.name == "Thread":
                    threads.add(local)
                elif a.name == "ThreadPoolExecutor":
                    pools.add(local)
                elif a.name == "io_callback":
                    iocbs.add(local)
                else:
                    # `from . import faults as _faults` imports a MODULE
                    froms[local] = (mod, a.name)
    idx.mod_alias[f.rel] = mods
    idx.from_imports[f.rel] = froms
    idx.thread_names[f.rel] = threads
    idx.pool_names[f.rel] = pools
    idx.iocb_names[f.rel] = iocbs


def _is_thread_ctor(idx: _Index, f: _File, call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id in idx.thread_names[f.rel]
    return (isinstance(fn, ast.Attribute) and fn.attr == "Thread"
            and isinstance(fn.value, ast.Name)
            and idx.mod_alias[f.rel].get(fn.value.id) == "threading")


def _is_pool_ctor(idx: _Index, f: _File, call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id in idx.pool_names[f.rel]
    return isinstance(fn, ast.Attribute) and fn.attr == "ThreadPoolExecutor"


def _is_iocb(idx: _Index, f: _File, call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id in idx.iocb_names[f.rel]
    return isinstance(fn, ast.Attribute) and fn.attr == "io_callback"


class _FuncVisitor:
    """Extract calls/spawns/accesses/locks from ONE function body (does not
    descend into nested function definitions — they are their own _Funcs)."""

    def __init__(self, idx: _Index, fn: _Func, local_types: Dict[str, str]):
        self.idx = idx
        self.fn = fn
        self.f = fn.file
        self.types = local_types        # local var -> repo class name

    # -- lock identity ----------------------------------------------------

    def _lock_key(self, expr) -> Optional[str]:
        """Identity of a ``with`` context that looks like a lock:
        ``self.<attr>`` (class-scoped) or a bare module-level name."""
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self.fn.cls):
            cls = self.idx.classes.get(self.fn.cls)
            attr = expr.attr
            if cls is not None and (attr in cls.lock_attrs
                                    or "lock" in attr.lower()):
                return f"{self.fn.cls}.{attr}"
            return None
        if isinstance(expr, ast.Name) and "lock" in expr.id.lower():
            self.idx.module_locks[(self.f.rel, expr.id)] = expr.id
            return f"{self.f.rel}::{expr.id}"
        return None

    # -- traversal --------------------------------------------------------

    def run(self):
        body = self.fn.node.body if not isinstance(self.fn.node, ast.Lambda) \
            else [self.fn.node.body]
        for stmt in body:
            self._visit(stmt, frozenset())

    def _visit(self, node, held: frozenset):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return                       # separate _Func; held does not carry
        if isinstance(node, ast.With):
            taken = []
            for item in node.items:
                k = self._lock_key(item.context_expr)
                if k is not None:
                    # allow[lock-order] only hides the acquisition from the
                    # WF263 graph — the lock still counts as HELD for WF260.
                    # Earlier items of the SAME statement are already held
                    # when a later one acquires (`with self.a, self.b:` is
                    # an a->b edge like nested withs).
                    if not self.f.allows(node.lineno, "lock-order"):
                        self.fn.acquires.append(
                            (k, held | frozenset(taken), node.lineno))
                    taken.append(k)
                # a with-as over a repo class (ThreadPoolExecutor as ex)
                if (isinstance(item.context_expr, ast.Call)
                        and item.optional_vars is not None
                        and isinstance(item.optional_vars, ast.Name)):
                    if _is_pool_ctor(self.idx, self.f, item.context_expr):
                        self.types[item.optional_vars.id] = \
                            "ThreadPoolExecutor"
                    else:
                        cn = _ctor_name(item.context_expr)
                        if cn in self.idx.classes:
                            self.types[item.optional_vars.id] = cn
                self._visit(item.context_expr, held)
            inner = held | frozenset(taken)
            for child in node.body:
                self._visit(child, inner)
            return
        if isinstance(node, ast.Assign):
            # local type binding: x = ClassName(...) / x = ThreadPoolExecutor(...)
            if (isinstance(node.value, ast.Call)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                if _is_pool_ctor(self.idx, self.f, node.value):
                    self.types[node.targets[0].id] = "ThreadPoolExecutor"
                elif _is_thread_ctor(self.idx, self.f, node.value):
                    self.types[node.targets[0].id] = "threading.Thread"
                else:
                    cn = _ctor_name(node.value)
                    if cn in self.idx.classes:
                        self.types[node.targets[0].id] = cn
        if isinstance(node, ast.Call):
            self._record_call(node, held)
        if isinstance(node, ast.Attribute):
            self._record_access(node, held)
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, (ast.Store, ast.Del))
                and isinstance(node.value, ast.Attribute)
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id == "self"):
            # self.x[k] = v: a WRITE to x (the attr itself loads, the
            # container mutates)
            self.fn.accesses.append((node.value.attr, True, node.lineno,
                                     held))
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    def _record_access(self, node: ast.Attribute, held: frozenset):
        if not (isinstance(node.value, ast.Name) and node.value.id == "self"):
            return
        is_write = isinstance(node.ctx, (ast.Store, ast.Del))
        self.fn.accesses.append((node.attr, is_write, node.lineno, held))

    def _record_call(self, node: ast.Call, held: frozenset):
        fn = node.func
        # spawn sites ------------------------------------------------------
        if _is_thread_ctor(self.idx, self.f, node):
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
            daemon = any(kw.arg == "daemon"
                         and isinstance(kw.value, ast.Constant)
                         and kw.value.value is True
                         for kw in node.keywords)
            for role in self._spawn_roles(node, DEFAULT_THREAD_ROLE):
                if target is not None:
                    self.fn.spawns.append(("thread", target, role, node,
                                           daemon))
            return
        if isinstance(fn, ast.Attribute) and fn.attr in ("submit", "map"):
            base = fn.value
            is_pool = (isinstance(base, ast.Name)
                       and self.types.get(base.id) == "ThreadPoolExecutor")
            if (not is_pool and isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self" and self.fn.cls):
                # executor stored on self (`self._pool.submit(...)`) —
                # typed by _index_class_attrs from the __init__ assignment
                cls = self.idx.classes.get(self.fn.cls)
                is_pool = (cls is not None and cls.attr_types.get(base.attr)
                           == "ThreadPoolExecutor")
            if is_pool and node.args:
                for role in self._spawn_roles(node, DEFAULT_POOL_ROLE):
                    self.fn.spawns.append(("pool", node.args[0], role, node,
                                           True))
                return
        if _is_iocb(self.idx, self.f, node) and node.args:
            for role in self._spawn_roles(node, CALLBACK_ROLE):
                self.fn.spawns.append(("iocb", node.args[0], role, node,
                                       True))
            # fall through: also a call (WF262 inspects it via spawns)
        # mutator-method writes -------------------------------------------
        if (isinstance(fn, ast.Attribute) and fn.attr in _MUTATOR_METHODS
                and isinstance(fn.value, ast.Attribute)
                and isinstance(fn.value.value, ast.Name)
                and fn.value.value.id == "self"):
            cls = self.idx.classes.get(self.fn.cls) if self.fn.cls else None
            # an attr holding a REPO object is a method call (edge), not a
            # container mutation (`self._seg.add(...)` is _Segment.add)
            if cls is None or fn.value.attr not in cls.attr_types:
                self.fn.accesses.append((fn.value.attr, True, node.lineno,
                                         held))
        if isinstance(fn, ast.Attribute) and fn.attr == "join":
            # only thread-shaped receivers count for WF264: a bare local
            # (`t.join()`, incl. loop vars over a thread list) that is not
            # a module alias, or a self attribute (`self._thread.join()`)
            # — NOT os.path.join / ", ".join / some_module.join
            recv = fn.value
            if isinstance(recv, ast.Name):
                if (recv.id not in self.idx.mod_alias[self.f.rel]
                        and recv.id not in self.idx.from_imports[self.f.rel]
                        and self.types.get(recv.id) != "ThreadPoolExecutor"):
                    self.fn.has_join = True
            elif (isinstance(recv, ast.Attribute)
                    and isinstance(recv.value, ast.Name)
                    and recv.value.id == "self"):
                self.fn.has_join = True
        # call edges -------------------------------------------------------
        spec = None
        if isinstance(fn, ast.Name):
            spec = ("name", fn.id, node)
        elif isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name):
                spec = ("attr", base.id, fn.attr, node)
            elif (isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"):
                spec = ("selfattr", base.attr, fn.attr, node)
            else:
                spec = ("attr", None, fn.attr, node)
        if spec is not None:
            self.fn.calls.append(spec)
            self.fn.call_sites.append((held, spec))

    def _spawn_roles(self, node: ast.Call, default: str) -> List[str]:
        """Role(s) a spawn line declares — EVERY listed role seeds the
        target (a multi-role spawn annotation must not silently drop its
        tail); unannotated spawns get the kind's default."""
        roles = self.f.ann(node.lineno, _ROLE_RE)
        if roles is None:
            return [default]
        bad = [r for r in roles if r not in ROLES]
        if bad or not roles or roles == [""]:
            self.idx.finding(
                "WF265", "error", self.f, node.lineno,
                f"thread-role annotation names unknown role(s) "
                f"{bad or roles} — roles: {', '.join(ROLES)}")
            return [default]
        return roles


def _index_tree(root: str, package_dirs: Sequence[str]) -> _Index:
    idx = _Index()
    files = [_File(p, os.path.relpath(p, root))
             for p in _walk_py(root, package_dirs)]
    files = [f for f in files if f.tree is not None]
    # module basename -> rel path (drop ambiguous, e.g. two __init__.py)
    seen: Dict[str, List[str]] = {}
    for f in files:
        seen.setdefault(os.path.basename(f.rel)[:-3], []).append(f.rel)
    idx.module_files = {b: p[0] for b, p in seen.items() if len(p) == 1}

    for f in files:
        _index_imports(idx, f)
        _collect_defs(idx, f)
    # class attr types + lock/threadsafe attrs need the class table complete
    for cls in idx.classes.values():
        _index_class_attrs(idx, cls)
    # extract bodies; each visitor fills the function's local-type map
    # (constructor + with-as bindings), consulted later by _resolve_call
    for fn in idx.funcs:
        v = _FuncVisitor(idx, fn, {})
        v.run()
        fn.local_types = v.types
    return idx


def _collect_defs(idx: _Index, f: _File) -> None:
    def walk(node, scope: List[str], cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                c = _Class(child.name, f, child)
                c.bases = [b.id if isinstance(b, ast.Name)
                           else (b.attr if isinstance(b, ast.Attribute)
                                 else "") for b in child.bases]
                c.class_single_writer = f.ann(child.lineno,
                                              _SINGLE_WRITER_RE)
                if c.class_single_writer is not None:
                    _check_roles(idx, f, child.lineno,
                                 c.class_single_writer, "single-writer")
                # first definition wins; duplicate class names across the
                # tree are rare and only blunt resolution
                idx.classes.setdefault(child.name, c)
                walk(child, scope + [child.name], child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{f.rel}::{'.'.join(scope + [child.name])}"
                fn = _Func(qual, child, f, cls, child.name)
                fn.decl_roles = f.ann(child.lineno, _ROLE_RE)
                if fn.decl_roles is not None:
                    _check_roles(idx, f, child.lineno, fn.decl_roles,
                                 "thread-role")
                idx.funcs.append(fn)
                idx.by_qual[qual] = fn
                if cls is not None and len(scope) and scope[-1] == cls:
                    idx.classes[cls].methods.setdefault(child.name, fn)
                    idx.methods_by_name.setdefault(child.name,
                                                   []).append(fn)
                elif not scope:
                    idx.module_funcs[(f.rel, child.name)] = fn
                idx.funcs_by_name.setdefault(child.name, []).append(fn)
                walk(child, scope + [child.name], cls)
            elif isinstance(child, ast.Lambda):
                qual = f"{f.rel}::{'.'.join(scope)}.<lambda>@{child.lineno}"
                fn = _Func(qual, child, f, cls, "<lambda>")
                idx.funcs.append(fn)
                idx.by_qual[qual] = fn
                walk(child, scope, cls)
            else:
                walk(child, scope, cls)

    walk(f.tree, [], None)


def _check_roles(idx: _Index, f: _File, lineno: int, roles: List[str],
                 kind: str) -> None:
    bad = [r for r in roles if r not in ROLES]
    if bad or not roles or roles == [""]:
        idx.finding("WF265", "error", f, lineno,
                    f"{kind} annotation names unknown role(s) "
                    f"{bad or roles} — roles: {', '.join(ROLES)}")


def _param_ann_types(cls: _Class) -> Dict[str, str]:
    """``{param name: annotated class name}`` of the class's ``__init__``
    (string annotations like ``"Tracer"`` included)."""
    out: Dict[str, str] = {}
    for node in cls.node.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == "__init__":
            for arg in node.args.args + node.args.kwonlyargs:
                ann = arg.annotation
                if isinstance(ann, ast.Name):
                    out[arg.arg] = ann.id
                elif isinstance(ann, ast.Constant) \
                        and isinstance(ann.value, str):
                    out[arg.arg] = ann.value
    return out


def _index_class_attrs(idx: _Index, cls: _Class) -> None:
    f = cls.file
    for node in ast.walk(cls.node):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        for t in targets:
            if not (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                continue
            attr = t.attr
            g = f.ann(node.lineno, _GUARDED_RE)
            if g:
                cls.guarded[attr] = g[0]
            sw = f.ann(node.lineno, _SINGLE_WRITER_RE)
            if sw is not None:
                _check_roles(idx, f, node.lineno, sw, "single-writer")
                cls.single_writer[attr] = sw
            val = getattr(node, "value", None)
            if isinstance(val, ast.Call):
                cn = _ctor_name(val)
                if cn == "ThreadPoolExecutor":
                    cls.attr_types[attr] = "ThreadPoolExecutor"
                elif cn in _THREADSAFE_CTORS:
                    cls.threadsafe_attrs.add(attr)
                    if cn in ("Lock", "RLock", "Condition"):
                        cls.lock_attrs.add(attr)
                        cls.lock_kinds[attr] = cn
                elif cn in idx.classes:
                    cls.attr_types[attr] = cn
            elif isinstance(val, ast.Name):
                # `self.x = seg` where __init__ declares `seg: _Segment` —
                # the parameter annotation types the attribute
                t = _param_ann_types(cls).get(val.id)
                if t is not None and t in idx.classes:
                    cls.attr_types[attr] = t


# ------------------------------------------------------------ call resolution


def _class_method(idx: _Index, cls_name: str, meth: str,
                  _seen=None) -> Optional["_Func"]:
    """Method lookup through the in-repo base chain (by class name)."""
    if _seen is None:
        _seen = set()
    if cls_name in _seen:
        return None
    _seen.add(cls_name)
    cls = idx.classes.get(cls_name)
    if cls is None:
        return None
    if meth in cls.methods:
        return cls.methods[meth]
    for b in cls.bases:
        got = _class_method(idx, b, meth, _seen)
        if got is not None:
            return got
    return None


def _name_fallback(idx: _Index, meth: str) -> List["_Func"]:
    """Conservative global fallback for an unresolved ``obj.m()``: edges
    only when the name is defined in exactly ONE class, or when EVERY
    definition carries the SAME thread-role declaration (the analyst opted
    those APIs into being chased through untyped receivers; identical sets
    mean the edges cannot smear one class's allowed roles into a stricter
    class — either every candidate violates or none does).  Ubiquitous
    stdlib method names never resolve by name alone."""
    if meth in _FALLBACK_BLOCKLIST or meth.startswith("__"):
        return []
    cands = idx.methods_by_name.get(meth, [])
    classes = {c.cls for c in cands}
    if len(classes) == 1:
        return cands
    if cands and all(c.decl_roles is not None for c in cands):
        sets = {frozenset(c.decl_roles) for c in cands}
        if len(sets) == 1:
            return cands
    return []


def _resolve_call(idx: _Index, caller: _Func, spec) -> List["_Func"]:
    kind = spec[0]
    if kind == "name":
        name = spec[1]
        # nested def in an enclosing scope of this file: qual prefix search
        prefix = caller.qual.rsplit("::", 1)
        scope_path = prefix[1] if len(prefix) == 2 else ""
        parts = scope_path.split(".")
        for i in range(len(parts), -1, -1):
            qual = f"{caller.file.rel}::{'.'.join(parts[:i] + [name])}"
            got = idx.by_qual.get(qual)
            if got is not None:
                return [got]
        got = idx.module_funcs.get((caller.file.rel, name))
        if got is not None:
            return [got]
        fi = idx.from_imports[caller.file.rel].get(name)
        if fi is not None:
            mod_rel = idx.module_files.get(fi[0])
            if mod_rel:
                got = idx.module_funcs.get((mod_rel, fi[1]))
                if got is not None:
                    return [got]
        return []
    if kind == "attr":
        _k, base, meth, _node = spec
        if base == "self" and caller.cls:
            got = _class_method(idx, caller.cls, meth)
            return [got] if got is not None else []
        if base is not None:
            # a constructor-typed local resolves precisely (`acc =
            # MicrobatchAccumulator(...); acc.drain()`)
            t = caller.local_types.get(base)
            if t is not None and t in idx.classes:
                got = _class_method(idx, t, meth)
                return [got] if got is not None else []
            mod = idx.mod_alias[caller.file.rel].get(base)
            if mod is None:
                fi = idx.from_imports[caller.file.rel].get(base)
                mod = fi[0] if fi is not None and fi[1] == fi[0] else \
                    (fi[1] if fi is not None else None)
            if mod is not None:
                mod_rel = idx.module_files.get(mod)
                if mod_rel:
                    got = idx.module_funcs.get((mod_rel, meth))
                    return [got] if got is not None else []
                return []
        return _name_fallback(idx, meth)
    if kind == "selfattr":
        _k, attr, meth, _node = spec
        cls = idx.classes.get(caller.cls) if caller.cls else None
        if cls is not None and attr in cls.attr_types:
            got = _class_method(idx, cls.attr_types[attr], meth)
            return [got] if got is not None else []
        return _name_fallback(idx, meth)
    return []


def _resolve_target(idx: _Index, caller: _Func, expr) -> List["_Func"]:
    """Spawn/callback target resolution — broader than call edges (a missed
    target means a whole thread's code runs unclassified)."""
    if isinstance(expr, ast.Lambda):
        qual_prefix = caller.qual.rsplit("::", 1)
        scope = qual_prefix[1] if len(qual_prefix) == 2 else ""
        parts = scope.split(".") if scope else []
        for i in range(len(parts), -1, -1):
            qual = (f"{caller.file.rel}::"
                    f"{'.'.join(parts[:i] + [f'<lambda>@{expr.lineno}'])}")
            got = idx.by_qual.get(qual)
            if got is not None:
                return [got]
        # lambda quals are scope-exact; fall back to a scan
        return [fn for fn in idx.funcs
                if fn.node is expr]
    if isinstance(expr, ast.Name):
        got = _resolve_call(idx, caller, ("name", expr.id, None))
        if got:
            return got
        return idx.funcs_by_name.get(expr.id, [])
    if isinstance(expr, ast.Attribute):
        base = expr.value
        if isinstance(base, ast.Name):
            got = _resolve_call(idx, caller,
                                ("attr", base.id, expr.attr, None))
            if got:
                return got
        elif (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"):
            got = _resolve_call(idx, caller,
                                ("selfattr", base.attr, expr.attr, None))
            if got:
                return got
        return idx.methods_by_name.get(expr.attr, []) or \
            idx.funcs_by_name.get(expr.attr, [])
    return []


# ------------------------------------------------------------ role inference


def _infer_roles(idx: _Index) -> None:
    edges: Dict[str, List[str]] = {fn.qual: fn.edges for fn in idx.funcs}

    def propagate(seeds: List[Tuple[_Func, str, str]]):
        work = []
        for fn, role, why in seeds:
            if role not in fn.roles:
                fn.roles.add(role)
                fn.provenance[role] = why
                work.append((fn, role))
        while work:
            fn, role = work.pop()
            for q in edges.get(fn.qual, ()):
                callee = idx.by_qual[q]
                if role not in callee.roles:
                    callee.roles.add(role)
                    callee.provenance[role] = \
                        f"{fn.provenance.get(role, fn.qual)} -> {callee.name}"
                    work.append((callee, role))

    seeds: List[Tuple[_Func, str, str]] = []
    for fn in idx.funcs:
        if fn.decl_roles:
            for r in fn.decl_roles:
                if r in ROLES:
                    seeds.append((fn, r, f"declared at {fn.qual}"))
        for kind, target, role, node, _daemon in fn.spawns:
            for tgt in _resolve_target(idx, fn, target):
                seeds.append((
                    tgt, role,
                    f"spawned as {role} at "
                    f"{fn.file.rel}:{node.lineno} ({kind})"))
    propagate(seeds)
    # driver default: anything no spawned role reaches is main-thread code
    driver_seeds = [(fn, "driver", f"main-thread default at {fn.qual}")
                    for fn in idx.funcs if not fn.roles]
    propagate(driver_seeds)


def _effective_held(idx: _Index) -> None:
    """Must-analysis: a function whose EVERY resolved call site holds lock L
    effectively runs under L (``HostStore._append_row`` inherits the
    ``upsert`` lock).  Standard intersection fixpoint: entry_held(f) =
    ∩ over call sites (site_held ∪ entry_held(caller)); functions with no
    known call sites (entry points, spawn targets) start — and stay — at ∅.
    Self-recursive edges are ignored (a recursive call cannot prove its own
    entry lock)."""
    sites: Dict[str, List[Tuple[str, frozenset]]] = {}
    for fn in idx.funcs:
        for held, _spec, quals in fn.resolved_sites:
            for q in quals:
                if q != fn.qual:
                    sites.setdefault(q, []).append((fn.qual, held))
    universe = frozenset(k for f in idx.funcs for k, _h, _l in f.acquires)
    eff = {fn.qual: (universe if fn.qual in sites and not fn.spawns
                     and fn.decl_roles is None else frozenset())
           for fn in idx.funcs}
    # spawn TARGETS must also start at ∅ — being called somewhere under a
    # lock proves nothing about the spawned invocation
    spawn_targets = set()
    for fn in idx.funcs:
        for _k, target, _r, _n, _d in fn.spawns:
            for tgt in _resolve_target(idx, fn, target):
                spawn_targets.add(tgt.qual)
    for q in spawn_targets:
        eff[q] = frozenset()
    changed = True
    while changed:
        changed = False
        for q, callers in sites.items():
            if q in spawn_targets:
                continue
            new = None
            for caller_q, held in callers:
                s = held | eff.get(caller_q, frozenset())
                new = s if new is None else (new & s)
            new = new or frozenset()
            if new != eff.get(q):
                eff[q] = new
                changed = True
    for fn in idx.funcs:
        fn.entry_held = eff.get(fn.qual, frozenset())


# ------------------------------------------------------------------- rules


def _rule_role_constraints(idx: _Index) -> None:
    """WF261: inferred roles must stay inside the declared set."""
    for fn in idx.funcs:
        if not fn.decl_roles:
            continue
        declared = {r for r in fn.decl_roles if r in ROLES}
        extra = sorted(fn.roles - declared)
        for role in extra:
            where = fn.provenance.get(role, "?")
            label = f"{fn.cls}.{fn.name}" if fn.cls else fn.name
            idx.finding(
                "WF261", "error", fn.file, fn.lineno,
                f"{label} is declared thread-role"
                f"[{', '.join(fn.decl_roles)}] but is reachable on role "
                f"'{role}' (via {where}) — call it from an allowed role "
                f"only, widen the annotation with a rationale, or break "
                f"the call path")


def _rule_shared_state(idx: _Index) -> None:
    """WF260: cross-role mutable attributes must be consistently locked or
    explicitly annotated."""
    for cls in idx.classes.values():
        # collect accesses per attr from every method (incl. nested funcs
        # whose enclosing class is this one)
        per_attr: Dict[str, List[tuple]] = {}
        for fn in idx.funcs:
            if fn.cls != cls.name or fn.file.rel != cls.file.rel:
                continue
            if fn.name in ("__init__", "__post_init__") \
                    or ".__init__." in fn.qual \
                    or ".__post_init__." in fn.qual:
                continue                  # construction happens-before spawn
            roles = frozenset(fn.roles) or frozenset({"driver"})
            for attr, is_write, lineno, held in fn.accesses:
                per_attr.setdefault(attr, []).append(
                    (roles, is_write, lineno, held | fn.entry_held, fn))
        for attr, accs in sorted(per_attr.items()):
            if attr in cls.guarded or attr in cls.threadsafe_attrs:
                continue
            if attr in cls.single_writer or \
                    cls.class_single_writer is not None:
                continue
            roles_all: Set[str] = set()
            for roles, _w, _l, _h, _fn in accs:
                roles_all |= roles
            writes = [a for a in accs if a[1]]
            if not writes or len(roles_all) < 2:
                continue
            live = [a for a in accs
                    if not a[4].file.allows(a[2], "unguarded")]
            if not live:
                continue
            held_sets = [a[3] for a in live]
            common = set(held_sets[0])
            for h in held_sets[1:]:
                common &= h
            if common:
                continue                  # one lock covers every access
            unlocked = next((a for a in live if not a[3]), live[0])
            writer_roles = set()
            for roles, w, _l, _h, _fn in accs:
                if w:
                    writer_roles |= roles
            idx.finding(
                "WF260", "error", cls.file, unlocked[2],
                f"{cls.name}.{attr} is written under role(s) "
                f"{sorted(writer_roles)} and accessed under "
                f"{sorted(roles_all)} without one consistent "
                f"`with self.<lock>:` around every access — guard it, or "
                f"annotate the declaration with "
                f"`# wf-lint: guarded-by[<lock>]` / "
                f"`# wf-lint: single-writer[<role>]` and say why the "
                f"race is benign")


def _rule_ordered_effects(idx: _Index, replay: Set[str]) -> None:
    """WF262: io_callback in replay modules — literal ordered=True + a
    resolvable callback."""
    seen: Set[int] = set()
    for fn in idx.funcs:
        if fn.file.rel not in replay:
            continue
        for kind, target, _role, node, _d in fn.spawns:
            if kind != "iocb" or id(node) in seen:
                continue                 # one check per call site (a multi-
            seen.add(id(node))           # role spawn has N records)
            if fn.file.allows(node.lineno, "unordered"):
                continue
            ordered = None
            for kw in node.keywords:
                if kw.arg == "ordered":
                    ordered = kw.value
            if not (isinstance(ordered, ast.Constant)
                    and ordered.value is True):
                idx.finding(
                    "WF262", "error", fn.file, node.lineno,
                    "io_callback in a deterministic-replay module must "
                    "pass a LITERAL ordered=True — an unordered host "
                    "callback reorders side effects under scan-fused "
                    "dispatch and breaks byte-identical replay")
            if not _resolve_target(idx, fn, target):
                idx.finding(
                    "WF262", "error", fn.file, node.lineno,
                    "io_callback target does not resolve to a known "
                    "function/method — the analyzer cannot assign it the "
                    "jax-callback role, so its shared-state discipline "
                    "is unchecked; pass a named function or method")


def _rule_lock_order(idx: _Index) -> None:
    """WF263: cycles in the lock-acquisition graph."""
    # eventual locks per function (direct + callees, fixpoint)
    direct: Dict[str, Set[str]] = {
        fn.qual: {k for k, _h, _l in fn.acquires} for fn in idx.funcs}
    callees: Dict[str, List[str]] = {fn.qual: fn.edges for fn in idx.funcs}
    eventual = {q: set(s) for q, s in direct.items()}
    changed = True
    while changed:
        changed = False
        for q, outs in callees.items():
            for o in outs:
                new = eventual.get(o, set()) - eventual[q]
                if new:
                    eventual[q] |= new
                    changed = True
    # edges held -> acquired
    graph: Dict[str, Set[str]] = {}
    site: Dict[Tuple[str, str], Tuple[_File, int]] = {}

    def edge(a: str, b: str, f: _File, lineno: int):
        if a == b:
            return                        # reentrancy handled separately
        graph.setdefault(a, set()).add(b)
        site.setdefault((a, b), (f, lineno))

    def _is_plain_lock(k: str) -> bool:
        cls_attr = k.split(".", 1)
        if len(cls_attr) == 2 and cls_attr[0] in idx.classes:
            return idx.classes[cls_attr[0]].lock_kinds.get(
                cls_attr[1]) == "Lock"
        return False

    for fn in idx.funcs:
        for k, held, lineno in fn.acquires:
            for h in held:
                edge(h, k, fn.file, lineno)
        for held, spec, quals in fn.resolved_sites:
            if not held:
                continue
            for q in quals:
                for k in eventual.get(q, ()):
                    if k in held:
                        # calling into code that re-takes a lock we hold:
                        # a plain Lock deadlocks right here (the a==b edge
                        # the cycle graph deliberately drops)
                        if _is_plain_lock(k):
                            idx.finding(
                                "WF263", "warning", fn.file,
                                spec[-1].lineno,
                                f"call while holding {k} reaches code "
                                f"that re-acquires it ({q.split('::')[-1]}"
                                f") — a non-reentrant Lock deadlocks; "
                                f"hoist the call out of the lock or use "
                                f"an RLock")
                        continue
                    for h in held:
                        edge(h, k, fn.file, spec[-1].lineno)
        # direct self-reacquire of a non-reentrant Lock (nested withs)
        for k, held, lineno in fn.acquires:
            if k in held and _is_plain_lock(k):
                idx.finding(
                    "WF263", "warning", fn.file, lineno,
                    f"re-acquiring non-reentrant lock {k} while "
                    f"already holding it — guaranteed deadlock")
    # cycle detection (DFS)
    color: Dict[str, int] = {}
    stack: List[str] = []
    reported: Set[frozenset] = set()

    def dfs(u: str):
        color[u] = 1
        stack.append(u)
        for v in graph.get(u, ()):
            if color.get(v, 0) == 0:
                dfs(v)
            elif color.get(v) == 1:
                cyc = stack[stack.index(v):] + [v]
                key = frozenset(cyc)
                if key not in reported:
                    reported.add(key)
                    f, lineno = site[(u, v)]
                    idx.finding(
                        "WF263", "warning", f, lineno,
                        f"lock-order cycle {' -> '.join(cyc)} — two "
                        f"threads taking these locks in opposite orders "
                        f"deadlock; impose one global order or collapse "
                        f"to one lock")
        stack.pop()
        color[u] = 2

    for u in list(graph):
        if color.get(u, 0) == 0:
            dfs(u)


def _rule_unjoined_threads(idx: _Index) -> None:
    """WF264: a non-daemon thread with no reachable join() leaks past
    shutdown."""
    seen: Set[int] = set()
    for fn in idx.funcs:
        for kind, _t, _r, node, daemon in fn.spawns:
            if kind != "thread" or daemon or id(node) in seen:
                continue
            seen.add(id(node))
            if fn.file.allows(node.lineno, "unjoined"):
                continue
            if _join_reachable(idx, fn):
                continue
            idx.finding(
                "WF264", "warning", fn.file, node.lineno,
                "non-daemon thread is started but no join() is reachable "
                "from the spawning function, its callees, or its class — "
                "join it on the shutdown path, mark it daemon=True, or "
                "annotate `# wf-lint: allow[unjoined]` with a rationale")


def _join_reachable(idx: _Index, fn: _Func) -> bool:
    if fn.has_join:
        return True
    for q in fn.edges:                          # direct callees, one hop
        if idx.by_qual[q].has_join:
            return True
    if fn.cls:
        cls = idx.classes.get(fn.cls)
        if cls is not None and any(m.has_join for m in cls.methods.values()):
            return True
    return False


# -------------------------------------------------------------- entry point

#: (root, dirs, file-signature) -> indexed+inferred tree.  The index (parse
#: + call graph + role inference + must-held fixpoint) dominates the pass's
#: cost and is a pure function of the scanned sources, so repeat runs in one
#: process (the tier-1 gates call run_lint several times) reuse it; the
#: signature carries every file's (path, mtime_ns, size), so an edited tree
#: re-indexes.  The per-rule passes re-run every time (they are cheap and
#: depend on replay_modules).
_INDEX_CACHE: Dict[tuple, "_Index"] = {}


def _indexed(root: str, package_dirs: Sequence[str]) -> "_Index":
    sig = []
    for p in _walk_py(root, package_dirs):
        try:
            st = os.stat(p)
            sig.append((p, st.st_mtime_ns, st.st_size))
        except OSError:
            sig.append((p, 0, 0))
    key = (os.path.abspath(root), tuple(package_dirs), tuple(sig))
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        idx = _index_tree(root, package_dirs)
        # resolve the call graph ONCE; every later pass reads
        # fn.resolved_sites/fn.edges instead of re-resolving
        for fn in idx.funcs:
            resolved = []
            outs = set()
            for held, spec in fn.call_sites:
                quals = [c.qual for c in _resolve_call(idx, fn, spec)]
                resolved.append((held, spec, quals))
                outs.update(quals)
            fn.resolved_sites = resolved
            fn.edges = sorted(outs)
        #: grammar (WF265) findings discovered during indexing — snapshot
        #: so repeat runs re-emit them without double-appending
        _infer_roles(idx)
        _effective_held(idx)
        idx.grammar_findings = list(idx.findings)
        if len(_INDEX_CACHE) >= 8:    # bound the memory across fixture trees
            _INDEX_CACHE.clear()
        _INDEX_CACHE[key] = idx
    idx.findings = list(idx.grammar_findings)
    return idx


def run_rules(root: str, package_dirs: Sequence[str] = ("windflow_tpu_torch",),
              replay_modules: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the whole-repo concurrency pass; returns plain finding dicts
    (``code``/``severity``/``path``/``line``/``message``/``text``) —
    ``analysis/lint.py`` wraps them into its ``Finding`` type so they ride
    the shared baseline ratchet."""
    idx = _indexed(root, package_dirs)
    _rule_role_constraints(idx)
    _rule_shared_state(idx)
    replay = {p.replace(os.sep, "/")
              for p in (replay_modules if replay_modules is not None
                        else DEFAULT_REPLAY_MODULES)}
    _rule_ordered_effects(idx, replay)
    _rule_lock_order(idx)
    _rule_unjoined_threads(idx)
    out = sorted(idx.findings,
                 key=lambda d: (d["path"], d["line"], d["code"]))
    return out


def inferred_roles(root: str, package_dirs: Sequence[str] = ("windflow_tpu_torch",),
                   ) -> Dict[str, List[str]]:
    """Debug/report surface: ``{function qualname: sorted roles}`` (used by
    tests and by humans answering 'why did WF261 fire?')."""
    idx = _indexed(root, package_dirs)
    return {fn.qual: sorted(fn.roles) for fn in idx.funcs}

"""Device-program analyzer — Pillar 4 of the port's static-analysis layer (WF3xx).

Counterpart of ``windflow_tpu/analysis/progcheck.py``. Where the JAX package
walks the closed jaxprs of a chain's step and scan programs, the port walks
``torch.fx`` graphs made by ``make_fx(..., tracing_mode="fake")`` over the
same per-batch step and K-step bodies that ``CompiledChain.push`` and
``push_many`` run (``CompiledChain._k_steps``). Inputs are fake tensors on
the chain's device, so a trace does zero FLOPs and touches no device.

The hand kernels are ``ctypes`` calls and cannot be traced: a trace runs
under the registry's plain selection (``ops/registry.py::plain_selection``,
forced for the trace and not recorded), and each :class:`Program` records in
``kernels`` the hand kernels the real step resolves to on its device (empty
on the CPU). How kernels are called on the main path does not change.

A step whose trace stops at a host read (``.item()``, ``bool(t)``, a
data-dependent output shape) is traced again operator by operator: the
operator that reads is reported (WF302) and the others are analyzed.

====== ========= =====================================================
code   severity  invariant
====== ========= =====================================================
WF300  error     order-dependent float accumulation in a deterministic-
                 replay program: ``aten.index_add``/``scatter_add``/
                 ``scatter_reduce(sum)``/``index_put(accumulate=True)``
                 on a float dtype accumulates colliding values in an
                 order the backend may change, so supervised replay is
                 bitwise-reproducible only by luck.  Fix: integer
                 accumulation, or a fixed-order fold (the port's
                 ``segment_fold_float`` kernel on the card)
WF301  error     unordered host effect in a compiled body (an
                 ``io_callback`` without ``ordered=True``).  The port
                 has no host callbacks in a step: registered, it
                 cannot fire (a standing difference)
WF302  warning   host sync in the per-push step: a host read
                 (``aten._local_scalar_dense`` from ``.item()``,
                 ``int(t)``, ``bool(t)``), a data-dependent output
                 shape (``nonzero``, ``unique``) or a copy to the CPU
                 — the host waits for the device on EVERY push, and a
                 CUDA-graph capture refuses it.  Named by the aten op
                 and the operator
WF303  warning   retrace-signature hazard from weak-typed inputs.
                 Torch has no weak types: registered, it cannot fire
WF304  error     donated-buffer aliasing (``donate_argnums``).  Torch
                 has no buffer donation: registered, it cannot fire
WF305  warning   shard/K-variant float reduction: a float
                 ``sum``/``mean``/``cumsum``/``mm``/``bmm``/``addmm``
                 in a program analyzed under dispatch K>1 or
                 shards>1 — float addition is non-associative, so the
                 grouping (and the bytes) can change with the
                 composition geometry (integer reductions are exact
                 and never flagged)
====== ========= =====================================================

``program_fingerprint`` is the other half: a canonical structural hash of a
traced program — ops, arguments, shapes, dtypes and topology under
first-use node numbering, constant values digested — with devices and
object addresses taken out, so a chain built on the card and the same chain
built on the CPU give the same digest, in any process.

Baseline: ``windflow_tpu_torch/analysis/progcheck_baseline.json`` (override:
``WF_PROGCHECK_BASELINE``) suppresses audited findings, and EVERY entry must
carry a non-empty ``rationale``: an entry without one fails the gate.
CLI: ``python -m windflow_tpu_torch.analysis.progcheck`` (the flags of the
JAX package's ``scripts/wf_progcheck.py``; exit 0 clean, 1 findings, 2
internal error).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..batch import Batch, stack_batches
from .lint import Finding

# --------------------------------------------------------------- programs


@dataclasses.dataclass
class Program:
    """One traced program plus the execution context it was traced for — the
    unit every WF3xx rule runs over."""

    target: str              # audit-target label, e.g. "nexmark:q3"
    kind: str                # "step" | "scan"
    gm: Optional[Any]        # torch.fx.GraphModule of the whole program, or
    #                          None where a host read stopped the trace
    capacity: int
    k: int = 1               # fused dispatch K (kind == "scan")
    shards: int = 1          # shard count the program will run under
    replay: bool = False     # deterministic-replay (supervised) context
    #: hand kernels the real program launches on its device
    kernels: Tuple[str, ...] = ()
    #: per-operator graphs ``(label, gm or None)`` when the whole trace failed
    parts: List[Tuple[str, Optional[Any]]] = dataclasses.field(default_factory=list)
    #: ``(operator label, what)`` where a per-operator trace hit a host read
    host_reads: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    @property
    def path(self) -> str:
        """Baseline identity path (the lint Finding ``path`` slot)."""
        return f"{self.target}/{self.kind}"

    def graphs(self) -> List[Tuple[str, Any]]:
        """``(label, GraphModule)`` of every traced graph of the program."""
        if self.gm is not None:
            return [("", self.gm)]
        return [(label, g) for label, g in self.parts if g is not None]


def _flat(tree) -> List[Any]:
    from ..runtime.graphs import leaves
    return leaves(tree)


def _rebuild(tree, new_leaves) -> Any:
    from ..runtime.graphs import rebuild
    return rebuild(tree, new_leaves)


def _tensor_positions(leaves_: Sequence[Any]) -> List[int]:
    return [i for i, x in enumerate(leaves_) if isinstance(x, torch.Tensor)]


#: custom ops that are hand kernels on a CUDA operand (traced opaquely, as
#: one node, through their fake implementation)
_CUSTOM_KERNELS = {"windflow_tpu_torch.masked_window_reduce": "masked_window_reduce"}


def _host_read(e: BaseException) -> Optional[str]:
    """The aten op or the reason of a trace stopped by a host read, or None
    for any other failure."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    if isinstance(e, (DataDependentOutputException, DynamicOutputShapeException)):
        return str(getattr(e, "func", "") or type(e).__name__)
    msg = str(e)
    if "data-dependent" in msg or "data dependent" in msg or "_local_scalar_dense" in msg:
        return "aten._local_scalar_dense.default"
    if ".numpy() is not supported" in msg:         # a host copy read by numpy
        return "Tensor.numpy"
    return None


def _trace(fn: Callable, tree: Any, device) -> Tuple[Any, set]:
    """``make_fx`` of ``fn(tree)`` over fake tensors: ``tree``'s tensors
    become fake tensors on their device (no data read) and the trace runs
    under the plain selection. Returns ``(GraphModule, would-launch set)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from ..ops.registry import plain_selection
    leaves_ = _flat(tree)
    pos = _tensor_positions(leaves_)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fakes = [mode.from_tensor(leaves_[i]) for i in pos]

    def flat_fn(*ts):
        new = list(leaves_)
        for i, t in zip(pos, ts):
            new[i] = t
        out = fn(_rebuild(tree, new))
        return [x for x in _flat(out) if isinstance(x, torch.Tensor)]

    with plain_selection() as seen:
        gm = make_fx(flat_fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*fakes)
    for node in gm.graph.nodes:
        name = _custom_name(node)
        val = node.meta.get("val")
        if name in _CUSTOM_KERNELS and getattr(val, "device", None) is not None \
                and val.device.type == "cuda":
            seen.add(_CUSTOM_KERNELS[name])
    return gm, seen


def _custom_name(node) -> str:
    tgt = node.target
    op = getattr(tgt, "_schema", None)
    return op.name.replace("::", ".") if op is not None else ""


def _fake_batch(capacity: int, spec, device, k: Optional[int] = None):
    """An all-invalid batch (``[K, C, ...]`` stacked when ``k``) of fake
    tensors on ``device``: nothing is allocated there."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        b = Batch.empty(capacity, spec, device)
        return stack_batches([b] * k) if k else b


def _op_label(j: int, op) -> str:
    return f"ops[{j}]:{op.getName()}"


def trace_step(chain, capacity: int):
    """``(GraphModule, would-launch kernels)`` of the full-chain per-push
    step — the body ``CompiledChain.push`` runs — traced over fake tensors."""
    def step(tree):
        states, batch = tree
        states = list(states)
        for j, op in enumerate(chain.ops):
            states[j], batch = op.apply(states[j], batch)
        return tuple(states), batch
    return _trace(step, (tuple(chain.states),
                         _fake_batch(capacity, chain.specs[0], chain.device)),
                  chain.device)


def trace_scan(chain, k: int, capacity: int):
    """``(GraphModule, would-launch kernels)`` of the K-step program — the
    body ``CompiledChain.push_many`` captures (``_k_steps``)."""
    body = chain._k_steps(0)
    return _trace(lambda tree: body(*tree),
                  (list(chain.states),
                   _fake_batch(capacity, chain.specs[0], chain.device, k=int(k))),
                  chain.device)


def trace_ops(chain, capacity: int):
    """Per-operator traces of the step: ``(parts, host_reads, kernels)``;
    an operator whose trace stops at a host read has no graph."""
    parts, reads, kernels = [], [], set()
    cap = capacity
    for j, op in enumerate(chain.ops):
        label = _op_label(j, op)
        b = _fake_batch(cap, chain.specs[j], chain.device)
        try:
            gm, seen = _trace(lambda tree, op=op: op.apply(*tree),
                              (chain.states[j], b), chain.device)
        except Exception as e:  # noqa: BLE001 — classified just below
            what = _host_read(e)
            if what is None:
                raise
            parts.append((label, None))
            reads.append((label, what))
        else:
            parts.append((label, gm))
            kernels |= seen
        cap = op.out_capacity(cap) if cap is not None else None
    return parts, reads, kernels


def chain_programs(chain, capacity: int = None, k: int = 1,
                   shards: int = 1, replay: bool = False,
                   target: str = "chain") -> List[Program]:
    """The programs a driver will actually dispatch for ``chain`` under the
    given config: the per-push step, plus the K-step program when scan
    dispatch is on (k > 1) — the ``warm``/``warm_scan`` surface."""
    if capacity is None:
        from ..basic import DEFAULT_BATCH_SIZE
        from ..runtime.pipeline import resolve_batch_hint
        capacity = chain.capacity or resolve_batch_hint(chain.ops) or DEFAULT_BATCH_SIZE
    common = dict(target=target, capacity=int(capacity), shards=int(shards),
                  replay=bool(replay))
    try:
        gm, seen = trace_step(chain, capacity)
    except Exception as e:  # noqa: BLE001 — a host read: traced op by op below
        if _host_read(e) is None:
            raise
        parts, reads, seen = trace_ops(chain, capacity)
        out = [Program(kind="step", gm=None, kernels=tuple(sorted(seen)), parts=parts,
                       host_reads=reads, **common)]
        if k and int(k) > 1:
            out.append(Program(kind="scan", gm=None, k=int(k),
                               kernels=tuple(sorted(seen)), parts=parts, **common))
        return out
    out = [Program(kind="step", gm=gm, kernels=tuple(sorted(seen)), **common)]
    if k and int(k) > 1:
        sgm, sseen = trace_scan(chain, int(k), capacity)
        out.append(Program(kind="scan", gm=sgm, k=int(k), kernels=tuple(sorted(sseen)),
                           **common))
    return out


# ----------------------------------------------------------------- rules


#: accumulating scatters whose float result depends on collision order
_SCATTER_ADDS = ("aten.index_add", "aten.index_add_", "aten.scatter_add",
                 "aten.scatter_add_", "aten.index_put", "aten.index_put_",
                 "aten._index_put_impl_", "aten.scatter_reduce", "aten.scatter_reduce_")

#: float reductions whose result depends on accumulation grouping
_GROUPING_REDUCTIONS = ("aten.sum", "aten.mean", "aten.cumsum", "aten.mm", "aten.bmm",
                        "aten.addmm")

#: data-dependent output shapes: the host waits for the device to size them
_DYNAMIC_SHAPE_OPS = ("aten.nonzero", "aten.unique", "aten._unique", "aten._unique2",
                      "aten.unique_consecutive", "aten.unique_dim", "aten.masked_select")


def _packet(node) -> str:
    """``aten.index_add`` of ``aten.index_add.default``."""
    name = str(node.target)
    return name.rsplit(".", 1)[0] if name.count(".") >= 2 else name


def _val(node):
    v = node.meta.get("val")
    return v[0] if isinstance(v, (list, tuple)) and v else v


def _is_float(node) -> bool:
    v = _val(node)
    return isinstance(v, torch.Tensor) and (v.dtype.is_floating_point or v.is_complex())


def _aval_str(node) -> str:
    v = _val(node)
    if not isinstance(v, torch.Tensor):
        return "?"
    return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"


def _accumulates(node) -> bool:
    pk = _packet(node)
    if pk not in _SCATTER_ADDS:
        return False
    if pk.startswith("aten.index_put") or pk == "aten._index_put_impl_":
        acc = node.kwargs.get("accumulate", node.args[3] if len(node.args) > 3 else False)
        return bool(acc)
    if pk.startswith("aten.scatter_reduce"):
        red = node.kwargs.get("reduce", node.args[3] if len(node.args) > 3 else "")
        return red == "sum"
    return True


def _to_cpu(node) -> bool:
    """A copy of a device tensor to the CPU."""
    if _packet(node) not in ("aten._to_copy", "aten.copy_", "aten.copy"):
        return False
    out = _val(node)
    src = node.args[0] if node.args else None
    sv = src.meta.get("val") if hasattr(src, "meta") else None
    return (isinstance(out, torch.Tensor) and out.device.type == "cpu"
            and isinstance(sv, torch.Tensor) and sv.device.type not in ("cpu", "meta"))


def _finding(prog: Program, code: str, severity: str, line: int,
             message: str, text: str) -> Finding:
    return Finding(code=code, severity=severity, path=prog.path,
                   line=line, message=message, text=text)


def analyze_program(prog: Program) -> List[Finding]:
    """All WF30x findings for one traced program."""
    out: List[Finding] = []
    n = 0
    if prog.kind == "step":
        for label, what in prog.host_reads:
            n += 1
            out.append(_finding(
                prog, "WF302", "warning", n,
                f"{what} in {label}: the step reads a device value on the "
                f"host on EVERY push — the host waits for the device there, "
                f"and a CUDA-graph capture (dispatch=K, device_cursor_step) "
                f"refuses the step. Keep the value on the device, or move "
                f"the read to the maintain/settle path",
                text=f"host read {what} {label}"))
    for label, gm in prog.graphs():
        at = f"@{label}" if label else "@step" if prog.kind == "step" else "@scan"
        for node in gm.graph.nodes:
            if node.op != "call_function":
                continue
            n += 1
            pk = _packet(node)
            # WF300 — order-dependent float accumulation under replay
            if prog.replay and _accumulates(node) and _is_float(node):
                out.append(_finding(
                    prog, "WF300", "error", n,
                    f"{pk} on {_aval_str(node)} ({at}) in a deterministic-"
                    f"replay program: colliding float adds accumulate in an "
                    f"order the backend may change — replay is "
                    f"bitwise-reproducible only by luck. Use integer "
                    f"accumulation or a fixed-order fold",
                    text=f"{pk} {_aval_str(node)} {at}"))
            # WF302 — host sync in the per-push hot path
            if prog.kind == "step" and (pk == "aten._local_scalar_dense"
                                        or pk in _DYNAMIC_SHAPE_OPS or _to_cpu(node)):
                out.append(_finding(
                    prog, "WF302", "warning", n,
                    f"{pk} ({at}): a blocking device-to-host round trip on "
                    f"EVERY push — the host waits for the device here, and a "
                    f"CUDA-graph capture refuses it",
                    text=f"{pk} {at}"))
            # WF305 — grouping-variant float reductions under composition
            if (prog.k > 1 or prog.shards > 1) and pk in _GROUPING_REDUCTIONS \
                    and _is_float(node):
                geom = (f"dispatch K={prog.k}" if prog.k > 1 else "") + \
                       (" and " if prog.k > 1 and prog.shards > 1 else "") + \
                       (f"shards={prog.shards}" if prog.shards > 1 else "")
                out.append(_finding(
                    prog, "WF305", "warning", n,
                    f"{pk} on {_aval_str(node)} ({at}) in a program composed "
                    f"under {geom}: float accumulation is non-associative, so "
                    f"a grouping change with the composition geometry can "
                    f"change the bytes — prove the grouping fixed, cast to "
                    f"integer, or keep the pairing rejected",
                    text=f"{pk} {_aval_str(node)} {at}"))
    return out


def analyze_programs(programs: Sequence[Program]) -> List[Finding]:
    out: List[Finding] = []
    for p in programs:
        out += analyze_program(p)
    return sorted(out, key=lambda x: (x.path, x.line, x.code, x.text))


# ------------------------------------------------------- the fingerprint


_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")


def _digest_tensor(t: torch.Tensor) -> str:
    """Stable digest of a constant tensor (values matter: two programs
    differing only in a baked-in table differ). The device is left out."""
    t = t.detach()
    head = f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
    if t.device.type == "meta" or type(t) is not torch.Tensor:
        return head
    a = t.cpu().contiguous()
    raw = a.view(torch.uint8).numpy().tobytes() if a.numel() else b""
    return f"{head}:{hashlib.sha256(raw).hexdigest()[:16]}"


def _canon(x, ids: Dict[Any, int]) -> str:
    """Canonical, address- and device-free rendering of one node argument."""
    if isinstance(x, torch.fx.Node):
        if x not in ids:
            ids[x] = len(ids)
        return f"v{ids[x]}"
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_canon(v, ids) for v in x) + ")"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}={_canon(x[k], ids)}" for k in sorted(x)) + "}"
    if isinstance(x, torch.device):
        return "<dev>"
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if isinstance(x, torch.Tensor):
        return _digest_tensor(x)
    if callable(x) and not isinstance(x, type):
        return f"fn:{getattr(x, '__qualname__', getattr(x, '__name__', type(x).__name__))}"
    return _ADDR_RE.sub("", repr(x))


def _canon_graph(gm, h) -> None:
    """Feed a canonical rendering of ``gm`` into hash ``h``: nodes in graph
    order, numbered by first use (never by name or id), their targets,
    arguments and result shapes and dtypes; constants by value."""
    ids: Dict[Any, int] = {}
    for node in gm.graph.nodes:
        me = _canon(node, ids)
        if node.op == "get_attr":
            val = getattr(gm, node.target, None)
            body = _digest_tensor(val) if isinstance(val, torch.Tensor) else repr(type(val))
            h.update(f"{me}=const({body});".encode())
            continue
        if node.op == "placeholder":
            h.update(f"{me}=in({_aval_str(node)});".encode())
            continue
        if node.op == "output":
            h.update(f"out{_canon(node.args, ids)};".encode())
            continue
        tgt = node.target
        name = (str(tgt) if isinstance(tgt, str) or hasattr(tgt, "_schema")
                else getattr(tgt, "__qualname__", type(tgt).__name__))
        h.update(f"{me}={node.op}:{name}{_canon(tuple(node.args), ids)}"
                 f"{_canon(dict(node.kwargs), ids)}->{_aval_str(node)};".encode())


def program_fingerprint(prog_or_gm) -> str:
    """Canonical structural sha256 of a traced program (a :class:`Program`
    or a GraphModule) — a pure function of the program: same ops,
    arguments, shapes, dtypes, topology and constant values => same hex
    digest, in any process and on any device."""
    h = hashlib.sha256()
    if isinstance(prog_or_gm, Program):
        for label, gm in (prog_or_gm.parts if prog_or_gm.gm is None
                          else [("", prog_or_gm.gm)]):
            h.update(f"[{label}]".encode())
            if gm is None:
                h.update(b"<host read>")
            else:
                _canon_graph(gm, h)
    else:
        _canon_graph(prog_or_gm, h)
    return h.hexdigest()


def step_fingerprint(chain, capacity: int = None) -> str:
    """Fingerprint of the chain's per-push step program."""
    return program_fingerprint(chain_programs(chain, capacity=capacity)[0])


# --------------------------------------------------------------- baseline


def baseline_path(root: str = None) -> str:
    """``WF_PROGCHECK_BASELINE`` (run time) overrides the checked-in
    ``analysis/progcheck_baseline.json``; ``root=None`` resolves next to
    this module (validate() runs from any cwd), a root resolves
    repo-relative (the CLI convention)."""
    override = os.environ.get("WF_PROGCHECK_BASELINE", "")
    if override:
        return override if os.path.isabs(override) \
            else os.path.join(root or ".", override)
    if root is None:
        return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "progcheck_baseline.json")
    return os.path.join(root, "windflow_tpu_torch", "analysis",
                        "progcheck_baseline.json")


def load_baseline(path: str) -> Tuple[Dict[tuple, int], List[str]]:
    """(suppression counts, problems). Problems are entries without a
    non-empty ``rationale`` — the gate REFUSES to ride them."""
    if not os.path.exists(path):
        return {}, []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    counts: Dict[tuple, int] = {}
    problems: List[str] = []
    for e in data.get("findings", ()):
        k = (e["code"], e["path"], e.get("text", ""))
        if not str(e.get("rationale", "")).strip():
            problems.append(f"{e['code']} {e['path']} {e.get('text', '')!r}")
            continue
        counts[k] = counts.get(k, 0) + 1
    return counts, problems


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Write the baseline from ``findings``, PRESERVING rationales already
    written for entries that still match."""
    old: Dict[tuple, List[str]] = {}
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            for e in json.load(f).get("findings", ()):
                k = (e["code"], e["path"], e.get("text", ""))
                r = str(e.get("rationale", "")).strip()
                if r:
                    old.setdefault(k, []).append(r)
    entries = []
    for x in findings:
        kept = old.get(x.key())
        entries.append({"code": x.code, "path": x.path, "text": x.text,
                        "message": x.message,
                        "rationale": kept.pop(0) if kept else ""})
    payload = {
        "comment": "audited progcheck findings of the port suppressed from the "
                   "gate; EVERY entry must carry a written rationale (empty "
                   "rationale = gate failure). Regenerate with python -m "
                   "windflow_tpu_torch.analysis.progcheck --update-baseline "
                   "(existing rationales are preserved for entries that still "
                   "match).",
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")


def apply_baseline(findings: Sequence[Finding],
                   counts: Dict[tuple, int]) -> List[Finding]:
    """Findings not suppressed (count-aware, the lint.py semantics)."""
    remaining = dict(counts)
    fresh = []
    for x in findings:
        k = x.key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
        else:
            fresh.append(x)
    return fresh


# ----------------------------------------------------------- audit surface


def _mk_chain(src, ops, capacity: int, device):
    from ..runtime.pipeline import CompiledChain
    return CompiledChain(list(ops), src.payload_spec(), batch_capacity=capacity,
                         device=device)


#: K of the audited K-step programs. The port's K-step program holds the K
#: bodies unrolled (a ``lax.scan`` holds one), so K = 2 is the smallest
#: program that carries the K > 1 evidence (WF305)
AUDIT_K = 2


def _nexmark_programs(device="cpu") -> List[Program]:
    """The Nexmark query set: every query's step program, the K-step program
    for the dispatch surface, and the q3 tiered variant, all under replay
    semantics (every query runs under the supervised drivers)."""
    from ..nexmark import queries as q
    out: List[Program] = []
    for name in q.PORTED:
        src, ops = q.make_query(name, total=512, device=device)
        out += chain_programs(_mk_chain(src, ops, 64, device), capacity=64, k=AUDIT_K,
                              replay=True, target=f"nexmark:{name}")
    src, ops = q.q3_enrich_join(512, tiered=dict(), device=device)
    out += chain_programs(_mk_chain(src, ops, 64, device), capacity=64, k=1,
                          replay=True, target="nexmark:q3_tiered")
    return out


def _ysb_programs(device="cpu") -> List[Program]:
    from ..benchmarks import ysb
    out: List[Program] = []
    for label, mk in (("ysb", ysb.make_ops), ("ysb_wmr", ysb.make_ops_wmr)):
        src = ysb.make_source(total=2048, device=device)
        out += chain_programs(_mk_chain(src, mk(device=device), 1024, device),
                              capacity=1024, k=AUDIT_K, replay=True, target=f"bench:{label}")
    return out


def _mp_matrix_programs(device="cpu") -> List[Program]:
    """The mp_test matrix topologies (``tests/test_mp_matrix.py`` CASES):
    every window-pattern family at its test geometry, step programs under
    replay."""
    from ..basic import win_type_t
    from ..operators import (DeviceSource, Key_Farm, Key_FFAT, Pane_Farm, Win_Farm,
                             Win_MapReduce, Win_Seq, WindowSpec)
    K, dev = 3, dict(device=device)
    cases = {
        "win_seq_cb": lambda: Win_Seq(lambda wid, it: it.sum("v"),
                                      WindowSpec(8, 4, win_type_t.CB), num_keys=K, **dev),
        "win_seq_tb": lambda: Win_Seq(lambda wid, it: it.sum("v"),
                                      WindowSpec(12, 6, win_type_t.TB), num_keys=K, **dev),
        "win_farm_cb": lambda: Win_Farm(lambda wid, it: it.sum("v"),
                                        WindowSpec(10, 5, win_type_t.CB),
                                        parallelism=4, num_keys=K, **dev),
        "key_farm_cb": lambda: Key_Farm(lambda wid, it: it.max("v"),
                                        WindowSpec(6, 3, win_type_t.CB),
                                        parallelism=3, num_keys=K, **dev),
        "key_ffat_cb": lambda: Key_FFAT(lambda t: t.v, torch.add,
                                        spec=WindowSpec(8, 2, win_type_t.CB),
                                        num_keys=K, **dev),
        "pane_farm_cb": lambda: Pane_Farm(lambda pid, it: it.sum("v"),
                                          lambda wid, it: it.sum(),
                                          WindowSpec(9, 3, win_type_t.CB),
                                          num_keys=K, **dev),
        "wmr_cb": lambda: Win_MapReduce(lambda wid, it: it.sum("v"),
                                        lambda wid, it: it.sum(),
                                        WindowSpec(8, 8, win_type_t.CB),
                                        map_parallelism=2, num_keys=K, **dev),
    }
    out: List[Program] = []
    for label, mk in sorted(cases.items()):
        src = DeviceSource(lambda i: {"v": ((i * 13) % 23).float()}, total=240,
                           num_keys=K, **dev)
        ops = mk()
        ops = list(ops) if isinstance(ops, (list, tuple)) else [ops]
        out += chain_programs(_mk_chain(src, ops, 48, device), capacity=48, k=1,
                              replay=True, target=f"mp:{label}")
    return out


def _example_programs(device="cpu") -> List[Program]:
    """The example topologies, rebuilt as op chains with the port's
    builders: the word count (FlatMap -> Map -> KeyBy -> Accumulator), the
    multichip Key_FFAT chain under shards=2 (the WF305 shard axis) and the
    serving echo graph."""
    from ..basic import win_type_t
    from ..operators import (Accumulator, DeviceSource, FlatMap, Key_FFAT, KeyBy, Map,
                             WindowSpec)
    dev = dict(device=device)
    out: List[Program] = []
    VOCAB = 50

    def make_words(i):
        return {"w": torch.stack([(i * 7) % VOCAB, (i * 13) % VOCAB, (i * 29) % VOCAB])}

    def split_words(t, shipper):
        for j in range(3):
            shipper.push({"word": t.w[j]})

    src = DeviceSource(make_words, total=512, **dev)
    ops = [FlatMap(split_words, max_fanout=3, **dev),
           Map(lambda t: {"one": torch.ones((), dtype=torch.int32), "word": t.word}, **dev),
           KeyBy(lambda t: t.word, num_keys=VOCAB, **dev),
           Accumulator(lambda t: t.data["one"], init_value=0, num_keys=VOCAB, **dev)]
    out += chain_programs(_mk_chain(src, ops, 64, device), capacity=64, k=1,
                          replay=True, target="example:wordcount")
    src = DeviceSource(lambda i: {"v": ((i * 7) % 31).float()}, total=4096,
                       num_keys=8, **dev)
    op = Key_FFAT(lambda t: t.v, torch.add, spec=WindowSpec(8, 4, win_type_t.CB),
                  num_keys=8, **dev)
    out += chain_programs(_mk_chain(src, [op], 256, device), capacity=256, k=1,
                          shards=2, replay=True, target="example:multichip")
    src = DeviceSource(lambda i: {"v": (i % 97).int()}, total=512, num_keys=8, **dev)
    out += chain_programs(_mk_chain(src, [Map(lambda t: {"v": t.v * 2}, **dev)], 64,
                                    device),
                          capacity=64, k=1, replay=True, target="example:serving_echo")
    return out


#: the audited whole-repo target set — the CLI runs all of these by
#: default; tests exercise them one family at a time
AUDIT_TARGETS: Dict[str, Callable[..., List[Program]]] = {
    "nexmark": _nexmark_programs,
    "ysb": _ysb_programs,
    "mp-matrix": _mp_matrix_programs,
    "examples": _example_programs,
}


def audit_programs(targets: Optional[Sequence[str]] = None,
                   device="cpu") -> List[Program]:
    """Trace every audit target (or the named subset), built on ``device``."""
    programs: List[Program] = []
    for name in (targets or sorted(AUDIT_TARGETS)):
        if name not in AUDIT_TARGETS:
            raise ValueError(f"unknown progcheck target {name!r}; "
                             f"registered: {sorted(AUDIT_TARGETS)}")
        programs += AUDIT_TARGETS[name](device=device)
    return programs


def run_progcheck(targets: Optional[Sequence[str]] = None) -> List[Finding]:
    """Trace + analyze every audit target (or the named subset)."""
    return analyze_programs(audit_programs(targets))


def progcheck_repo(root: str = ".", targets: Optional[Sequence[str]] = None,
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """(fresh, suppressed, baseline_problems) — THE gate semantics shared
    by the CLI and tests; ``baseline_problems`` (entries without a
    rationale) must fail the gate."""
    findings = run_progcheck(targets)
    counts, problems = load_baseline(baseline_path(root))
    fresh = apply_baseline(findings, counts)
    fresh_ids = {id(x) for x in fresh}
    return fresh, [x for x in findings if id(x) not in fresh_ids], problems


# --------------------------------------------------------------- the CLI


def main(argv=None) -> int:
    """``python -m windflow_tpu_torch.analysis.progcheck``: the flags and
    exit codes of the JAX package's ``scripts/wf_progcheck.py`` (0 clean,
    1 findings or a baseline entry without a rationale, 2 broken
    invocation or internal error)."""
    import argparse
    from . import lint
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(prog="python -m windflow_tpu_torch.analysis.progcheck",
                                 description="the port's device-program analyzer (WF3xx)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--root", default=repo, help="repository root (default: this checkout)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file overriding analysis/progcheck_baseline.json "
                         "(WF_PROGCHECK_BASELINE env does the same)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings (rationales "
                         "already written are preserved) and exit 0")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--select", default=None, metavar="CODES",
                    help="comma-separated codes/families to run in isolation")
    ap.add_argument("--ignore", default=None, metavar="CODES",
                    help="comma-separated codes/families to drop")
    ap.add_argument("--explain", default=None, metavar="WFnnn",
                    help="print what a rule code means and exit")
    ap.add_argument("--targets", default=None, metavar="NAMES",
                    help="comma-separated audit-target families to trace "
                         "(default: all; see progcheck.AUDIT_TARGETS)")
    ap.add_argument("--device", default="cpu",
                    help="device the audited chains are built on (default cpu)")
    ap.add_argument("--fingerprints", action="store_true",
                    help="also print each traced program's structural fingerprint")
    args = ap.parse_args(argv)
    try:
        if args.explain:
            return lint.explain(args.explain, prog="progcheck")
        if args.update_baseline and (args.select or args.ignore):
            print("progcheck: refusing --update-baseline with --select/--ignore "
                  "(a partial baseline would drop the other codes' suppressions)",
                  file=sys.stderr)
            return 2
        keep = lint.parse_codes(args.select) if args.select else None
        drop = lint.parse_codes(args.ignore) if args.ignore else None
        targets = ([t.strip() for t in args.targets.split(",") if t.strip()]
                   if args.targets else None)
        if args.baseline:
            os.environ["WF_PROGCHECK_BASELINE"] = os.path.abspath(args.baseline)
        programs = audit_programs(targets, device=args.device)
        findings = analyze_programs(programs)
        if keep is not None:
            findings = [x for x in findings if x.code in keep]
        if drop is not None:
            findings = [x for x in findings if x.code not in drop]
        bpath = baseline_path(args.root)
        if args.update_baseline:
            save_baseline(bpath, findings)
            with open(bpath, encoding="utf-8") as f:
                empty = sum(1 for e in json.load(f)["findings"] if not e["rationale"].strip())
            print(f"progcheck: wrote {len(findings)} finding(s) to {bpath}"
                  + (f" — {empty} without a rationale: fill them or the gate stays red"
                     if empty else ""))
            return 0
        if args.no_baseline:
            fresh, suppressed, problems = findings, [], []
        else:
            counts, problems = load_baseline(bpath)
            fresh = apply_baseline(findings, counts)
            fresh_ids = {id(x) for x in fresh}
            suppressed = [x for x in findings if id(x) not in fresh_ids]
        fps = ([{"target": p.target, "kind": p.kind, "k": p.k, "shards": p.shards,
                 "capacity": p.capacity, "kernels": list(p.kernels),
                 "fingerprint": program_fingerprint(p)} for p in programs]
               if args.fingerprints else None)
    except Exception as e:  # noqa: BLE001 — a broken analyzer must exit 2,
        #                     never masquerade as a clean (0) or dirty (1) run
        print(f"progcheck: internal error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps({"findings": [x.to_dict() for x in fresh],
                          "suppressed": len(suppressed), "baseline_problems": problems,
                          "programs": len(programs),
                          **({"fingerprints": fps} if fps is not None else {})},
                         indent=1))
    else:
        for row in fps or ():
            print(f"{row['target']}/{row['kind']} k={row['k']} shards={row['shards']} "
                  f"cap={row['capacity']}  {row['fingerprint']}")
        for x in fresh:
            print(x.render())
        for p in problems:
            print(f"progcheck: baseline entry WITHOUT a rationale: {p} — a "
                  f"suppression is an argued decision; write one")
        print(f"progcheck: {len(fresh)} finding(s) ({len(suppressed)} baselined, "
              f"{len(programs)} programs"
              + (f", {len(problems)} baseline entries missing a rationale"
                 if problems else "") + ")")
    return 1 if (fresh or problems) else 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's kernel registry: launch counters and implementation selection.

Counterpart of ``windflow_tpu/ops/registry.py``. Two parts:

**Launch counters.** One entry per hand-written kernel family: its CUDA
source, the TPU kernel it replaces, and an integer launch counter that the
kernel's wrapper bumps exactly where it launches the kernel (and nowhere
else), so a run can show that its main path went through the kernel. A
CUDA-graph replay calls no wrapper: the launches a capture counted are taken
back and added once per replay (:func:`add_launches`, ``runtime/graphs.py``).
The counts are safe under threads: every update takes one lock, and a
capture collects only the launches its own thread makes while it captures
(:func:`collect`), so another stage thread's launches during a capture are
neither put into the graph's per-replay counts nor taken off the totals.
An entry whose ``replaces`` is None is a helper kernel that replaces no TPU
kernel (``segment_fold_float``: the fixed-order float fold; ``cold_probe``:
the tiered state's cold-tier read through mapped host memory, where the JAX
package calls back into Python; ``cold_fetch``: the interval join's archive
tier read, the multimap counterpart; ``cold_scatter``: the copy of a host
store's written index slots to its mirror in the card's memory, which the
two reads walk). It is counted the same way;
:func:`tpu_kernels` leaves it out.

**Implementation selection** (:class:`KernelRegistry`). The five families of
the JAX registry (``names.py::KERNELS``) register two implementations each:
``torch``, the plain PyTorch version (the reference), and ``cuda``, the
hand-written kernel, which takes CUDA tensors only. The op entry points
resolve theirs through :func:`resolve_impl`, in the JAX package's order:

1. an explicit ``impl=`` at the call site;
2. ``WF_KERNEL_IMPL``: global (``"torch"``) or per kernel
   (``"histogram=cuda,lookup=torch"``), ``''``/``'0'`` off;
3. the deprecated aliases ``WF_HISTOGRAM_IMPL`` and ``WF_LOOKUP_IMPL``;
4. a winner persisted in an attached ``control.autotune.TuningCache``
   (keyed by kernel, spec key and device kind, ``gpu:<card>`` or
   ``cpu:cpu``);
5. the default: ``cuda`` when the operand lies on a CUDA card, ``torch``
   on the CPU. The JAX default is its ``xla`` reference; the port keeps the
   hand kernel on the card's main path.

A JAX impl name (``xla``, ``pallas``, ``pallas_mm``) is refused with a
``ValueError`` that lists the port's, and ``cuda`` for an operand off the
card raises: nothing falls back. The port resolves at every eager call
rather than once at a trace, so a resolution is memoized on (kernel, spec
key, device, the three environment strings, the tuning cache's
generation): a repeated call costs those lookups, no parse and no lock.

Like a jitted executable, a captured CUDA graph keeps the kernels chosen at
capture. Every resolution is recorded under (kernel, spec key, device kind)
(:meth:`KernelRegistry.trace_records`), and a capture also keeps the
resolutions made while it captured (:func:`capturing`), so
:func:`stale_selections` reports each recorded impl the current selection no
longer picks, naming the captured graphs that still replay it. A replay
adds the launches of the kernels it captured, whatever the selection is now.

**Abstract evaluation.** Inside :func:`plain_selection` every resolution on
the calling thread gives the plain version and records nothing, and every
device-dispatched helper (:func:`on_card`) takes its plain version too. The
operators' spec probes run there on meta tensors, and the static analysis
(``analysis/progcheck.py``) traces steps there over fake tensors: neither
launches a kernel. The block yields the set of hand kernels the unforced
selection would have launched for the same operands.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class Kernel:
    name: str          # family name (the JAX registry's kernel name)
    source: str        # CUDA source, relative to the repository root
    replaces: Optional[str]  # the Pallas function it replaces (file:line of
    #                          its def); None for a helper
    launches: int = 0


KERNELS = {
    k.name: k for k in (
        Kernel("histogram", "windflow_tpu_torch/ops/csrc/histogram.cu",
               "windflow_tpu/ops/histogram.py:195"),
        Kernel("lookup", "windflow_tpu_torch/ops/csrc/lookup.cu",
               "windflow_tpu/ops/lookup.py:113"),
        Kernel("segment_fold", "windflow_tpu_torch/ops/csrc/segment.cu",
               "windflow_tpu/ops/segment.py:90"),
        Kernel("ordering_merge", "windflow_tpu_torch/ops/csrc/bitonic.cu",
               "windflow_tpu/ops/bitonic.py:131"),
        Kernel("join_probe", "windflow_tpu_torch/ops/csrc/join_probe.cu",
               "windflow_tpu/ops/lookup.py:209"),
        Kernel("masked_window_reduce", "windflow_tpu_torch/ops/csrc/masked_sum.cu",
               "windflow_tpu/ops/pallas_kernels.py:57"),
        Kernel("segment_fold_float", "windflow_tpu_torch/ops/csrc/segment.cu", None),
        Kernel("cold_probe", "windflow_tpu_torch/ops/csrc/cold_probe.cu", None),
        Kernel("cold_fetch", "windflow_tpu_torch/ops/csrc/cold_probe.cu", None),
        Kernel("cold_scatter", "windflow_tpu_torch/ops/csrc/cold_probe.cu", None),
    )
}


def tpu_kernels() -> dict:
    """The entries that replace a TPU kernel (helpers left out)."""
    return {n: k for n, k in KERNELS.items() if k.replaces is not None}


_lock = threading.Lock()
_local = threading.local()      # .collector: the capture's counts, or None


def count_launch(name: str) -> None:
    add_launches({name: 1})


def add_launches(counts: dict) -> None:
    """Add ``{name: n}`` to the counts: the launches of one CUDA-graph replay,
    recorded at capture (a replay calls no wrapper). Inside :func:`collect`
    on this thread they go to the collector instead."""
    sink = getattr(_local, "collector", None)
    if sink is not None:
        for name, n in counts.items():
            sink[name] = sink.get(name, 0) + n
        return
    with _lock:
        for name, n in counts.items():
            KERNELS[name].launches += n


@contextlib.contextmanager
def collect() -> Iterator[Dict[str, int]]:
    """The launches this thread makes inside the block, as ``{name: n}``,
    kept out of the global counts (a capture's launches run at each replay,
    not now). Other threads count as usual meanwhile."""
    prev = getattr(_local, "collector", None)
    _local.collector = counts = {}
    try:
        yield counts
    finally:
        _local.collector = prev


def reset_launches() -> None:
    with _lock:
        for k in KERNELS.values():
            k.launches = 0


def launch_counts() -> dict:
    with _lock:
        return {name: k.launches for name, k in KERNELS.items()}


# ------------------------------------------------------ implementation selection

#: the implementation names (``names.py::KERNEL_IMPLS``)
IMPLS = ("torch", "cuda")


def _deprecated_alias_choice(kernel: str, hist: str, look: str) -> Optional[str]:
    """The deprecated pre-registry toggles ``WF_HISTOGRAM_IMPL`` and
    ``WF_LOOKUP_IMPL`` (already read by the caller): ``''``/``'0'`` = no
    override, anything else must be a registered impl name."""
    value = hist if kernel == "histogram" else look if kernel == "lookup" else ""
    return None if value in ("", "0") else value


def _parse_kernel_impl_env(value: str) -> Dict[str, str]:
    """``WF_KERNEL_IMPL`` grammar: ``"torch"`` (the global choice, under key
    ``"*"``) or ``"histogram=cuda,lookup=torch"`` (per kernel); an entry
    without ``=`` sets the global choice. ``''``/``'0'`` = no override."""
    out: Dict[str, str] = {}
    if value in ("", "0"):
        return out
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, _, v = part.partition("=")
            out[k.strip()] = v.strip()
        else:
            out["*"] = part
    return out


def device_kind(device=None) -> str:
    """``platform:device_kind`` (``control/autotune.py::device_kind``), so
    kernel entries and capacity plans key one tuning cache file with the
    same device string."""
    from ..control.autotune import device_kind as _dk
    return _dk(device)


class KernelImpl:
    """One registered implementation of a kernel family. ``devices``: the
    device types its operands may lie on."""

    __slots__ = ("kernel", "name", "fn", "reference", "devices")

    def __init__(self, kernel: str, name: str, fn: Optional[Callable],
                 reference: bool, devices: Tuple[str, ...]):
        self.kernel = kernel
        self.name = name
        self.fn = fn
        self.reference = reference
        self.devices = devices

    def __repr__(self) -> str:
        return (f"KernelImpl({self.kernel}:{self.name}"
                f"{' [ref]' if self.reference else ''})")


_capture_local = threading.local()      # .selections: a capture's resolutions
_plain_local = threading.local()        # .kernels: the would-launch set, or None


@contextlib.contextmanager
def plain_selection() -> Iterator[set]:
    """Inside the block this thread's resolutions give each kernel's plain
    version and record nothing (no trace record, no capture selection, no
    health note). Yields the set of kernels the selection would otherwise
    have launched (the hand kernel for an operand on the card)."""
    prev = getattr(_plain_local, "kernels", None)
    _plain_local.kernels = seen = set()
    try:
        yield seen
    finally:
        _plain_local.kernels = prev


def traced(t) -> bool:
    """Whether ``t`` is a fake tensor of a trace inside :func:`plain_selection`
    (``analysis/progcheck.py``): a helper whose plain version reads values
    on the host then gives its kernel's outputs unread (zeros of their
    shapes), so the trace models the card's program."""
    if getattr(_plain_local, "kernels", None) is None:
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def on_card(kernel: str, t) -> bool:
    """Whether a device-dispatched helper launches ``kernel`` for the
    operand ``t``: on a CUDA tensor, outside :func:`plain_selection`
    (inside it the kernel is noted as would-launch and the plain version
    runs)."""
    if t.device.type != "cuda":
        return False
    seen = getattr(_plain_local, "kernels", None)
    if seen is None:
        return True
    seen.add(kernel)
    return False


@contextlib.contextmanager
def capturing(graph) -> Iterator[dict]:
    """The resolutions this thread makes inside the block, as
    ``{(kernel, spec_key, device): impl}``, kept as ``graph.selections``;
    the registry then watches ``graph`` (weakly) for :func:`stale_selections`."""
    prev = getattr(_capture_local, "selections", None)
    _capture_local.selections = sel = {}
    try:
        yield sel
    finally:
        _capture_local.selections = prev
    graph.selections = dict(sel)
    REGISTRY.watch_graph(graph)


class KernelRegistry:
    """The kernel registry. One process-wide instance (:data:`REGISTRY`)
    backs the module-level functions; the class lets tests build isolated
    ones."""

    def __init__(self):
        self._impls: Dict[str, Dict[str, KernelImpl]] = {}
        self._cache = None                      # control.autotune.TuningCache
        self._cache_gen = 0
        # (kernel, spec_key, device kind) -> every impl resolved (a set: each
        # may live on in a captured graph, so a later resolution must not
        # silence the staleness check for an earlier one)
        self._records: Dict[Tuple[str, str, str], set] = {}
        self._memo: dict = {}
        self._graphs = weakref.WeakSet()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ registration

    def register_kernel(self, kernel: str, impl: str, fn: Optional[Callable] = None, *,
                        reference: bool = False,
                        devices: Tuple[str, ...] = ("cpu", "cuda")) -> None:
        """Register ``impl`` for ``kernel``; ``reference`` marks the plain
        version every other impl is held against. Re-registration replaces."""
        if impl not in IMPLS:
            raise ValueError(f"unknown impl name {impl!r} (impls: {', '.join(IMPLS)})")
        with self._lock:
            self._impls.setdefault(kernel, {})[impl] = KernelImpl(
                kernel, impl, fn, reference, tuple(devices))
            self._memo.clear()

    def kernels(self) -> Tuple[str, ...]:
        return tuple(sorted(self._impls))

    def impls(self, kernel: str) -> Tuple[str, ...]:
        return tuple(sorted(self._impls.get(kernel, ())))

    def reference_impl(self, kernel: str) -> Optional[str]:
        for impl in self._impls.get(kernel, {}).values():
            if impl.reference:
                return impl.name
        return None

    # --------------------------------------------------------------- tuning

    def attach_tuning_cache(self, cache) -> None:
        """Warm-start selection from (and persist winners to) a
        ``TuningCache``. ``None`` detaches."""
        with self._lock:
            self._cache = cache
            self._cache_gen += 1
            self._memo.clear()

    def persist_winner(self, kernel: str, spec_key: str, impl: str,
                       tps: Optional[float] = None, device=None) -> None:
        """Record a winning impl in the attached TuningCache under the kernel
        tuning key of ``device`` (None: :func:`device_kind`'s default)."""
        self._require_impl(kernel, impl)
        if self._cache is None:
            return
        from ..control.autotune import kernel_tuning_key
        entry = {"impl": impl, "kernel": kernel, "spec": spec_key}
        if tps is not None:
            entry["tps"] = float(tps)
        self._cache.put(kernel_tuning_key(kernel, spec_key, device_kind(device)), entry)
        with self._lock:
            self._cache_gen += 1
            self._memo.clear()

    def _cached_winner(self, kernel: str, spec_key: str, dk: str) -> Optional[str]:
        if self._cache is None:
            return None
        from ..control.autotune import kernel_tuning_key
        hit = self._cache.get(kernel_tuning_key(kernel, spec_key, dk))
        if hit and isinstance(hit.get("impl"), str):
            return hit["impl"]
        return None

    # ------------------------------------------------------------- selection

    def _require_impl(self, kernel: str, impl: str) -> str:
        fam = self._impls.get(kernel)
        if not fam:
            raise ValueError(
                f"unknown kernel {kernel!r}; registered kernels: "
                f"{', '.join(self.kernels()) or '(none)'}")
        if impl not in fam:
            raise ValueError(
                f"kernel {kernel!r} has no impl {impl!r}; registered impls: "
                f"{', '.join(self.impls(kernel))}")
        return impl

    def _select(self, kernel: str, spec_key: str, explicit: Optional[str],
                dev_type: str, dk: str, env: str, hist: str, look: str) -> str:
        if explicit:
            return self._require_impl(kernel, explicit)
        parsed = _parse_kernel_impl_env(env)
        choice = parsed.get(kernel) or parsed.get("*")
        if not choice:
            choice = _deprecated_alias_choice(kernel, hist, look)
        if not choice:
            choice = self._cached_winner(kernel, spec_key, dk)
        if not choice:
            fam = self._impls.get(kernel, {})
            choice = ("cuda" if dev_type == "cuda" and "cuda" in fam
                      else self.reference_impl(kernel) or "")
        return self._require_impl(kernel, choice)

    def resolve_impl(self, kernel: str, *, spec_key: str = "", impl: Optional[str] = None,
                     device=None, record: bool = True) -> str:
        """The implementation of ``kernel`` for an operand on ``device``
        (None: the first CUDA card when there is one, else the CPU), by the
        module's precedence. Raises ``ValueError`` for an impl that does not
        take operands on that device. A resolution without an explicit
        ``impl=`` is recorded (``record``) for :meth:`stale_selections`, and
        inside :func:`capturing` also kept by the capturing graph. Inside
        :func:`plain_selection` the reference impl, unrecorded."""
        seen = getattr(_plain_local, "kernels", None)
        if seen is not None:
            return self._plain(kernel, spec_key, impl, device, seen)
        env = os.environ.get("WF_KERNEL_IMPL", "")
        hist = os.environ.get("WF_HISTOGRAM_IMPL", "")
        look = os.environ.get("WF_LOOKUP_IMPL", "")
        key = (kernel, spec_key, impl, device, record, env, hist, look, self._cache_gen)
        hit = self._memo.get(key)
        if hit is None:
            hit = self._resolve(kernel, spec_key, impl, device, record, env, hist, look)
            self._memo[key] = hit
        choice, dk = hit
        sel = getattr(_capture_local, "selections", None)
        if sel is not None and impl is None:
            sel[(kernel, spec_key, dk)] = choice
        return choice

    def _plain(self, kernel, spec_key, impl, device, seen: set) -> str:
        """The reference impl; notes ``kernel`` in ``seen`` when the
        unforced, unrecorded selection for ``device`` is the hand kernel."""
        if getattr(device, "type", device) not in ("meta", None):
            try:
                would, _dk = self._resolve(
                    kernel, spec_key, impl, device, False,
                    os.environ.get("WF_KERNEL_IMPL", ""),
                    os.environ.get("WF_HISTOGRAM_IMPL", ""),
                    os.environ.get("WF_LOOKUP_IMPL", ""))
            except ValueError:
                would = None
            if would == "cuda":
                seen.add(kernel)
        return self.reference_impl(kernel) or "torch"

    def _resolve(self, kernel, spec_key, impl, device, record, env, hist, look):
        import torch
        dev = torch.device(device if device is not None else
                           "cuda" if torch.cuda.is_available() else "cpu")
        dk = device_kind(dev)
        choice = self._select(kernel, spec_key, impl, dev.type, dk, env, hist, look)
        if dev.type not in self._impls[kernel][choice].devices:
            raise ValueError(
                f"kernel {kernel!r}: impl {choice!r} takes operands on "
                f"{', '.join(self._impls[kernel][choice].devices)}, not {dev.type}")
        if record and impl is None:
            with self._lock:
                self._records.setdefault((kernel, spec_key, dk), set()).add(choice)
            # the health ledger's kernel_resolve record (the first resolution
            # of this key: the eager counterpart of a trace-time resolution)
            from ..observability import device_health as _dh
            _dh.note_kernel_resolve(kernel, spec_key, choice, device=dk)
        return choice, dk

    # ---------------------------------------------------------- staleness

    def watch_graph(self, graph) -> None:
        """Watch a captured graph's ``selections`` (weakly: a graph that is
        gone keeps nothing alive)."""
        with self._lock:
            self._graphs.add(graph)

    def watched_graphs(self) -> List[str]:
        """The names of the captured graphs the registry watches (alive)."""
        with self._lock:
            return sorted(g.name for g in self._graphs)

    def trace_records(self) -> Dict[Tuple[str, str, str], frozenset]:
        """Every (kernel, spec_key, device kind) -> the impls resolved for it
        in this process (since :meth:`reset_records`)."""
        with self._lock:
            return {k: frozenset(v) for k, v in self._records.items()}

    def stale_selections(self) -> List[dict]:
        """Recorded impls the current selection (environment and cache as of
        now; explicit ``impl=`` excluded) no longer picks: one entry each,
        with ``graphs`` naming the captured graphs that still replay it."""
        with self._lock:
            graphs = list(self._graphs)
        env = os.environ.get("WF_KERNEL_IMPL", "")
        hist = os.environ.get("WF_HISTOGRAM_IMPL", "")
        look = os.environ.get("WF_LOOKUP_IMPL", "")
        records = {k: set(v) for k, v in self.trace_records().items()}
        for g in graphs:
            for k, impl in g.selections.items():
                records.setdefault(k, set()).add(impl)
        out = []
        for (kernel, spec_key, dk), recorded in sorted(records.items()):
            dev_type = "cuda" if dk.startswith("gpu:") else "cpu"
            try:
                current = self._select(kernel, spec_key, None, dev_type, dk, env, hist, look)
            except ValueError:
                continue                      # kernel/impl unregistered now
            for impl in sorted(recorded - {current}):
                row = {"kernel": kernel, "spec_key": spec_key, "device": dk,
                       "recorded": impl, "current": current}
                names = sorted(g.name for g in graphs
                               if g.selections.get((kernel, spec_key, dk)) == impl)
                if names:
                    row["graphs"] = names
                out.append(row)
        return out

    def reset_records(self) -> None:
        """Forget the records and the memo (tests; a fresh process starts so)."""
        with self._lock:
            self._records.clear()
            self._memo.clear()


#: the process-wide registry the op modules register into
REGISTRY = KernelRegistry()


def register_kernel(kernel: str, impl: str, fn: Optional[Callable] = None, *,
                    reference: bool = False,
                    devices: Tuple[str, ...] = ("cpu", "cuda")) -> None:
    REGISTRY.register_kernel(kernel, impl, fn, reference=reference, devices=devices)


def resolve_impl(kernel: str, *, spec_key: str = "", impl: Optional[str] = None,
                 device=None, record: bool = True) -> str:
    return REGISTRY.resolve_impl(kernel, spec_key=spec_key, impl=impl, device=device,
                                 record=record)


def attach_tuning_cache(cache) -> None:
    REGISTRY.attach_tuning_cache(cache)


def persist_winner(kernel: str, spec_key: str, impl: str,
                   tps: Optional[float] = None, device=None) -> None:
    REGISTRY.persist_winner(kernel, spec_key, impl, tps, device=device)


def stale_selections() -> List[dict]:
    return REGISTRY.stale_selections()


def trace_records() -> Dict[Tuple[str, str, str], frozenset]:
    return REGISTRY.trace_records()


def reset_records() -> None:
    REGISTRY.reset_records()

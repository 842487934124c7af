"""One chain step captured into a CUDA graph: the port's counterpart of ``jax.jit``.

``CompiledChain.push_many`` (K batch steps) and the captured
``benchmarks.device_cursor_step`` (one bench step) share the PyTorch idiom
wrapped here: a function ``fn(states, inputs) -> (states, outs)`` captured
once into a ``torch.cuda.CUDAGraph`` with its own memory pool, then replayed,
so one host call launches every kernel of the step.

- **Static state carry.** The tensors of ``states`` at capture are the
  graph's static state. At the end of the captured region each new state
  tensor is ``copy_``'d into its static tensor, except where it already is
  that storage (Win_Seq's archive rings, updated in place). Before a replay,
  a state tensor handed in that is not the static one (after an eager
  ``push`` or a ``flush`` replaced it) is copied in. States come back as
  fresh objects over the static tensors; the objects handed in are consumed
  as an eager ``apply`` consumes them (``consume()``, Win_Seq's F1 check).
- **Static inputs.** The graph owns the input tensors it was captured with;
  the caller fills them (:attr:`StepGraph.inputs`) before each run.
- **Outputs** are cloned out of the pool after each replay, so a sink's
  ``consume`` and the next replay never share memory. That costs one
  device copy of every output a replay.
- **Launch counts.** ``ops/registry.py`` counts on the host, where a kernel's
  wrapper launches it, and a replay calls no wrapper. The counts a capture
  made are taken back and kept as the graph's :attr:`StepGraph.launches`,
  which every replay adds once.

What a capture needs beforehand, and the caller's part: every kernel of the
step built and loaded, and the one-time settings made at a kernel's first
launch on the device (K1, K3 and K5's shared-memory opt-in with
``cudaFuncSetAttribute``, K4's cluster occupancy query, PyTorch's own lazy
initialisation). One eager step at the same shapes does all of it.
``CompiledChain.warm_scan`` runs that step over an all-invalid batch, which
writes no state: Win_Seq's one in-place update rewrites slot 0 with its own
content when no lane writes, and every other operator is functional, its
results dropped. The bench step's first call is an eager step of its own.

What cannot be captured raises: an operator that reads a device value in
``apply`` (``.item()``, ``bool()``, a boolean-mask index, ``nonzero``)
makes the capture fail, and a state that carries a host value which changes
from step to step is refused. There is no eager retry. Python side effects
of ``apply`` happen once, at capture (the operators on the port's paths set
only values fixed by the batch capacity there: Win_Seq's and Key_FFAT's
fired-window budget ``_w``).

On the CPU there is no graph: the callers call ``fn`` itself, the CPU's
version of a replay, as a kernel's plain version is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

from ..ops import registry


def _is_node(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def leaves(tree: Any) -> List[Any]:
    """Leaves of a state or batch tree in a fixed order: tensors and host
    values (None included) of dicts, lists, tuples and dataclasses."""
    out: List[Any] = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif _is_node(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        else:
            out.append(x)
    walk(tree)
    return out


def rebuild(tree: Any, new_leaves: List[Any]) -> Any:
    """``tree``'s structure over ``new_leaves``, every container and dataclass
    a new object (so a fresh Win_Seq state, not marked consumed)."""
    it = iter(new_leaves)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if _is_node(x):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return next(it)
    return walk(tree)


def consume(tree: Any) -> None:
    """Consume every object of ``tree`` that can be (``consume()``), as an
    eager step would: the caller hands those states over."""
    if isinstance(tree, dict):
        for v in tree.values():
            consume(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            consume(v)
    elif _is_node(tree) and hasattr(tree, "consume"):
        tree.consume("captured step")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def _load(static: List[Any], given: List[Any], what: str) -> None:
    """Copy each tensor of ``given`` that is not its static tensor into it
    (recorded into the graph at the end of a capture, run before a
    replay); shapes and dtypes must match, and host values must equal the
    captured ones: a graph cannot replay a host value that changes."""
    if len(static) != len(given):
        raise ValueError(f"{what}: {len(given)} leaves, the graph holds {len(static)}")
    for s, g in zip(static, given):
        if isinstance(s, torch.Tensor):
            if not isinstance(g, torch.Tensor) or g.shape != s.shape or g.dtype != s.dtype:
                raise ValueError(f"{what}: a leaf {getattr(g, 'dtype', type(g))} "
                                 f"{tuple(getattr(g, 'shape', ()))} does not match the "
                                 f"captured {s.dtype} {tuple(s.shape)}")
            if not _same(s, g):
                s.copy_(g)
        elif not (s is g or s == g):
            raise ValueError(f"{what}: host value {g!r} differs from the captured "
                             f"{s!r}; a captured step cannot carry it")


class StepGraph:
    """``fn(states, inputs) -> (states, outs)`` captured once on the card.

    ``states``' tensors become the static state and ``inputs`` (a tree of
    tensors, owned by the graph from now on) the static input. Capture
    records and runs nothing: the states keep their values until the first
    :meth:`run`. Raises if the capture fails."""

    def __init__(self, fn: Callable, states: Any, inputs: Any):
        self._template = states
        self._static = leaves(states)
        self.inputs = inputs
        before = registry.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            new_states, outs = fn(rebuild(states, self._static), inputs)
            _load(self._static, leaves(new_states), "captured step's new state")
        self._outs = outs
        after = registry.launch_counts()
        #: kernel launches of one replay, by registry name
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        registry.add_launches({k: -n for k, n in self.launches.items()})
        self.replays = 0

    def run(self, states: Any) -> Tuple[Any, Any]:
        """Load ``states`` (consumed), replay, count the graph's launches;
        returns the new states and a clone of the outputs. Fill
        :attr:`inputs` first."""
        _load(self._static, leaves(states), "captured step state")
        consume(states)
        self.graph.replay()
        self.replays += 1
        registry.add_launches(self.launches)
        outs = rebuild(self._outs, [t.clone() if isinstance(t, torch.Tensor) else t
                                    for t in leaves(self._outs)])
        return rebuild(self._template, self._static), outs

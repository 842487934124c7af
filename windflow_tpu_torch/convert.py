"""Carry operator state between the JAX package and the port.

A stream processor has no weights: operator state (Win_SeqFFAT's pane ring and
clock, Win_Seq's archive rings and per-key counters, ReduceSink accumulators) is what a run carries from batch to batch. The
functions here turn a chain's states given as numpy arrays — e.g. the JAX
package's states after ``jax.tree.map(np.asarray, state)`` — into the port's
states on a chosen device, and back, so a stream can start in one package and
finish in the other, and tests can compare the states themselves.

A Win_SeqFFAT state may come as any object with the attributes of the JAX
package's ``GFFATState`` (``panes``, ``cnt``, ``wm``, ``next_win``,
``dropped_old``, ``lat_hist``; the global-time path) or ``FFATState``
(:data:`FFAT_FIELDS` and ``lat_hist``; the per-key path), or as a dict with
those keys. Its event-time lateness histogram ``lat_hist`` (None unless the
chain was built with event-time monitoring) converts with it.

Every other state is a pytree of arrays and converts leaf by leaf: a
KeyedMap's ``{"tbl": ..., "bad": ...}``, an Accumulator's ``[K, ...]``
table, a ReduceSink's accumulator, a join's or a session's dict (with its
``lat_hist`` or ``lat_l``/``lat_r`` lateness histograms under event-time
monitoring).

A Win_Seq state (Win_Farm, Key_Farm, and the engine of Win_MapReduce) comes
the same way with the fields of ``WinSeqState`` (:data:`WINSEQ_FIELDS`);
Pane_Farm's is the dict ``{"plq": ..., "wlq": ...}`` of two of them, and a
Nested_Farm's is its inner pattern's.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .batch import tree_map
from .operators.win_patterns import Nested_Farm, Pane_Farm, Win_MapReduce
from .operators.win_seq import Win_Seq, WinSeqState
from .operators.win_seqffat import FFATState, GFFATState, Win_SeqFFAT
from .parallel.mesh import host_copy

GFFAT_FIELDS = ("panes", "cnt", "wm", "next_win", "dropped_old")
FFAT_FIELDS = ("panes", "pane_count", "pane_of", "count", "wm", "next_win", "dropped_old")
WINSEQ_FIELDS = ("arch_payload", "arch_id", "arch_ts", "arch_pos", "count", "wm",
                 "next_win")


def _to_tensor(device):
    return lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name, None)


def state_from_numpy(op, state: Any, device=None) -> Any:
    """The port's state of ``op`` from ``state`` given as numpy arrays, on
    ``device`` (default: the operator's device)."""
    device = op.device if device is None else torch.device(device)
    if state is None:
        return None
    if isinstance(op, Nested_Farm):
        return state_from_numpy(op.inner, state, device)
    if isinstance(op, Win_MapReduce):
        return state_from_numpy(op.engine, state, device)
    if isinstance(op, Pane_Farm):
        return {"plq": state_from_numpy(op.plq, state["plq"], device),
                "wlq": state_from_numpy(op.wlq, state["wlq"], device)}
    conv = _to_tensor(device)
    if isinstance(op, Win_Seq):
        return WinSeqState(arch_payload=tree_map(conv, _field(state, "arch_payload")),
                           **{f: conv(_field(state, f)) for f in WINSEQ_FIELDS[1:]})
    if isinstance(op, Win_SeqFFAT):
        cls, fields = _ffat(op)
        lat = _field(state, "lat_hist")
        return cls(panes=tree_map(conv, _field(state, "panes")),
                   **{f: conv(_field(state, f)) for f in fields[1:]},
                   lat_hist=None if lat is None else conv(lat))
    return tree_map(conv, state)


def state_to_numpy(op, state: Any) -> Any:
    """Inverse of :func:`state_from_numpy`: a Win_SeqFFAT state becomes a dict
    of numpy arrays keyed by :data:`GFFAT_FIELDS` or :data:`FFAT_FIELDS`, a
    Win_Seq state one keyed
    by :data:`WINSEQ_FIELDS` (Pane_Farm: ``{"plq": ..., "wlq": ...}`` of
    those), any other state a pytree of numpy arrays. Every array is a copy,
    so the snapshot stays as it was while the chain runs on."""
    if state is None:
        return None
    if isinstance(op, Nested_Farm):
        return state_to_numpy(op.inner, state)
    if isinstance(op, Win_MapReduce):
        return state_to_numpy(op.engine, state)
    if isinstance(op, Pane_Farm):
        return {"plq": state_to_numpy(op.plq, state["plq"]),
                "wlq": state_to_numpy(op.wlq, state["wlq"])}
    # a fresh host tensor a leaf (a sharded leaf assembled), as numpy
    host = lambda t: host_copy(t).numpy()  # noqa: E731
    if isinstance(op, Win_Seq):
        return {f: tree_map(host, getattr(state, f)) for f in WINSEQ_FIELDS}
    if isinstance(op, Win_SeqFFAT):
        out = {"panes": tree_map(host, state.panes),
               **{f: host(getattr(state, f)) for f in _ffat(op)[1][1:]}}
        if state.lat_hist is not None:
            out["lat_hist"] = host(state.lat_hist)
        return out
    return tree_map(host, state)


def _ffat(op):
    """The state class of ``op``'s path and its fields."""
    return (GFFATState, GFFAT_FIELDS) if op.global_time else (FFATState, FFAT_FIELDS)


def chain_states_from_numpy(chain, states: Sequence[Any], device=None) -> list:
    """Convert every operator state of ``chain`` (one entry per op) and install
    them as the chain's states. Returns the new state list."""
    if len(states) != len(chain.ops):
        raise ValueError(f"{len(states)} states for a chain of {len(chain.ops)} ops")
    chain.states = [state_from_numpy(op, st, device)
                    for op, st in zip(chain.ops, states)]
    return chain.states


def chain_states_to_numpy(chain) -> list:
    return [state_to_numpy(op, st) for op, st in zip(chain.ops, chain.states)]

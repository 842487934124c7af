"""Carry operator state between the JAX package and the port.

A stream processor has no weights: operator state (Win_SeqFFAT's pane ring and
clock, ReduceSink accumulators) is what a run carries from batch to batch. The
functions here turn a chain's states given as numpy arrays — e.g. the JAX
package's states after ``jax.tree.map(np.asarray, state)`` — into the port's
states on a chosen device, and back, so a stream can start in one package and
finish in the other, and tests can compare the states themselves.

A Win_SeqFFAT state may come as any object with the attributes of the JAX
package's ``GFFATState`` (``panes``, ``cnt``, ``wm``, ``next_win``,
``dropped_old``, ``lat_hist``) or as a dict with those keys. Its event-time
lateness histogram (``lat_hist``) is not ported and must be None.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .batch import tree_map
from .operators.win_seqffat import GFFATState, Win_SeqFFAT

GFFAT_FIELDS = ("panes", "cnt", "wm", "next_win", "dropped_old")


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
    conv = _to_tensor(device)
    if isinstance(op, Win_SeqFFAT):
        if _field(state, "lat_hist") is not None:
            raise NotImplementedError(
                "state_from_numpy: the event-time lateness histogram is not ported")
        return GFFATState(panes=tree_map(conv, _field(state, "panes")),
                          **{f: conv(_field(state, f)) for f in GFFAT_FIELDS[1:]})
    return tree_map(conv, state)


def state_to_numpy(op, state: Any) -> Any:
    """Inverse of :func:`state_from_numpy`: a Win_SeqFFAT state becomes a dict
    of numpy arrays keyed by :data:`GFFAT_FIELDS`, any other state a pytree of
    numpy arrays."""
    if state is None:
        return None
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    if isinstance(op, Win_SeqFFAT):
        return {"panes": tree_map(host, state.panes),
                **{f: host(getattr(state, f)) for f in GFFAT_FIELDS[1:]}}
    return tree_map(host, state)


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

"""Signature introspection for user functions.

The part of ``windflow_tpu/meta.py`` this slice needs: the reference deduces the
function flavour (plain/rich, itemized/loop) from ``&F_t::operator()``
(``wf/meta.hpp:49-877``); here ``inspect.signature`` classifies the callable once
at operator construction, so ill-formed functions are rejected at graph-build
time with the list of accepted signatures.

Accepted signatures (``t`` is a :class:`~windflow_tpu_torch.batch.TupleRef`):

- Source : ``f(i, ctx?) -> payload``   (itemized; the loop flavour comes later)
- Map    : ``f(t, ctx?) -> payload``
- Filter : ``f(t, ctx?) -> bool``
- Sink   : ``f(view_of_numpy, ctx?) -> None``
"""

from __future__ import annotations

import inspect
import warnings
from typing import Callable

RICH_PARAM_NAMES = ("ctx", "context", "rc")

#: parameter names marking a Shipper parameter (loop-style Source flavour)
SHIPPER_PARAM_NAMES = ("shipper", "ship", "out", "emit")


class FlavourWarning(UserWarning):
    """A flavour was deduced from a parameter NAME that is not in the
    recognized list."""


class SignatureError(TypeError):
    """Raised at graph-build time when a user callable has an unusable signature."""


def _warn_flavour(msg: str) -> None:
    warnings.warn(msg, FlavourWarning, stacklevel=4)


def _positional_params(fn: Callable):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def classify(fn: Callable, *, base_arity: int, what: str, accepted: str):
    """``is_rich`` for a callable taking ``base_arity`` positional args,
    optionally followed by a RuntimeContext parameter."""
    params = _positional_params(fn)
    if params is None:
        return False
    n = len(params)
    if n == base_arity:
        return False
    if n == base_arity + 1:
        if params[-1].name not in RICH_PARAM_NAMES:
            _warn_flavour(
                f"{what}: trailing parameter {params[-1].name!r} is treated as "
                f"the RuntimeContext (rich flavour); name it one of "
                f"{RICH_PARAM_NAMES} to silence this warning")
        return True
    raise SignatureError(
        f"{what}: callable takes {n} positional parameters; accepted signatures are:\n"
        f"  {accepted}\n"
        f"(append a trailing context parameter named one of {RICH_PARAM_NAMES} for the"
        f" rich variant — wf/meta.hpp semantics)")


def classify_source_flavour(fn):
    """Deduce the Source flavour: ``(loop, is_rich)`` (``wf/meta.hpp:49-88``).
    Itemized ``f(i)`` / ``f(i, ctx)``; a shipper-named second parameter selects
    the loop flavour ``f(i, shipper[, ctx])``."""
    params = _positional_params(fn)
    if params is None:
        return False, False
    names = [p.name for p in params]
    n = len(names)
    if n == 1:
        return False, False
    if n == 2:
        if names[1] in SHIPPER_PARAM_NAMES:
            return True, False
        if names[1] not in RICH_PARAM_NAMES:
            _warn_flavour(
                f"Source: parameter {names[1]!r} is treated as the "
                f"RuntimeContext (itemized rich flavour); for a LOOP source "
                f"name it one of {SHIPPER_PARAM_NAMES}, for a context one of "
                f"{RICH_PARAM_NAMES}")
        return False, True
    if n == 3 and names[1] in SHIPPER_PARAM_NAMES:
        return True, True
    raise SignatureError(
        f"Source: callable with positional parameters {names} matches no accepted "
        f"signature: f(i), f(i, ctx), f(i, shipper), f(i, shipper, ctx)")


def classify_map(fn):
    return classify(fn, base_arity=1, what="Map",
                    accepted="f(t) -> payload | f(t, ctx) -> payload")


def classify_filter(fn):
    return classify(fn, base_arity=1, what="Filter",
                    accepted="f(t) -> bool | f(t, ctx) -> bool")


def classify_sink(fn):
    return classify(fn, base_arity=1, what="Sink",
                    accepted="f(batch) | f(batch, ctx)")

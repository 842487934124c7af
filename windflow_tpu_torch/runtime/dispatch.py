"""Scan dispatch: the configuration and the accumulator of the fused drive loop.

Counterpart of ``windflow_tpu/runtime/dispatch.py``. The drivers amortize
per-tuple overhead by micro-batching but still pay one host dispatch per
batch, and every port loop but one is host-bound (PERF.md §5). Scan dispatch
runs K consecutive batch steps as one device program:
``CompiledChain.push_many`` replays one CUDA graph of K captured steps
(``runtime/graphs.py``) with operator states carried in static tensors, one
graph per ``(from_op, K, capacity)``, with outputs byte-identical to K
sequential ``push`` calls. On the CPU it is the plain loop.

The pieces here are host-side:

- :class:`DispatchConfig`: the ``dispatch=`` argument resolved (``None``
  consults ``WF_DISPATCH``, off by default; ``WF_DISPATCH_K`` overrides K
  whenever dispatch is on).
- :class:`MicrobatchAccumulator`: gathers up to K same-capacity batches at a
  driver's ingest boundary. A capacity change dispatches the current group
  short first (a captured program holds one shape), and a wall-clock
  *linger* bounds how long a partial group may wait in a polling driver. The
  port's ``Pipeline`` pulls from a synchronous source and never waits: its
  partial group exists only at EOS (``drain``) or at a capacity switch.
- :class:`GroupRunner`: one driver's loop over a chain, feeding the
  accumulator and running each group with :func:`fused_push`.
- :func:`fused_push` (with the per-batch trace spans it synthesizes from the
  one launch) and :func:`build_k_ladder`.

The single-threaded drivers' accumulators publish the
``dispatch_linger_depth`` control gauge. Not ported, and stated rather than
stubbed: the K tuner that rides the control plane's autotuner (ROADMAP
Queue 1 item 15); :func:`refuse_k_tuner` raises where the JAX package would
start it.

K = 1 is the degenerate pass-through: every group has one batch and the
drivers call ``push`` unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Union

from .. import control as _control
from ..observability import tracing as _tracing


@dataclasses.dataclass
class DispatchConfig:
    """Resolved scan-dispatch settings for one driver run."""

    #: batches fused per device program (1 = per-batch dispatch)
    k: int = 8
    #: max wall-clock seconds a PARTIAL group may linger in a polling driver
    #: before it is dispatched short (the port's pull driver never waits)
    linger_s: float = 0.002
    #: grow the control plane's autotuner ladder with a K dimension when its
    #: autotune is on (the control plane is not ported: see refuse_k_tuner)
    autotune_k: bool = True
    #: capture the K-step program for ``k`` before the first batch
    #: (``CompiledChain.warm_scan``), so no group pays the capture
    prewarm: bool = True

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError(f"dispatch k must be >= 1, got {self.k}")
        if float(self.linger_s) < 0:
            raise ValueError(
                f"dispatch linger_s must be >= 0, got {self.linger_s}")

    @classmethod
    def resolve(cls, dispatch: Union[None, bool, int, str, dict,
                                     "DispatchConfig"],
                ) -> Optional["DispatchConfig"]:
        """Normalize the user-facing ``dispatch=`` argument; None when off.
        ``None`` consults ``WF_DISPATCH`` (``''``/``'0'`` = off, ``'1'`` =
        defaults, an integer = K, inline JSON / a JSON file path = field
        overrides); ``False``/``0`` force off; ``True`` = defaults; an int =
        K; a dict = field overrides; a config passes through.
        ``WF_DISPATCH_K`` overrides ``k`` whenever dispatch is on."""
        if dispatch is False:
            return None
        if isinstance(dispatch, DispatchConfig):
            cfg = dispatch
        elif isinstance(dispatch, bool):          # True (False returned above)
            cfg = cls()
        elif isinstance(dispatch, int):
            if dispatch == 0:       # the WF_DISPATCH='0' / False spelling
                return None
            cfg = cls(k=dispatch)
        elif isinstance(dispatch, dict):
            cfg = cls(**dispatch)
        elif isinstance(dispatch, str):
            cfg = cls._from_text(dispatch)
        else:                                     # None: env-driven
            env = os.environ.get("WF_DISPATCH", "")
            if env in ("", "0"):
                return None
            cfg = cls._from_text(env)
        k_env = os.environ.get("WF_DISPATCH_K", "")
        if k_env:
            cfg = dataclasses.replace(cfg, k=int(k_env))
        return cfg

    @classmethod
    def _from_text(cls, text: str) -> "DispatchConfig":
        text = text.strip()
        if text in ("1", "true"):
            return cls()
        if text.isdigit():
            return cls(k=int(text))
        if text and text[0] == "{":
            return cls(**json.loads(text))
        with open(text) as f:                 # a path to a JSON config file
            return cls(**json.load(f))


def refuse_k_tuner(cfg: DispatchConfig) -> None:
    """Raise where the JAX package would start the dispatch K tuner: K > 1
    with ``autotune_k`` while the control plane is on (``WF_CONTROL``; the
    port's drivers take no ``control=``)."""
    if cfg.autotune_k and cfg.k > 1 and os.environ.get("WF_CONTROL", "") not in ("", "0"):
        raise NotImplementedError(
            "the dispatch K tuner rides the control plane's autotuner, which is "
            "not ported yet (ROADMAP Queue 1 item 15); unset WF_CONTROL or pass "
            "dispatch={'k': K, 'autotune_k': False}")


def fused_push(chain, group: List, label: str) -> List:
    """Run one dispatch group through ``chain``: ``push_many`` for K > 1, the
    per-batch ``push`` for a singleton. Outputs return in batch order. A
    traced batch gets a service span on stage ``label``; under K > 1 each
    span carries ``k`` so the trace report divides the one launch among the
    group's members."""
    spans = [_tracing.service(b, label, k=len(group)) for b in group]
    outs = chain.push_many(group) if len(group) > 1 else [chain.push(group[0])]
    for b, out, span in zip(group, outs, spans):
        if span is not None:
            span.done()
            _tracing.carry(b, out)
    return outs


def build_k_ladder(k_max: int) -> List[int]:
    """Power-of-two K rungs up to (and always including) ``k_max``,
    ascending with 1 first (the degenerate rung is the per-batch push)."""
    k_max = int(k_max)
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    rungs = {1, k_max}
    c = 2
    while c < k_max:
        rungs.add(c)
        c *= 2
    return sorted(rungs)


class MicrobatchAccumulator:
    """Gather up to K same-capacity batches into dispatch groups.

    ``feed`` returns the groups that became ready (zero, one, or, after a
    capacity change dispatched the previous partial group, two).
    ``expired()`` + ``take()`` serve the linger path of polling drivers;
    ``drain()`` the EOS tail; ``clear()`` a restore (replay re-feeds the
    dropped batches). ``set_k`` takes effect at the next group boundary.
    One thread owns an accumulator: its buffer is not locked."""

    def __init__(self, k: int, linger_s: float = 0.0, clock=time.monotonic,
                 publish_gauge: bool = True):
        self.k = max(1, int(k))
        self.linger_s = float(linger_s)
        self.clock = clock
        #: whether this accumulator publishes the process-wide
        #: ``dispatch_linger_depth`` gauge: the single-threaded drivers' do,
        #: the threaded drivers' per-stage ones do not (N threads on one
        #: gauge would show a random thread's depth)
        self.publish_gauge = bool(publish_gauge)
        self._buf: List = []
        self._t0: Optional[float] = None

    def __len__(self) -> int:
        return len(self._buf)

    def set_k(self, k: int) -> None:
        """New group size; takes effect for groups formed from now on."""
        self.k = max(1, int(k))

    def _take(self) -> List:
        group, self._buf = self._buf, []
        self._t0 = None
        if self.publish_gauge:
            _control.set_gauge("dispatch_linger_depth", 0)
        return group

    def feed(self, batch) -> List[List]:
        """One batch in; the list of groups now ready to dispatch."""
        out: List[List] = []
        if self._buf and self._buf[0].capacity != batch.capacity:
            # a captured program holds one (K, capacity) shape: dispatch the
            # buffered run short rather than mix shapes
            out.append(self._take())
        self._buf.append(batch)
        if self._t0 is None:
            self._t0 = self.clock()
        if self.publish_gauge:
            _control.set_gauge("dispatch_linger_depth", len(self._buf))
        if len(self._buf) >= self.k:
            out.append(self._take())
        return out

    def expired(self) -> bool:
        """True when a partial group has lingered past ``linger_s``."""
        return (bool(self._buf) and self._t0 is not None
                and self.clock() - self._t0 >= self.linger_s)

    def take(self) -> List:
        """Pop the current partial group (linger flush)."""
        return self._take()

    def drain(self) -> List:
        """EOS: the partial tail (< K), possibly []."""
        return self._take() if self._buf else []

    def clear(self) -> None:
        """Restore: drop buffered batches (replay re-feeds them)."""
        self._buf = []
        self._t0 = None
        if self.publish_gauge:
            _control.set_gauge("dispatch_linger_depth", 0)


class GroupRunner:
    """A driver's dispatch over one chain (``Pipeline.run``, a threaded
    stage): batches of the chain's capacity are gathered into groups of up
    to K (``cfg`` None: one a group) and run with :func:`fused_push`; a
    batch of another capacity runs eagerly after the group in hand, because
    no graph of its shape was captured. ``emit(out)`` takes each output in
    order. A chain without operators (a pipe that only splits or merges)
    passes each batch on alone. Trace spans go on stage ``chain.label``;
    ``publish_gauge`` is the accumulator's."""

    def __init__(self, chain, cfg: Optional[DispatchConfig], emit,
                 publish_gauge: bool = True):
        self.chain = chain
        self.emit = emit
        self.acc = (MicrobatchAccumulator(cfg.k, cfg.linger_s, publish_gauge=publish_gauge)
                    if cfg is not None and cfg.k > 1 and chain.ops else None)

    def _run(self, group) -> None:
        if group:
            for out in fused_push(self.chain, group, self.chain.label):
                self.emit(out)

    def feed(self, batch) -> None:
        if self.acc is None:
            self._run([batch])
        elif batch.capacity != self.chain.capacity:
            self._run(self.acc.drain())
            self._run([batch])
        else:
            for group in self.acc.feed(batch):
                self._run(group)

    def idle(self) -> None:
        """The input ran dry: a partial group past its linger goes out short."""
        if self.acc is not None and self.acc.expired():
            self._run(self.acc.take())

    def finish(self) -> None:
        """EOS: the partial tail, then the chain's flush."""
        if self.acc is not None:
            self._run(self.acc.drain())
        for out in self.chain.flush():
            self.emit(out)

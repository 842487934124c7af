"""Fluent builders — operator construction with build-time signature checks.

Counterpart of ``windflow_tpu/runtime/builders.py`` (reference
``wf/builders.hpp`` and ``wf/builders_gpu.hpp``). Common methods:
``withName``, ``withParallelism``, ``withOpt``, ``withBatch``,
``withDevice``, ``withClosingFunction``; ``build()`` returns the operator
(``build_ptr``/``build_unique`` alias it). Signatures are checked at
``build()`` by the operators' ``meta.classify_*``.

``withBatch(n)`` is a micro-batch capacity ceiling that ``Pipeline``,
``CompiledChain`` and ``PipeGraph`` honour when no explicit ``batch_size`` is
given; ``withDevice(device)`` builds the operator on a torch device (the
reference's ``withGPU`` device selection), and two different hints inside one
chain are an error at chain construction.

``Map_Builder(f).withState(init)`` builds the keyed stateful ``KeyedMap``
(``f(t, state_k) -> (payload, new_state_k)``); ``FlatMap_Builder`` needs
``withMaxFanout``, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..basic import opt_level_t, win_type_t
from ..operators.accumulator import Accumulator
from ..operators.filter import Filter
from ..operators.flatmap import FlatMap
from ..operators.map import KeyedMap, Map
from ..operators.sink import ReduceSink, Sink
from ..operators.source import DeviceSource
from ..operators.win_patterns import (Key_Farm, Key_FFAT, Pane_Farm, Win_Farm,
                                      Win_MapReduce)
from ..operators.win_seq import Win_Seq
from ..operators.win_seqffat import Win_SeqFFAT
from ..operators.window import WindowSpec


class _Builder:
    _cls: type = None

    def __init__(self, *fns):
        self._fns = fns
        self._kw: dict = {}
        self._batch_hint: Optional[int] = None
        self._device = None
        self._opt: Optional[opt_level_t] = None
        self._closing: Optional[Callable] = None

    def withName(self, name: str):
        self._kw["name"] = name
        return self

    def withParallelism(self, n: int):
        self._kw["parallelism"] = n
        return self

    def withOpt(self, level: opt_level_t):
        """Optimization level (``wf/basic.hpp:92``), recorded on the operator:
        a chain runs its operators one after the other at every level."""
        self._opt = opt_level_t(level)
        return self

    def withBatch(self, batch_len: int):
        """Micro-batch capacity ceiling for this operator (the GPU builders'
        ``withBatch(batch_len)``): a chain runs at the smallest hint of its
        operators when no explicit batch_size is given."""
        if int(batch_len) < 1:
            raise ValueError(f"withBatch: batch_len must be >= 1, got {batch_len}")
        self._batch_hint = int(batch_len)
        return self

    def withDevice(self, device):
        """Build the operator on ``device`` (a torch device or its name): the
        reference's ``withGPU`` device selection. A chain runs on one device;
        two different hints in one chain are an error."""
        self._device = device
        return self

    def withClosingFunction(self, fn: Callable):
        """Host callback ``fn(RuntimeContext)`` run once per replica at
        teardown (the reference's closing_func)."""
        self._closing = fn
        return self

    def _construct(self):
        return self._cls(*self._fns, **self._kw)

    def build(self):
        if self._device is not None:
            self._kw["device"] = self._device
        op = self._construct()
        if self._closing is not None:
            op.closing_func = self._closing
        if self._batch_hint is not None:
            op._batch_hint = self._batch_hint
        if self._device is not None:
            op._device = op.device
        if self._opt is not None:
            op._opt_level = self._opt
        return op

    # C++ API parity aliases (wf/builders.hpp:583-643)
    build_ptr = build
    build_unique = build


class Source_Builder(_Builder):
    """``f(i) -> payload`` or ``f(i, shipper)`` (+rich), ``wf/builders.hpp:49``."""
    _cls = DeviceSource

    def withTotal(self, total: int):
        self._kw["total"] = total
        return self

    def withKeys(self, num_keys: int, key_fn: Callable = None):
        self._kw["num_keys"] = num_keys
        if key_fn is not None:
            self._kw["key_fn"] = key_fn
        return self

    def withTimestamps(self, ts_fn: Callable):
        self._kw["ts_fn"] = ts_fn
        return self

    def withMaxFanout(self, f: int):
        self._kw["max_fanout"] = f
        return self

    def _construct(self):
        if "total" not in self._kw:
            raise ValueError("Source_Builder: withTotal(n) is required")
        return DeviceSource(*self._fns, **self._kw)


class Filter_Builder(_Builder):
    """``wf/builders.hpp:168``; predicate ``f(t) -> bool`` (+rich)."""
    _cls = Filter

    def enable_KeyBy(self):
        self._kw["keyed"] = True
        return self


class Map_Builder(_Builder):
    """``wf/builders.hpp:332``; ``f(t) -> payload`` or in place (+rich).
    ``withState(init)`` builds the keyed stateful map (``KeyedMap``,
    ``f(t, state_k) -> (payload, new_state_k)``), the reference fork's
    keyed MapGPU; ``enable_KeyBy`` does not apply to it (it is keyed)."""
    _cls = Map

    def enable_KeyBy(self):
        self._kw["keyed"] = True
        return self

    def withState(self, init_state_value, num_keys: int = None):
        self._keyed_state = (init_state_value, num_keys)
        return self

    def _construct(self):
        if getattr(self, "_keyed_state", None) is None:
            return Map(*self._fns, **self._kw)
        init, num_keys = self._keyed_state
        kw = {k: v for k, v in self._kw.items() if k != "keyed"}
        if num_keys is not None:
            kw["num_keys"] = num_keys
        return KeyedMap(*self._fns, init, **kw)


class FlatMap_Builder(_Builder):
    """``wf/builders.hpp:494``; ``f(t, shipper)`` (+rich)."""
    _cls = FlatMap

    def withMaxFanout(self, f: int):
        self._kw["max_fanout"] = f
        return self

    def _construct(self):
        if "max_fanout" not in self._kw:
            raise ValueError("FlatMap_Builder: withMaxFanout(F) is required (a static "
                             "fan-out capacity keeps the output shape fixed)")
        return FlatMap(*self._fns, **self._kw)


class Accumulator_Builder(_Builder):
    """``wf/builders.hpp:653``; ``value_fn(t)`` + associative combine."""
    _cls = Accumulator

    def withInitialValue(self, v):
        self._kw["init_value"] = v
        return self

    def withCombine(self, fn, identity=0):
        self._kw["combine"] = fn
        self._kw["identity"] = identity
        return self

    def withKeys(self, num_keys: int):
        self._kw["num_keys"] = num_keys
        return self


class _WinBuilder(_Builder):
    def __init__(self, *fns):
        super().__init__(*fns)
        self._win = None

    def withCBWindows(self, win_len: int, slide: int):
        self._win = WindowSpec(win_len, slide, win_type_t.CB)
        return self

    def withTBWindows(self, win_len: int, slide: int):
        self._win = WindowSpec(win_len, slide, win_type_t.TB,
                               self._win.delay if self._win else 0)
        return self

    def withLateness(self, delay: int):
        if self._win is None or self._win.is_cb:
            raise ValueError("withLateness applies to TB windows "
                             "(triggering_delay, wf/window.hpp:83-121)")
        self._win = WindowSpec(self._win.win_len, self._win.slide, self._win.wtype, delay)
        return self

    def withKeys(self, num_keys: int):
        self._kw["num_keys"] = num_keys
        return self

    def withMaxWins(self, w: int):
        self._kw["max_wins"] = w
        return self

    def withArchive(self, capacity: int):
        self._kw["archive_capacity"] = capacity
        return self

    def prepare4Nesting(self):
        return self

    def _spec(self):
        if self._win is None:
            raise ValueError("window builder: call withCBWindows/withTBWindows first")
        return self._win


class WinSeq_Builder(_WinBuilder):
    """``wf/builders.hpp:789``; ``f(wid, iterable) -> result``, or incremental
    with ``withIncremental(init_acc)``."""

    def withIncremental(self, init_acc):
        self._kw["incremental"] = True
        self._kw["init_acc"] = init_acc
        return self

    def _construct(self):
        return Win_Seq(self._fns[0], self._spec(), **self._kw)


class WinSeqFFAT_Builder(_WinBuilder):
    """``wf/builders.hpp:950``; lift + combine."""

    def withIdentity(self, identity):
        self._kw["identity"] = identity
        return self

    def _construct(self):
        lift, comb = self._fns
        return Win_SeqFFAT(lift, comb, spec=self._spec(), **self._kw)


def _nesting_kw(builder: str, win, kw) -> dict:
    """A nested build takes only withParallelism/withName: the window
    geometry belongs to the inner pattern's builder."""
    if win is not None:
        raise TypeError(
            f"{builder}(inner_pattern): nesting accepts only withParallelism/"
            f"withName — configure windows on the inner builder, not "
            f"withCB/TBWindows here")
    return kw


class WinFarm_Builder(_WinBuilder):
    """``wf/builders.hpp:1120``: a window function, or a built Pane_Farm /
    Win_MapReduce to nest."""

    def _construct(self):
        inner = self._fns[0]
        if isinstance(inner, (Pane_Farm, Win_MapReduce)):
            return Win_Farm(inner, **_nesting_kw("WinFarm_Builder", self._win, self._kw))
        return Win_Farm(inner, self._spec(), **self._kw)


class KeyFarm_Builder(_WinBuilder):
    """``wf/builders.hpp:1343``: a window function, or a built Pane_Farm /
    Win_MapReduce to nest."""

    def _construct(self):
        inner = self._fns[0]
        if isinstance(inner, (Pane_Farm, Win_MapReduce)):
            return Key_Farm(inner, **_nesting_kw("KeyFarm_Builder", self._win, self._kw))
        return Key_Farm(inner, self._spec(), **self._kw)


class KeyFFAT_Builder(_WinBuilder):
    """``wf/builders.hpp:1569``."""

    def withIdentity(self, identity):
        self._kw["identity"] = identity
        return self

    def _construct(self):
        lift, comb = self._fns
        return Key_FFAT(lift, comb, spec=self._spec(), **self._kw)


class PaneFarm_Builder(_WinBuilder):
    """``wf/builders.hpp:1755``; plq_fn + wlq_fn."""

    def withPLQParallelism(self, n: int):
        self._kw["plq_parallelism"] = n
        return self

    def withWLQParallelism(self, n: int):
        self._kw["wlq_parallelism"] = n
        return self

    def _construct(self):
        self._kw.pop("parallelism", None)
        plq, wlq = self._fns
        return Pane_Farm(plq, wlq, self._spec(), **self._kw)


class WinMapReduce_Builder(_WinBuilder):
    """``wf/builders.hpp:1975``; map_fn + reduce_fn."""

    def withMapParallelism(self, n: int):
        self._kw["map_parallelism"] = n
        return self

    def _construct(self):
        self._kw.pop("parallelism", None)
        m, r = self._fns
        return Win_MapReduce(m, r, self._spec(), **self._kw)


class Sink_Builder(_Builder):
    """``wf/builders.hpp:2195``; host callback ``f(view)`` (+rich)."""
    _cls = Sink

    def enable_KeyBy(self):
        self._kw["keyed"] = True
        return self


class ReduceSink_Builder(_Builder):
    _cls = ReduceSink

    def withCombine(self, fn, identity=0):
        self._kw["combine"] = fn
        self._kw["identity"] = identity
        return self


# the JAX package aliases its device builders under *_TPU names (the
# reference's *_GPU builders); every port operator is the device operator too
MapTPU_Builder = Map_Builder
FilterTPU_Builder = Filter_Builder
WinSeqTPU_Builder = WinSeq_Builder
WinSeqFFATTPU_Builder = WinSeqFFAT_Builder
WinFarmTPU_Builder = WinFarm_Builder
KeyFarmTPU_Builder = KeyFarm_Builder
KeyFFATTPU_Builder = KeyFFAT_Builder
PaneFarmTPU_Builder = PaneFarm_Builder
WinMapReduceTPU_Builder = WinMapReduce_Builder

__all__ = ["Source_Builder", "Filter_Builder", "Map_Builder", "FlatMap_Builder",
           "Accumulator_Builder", "WinSeq_Builder", "WinSeqFFAT_Builder",
           "WinFarm_Builder", "KeyFarm_Builder", "KeyFFAT_Builder", "PaneFarm_Builder",
           "WinMapReduce_Builder", "Sink_Builder", "ReduceSink_Builder",
           "MapTPU_Builder", "FilterTPU_Builder", "WinSeqTPU_Builder",
           "WinSeqFFATTPU_Builder", "WinFarmTPU_Builder", "KeyFarmTPU_Builder",
           "KeyFFATTPU_Builder", "PaneFarmTPU_Builder", "WinMapReduceTPU_Builder"]

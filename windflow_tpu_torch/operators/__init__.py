"""Operators of the port (the YSB, Nexmark, windowed-operator, stateless and
keyed-state slices)."""

from .accumulator import Accumulator
from .base import Basic_Operator
from .filter import Compact, Filter, FilterMap
from .flatmap import FlatMap
from .join import StreamTableJoin
from .map import BatchMap, KeyBy, KeyedMap, Map
from .rank import Distinct, TopN
from .sink import ReduceSink, Sink
from .source import (DeviceSource, GeneratorSource, RecordSource, Source, SourceBase,
                     prefetch_to_device)
from .win_patterns import (Key_Farm, Key_FFAT, Nested_Farm, Pane_Farm, Win_Farm,
                           Win_MapReduce)
from .win_seq import Win_Seq, WinSeqState
from .win_seqffat import FFATState, GFFATState, Win_SeqFFAT
from .window import Iterable, WindowSpec

__all__ = ["Accumulator", "FlatMap", "KeyedMap", "FFATState", "Basic_Operator", "Compact", "Filter", "FilterMap", "GeneratorSource", "BatchMap", "KeyBy", "Map", "ReduceSink",
           "Sink", "DeviceSource", "RecordSource", "Source", "SourceBase", "Key_FFAT",
           "prefetch_to_device",
           "GFFATState", "Win_SeqFFAT", "WindowSpec", "StreamTableJoin", "TopN",
           "Distinct", "Win_Seq", "WinSeqState", "Win_Farm", "Key_Farm", "Pane_Farm",
           "Win_MapReduce", "Nested_Farm", "Iterable"]

"""Operators of the port (the YSB, Nexmark, windowed-operator and stateless slices)."""

from .base import Basic_Operator
from .filter import Compact, Filter, FilterMap
from .join import StreamTableJoin
from .map import BatchMap, KeyBy, Map
from .rank import Distinct, TopN
from .sink import ReduceSink, Sink
from .source import DeviceSource, GeneratorSource, Source, SourceBase
from .win_patterns import (Key_Farm, Key_FFAT, Nested_Farm, Pane_Farm, Win_Farm,
                           Win_MapReduce)
from .win_seq import Win_Seq, WinSeqState
from .win_seqffat import GFFATState, Win_SeqFFAT
from .window import Iterable, WindowSpec

__all__ = ["Basic_Operator", "Compact", "Filter", "FilterMap", "GeneratorSource", "BatchMap", "KeyBy", "Map", "ReduceSink",
           "Sink", "DeviceSource", "Source", "SourceBase", "Key_FFAT",
           "GFFATState", "Win_SeqFFAT", "WindowSpec", "StreamTableJoin", "TopN",
           "Distinct", "Win_Seq", "WinSeqState", "Win_Farm", "Key_Farm", "Pane_Farm",
           "Win_MapReduce", "Nested_Farm", "Iterable"]

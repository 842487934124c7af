"""Operators of the port (the YSB and Nexmark slices)."""

from .base import Basic_Operator
from .filter import Filter
from .join import StreamTableJoin
from .map import BatchMap, KeyBy, Map
from .rank import Distinct, TopN
from .sink import ReduceSink, Sink
from .source import DeviceSource, Source, SourceBase
from .win_patterns import Key_FFAT
from .win_seqffat import GFFATState, Win_SeqFFAT
from .window import WindowSpec

__all__ = ["Basic_Operator", "Filter", "BatchMap", "KeyBy", "Map", "ReduceSink",
           "Sink", "DeviceSource", "Source", "SourceBase", "Key_FFAT",
           "GFFATState", "Win_SeqFFAT", "WindowSpec", "StreamTableJoin", "TopN",
           "Distinct"]

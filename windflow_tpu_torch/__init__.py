"""windflow_tpu_torch — the PyTorch and CUDA port of windflow_tpu.

The same stream-processing model as the JAX package (fixed-capacity SoA
micro-batches, functional operator state, PipeGraph/MultiPipe dataflow graphs
with split, merge and DETERMINISTIC ordering), run eagerly by PyTorch on an NVIDIA
H100, or as CUDA-graph replays of captured steps under scan dispatch
(``Pipeline(dispatch=K)``) and in the bench step. Every TPU kernel on a ported path is a hand-written CUDA kernel for
``sm_90a`` (``ops/csrc/``), built with ``nvcc`` at first use and paired with a
plain PyTorch version that the CPU path and the tests use. Entry points run on
``"cuda"`` unless the caller passes ``device=``.

This package imports neither JAX nor anything of ``windflow_tpu``.
"""

from .basic import (Mode, win_type_t, opt_level_t, routing_modes_t, pattern_t,
                    win_event_t, ordering_mode_t, role_t,
                    current_time_usecs, current_time_nsecs, WinOperatorConfig)
from .batch import (CTRL_DTYPE, TRACE_META_ATTR, Batch, MutableTupleRef, TupleRef,
                    concat_batches, hash_key_to_slot, split_batch, trace_meta,
                    tuple_refs)
from .context import RuntimeContext, LocalStorage
from .device import resolve_device
from .operators import (Basic_Operator, BatchMap, Compact, DeviceSource, Distinct,
                        Filter, FilterMap, GeneratorSource, GFFATState, Iterable,
                        Key_Farm, Key_FFAT, KeyBy, Map, Nested_Farm, Pane_Farm,
                        ReduceSink, Sink, Source, StreamTableJoin, TopN, Win_Farm,
                        Win_MapReduce, Win_Seq, Win_SeqFFAT, WinSeqState, WindowSpec)
from .runtime import CompiledChain, MultiPipe, Pipeline, PipeGraph, builders
from .runtime.async_sink import AsyncResultShipper, ShippedResult
from .runtime.builders import (Accumulator_Builder, Filter_Builder, FlatMap_Builder,
                               KeyFarm_Builder, KeyFFAT_Builder, Map_Builder,
                               PaneFarm_Builder, ReduceSink_Builder, Sink_Builder,
                               Source_Builder, WinFarm_Builder, WinMapReduce_Builder,
                               WinSeq_Builder, WinSeqFFAT_Builder)
from .shipper import Shipper
from .stats import LogHistogram, Stats_Record
from . import nexmark, parallel

__version__ = "0.1.0"

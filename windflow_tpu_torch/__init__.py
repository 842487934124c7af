"""windflow_tpu_torch — the PyTorch and CUDA port of windflow_tpu.

The same stream-processing model as the JAX package (fixed-capacity SoA
micro-batches, functional operator state, PipeGraph/MultiPipe dataflow graphs
with split, merge and DETERMINISTIC ordering), run eagerly by PyTorch on an NVIDIA
H100, or as CUDA-graph replays of captured steps under scan dispatch
(``Pipeline(dispatch=K)``) and in the bench step, by one host thread or, in
``ThreadedPipeline`` and ``PipeGraph.run(threaded=True)``, by one host thread
a stage joined by the native SPSC rings (``native/``), each on a CUDA stream
of its own. ``SupervisedPipeline`` and ``PipeGraph.run_supervised`` add
aligned checkpoints, replay and exactly-once delivery on failure, journaled by
the ``EventJournal``; ``monitoring=`` and ``trace=`` (``observability/``) add
the metrics registry and reporter, event-time lateness histograms, batch
tracing and the device-health ledger. Every TPU kernel on a ported path is a hand-written CUDA kernel for
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
from .operators import (Accumulator, Basic_Operator, BatchMap, Compact, DeviceSource,
                        Distinct, FFATState, Filter, FilterMap, FlatMap, GeneratorSource,
                        GFFATState, IntervalJoin, Iterable, Key_Farm, Key_FFAT, KeyBy, KeyedMap, Map,
                        Nested_Farm, Pane_Farm, RecordSource, ReduceSink, SessionWindow,
                        Sink, Source, StreamTableJoin, TopN, Win_Farm, Win_MapReduce, Win_Seq,
                        Win_SeqFFAT, WinSeqState, WindowSpec, prefetch_to_device)
from .runtime import (CompiledChain, MultiPipe, Pipeline, PipeGraph, ThreadedPipeline,
                      builders)
from .runtime.async_sink import AsyncResultShipper, ShippedResult
from .runtime.checkpoint import CheckpointCorrupt, load_chain, save_chain
from .runtime.faults import (DeadLetterQueue, FaultInjector, FaultPlan, FaultSpec,
                             InjectedFault, WatchdogTimeout)
from .runtime.supervisor import RestartExhausted, SupervisedPipeline
from .observability import (EventJournal, MetricsRegistry, MonitoringConfig, Reporter,
                            read_journal, topology_dot, topology_json)
from .runtime.builders import (Accumulator_Builder, Filter_Builder, FlatMap_Builder,
                               KeyFarm_Builder, KeyFFAT_Builder, Map_Builder,
                               PaneFarm_Builder, ReduceSink_Builder, Sink_Builder,
                               Source_Builder, WinFarm_Builder, WinMapReduce_Builder,
                               WinSeq_Builder, WinSeqFFAT_Builder)
from .shipper import Shipper
from .stats import LogHistogram, Stats_Record
from . import nexmark, parallel

__version__ = "0.1.0"

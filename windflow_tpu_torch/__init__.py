"""windflow_tpu_torch — the PyTorch and CUDA port of windflow_tpu.

The same stream-processing model as the JAX package (fixed-capacity SoA
micro-batches, functional operator state), run eagerly by PyTorch on an NVIDIA
H100. Every TPU kernel on a ported path is a hand-written CUDA kernel for
``sm_90a`` (``ops/csrc/``), built with ``nvcc`` at first use and paired with a
plain PyTorch version that the CPU path and the tests use. Entry points run on
``"cuda"`` unless the caller passes ``device=``.

This package imports neither JAX nor anything of ``windflow_tpu``.
"""

from .basic import (Mode, win_type_t, opt_level_t, routing_modes_t, pattern_t,
                    win_event_t, ordering_mode_t, role_t,
                    current_time_usecs, current_time_nsecs, WinOperatorConfig)
from .batch import CTRL_DTYPE, Batch, TupleRef, tuple_refs
from .context import RuntimeContext, LocalStorage
from .device import resolve_device
from .operators import (Basic_Operator, BatchMap, DeviceSource, Distinct, Filter,
                        GFFATState, Key_FFAT, KeyBy, Map, ReduceSink, Sink, Source,
                        StreamTableJoin, TopN, Win_SeqFFAT, WindowSpec)
from .runtime import CompiledChain, Pipeline
from .stats import Stats_Record
from . import nexmark

__version__ = "0.1.0"

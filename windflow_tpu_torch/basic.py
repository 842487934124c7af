"""Basic definitions: enums and constants governing the whole runtime.

A copy of ``windflow_tpu/basic.py`` (that module imports no JAX, but the port
imports nothing of the JAX package, so it keeps its own copy). The names and
taxonomy follow the reference's ``wf/basic.hpp`` (enums at ``:86-132``, clocks at
``:54-74``, ``WinOperatorConfig`` at ``:154-184``), so a WindFlow user finds the
same vocabulary. Meanings are those of the micro-batch execution model:

- ``win_type_t.CB`` / ``TB``: count-based windows index by per-key arrival position,
  time-based by the tuple timestamp with a configurable ``triggering_delay``.
- ``Mode``, ``opt_level_t``, ``routing_modes_t`` and the other enums are kept for
  API parity with the JAX package.
"""

from __future__ import annotations

import enum
import time


class Mode(enum.Enum):
    """Processing mode of the PipeGraph (``wf/basic.hpp:86``)."""

    DEFAULT = 0
    DETERMINISTIC = 1


class win_type_t(enum.Enum):
    """Window type: count-based, time-based (``wf/basic.hpp:89``), or
    session (data-dependent gap — an extension beyond the reference's fixed
    CB/TB lattice; the survey's operator taxonomy, PAPER.md §2.4, lists
    session windows as the third firing family every production stream
    system carries)."""

    CB = 0
    TB = 1
    SESSION = 2


class opt_level_t(enum.Enum):
    """Optimization level of complex window operators (``wf/basic.hpp:92``)."""

    LEVEL0 = 0
    LEVEL1 = 1
    LEVEL2 = 2


class routing_modes_t(enum.Enum):
    """How an operator's input is distributed to its replicas (``wf/basic.hpp:95``)."""

    NONE = 0
    FORWARD = 1
    KEYBY = 2
    COMPLEX = 3


class pattern_t(enum.Enum):
    """Taxonomy of windowed-operator patterns (``wf/basic.hpp:98``)."""

    SEQ_CPU = 0
    SEQ_GPU = 1
    WF_CPU = 2
    WF_GPU = 3
    KF_CPU = 4
    KF_GPU = 5
    KFF_CPU = 6
    KFF_GPU = 7
    PF_CPU = 8
    PF_GPU = 9
    WMR_CPU = 10
    WMR_GPU = 11


class win_event_t(enum.Enum):
    """Events raised by a triggerer for a tuple vs. a window (``wf/basic.hpp:126``)."""

    OLD = 0        # tuple precedes the window (dropped / already purged)
    IN = 1         # tuple belongs to the (still open) window
    DELAYED = 2    # TB only: tuple within the lateness allowance
    FIRED = 3      # window is complete
    BATCHED = 4    # window queued in the current device micro-batch


class ordering_mode_t(enum.Enum):
    """Ordering criterion used at shuffle/merge boundaries (``wf/basic.hpp:129``)."""

    ID = 0
    TS = 1
    TS_RENUMBERING = 2


class role_t(enum.Enum):
    """Role of a sequential window engine inside a composed pattern (``wf/basic.hpp:132``)."""

    SEQ = 0
    PLQ = 1
    WLQ = 2
    MAP = 3
    REDUCE = 4


# --- defaults (counterparts of wf/basic.hpp:76-84) -----------------------------------

#: default micro-batch capacity (tuples per batch) for device operators; the reference's
#: GPU operators default their batch_len similarly (``wf/builders_gpu.hpp:67-71``).
DEFAULT_BATCH_SIZE = 4096

#: default capacity (in fired windows) of one windowed-operator device batch
#: (counterpart of ``DEFAULT_BATCH_SIZE_TB``, ``wf/basic.hpp:80``).
DEFAULT_WIN_BATCH = 256

#: default number of distinct key slots for keyed state tables.
DEFAULT_MAX_KEYS = 1024


def current_time_usecs() -> int:
    """Monotonic clock in microseconds (``wf/basic.hpp:54-63``)."""
    return time.monotonic_ns() // 1_000


def current_time_nsecs() -> int:
    """Monotonic clock in nanoseconds (``wf/basic.hpp:65-74``)."""
    return time.monotonic_ns()


class WinOperatorConfig:
    """Window-distribution coordinate system of a sequential engine inside a composed
    pattern (counterpart of ``wf/basic.hpp:154-184``).

    ``(id_outer, n_outer, slide_outer)`` locate the engine inside the outer pattern
    (e.g. which Win_Farm replica it is); ``(id_inner, n_inner, slide_inner)`` locate it
    inside a nested pattern. ``Win_Seq`` uses these to derive its first global window id
    and initial tuple id (``wf/win_seq.hpp:328-332``).
    """

    __slots__ = ("id_outer", "n_outer", "slide_outer", "id_inner", "n_inner", "slide_inner")

    def __init__(self, id_outer=0, n_outer=1, slide_outer=0, id_inner=0, n_inner=1, slide_inner=0):
        self.id_outer = id_outer
        self.n_outer = n_outer
        self.slide_outer = slide_outer
        self.id_inner = id_inner
        self.n_inner = n_inner
        self.slide_inner = slide_inner

    def __repr__(self):
        return (f"WinOperatorConfig(outer=({self.id_outer}/{self.n_outer},{self.slide_outer}),"
                f" inner=({self.id_inner}/{self.n_inner},{self.slide_inner}))")

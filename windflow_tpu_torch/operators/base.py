"""Operator base class — uniform introspection over all operators.

Counterpart of ``windflow_tpu/operators/base.py`` (reference ``Basic_Operator``,
``wf/basic_operator.hpp:47-79``). An operator is a batch transform with the
functional contract ``init_state(payload_spec) -> state``,
``apply(state, batch) -> (state, out_batch)`` and ``flush(state) -> (state,
out_batch or None)``; the port's operators return new state tensors and do not
update a state they were given.

Every operator has a ``device`` (``None`` = ``"cuda"``, resolved at
construction; without CUDA that raises). State is built there, and a chain
refuses operators on another device than its own.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..basic import routing_modes_t
from ..batch import Batch
from ..device import resolve_device
from ..stats import Stats_Record


class Basic_Operator:
    routing: routing_modes_t = routing_modes_t.FORWARD
    #: capacity ceiling from a builder's ``withBatch`` (None: no hint)
    _batch_hint: int = None
    #: device from a builder's ``withDevice`` (None: no hint)
    _device = None
    #: outcome of ``MultiPipe.chain``: True fused, False fell back to add,
    #: None not chained (rendered by ``PipeGraph.dump_DOTGraph``)
    _chained = None

    def __init__(self, name: str, parallelism: int = 1, device=None):
        self._name = name
        self._parallelism = max(1, int(parallelism))
        self.device = resolve_device(device)
        self._used = False
        self._stats = [Stats_Record(name, i) for i in range(self._parallelism)]
        #: host callback run once per replica at teardown (reference closing_func)
        self.closing_func = None

    def close(self) -> None:
        """Invoke the closing function (if any) once per replica."""
        if self.closing_func is None:
            return
        from ..context import RuntimeContext
        own = getattr(self, "context", None)
        for i in range(self._parallelism):
            ctx = (own if own is not None and own.getReplicaIndex() == i
                   else RuntimeContext(self._parallelism, i))
            self.closing_func(ctx)

    # -- Basic_Operator surface (wf/basic_operator.hpp:47-79) -------------------------

    def getName(self) -> str:
        return self._name

    def getParallelism(self) -> int:
        return self._parallelism

    def getRoutingMode(self) -> routing_modes_t:
        return self.routing

    def isUsed(self) -> bool:
        return self._used

    def get_StatsRecords(self):
        return list(self._stats)

    def collect_stats(self, state: Any = None) -> None:
        """Sync device-resident counters carried in ``state`` into the host
        ``Stats_Record``; no-op by default."""

    def tier_controllers(self) -> tuple:
        """The operator's tiered-state controllers (``state/tiered.py``
        ``TieredTable``, one per tiered table): empty unless the operator was
        built with ``tiered=`` on. ``CompiledChain`` runs their maintenance
        after every push and their settle, snapshot and restore with the
        chain's."""
        return ()

    name = property(getName)
    parallelism = property(getParallelism)

    # -- batch-transform surface ------------------------------------------------------

    def bind_geometry(self, batch_capacity: int) -> None:
        """Called once by the chain with the incoming micro-batch capacity,
        before ``init_state``."""

    def out_capacity(self, in_capacity: int) -> int:
        return in_capacity

    def init_state(self, payload_spec: Any) -> Any:
        """State pytree for this operator on ``self.device`` (None if stateless)."""
        return None

    def out_spec(self, payload_spec: Any) -> Any:
        """Output payload spec (per-tuple meta tensors) given the input spec."""
        return payload_spec

    def apply(self, state: Any, batch: Batch) -> Tuple[Any, Batch]:
        raise NotImplementedError

    def flush(self, state: Any) -> Tuple[Any, Optional[Batch]]:
        """Drain residual state at EOS. Returns (state, out_batch or None)."""
        return state, None

    def _mark_used(self):
        self._used = True

    def __repr__(self):
        return f"{type(self).__name__}({self._name!r}, parallelism={self._parallelism})"

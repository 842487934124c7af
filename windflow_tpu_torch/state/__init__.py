"""Tiered keyed state: million-key tables over fixed-capacity device tables.

Counterpart of ``windflow_tpu/state``: a stateful operator keeps its hot set
on the device while cold keys live in a host-side :class:`HostStore`, moved
by the :class:`TieredTable` controller (spills copied asynchronously,
readmission on a probe miss, watermark compaction). Off by default behind
the ``tiered=`` argument and ``WF_STATE_TIERED``; the off path builds the
untiered state.
"""

from .host_store import HostStore
from .tiered import TierConfig, TieredTable

__all__ = ["HostStore", "TierConfig", "TieredTable"]

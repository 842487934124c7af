"""Routing and ordering between pipeline segments (the emitters and the
Ordering_Node) and key ownership for shard-local supervision
(``sharding.py``: ``ShardAssignment``, ``ReshardPlan``, ``make_splitter``).
The mesh half of the JAX package's ``parallel`` (``mesh.py``,
``ShardedChain``, ``batch_sharding``, ``shard_batch``, ``collective.py``,
``multihost.py``) is not ported (ROADMAP Queue 1 item 14)."""

from .emitters import (Basic_Emitter, Broadcast_Emitter, Splitting_Emitter,
                       Standard_Emitter, Tree_Emitter)
from .ordering import Ordering_Node
from .sharding import (ReshardPlan, ShardAssignment, affected_shards, make_splitter,
                       resolve_shards)

__all__ = ["Basic_Emitter", "Standard_Emitter", "Broadcast_Emitter",
           "Splitting_Emitter", "Tree_Emitter", "Ordering_Node", "ShardAssignment",
           "ReshardPlan", "make_splitter", "affected_shards", "resolve_shards"]

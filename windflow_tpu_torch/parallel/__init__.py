"""Scale-out: meshes and sharded execution, the explicit collectives,
multi-process meshes over ``torch.distributed``, routing and ordering between
pipeline segments (the emitters and the Ordering_Node), and key ownership for
shard-local supervision.

Counterpart of ``windflow_tpu/parallel``: ``mesh.py`` (meshes, placements,
sharded tensors), ``sharding.py`` (``ShardedChain``, ``shard_batch``, the
placement rules; ``ShardAssignment``, ``ReshardPlan``, ``make_splitter``),
``collective.py``, ``multihost.py``, ``emitters.py``, ``ordering.py``."""

from .mesh import (Mesh, Placement, ShardedTensor, device_put, leading_axis_sharding,
                   make_mesh, make_mesh_2d, replicated)
from .sharding import (ShardedChain, shard_batch, batch_sharding, ReshardPlan,
                       ShardAssignment, affected_shards, make_splitter, resolve_shards)
from .emitters import (Basic_Emitter, Broadcast_Emitter, Splitting_Emitter,
                       Standard_Emitter, Tree_Emitter)
from .ordering import Ordering_Node
from .collective import (wmr_map_reduce, ring_pane_windows, keyed_all_to_all,
                         keyed_all_to_all_lossless)
from . import multihost

__all__ = [
    "make_mesh", "make_mesh_2d", "leading_axis_sharding", "replicated",
    "Mesh", "Placement", "ShardedTensor", "device_put",
    "ShardedChain", "shard_batch", "batch_sharding",
    "ShardAssignment", "ReshardPlan", "make_splitter", "affected_shards",
    "resolve_shards",
    "Basic_Emitter", "Standard_Emitter", "Broadcast_Emitter",
    "Splitting_Emitter", "Tree_Emitter", "Ordering_Node",
    "wmr_map_reduce", "ring_pane_windows", "keyed_all_to_all",
    "keyed_all_to_all_lossless", "multihost",
]

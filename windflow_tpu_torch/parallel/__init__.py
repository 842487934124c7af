"""Routing and ordering between pipeline segments: the emitters and the
Ordering_Node. The mesh, sharding, collective and multi-host parts of the JAX
package's ``parallel`` are not ported (ROADMAP Queue 1 item 14)."""

from .emitters import (Basic_Emitter, Broadcast_Emitter, Splitting_Emitter,
                       Standard_Emitter, Tree_Emitter)
from .ordering import Ordering_Node

__all__ = ["Basic_Emitter", "Standard_Emitter", "Broadcast_Emitter",
           "Splitting_Emitter", "Tree_Emitter", "Ordering_Node"]

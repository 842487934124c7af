"""RuntimeContext and LocalStorage — per-replica info for "rich" user functions.

A copy of ``windflow_tpu/context.py`` (the port imports nothing of the JAX
package). Counterparts of ``wf/context.hpp:49-102`` and ``wf/local_storage.hpp:49-139``. In the
reference a rich function receives the replica's parallelism, its index and a typed
per-replica key-value store. Here a "replica" is a shard of the compiled program;
``RuntimeContext`` carries the same identity ([replica_index, parallelism]) plus the
device-side state slot the rich function may read/update (a pytree threaded through
the step).
"""

from __future__ import annotations

from typing import Any, Dict


class LocalStorage:
    """Per-replica untyped key-value store (``wf/local_storage.hpp:49-139``).

    Host-side only (user closing/init functions run on host). ``get(name, default)``
    inserts the default on miss like the reference's default-construct-on-miss
    (``wf/local_storage.hpp:74-90``)."""

    def __init__(self):
        self._store: Dict[str, Any] = {}

    def get(self, name: str, default: Any = None) -> Any:
        if name not in self._store:
            self._store[name] = default
        return self._store[name]

    def put(self, name: str, value: Any) -> None:     # wf/local_storage.hpp:93
        self._store[name] = value

    def remove(self, name: str) -> None:              # wf/local_storage.hpp:117
        self._store.pop(name, None)

    def is_contained(self, name: str) -> bool:
        return name in self._store

    def get_size(self) -> int:
        return len(self._store)


class RuntimeContext:
    """Identity of the executing replica handed to rich user functions
    (``wf/context.hpp:49-102``).

    ``state`` is the optional per-replica *device* state pytree for rich map/filter
    functions (the functional replacement for mutating members of a C++ functor): a
    rich function has signature ``f(tuple, ctx)`` and may return
    ``(result, new_state)`` with ``ctx.state`` as input state.
    """

    def __init__(self, parallelism: int = 1, index: int = 0, state: Any = None):
        self._parallelism = parallelism
        self._index = index
        self.state = state
        self._storage = LocalStorage()

    def getParallelism(self) -> int:
        return self._parallelism

    def getReplicaIndex(self) -> int:
        return self._index

    def getLocalStorage(self) -> LocalStorage:
        return self._storage

    # pythonic aliases
    parallelism = property(getParallelism)
    replica_index = property(getReplicaIndex)
    storage = property(getLocalStorage)

"""Key ownership for shard-local supervision: the single-card half of sharding.

Counterpart of the key-ownership part of ``windflow_tpu/parallel/sharding.py``
(``ShardAssignment``, ``ReshardPlan``, ``make_splitter``, ``affected_shards``,
``resolve_shards``). The sharded supervisors (``runtime/supervisor.py``) run
N shards of one chain on one device: each shard owns the keys
``owner_of(key) == s`` and pushes a sub-batch whose ``valid`` is the batch's
masked by that ownership, so the live lanes of the N sub-batches are the
batch's, each in exactly one of them.

The mesh half (``ShardedChain``, ``batch_sharding``, ``shard_batch`` and the
state placement rules) is not ported: ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from ..batch import Batch, map_tuples


@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    """Deterministic key -> shard map: ``owner(key) = key % num_shards``
    (floored, as ``jnp``'s ``%``), overridden by ``moves``, a small tuple of
    ``(key, shard)`` pairs (a re-sharding plan's targeted moves). Doubling the
    shard count splits every shard in two (``key % 2N`` is congruent to ``key
    % N`` mod N). Pure data: ``to_meta``/``from_meta`` carry it in checkpoints,
    so a supervised replay re-derives the same ownership."""

    num_shards: int
    moves: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if int(self.num_shards) < 1:
            raise ValueError(f"ShardAssignment: num_shards must be >= 1, "
                             f"got {self.num_shards}")
        norm = tuple(sorted((int(k), int(s)) for k, s in self.moves))
        if len({k for k, _s in norm}) != len(norm):
            dupes = sorted({k for k, _s in norm
                            if sum(1 for kk, _ in norm if kk == k) > 1})
            raise ValueError(
                f"ShardAssignment: key slot(s) {dupes} appear in more than one move — "
                f"each key has exactly one owner")
        for k, s in norm:
            if not (0 <= s < self.num_shards):
                raise ValueError(
                    f"ShardAssignment: move {k} -> shard {s} references a nonexistent "
                    f"shard (have {self.num_shards})")
        object.__setattr__(self, "num_shards", int(self.num_shards))
        object.__setattr__(self, "moves", norm)

    def owner_of(self, keys: torch.Tensor) -> torch.Tensor:
        """Owning shard of each key (a tensor in, a tensor out)."""
        own = torch.remainder(keys, self.num_shards)
        for k, s in self.moves:
            own = torch.where(keys == k, torch.full_like(own, s), own)
        return own

    def owner(self, key_slot: int) -> int:
        """The owner of one key, on the host."""
        for k, s in self.moves:
            if k == int(key_slot):
                return s
        return int(key_slot) % self.num_shards

    def split(self, batch: Batch):
        """``[sub_batch_0, ..., sub_batch_{N-1}]`` of one batch."""
        if self.num_shards == 1:
            return [batch]
        return list(make_splitter(self)(batch))

    def to_meta(self) -> dict:
        return {"num_shards": self.num_shards, "moves": [[k, s] for k, s in self.moves]}

    @classmethod
    def from_meta(cls, meta: dict) -> "ShardAssignment":
        return cls(int(meta["num_shards"]),
                   tuple((int(k), int(s)) for k, s in meta.get("moves", ())))


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """A live re-sharding request, applied by the sharded supervisors at the
    first checkpoint barrier at or after ``at_pos`` (so replay re-derives the
    same layout). ``new_shards``: the target count (None keeps it); ``moves``:
    targeted ``(key, shard)`` overrides on top. ``WF_RESHARD`` takes ``"8"``
    or the JSON ``{"at_pos": 64, "new_shards": 8, "moves": [[3, 1]]}``."""

    new_shards: Optional[int] = None
    moves: Tuple[Tuple[int, int], ...] = ()
    at_pos: int = 0

    def __post_init__(self):
        object.__setattr__(self, "moves", tuple((int(k), int(s)) for k, s in self.moves))
        if self.new_shards is not None:
            object.__setattr__(self, "new_shards", int(self.new_shards))
        object.__setattr__(self, "at_pos", int(self.at_pos))

    def apply_to(self, cur: ShardAssignment) -> ShardAssignment:
        """The new layout (its moves validated by ShardAssignment). A count
        change re-bases every key to ``key % N``, so the old moves carry over
        only when the count stays."""
        n = self.new_shards if self.new_shards is not None else cur.num_shards
        merged = dict(cur.moves if n == cur.num_shards else ())
        merged.update(dict(self.moves))
        return ShardAssignment(n, tuple(merged.items()))

    @classmethod
    def resolve(cls, arg):
        """A driver's ``reshard=``: None consults ``WF_RESHARD``; False is off;
        ``"auto"`` passes through as the governor's sentinel (the caller
        decides); a plan, dict, int or JSON string parses."""
        if arg is False:
            return None
        if isinstance(arg, cls):
            return arg
        if arg is None:
            raw = os.environ.get("WF_RESHARD", "").strip()
            if not raw:
                return None
            arg = raw
        if isinstance(arg, str):
            if arg == "auto":
                return "auto"
            arg = json.loads(arg) if arg[:1] in "[{" else int(arg)
        if isinstance(arg, int):
            return cls(new_shards=arg)
        if isinstance(arg, dict):
            return cls(new_shards=arg.get("new_shards"),
                       moves=tuple((int(k), int(s)) for k, s in arg.get("moves", ())),
                       at_pos=arg.get("at_pos", 0))
        raise TypeError(f"reshard= accepts a ReshardPlan, dict, int, JSON string, "
                        f"'auto', or None/False — got {type(arg)}")


def make_splitter(assignment: ShardAssignment, key_fn=None):
    """``batch -> (sub_batch_0, ..., sub_batch_{N-1})``: every lane kept, each
    sub-batch's ``valid`` the batch's masked by ownership. ``key_fn``
    (``TupleRef -> int``, the KeyBy convention) overrides ``batch.key`` as the
    ownership key, which must follow the key the state tables group on (a
    KeyBy downstream, or an operator ``key_fn`` over another field)."""
    n = assignment.num_shards

    def split(batch: Batch):
        keys = batch.key if key_fn is None else map_tuples(key_fn, batch).to(batch.key.dtype)
        own = assignment.owner_of(keys)
        return tuple(batch.replace(valid=batch.valid & (own == s)) for s in range(n))
    return split


def affected_shards(old: ShardAssignment, new: ShardAssignment) -> set:
    """The new layout's shards whose key set changes: every shard on a count
    change, else the donors and recipients of the moves."""
    if old.num_shards != new.num_shards:
        return set(range(new.num_shards))
    out = set()
    for k in ({k for k, _ in old.moves} | {k for k, _ in new.moves}):
        a, b = old.owner(k), new.owner(k)
        if a != b:
            out.add(a)
            out.add(b)
    return out


def resolve_shards(arg) -> int:
    """A driver's ``shards=``: None consults ``WF_SHARDS`` (unset, empty, 0
    or 1 all mean off: one supervision domain); 0 means off; negative raises."""
    if arg is None:
        raw = os.environ.get("WF_SHARDS", "").strip()
        arg = int(raw) if raw else 1
    n = int(arg)
    if n == 0:
        return 1
    if n < 0:
        raise ValueError(f"shards= must be >= 0, got {n}")
    return n


__all__ = ["ShardAssignment", "ReshardPlan", "make_splitter", "affected_shards",
           "resolve_shards"]

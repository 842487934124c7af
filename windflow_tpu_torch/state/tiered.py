"""Tiered keyed state: the host-side controller of the two-tier layer.

Counterpart of ``windflow_tpu/state/tiered.py``. ``TieredTable`` supervises
one device table's cold tier: the operator's ``apply`` packs eviction
candidates into a bounded **outbox** inside the step (a pure function of the
watermark, per-key last access and occupancy), and this controller moves
them to the :class:`~windflow_tpu_torch.state.host_store.HostStore`.

The spill protocol, one :meth:`TieredTable.maintain` a push boundary (so the
cadence is a function of stream position and supervised replay re-walks it):

1. a *count probe*: the outbox count copied ``non_blocking`` into pinned
   memory, a CUDA event recorded behind it on the chain's stream;
2. when the count was non-zero, a *full copy* of the outbox columns (and the
   watermark) the same way;
3. the next maintain waits on the chain's own stream (never the whole
   device) for the push that produced the state, **applies** the copied
   prefix to the host store and **clears** exactly that prefix from the
   outbox: a small torch function returning new tensors, which a captured
   graph's static state copies in at its next replay. Entries leave the
   outbox only after they are in the store, so the union (device table,
   outbox, host store) always covers every key.

The host writes the store only here, in ``settle``, ``restore`` and TopN's
EOS drain, on the chain's driving thread, after that wait and before the
next push is launched: inside one ``push_many`` the store is read-only, as
in the JAX package, which maintains once after K steps. On the card the
step reads the store with the ``cold_probe`` and ``cold_fetch`` kernels
(``ops/cold_probe.py``), which walk the store's index mirror in the card's
memory and read its records through mapped host memory, so the step stays
capturable: no host callback, no interpreter lock. A write keeps the
mirror in step on the current stream (the chain's), before the next push.

``settle()`` drains synchronously (the pre-snapshot barrier); a restore
discards whatever copies were in flight, and replay re-derives them.
Watermark compaction runs every ``compact_every`` maintains with the copied
watermark as its frontier hint (a stale hint only retains rows longer).

The slot-directory primitives at the end put a key -> hot-slot directory in
front of the direct-indexed session and top-N tables; like the JoinTable's
hooks (``ops/lookup.py``) they compute the JAX package's results without its
dense ``[R, H]`` and ``[R, S]`` compares.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..batch import jax_leaves, tree_map
from ..observability import journal as _journal
from ..ops.cold_probe import cold_fetch, cold_probe
from ..ops.lookup import (_IMAX, _isum, _set_drop, claim_free_slots, hot_slot,
                          outbox_find_last)
from .host_store import HostStore

_I32 = torch.int32


@dataclasses.dataclass
class TierConfig:
    """Resolved tiered-state settings for one stateful operator: the
    ``tiered=`` argument / ``WF_STATE_TIERED`` of ``StreamTableJoin``,
    ``Distinct``, ``SessionWindow``, ``TopN`` and ``IntervalJoin``. Off by default; the off
    path builds the untiered state."""

    #: device-resident hot-table slots (None = the operator's own
    #: ``num_slots``/``num_keys``). ``WF_STATE_HOT_CAPACITY`` overrides it
    #: for every tiered operator.
    hot_capacity: Optional[int] = None
    #: spill-outbox slots (None = 4x the operator's per-batch admission bound)
    outbox: Optional[int] = None
    #: interval-join readmission: cold rows fetched for a probing lane a batch
    readmit_rows: int = 8
    #: maintains between host-store watermark compactions
    compact_every: int = 64
    #: cold-tier TTL in event-time ticks for the JoinTable-backed operators
    #: (None: rows live forever); a row retires once its version ts <
    #: watermark - ttl
    ttl: Optional[int] = None

    def __post_init__(self):
        if self.hot_capacity is not None and int(self.hot_capacity) < 2:
            raise ValueError("tiered hot_capacity must be >= 2")
        if self.outbox is not None and int(self.outbox) < 1:
            raise ValueError("tiered outbox must be >= 1")
        if int(self.readmit_rows) < 1:
            raise ValueError("tiered readmit_rows must be >= 1")
        if int(self.compact_every) < 1:
            raise ValueError("tiered compact_every must be >= 1")

    @classmethod
    def resolve(cls, tiered: Union[None, bool, str, dict, "TierConfig"]
                ) -> Optional["TierConfig"]:
        """Normalize the user-facing ``tiered=`` argument; None when off.
        ``None`` consults ``WF_STATE_TIERED`` (``''``/``'0'`` off, ``'1'``
        defaults, inline JSON object or JSON file path: field overrides);
        ``WF_STATE_HOT_CAPACITY`` overrides the hot-table size whenever
        tiering is on. Read at operator construction."""
        cfg = None
        if isinstance(tiered, TierConfig):
            cfg = tiered
        elif isinstance(tiered, dict):
            cfg = cls(**tiered)
        elif tiered is None:
            env = os.environ.get("WF_STATE_TIERED", "")
            if env not in ("", "0", "false", "False"):
                if env == "1" or env.lower() == "true":
                    cfg = cls()
                elif env.lstrip().startswith("{"):
                    cfg = cls(**json.loads(env))
                elif os.path.exists(env):
                    with open(env, encoding="utf-8") as f:
                        cfg = cls(**json.load(f))
                else:
                    raise ValueError(
                        f"WF_STATE_TIERED={env!r} is neither a toggle, "
                        f"inline JSON, nor a readable JSON file")
        elif tiered:
            cfg = cls()
        if cfg is not None:
            hot = os.environ.get("WF_STATE_HOT_CAPACITY", "")
            if hot:
                cfg = dataclasses.replace(cfg, hot_capacity=int(hot))
        return cfg


def _np_tree(tree, n: Optional[int] = None):
    """Host numpy copies of a tree's tensors (their first ``n`` rows)."""
    return tree_map(lambda t: t[:n].cpu().numpy() if n is not None else t.cpu().numpy(), tree)


class TieredTable:  # wf-lint: single-writer[driver, stage]
    """Host-side supervisor of one device table's spill outbox and cold tier.

    ``col_keys`` name the outbox fields inside the operator's state dict
    (each may be a tree); ``count_key`` the live-entry count; ``apply_fn(
    store, n, cols)`` turns ``n`` copied outbox rows into store writes;
    ``compact_fn(store, wm)`` (optional) applies the operator's watermark
    retention bound. Owning-thread only: the chain's driving thread (the
    driver, or the segment thread of the threaded driver)."""

    def __init__(self, name: str, store: HostStore, count_key: str,
                 col_keys: List[str],
                 apply_fn: Callable[[HostStore, int, dict], int], *,
                 wm_key: Optional[str] = None,
                 compact_fn: Optional[Callable[[HostStore, int], int]] = None,
                 compact_every: int = 64):
        self.name = name
        self.store = store
        self.count_key = count_key
        self.col_keys = list(col_keys)
        self.apply_fn = apply_fn
        self.wm_key = wm_key
        self.compact_fn = compact_fn
        self.compact_every = max(1, int(compact_every))
        self._maintains = 0
        self._cnt = None       # (count, wm, event): the count probe in flight
        self._full = None      # (count, cols, wm, event): the full copy
        self._wm_hint = None   # last copied watermark (compaction frontier)
        self._journal_synced = {"state_spills": 0, "state_readmits": 0,
                                "state_compactions": 0}

    # -- the outbox clear ---------------------------------------------------------------

    def _clear(self, state, c0: int):
        """The first ``c0`` outbox entries shifted out of ``state`` (they are
        in the host store now): new tensors, zero-filled at the end."""
        out = dict(state)
        for k in self.col_keys:
            out[k] = tree_map(lambda a: torch.cat([a[c0:], torch.zeros_like(a[:c0])]),
                              state[k])
        out[self.count_key] = torch.clamp(state[self.count_key] - c0, min=0)
        return out

    @staticmethod
    def _quiesce(state) -> None:
        """Wait on the chain's current stream for the push that produced
        ``state``: no step of this chain reads the store while it is written.
        Not a device-wide sync."""
        dev = next(iter(t.device for t in state.values() if isinstance(t, torch.Tensor)))
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    # -- the per-push maintenance point ---------------------------------------------------

    def maintain(self, state):  # wf-lint: thread-role[driver, stage]
        """One push boundary: advance the three-phase spill pipeline and the
        compaction cadence; returns the state (the outbox cleared of what was
        applied)."""
        self._maintains += 1
        if self._full is not None:
            cnt, cols, wm, ev = self._full
            self._full = None
            if ev is not None:
                ev.synchronize()
            c0 = int(cnt)
            if wm is not None:
                self._wm_hint = int(wm)
            if c0 > 0:
                # the barrier before the store is written: the push just
                # launched reads it
                self._quiesce(state)
                host = {k: tree_map(lambda a: a[:c0].numpy(), v) for k, v in cols.items()}
                self.apply_fn(self.store, c0, host)
                state = self._clear(state, c0)
        elif self._cnt is not None:
            cnt, wm, ev = self._cnt
            self._cnt = None
            if ev is not None:
                ev.synchronize()
            if wm is not None:
                self._wm_hint = int(wm)
            if int(cnt) > 0:
                self._full = self._start_copy(state, full=True)
        if self._full is None and self._cnt is None:
            self._cnt = self._start_copy(state, full=False)
        if (self.compact_fn is not None and self._wm_hint is not None
                and self._maintains % self.compact_every == 0):
            self._quiesce(state)
            self.compact_fn(self.store, self._wm_hint)
        self._journal_deltas()
        return state

    def _start_copy(self, state, full: bool):
        """Copies of the count (and watermark; with ``full`` the outbox
        columns) into host memory: ``non_blocking`` into pinned buffers with
        an event behind them on the card, plain copies on the CPU."""
        dev = state[self.count_key].device
        cuda = dev.type == "cuda"

        def copy(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
            h.copy_(t, non_blocking=cuda)
            return h
        cnt = copy(state[self.count_key])
        wm = copy(state[self.wm_key]) if self.wm_key is not None else None
        cols = {k: tree_map(copy, state[k]) for k in self.col_keys} if full else None
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        return (cnt, cols, wm, ev) if full else (cnt, wm, ev)

    def settle(self, state):  # wf-lint: thread-role[driver, stage]
        """Drain the outbox into the host store synchronously and drop the
        copies in flight: after settle, (state, store) is a consistent pair.
        The count's read waits for the chain's stream."""
        self._cnt = None
        self._full = None
        c0 = int(state[self.count_key])
        if self.wm_key is not None:
            self._wm_hint = int(state[self.wm_key])
        if c0 > 0:
            host = {k: _np_tree(state[k], c0) for k in self.col_keys}
            self.apply_fn(self.store, c0, host)
            state = self._clear(state, c0)
        self._journal_deltas()
        return state

    def discard_inflight(self) -> None:
        """Restore path: drop the copies of the failed attempt; the restored
        state still holds those entries in its outbox."""
        self._cnt = None
        self._full = None

    # -- durability / telemetry -----------------------------------------------------------

    def manifest(self) -> Dict[str, np.ndarray]:
        return self.store.manifest()

    def restore(self, manifest: Dict[str, np.ndarray]) -> None:
        self.discard_inflight()
        self.store.restore(manifest)
        self._journal_synced = dict(self.store.counters())

    def counters(self) -> dict:
        return self.store.counters()

    def stats(self) -> dict:
        """Cold-tier size and movement counters (host side)."""
        out = {"cold_keys": self.store.key_count(), "cold_rows": len(self.store)}
        out.update(self.store.counters())
        return out

    def _journal_deltas(self) -> None:
        """``spill``/``readmit`` journal records for the counters' movement
        since the last maintenance point (only with a journal active)."""
        if _journal.get_active() is None:
            return
        cur = self.store.counters()
        for kind, event in (("state_spills", "spill"), ("state_readmits", "readmit")):
            delta = cur[kind] - self._journal_synced[kind]
            if delta > 0:
                _journal.record(event, table=self.name, n=delta, total=cur[kind])
        self._journal_synced.update({k: cur[k] for k in ("state_spills", "state_readmits")})
        self._journal_synced["state_compactions"] = cur["state_compactions"]


# ------------------------------------------------- per-table-shape runtimes


def _np_dtype(t) -> np.dtype:
    return torch.empty((), dtype=t.dtype).numpy().dtype


class JoinTableTier:
    """Cold tier, controller and cold read of one versioned JoinTable
    (``ops/lookup.py`` ``join_table_*``: StreamTableJoin and Distinct). Row
    schema: the table's value columns (``v<i>`` in ``jax.tree.leaves``
    order) and the ``(ver, vid, vseq)`` version triplet as meta."""

    def __init__(self, name: str, val_spec, cfg: TierConfig, device):
        self.cfg = cfg
        self._leaves = jax_leaves(val_spec)
        cols = {f"v{i}": _np_dtype(leaf) for i, leaf in enumerate(self._leaves)}
        self.store = HostStore(name, cols, unique=True, device=device)

        def apply_fn(store, n, host):
            return store.upsert(host["okey"], host["over"], host["ovid"], host["ovseq"],
                                {f"v{i}": leaf for i, leaf in
                                 enumerate(jax_leaves(host["oval"]))})

        compact_fn = None
        if cfg.ttl is not None:
            ttl = int(cfg.ttl)

            def compact_fn(store, wm):     # noqa: F811: the optional hook
                return store.compact_below("m0", wm - ttl)

        self.controller = TieredTable(
            name, self.store, "ocnt", ["okey", "oval", "over", "ovid", "ovseq"],
            apply_fn, wm_key="wm", compact_fn=compact_fn,
            compact_every=cfg.compact_every)

    def lookup(self, keys: torch.Tensor, want: torch.Tensor) -> tuple:
        """The cold read of the wanted keys: ``(found, m0, m1, m2, *value
        leaves)`` on ``keys``' device (``cold_probe``)."""
        return cold_probe(self.store, keys, want)


class SlotTableTier:
    """Cold tier and controller of a direct-indexed keyed table behind a slot
    directory (SessionWindow floors, TopN leaderboards). Row schema: ``cols``
    (name -> (dtype, trailing shape)); the LWW meta is the spill tick."""

    def __init__(self, name: str, cols, cfg: TierConfig, *,
                 count_key: str, col_keys, state_to_store,
                 compact_col: Optional[str] = None,
                 compact_bound=None, wm_key: Optional[str] = "wm", device=None):
        self.cfg = cfg
        dtypes = {k: np.dtype(d) for k, (d, _s) in cols.items()}
        shapes = {k: tuple(s) for k, (_d, s) in cols.items()}
        self.store = HostStore(name, dtypes, shapes, unique=True, device=device)
        self._order = [self.store.col_names.index(k) for k in sorted(dtypes)]
        self._state_to_store = state_to_store
        compact_fn = None
        if compact_col is not None and compact_bound is not None:
            def compact_fn(store, wm):  # noqa: F811: the optional hook
                return store.compact_below(compact_col, compact_bound(wm))
        self.controller = TieredTable(
            name, self.store, count_key, list(col_keys), self._apply, wm_key=wm_key,
            compact_fn=compact_fn, compact_every=cfg.compact_every)

    def _apply(self, store, n, host):
        keys, tick, cols = self._state_to_store(n, host)
        return store.upsert(keys, tick, np.zeros(n, np.int64), np.zeros(n, np.int64), cols)

    def lookup(self, keys: torch.Tensor, want: torch.Tensor) -> tuple:
        """``(found, *cols sorted by name)`` on ``keys``' device."""
        res = cold_probe(self.store, keys, want)
        return (res[0],) + tuple(res[4 + i] for i in self._order)


class ArchiveTier:
    """Cold tier and controller of one side of an interval-join archive: a
    multimap (``unique=False`` store). Every spilled row (an archived tuple
    the ring overwrote while still inside its match window) stays until the
    watermark frontier retires it (``compact_below("ts", compact_bound(wm))``
    every ``compact_every`` maintains). The read is read-only
    (:meth:`fetch`): cold rows are matched as extra candidates and stay
    probeable by later arrivals, and a row lives in exactly one tier
    (archive, outbox or here). Row schema: ``ts``, ``id`` and the payload
    leaves ``p<i>`` in ``jax.tree.leaves`` order."""

    def __init__(self, name: str, payload_spec, cfg: TierConfig, side: str,
                 compact_bound: Callable[[int], int], device=None):
        self.cfg = cfg
        self.side = side
        self._leaves = jax_leaves(payload_spec)
        cols = {"ts": np.dtype(np.int32), "id": np.dtype(np.int32)}
        shapes = {"ts": (), "id": ()}
        for i, leaf in enumerate(self._leaves):
            cols[f"p{i}"] = _np_dtype(leaf)
            shapes[f"p{i}"] = tuple(leaf.shape)
        self.store = HostStore(f"{name}.{side}", cols, shapes, unique=False, device=device)

        def apply_fn(store, n, host):
            rows = {"ts": host[f"{side}ots"], "id": host[f"{side}oid"]}
            rows.update({f"p{i}": leaf
                         for i, leaf in enumerate(jax_leaves(host[f"{side}opay"]))})
            z = np.zeros(n, np.int64)
            return store.append(host[f"{side}okey"], z, z, z, rows)

        def compact_fn(store, wm):
            return store.compact_below("ts", compact_bound(wm))

        self.controller = TieredTable(
            f"{name}.{side}", self.store, f"{side}ocnt",
            [f"{side}okey", f"{side}ots", f"{side}oid", f"{side}opay"],
            apply_fn, wm_key="wm", compact_fn=compact_fn,
            compact_every=cfg.compact_every)

    def fetch(self, keys: torch.Tensor, want: torch.Tensor) -> tuple:
        """Up to ``readmit_rows`` cold rows of each wanted lane's key:
        ``(mask [C, M], ts, id, *payload leaves)`` on ``keys``' device
        (``cold_fetch``)."""
        return cold_fetch(self.store, keys, want, self.cfg.readmit_rows)


# --------------------------------------- the slot-directory primitives
#
# The session/top-N tables are direct-indexed (the tuple key is the slot);
# tiering them puts a key -> hot-slot directory in front of the table math.

_KEY_SENTINEL = -(1 << 31)


def slot_lookup(hkey, hused, keys, ok):
    """``(hit [R], slot [R])`` of each wanted key in the hot directory
    (``slot``: the first equal directory entry, unused entries holding the
    sentinel, 0 where none)."""
    keys = keys.to(_I32)
    tk = torch.where(hused, hkey, _KEY_SENTINEL)
    slot, any_eq = hot_slot(tk, keys, torch.ones_like(keys, dtype=torch.bool))
    return any_eq & ok & (keys != _KEY_SENTINEL), slot


def slot_directory_resolve(state, keys, ok, lookup, admit_write):
    """Key -> hot-slot resolution for a direct-indexed table: touch hot hits,
    then for missing keys search the spill outbox (newest entry), then the
    cold tier (``lookup``), and admit every missing first-occurrence key,
    readmitted with its cold row or fresh, through the fresh-slot rule.
    ``admit_write(out, widx, got, in_ob, oidx, host_res)`` writes the
    operator's own columns for the admitted slots. Returns ``(state, slot
    [R], live [R])``; ``live`` leaves out lanes whose key found no slot."""
    from ..ops.segment import segment_rank
    H = state["hkey"].shape[0]
    keys = keys.to(_I32)
    ok = ok.to(torch.bool) & (keys != _KEY_SENTINEL)
    tick = state["tick"]
    hit, slot = slot_lookup(state["hkey"], state["hused"], keys, ok)
    lap = _set_drop(state["lap"], torch.where(hit, slot, H), tick)
    need = ok & ~hit
    in_ob, oidx = outbox_find_last(state["okey"], state["ocnt"], keys, need)
    need_host = need & ~in_ob
    host_res = lookup(keys, need_host)
    host_found = host_res[0] & need_host
    adm = need & (segment_rank(keys, need) == 0)
    got, snew = claim_free_slots(state["hused"], adm)    # the r-th admitted, the r-th free
    widx = torch.where(got, snew, H)
    out = dict(state)
    out["hkey"] = _set_drop(state["hkey"], widx, keys)
    out["hused"] = _set_drop(state["hused"], widx, torch.ones_like(got))
    out["lap"] = _set_drop(lap, widx, tick)
    out = admit_write(out, widx, got, in_ob, oidx, host_res)
    out["readmits"] = state["readmits"] + _isum(got & (in_ob | host_found))
    hit2, slot2 = slot_lookup(out["hkey"], out["hused"], keys, ok)
    return out, slot2, ok & hit2


def slot_directory_evict(state, hot_target, evictable, discardable, pack_write):
    """Pressure eviction over a hot directory: free the coldest ``used -
    hot_target`` evictable slots. Rows with nothing worth remembering
    (``discardable``) are freed outright; the rest pack into the outbox
    (``okey``/``otick`` here, the operator's columns through ``pack_write(out,
    opos, perm, spill)``), bounded by its space: a full outbox defers those
    evictions. Closes the batch by advancing ``tick``."""
    H, S = state["hkey"].shape[0], state["okey"].shape[0]
    dev = state["hkey"].device
    used = state["hused"]
    need = torch.clamp(_isum(used) - int(hot_target), min=0)
    cand = used & evictable
    perm = torch.argsort(torch.where(cand, state["lap"], _IMAX), stable=True)
    r = torch.arange(H, dtype=_I32, device=dev)
    sel = (r < need) & cand.index_select(0, perm)
    disc = discardable.index_select(0, perm)
    spill = sel & ~disc
    srank = torch.cumsum(spill.to(_I32), 0, dtype=_I32) - 1
    fits = spill & (state["ocnt"] + srank < S)
    evict = sel & (disc | fits)
    opos = torch.where(fits, state["ocnt"] + srank, S)
    out = dict(state)
    out["okey"] = _set_drop(state["okey"], opos, state["hkey"].index_select(0, perm))
    out["otick"] = _set_drop(state["otick"], opos, state["tick"])
    out = pack_write(out, opos, perm, fits)
    cleared = torch.where(evict, perm, H)
    out["hused"] = _set_drop(used, cleared, torch.zeros_like(evict))
    out["hkey"] = _set_drop(out["hkey"], cleared,
                            torch.full_like(out["hkey"], _KEY_SENTINEL))
    n = _isum(fits)
    out["ocnt"] = state["ocnt"] + n
    out["spills"] = state["spills"] + n
    out["tick"] = state["tick"] + 1
    return out


def slot_directory_init(hot: int, outbox: int, extra_outbox_cols, device) -> dict:
    """The directory and outbox fields shared by every slot-directory tier
    (``extra_outbox_cols``: name -> factory of a zero tensor over ``[S]``)."""
    H, S = int(hot), int(outbox)

    def full(n, v, dt=_I32):
        return torch.full((n,), v, dtype=dt, device=device)

    def scalar():
        return torch.zeros((), dtype=_I32, device=device)
    out = {"hkey": full(H, _KEY_SENTINEL), "hused": full(H, False, torch.bool),
           "lap": full(H, 0), "tick": scalar(), "okey": full(S, _KEY_SENTINEL),
           "otick": full(S, 0), "ocnt": scalar(), "spills": scalar(),
           "readmits": scalar()}
    for name, factory in extra_outbox_cols.items():
        out[name] = factory(S)
    return out


def slot_directory_stats(state) -> dict:
    """Device-side tier numbers of a slot directory (a few small reads)."""
    H = int(state["hkey"].shape[0])
    S = int(state["okey"].shape[0])
    used = int(state["hused"].sum())
    return {"hot_slots": H, "hot_used": used, "hot_pct": round(100.0 * used / H, 2),
            "outbox_slots": S, "outbox_depth": int(state["ocnt"]),
            "state_spills": int(state["spills"]),
            "state_readmits": int(state["readmits"])}


__all__ = ["TierConfig", "TieredTable", "JoinTableTier", "SlotTableTier", "ArchiveTier",
           "slot_lookup",
           "outbox_find_last", "slot_directory_resolve",
           "slot_directory_evict", "slot_directory_init", "slot_directory_stats"]

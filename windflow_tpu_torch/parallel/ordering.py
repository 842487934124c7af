"""Ordering_Node — deterministic order restoration at merge boundaries.

Counterpart of ``windflow_tpu/parallel/ordering.py`` (reference
``wf/ordering_node.hpp:47-287``): tuples are held back until the
*low watermark*, the minimum over the input channels of the largest id or ts
each has delivered, proves that nothing smaller can still arrive.

- Each channel's watermark is the max (ts, or id in ID mode) of its batches.
- ID mode releases sort keys ``<=`` the low watermark (a channel's ids
  strictly increase); the TS modes release strictly below it (a channel may
  deliver more tuples equal to its own watermark, and releasing those ties
  early would leak the poll interleaving into the output order). Channel
  EOS lifts that channel's gate.
- Modes (``ordering_mode_t``): ID, TS, TS_RENUMBERING (released tuples get
  progressive ids, for count-based windows downstream,
  ``wf/pipegraph.hpp:1954-1957``).

The pending pool is kept PHYSICALLY SORTED (live lanes ascending by the
composite key ``(prim, sec, chan)``, invalid lanes at the tail). A push:

1. updates the channel's watermark on the device;
2. sorts only the incoming batch with K4's sort network
   (``ops/bitonic.py::sort_network``), padded to a power of two with
   ``_BIG`` keys, with the lane index as the last key. The JAX package skips
   the sort when the batch is already ascending, a data-dependent
   ``lax.cond``; in eager PyTorch that test would be a host read, so the
   sort runs every time (the same values: the stable sort of a sorted
   batch is the identity);
3. merges it with the pool by K4's merge network over ascending(pool) ++
   descending(batch), padded to the power of two ``N >= P + B``;
4. releases the provably complete PREFIX with one elementwise compare, and
   rolls the kept lanes to the front with one modular gather (no host read
   of the count);
5. renumbers on the device in TS_RENUMBERING mode (``_next_id`` is a
   device scalar).

Both networks run the implementation the kernel registry resolved for the
node (family ``ordering_merge``, spec key ``mode=<mode>``, as the JAX
package resolves it once a node): kernel K4 by default on a CUDA tensor,
the plain version on the CPU. The unique index lane makes the key total, so the result equals the
stable lexsort either way.

The host reads back one packed ``[n_released, n_kept]`` pair a push: on the
card, a ``non_blocking`` copy into a pinned buffer with a CUDA event recorded
behind it, started as soon as the push is queued. ``last_release_count`` (or
the next push) waits for that event, reads the pair and trims the pool to the
power of two covering the kept lanes. ``flush`` and ``close_channel`` are
EOS-granular and read their counts synchronously.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

from ..basic import ordering_mode_t
from ..batch import Batch, CTRL_DTYPE, tree_map
from ..observability import journal as _journal
from ..ops import bitonic

#: "no watermark yet": gates the low watermark (a channel at the sentinel
#: keeps ``min(wm)`` there, and the release predicate masks on it). It aliases
#: the legal key ``iinfo(int32).min``, as in the JAX package.
WM_NONE = torch.iinfo(CTRL_DTYPE).min

_BIG = torch.iinfo(CTRL_DTYPE).max


def _pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _sort_keys(mode, b: Batch, chan):
    """(primary, secondary, channel): id/ts, then the other control field,
    then the source channel: a total order even when two channels carry equal
    (ts, id) pairs."""
    if mode == ordering_mode_t.ID:
        return b.id, b.ts, chan
    return b.ts, b.id, chan


def _masked_keys(mode, b: Batch, chan):
    """The composite key with invalid lanes at (+max, +max, +max)."""
    big = torch.full((), _BIG, dtype=CTRL_DTYPE, device=b.key.device)
    return tuple(torch.where(b.valid, k, big) for k in _sort_keys(mode, b, chan))


def _wm_after(mode, wm, channel: int, batch: Batch):
    k = batch.id if mode == ordering_mode_t.ID else batch.ts
    none = torch.full((), WM_NONE, dtype=CTRL_DTYPE, device=k.device)
    mx = torch.where(batch.valid, k, none).amax() if k.numel() else none
    lane = torch.arange(wm.shape[0], device=wm.device) == channel
    return torch.maximum(wm, torch.where(lane, mx, none))


def _sort_batch(mode, batch: Batch, chan, networks: Counter, impl: str = None):
    """Stable ascending sort of one batch by the composite key (invalid to
    the tail) with K4's sort network: the keys padded to a power of two with
    ``_BIG`` and the lane index (padding after every lane) as the last key.
    Returns the sorted keys and the data-order permutation (int64)."""
    bp, bs, bc = _masked_keys(mode, batch, chan)
    C = batch.capacity
    n = _pow2(C, 2)
    dev = bp.device
    pad = lambda a: torch.cat([a, torch.full((n - C,), _BIG, dtype=CTRL_DTYPE,  # noqa: E731
                                             device=dev)])
    iota = torch.arange(n, dtype=CTRL_DTYPE, device=dev)
    networks[(n, True)] += 1
    sp, ss, sc, order = bitonic.sort_network(pad(bp), pad(bs), pad(bc), iota, impl=impl)
    return sp[:C], ss[:C], sc[:C], order[:C].to(torch.int64)


def _split_release(mode, sortedb: Batch, chan_s, wm, next_id, release_all: bool):
    """Release decision on an already sorted pool: one elementwise compare.
    Returns (out, kept, kept_chan, counts[2], next_id); ``kept`` has its live
    lanes rolled to the front (the released lanes are a physical prefix)."""
    dev = chan_s.device
    if release_all:
        # EOS: every valid lane, sorted. No watermark compare: a valid key at
        # the dtype max is indistinguishable from the invalid-lane sentinel.
        releasable = sortedb.valid
    else:
        low_wm = wm.amin()
        big = torch.full((), _BIG, dtype=CTRL_DTYPE, device=dev)
        ks = torch.where(sortedb.valid, _sort_keys(mode, sortedb, chan_s)[0], big)
        releasable = (ks <= low_wm) if mode == ordering_mode_t.ID else (ks < low_wm)
        releasable = releasable & (low_wm != WM_NONE) & sortedb.valid
    out = sortedb.mask(releasable)
    kept = sortedb.mask(sortedb.valid & ~releasable)
    n_out = out.valid.sum(dtype=CTRL_DTYPE)
    N = sortedb.capacity
    roll = (torch.arange(N, device=dev) + n_out) % N          # jnp.roll(a, -n_out)
    kept = kept.take(roll)
    kept_chan = chan_s.index_select(0, roll)
    if mode == ordering_mode_t.TS_RENUMBERING:
        ids = torch.cumsum(out.valid.to(CTRL_DTYPE), 0, dtype=CTRL_DTYPE) - 1 + next_id
        out = out.replace(id=torch.where(out.valid, ids, out.id))
        next_id = next_id + n_out
    counts = torch.stack([n_out, kept.valid.sum(dtype=CTRL_DTYPE)])
    return out, kept, kept_chan, counts, next_id


def _first_push(mode, batch: Batch, channel: int, wm, next_id, networks: Counter,
                impl: str = None):
    """First push: no pool yet. Sort the batch, release its prefix."""
    wm = _wm_after(mode, wm, channel, batch)
    chan = torch.full((batch.capacity,), channel, dtype=CTRL_DTYPE, device=wm.device)
    _, _, _, order = _sort_batch(mode, batch, chan, networks, impl)
    out, kept, kept_chan, counts, next_id = _split_release(
        mode, batch.take(order), chan, wm, next_id, False)
    return out, kept, kept_chan, counts, wm, next_id


def _push(mode, pending: Batch, pchan, batch: Batch, channel: int, wm, next_id,
          networks: Counter, impl: str = None):
    """One push: watermark, incoming sort, bitonic merge with the sorted
    pool, prefix release, renumbering."""
    wm = _wm_after(mode, wm, channel, batch)
    P, B = pending.capacity, batch.capacity
    N = _pow2(P + B)
    dev = wm.device
    ap, asec, ac = _masked_keys(mode, pending, pchan)            # ascending already
    aidx = torch.arange(P, dtype=CTRL_DTYPE, device=dev)
    bchan = torch.full((B,), channel, dtype=CTRL_DTYPE, device=dev)
    bp, bs, bc, border = _sort_batch(mode, batch, bchan, networks, impl)
    bidx = P + border.to(CTRL_DTYPE)

    # pad the batch side to N - P with +max keys and a garbage index, then
    # reverse: ascending(pool) ++ descending(batch) is bitonic
    def ext(a, fill):
        return torch.cat([a, torch.full((N - P - B,), fill, dtype=CTRL_DTYPE,
                                        device=dev)]).flip(0)
    networks[(N, False)] += 1
    _, _, _, idx = bitonic.merge_network(
        torch.cat([ap, ext(bp, _BIG)]), torch.cat([asec, ext(bs, _BIG)]),
        torch.cat([ac, ext(bc, _BIG)]), torch.cat([aidx, ext(bidx, P + B)]), impl=impl)
    idx = idx.to(torch.int64)

    # one gather moves the rows: concat(pool, batch, one invalid garbage row)
    def take2(a, b):
        z = a.new_zeros((1,) + tuple(a.shape[1:]))
        return torch.cat([a, b, z]).index_select(0, idx)
    merged = Batch(key=take2(pending.key, batch.key), id=take2(pending.id, batch.id),
                   ts=take2(pending.ts, batch.ts),
                   payload=tree_map(take2, pending.payload, batch.payload),
                   valid=take2(pending.valid, batch.valid))
    mchan = take2(pchan, bchan)
    out, kept, kept_chan, counts, next_id = _split_release(
        mode, merged, mchan, wm, next_id, False)
    return out, kept, kept_chan, counts, wm, next_id


class Ordering_Node:  # wf-lint: single-writer[driver, stage]
    """One merge's order restoration over ``n_inputs`` channels, driven by
    one thread. ``device`` is where the watermarks and the renumbering
    counter live (None = the first batch's device). ``merge_impl``: the
    networks' implementation (``"cuda"``/``"torch"``; None: the registry's
    choice, resolved once the device is known)."""

    def __init__(self, n_inputs: int, mode: ordering_mode_t = ordering_mode_t.TS,
                 device=None, merge_impl: str = None):
        self.n_inputs = int(n_inputs)
        self.mode = mode
        self._merge_impl_arg = merge_impl
        self.merge_impl = None
        self._device = None if device is None else torch.device(device)
        self._wm_dev = None
        self._pending: Optional[Batch] = None    # INVARIANT: sorted, invalid at tail
        self._pending_chan = None                # int32 [C] source channel a lane
        self._next_id = None                     # int32 device scalar (renumbering)
        self._last_release_count = 0
        #: counts of the last push/try_release not yet read: (host int32 [2]
        #: tensor, CUDA event or None)
        self._counts_pending = None
        self._counts_host = None                 # pinned buffer (card)
        #: K4 network calls of this node: (lanes, sort) -> calls
        self.networks: Counter = Counter()
        if self._device is not None:
            self._init_device(self._device)

    def _init_device(self, dev: torch.device) -> None:
        from ..ops.registry import resolve_impl
        self.merge_impl = resolve_impl("ordering_merge", impl=self._merge_impl_arg,
                                       spec_key=f"mode={self.mode.name}", device=dev)
        self._device = dev
        self._wm_dev = torch.full((self.n_inputs,), WM_NONE, dtype=CTRL_DTYPE, device=dev)
        self._next_id = torch.zeros((), dtype=CTRL_DTYPE, device=dev)

    @property
    def last_release_count(self) -> int:
        """Valid lanes of the batch last returned by push/try_release/flush
        (reading it settles the counts of the last push)."""
        return self.settle()

    def settle(self) -> int:  # wf-lint: thread-role[driver, stage]
        """Read the counts of the last push/try_release (a no-op when none
        are owed): wait for their copy's event, record
        ``last_release_count`` and trim the pool they size."""
        pending = self._counts_pending
        if pending is not None:
            self._counts_pending = None
            host, event = pending
            if event is not None:
                event.synchronize()
            n_out, n_kept = (int(x) for x in host.tolist())
            self._last_release_count = n_out
            if self._pending is not None:
                self._trim_pow2(n_kept)
        return self._last_release_count

    def _defer_counts(self, counts: torch.Tensor) -> None:
        """Start the counts' device-to-host copy without waiting for it."""
        if counts.device.type == "cuda":
            if self._counts_host is None:
                self._counts_host = torch.empty((2,), dtype=CTRL_DTYPE, pin_memory=True)
            self._counts_host.copy_(counts, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(counts.device))
            self._counts_pending = (self._counts_host, event)
        else:
            self._counts_pending = (counts, None)

    # -- host protocol ----------------------------------------------------------------

    def push(self, channel: int, batch: Batch) -> Batch:
        """Deliver a batch from ``channel``; returns the released (ordered)
        batch, possibly with no valid lane (``last_release_count`` says how
        many). Queues the work and the counts' copy; does not wait."""
        self.settle()               # the trim owed by the previous call
        if self._wm_dev is None:
            self._init_device(batch.device)
        if self._pending is None:
            out, kept, kchan, counts, wm, nid = _first_push(
                self.mode, batch, int(channel), self._wm_dev, self._next_id,
                self.networks, self.merge_impl)
        else:
            self._pad_pow2()
            out, kept, kchan, counts, wm, nid = _push(
                self.mode, self._pending, self._pending_chan, batch, int(channel),
                self._wm_dev, self._next_id, self.networks, self.merge_impl)
        self._wm_dev, self._next_id = wm, nid
        self._pending, self._pending_chan = kept, kchan
        self._defer_counts(counts)
        return out

    def resort_pending(self) -> None:
        """Re-establish the sorted-pool invariant on a pool assigned from
        outside (the supervised graph restore: a snapshot from another
        writer may hold it unsorted; merge and release assume ascending
        order with the invalid lanes at the tail). One stable sort by the
        composite key, in plain PyTorch: a rare recovery path, not the hot
        path. Counts still owed are dropped, not settled: they sized a pool
        the assignment replaced."""
        self._counts_pending = None
        if self._pending is None:
            return
        b, chan = self._pending, self._pending_chan
        order = torch.arange(b.capacity, device=chan.device)
        for k in reversed(_masked_keys(self.mode, b, chan)):     # lexsort: last key first
            order = order.index_select(0, torch.argsort(k.index_select(0, order),
                                                        stable=True))
        self._pending = b.select(order, torch.ones_like(b.valid))
        self._pending_chan = chan.index_select(0, order)

    def _pad_pow2(self) -> None:
        """Pad the pool to a power-of-two capacity with invalid lanes at the
        tail (the sorted invariant holds), so merges see O(log backlog)
        shapes."""
        b = self._pending
        C = b.capacity
        P = _pow2(C)
        if P == C:
            return
        pz = lambda a: torch.cat([a, a.new_zeros((P - C,) + tuple(a.shape[1:]))])  # noqa: E731
        self._pending = Batch(key=pz(b.key), id=pz(b.id), ts=pz(b.ts),
                              payload=tree_map(pz, b.payload), valid=pz(b.valid))
        self._pending_chan = pz(self._pending_chan)

    def _trim_pow2(self, n: int) -> None:
        """Trim the kept pool (live lanes at the front) to the power of two
        covering its ``n`` live lanes, at least 64: the pool stays within
        about twice the held-back backlog."""
        b = self._pending
        cap = _pow2(max(n, 1), 1)
        cap = max(cap, 64)
        if b.capacity <= cap:
            return
        take = lambda a: a[:cap]  # noqa: E731
        self._pending = Batch(key=take(b.key), id=take(b.id), ts=take(b.ts),
                              payload=tree_map(take, b.payload), valid=take(b.valid))
        self._pending_chan = take(self._pending_chan)

    def try_release(self) -> Optional[Batch]:
        """Release the pool's prefix at the current low watermark (one
        compare, no sort). None only when there is no pool."""
        self.settle()
        if self._pending is None:
            self._last_release_count = 0
            return None
        out, kept, kchan, counts, nid = _split_release(
            self.mode, self._pending, self._pending_chan, self._wm_dev, self._next_id,
            False)
        self._pending, self._pending_chan = kept, kchan
        self._next_id = nid
        self._defer_counts(counts)
        return out

    def close_channel(self, channel: int) -> Optional[Batch]:
        """Channel EOS: the channel stops gating the low watermark (its
        watermark goes to the dtype max); returns what that releases. A
        valid tuple AT the dtype max rides out with :meth:`flush`."""
        if self._wm_dev is not None:
            lane = torch.arange(self.n_inputs, device=self._wm_dev.device) == channel
            self._wm_dev = torch.where(lane, torch.full_like(self._wm_dev, _BIG),
                                       self._wm_dev)
        out = self.try_release()
        self._journal_release("ordering_close_channel", channel=channel)
        return out

    def flush(self) -> Optional[Batch]:
        """EOS: release everything, sorted (the pool already is). Reads its
        count synchronously."""
        self.settle()
        if self._pending is None:
            self._last_release_count = 0
            self._journal_release("ordering_flush")
            return None
        out, _, _, counts, nid = _split_release(
            self.mode, self._pending, self._pending_chan, self._wm_dev, self._next_id,
            True)
        self._pending, self._pending_chan = None, None
        self._next_id = nid
        self._last_release_count = int(counts[0])
        self._journal_release("ordering_flush")
        return out

    def _journal_release(self, event: str, **fields) -> None:
        """An ordering-buffer record to the active journal (EOS-granular:
        ``close_channel`` and ``flush``, never a push). Reading the release
        count settles it, so it is read only when a journal is active."""
        if _journal.get_active() is not None:
            _journal.record(event, mode=self.mode.name, n_inputs=self.n_inputs,
                            released=self.last_release_count, **fields)


__all__ = ["Ordering_Node", "WM_NONE"]

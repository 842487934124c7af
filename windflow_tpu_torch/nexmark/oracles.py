"""Dense host-side oracles for every Nexmark query: exact expected outputs,
computed with plain Python loops over the event definitions, so a bug in the
batched operators cannot hide in its own oracle.

The port's own copy of ``windflow_tpu/nexmark/oracles.py`` (pure Python; the
port imports nothing of the JAX package). Python ints do not wrap, while the
generators compute ``i * 7919`` in int32: the two agree for i < 271,183, so
check streams shorter than that here.

Event model (mirrors :mod:`generators`, re-derived independently here):
``ts(i) = i // EVENTS_PER_TICK``; bid fields are modular functions of the
event index. All oracles return sorted lists of plain tuples; the tests
compare them against the sorted sink captures.
"""

from __future__ import annotations

from . import queries as q
from .generators import (EVENTS_PER_TICK, N_AUCTIONS, N_BIDDERS,
                         N_CATEGORIES, OPEN_EVERY, PRICE_MOD)


def _ts(i):
    return i // EVENTS_PER_TICK


def _auction(i):
    return (i * 2477) % N_AUCTIONS


def _bidder(i):
    return ((i % 7) * (i % 11) + i // 13) % N_BIDDERS


def _price(i):
    return (i * 7919) % PRICE_MOD + 100


def q1_currency(total):
    """[(id, auction, euro)] for every bid."""
    return sorted((i, _auction(i), _price(i) * q.EURO_NUM // q.EURO_DEN)
                  for i in range(total))


def q2_selection(total):
    """[(id, auction, price)] for bids on selected auctions."""
    return sorted((i, _auction(i), _price(i)) for i in range(total)
                  if _auction(i) % q.SELECT_MOD == 0)


def q3_enrich_join(total):
    """[(id, auction, category, price)] for every bid (definitions precede
    all bids, so every probe hits)."""
    out = []
    for i in range(N_AUCTIONS, total):
        a = _auction(i)
        out.append((i, a, (a * 13) % N_CATEGORIES, _price(i)))
    return sorted(out)


def q4_interval_join(total):
    """[(auction, open_ts, bid_ts, price)] for every (open, bid) pair of
    the same auction with ``bid_ts - open_ts in [0, JOIN_WINDOW]`` (bids
    indexed by (auction, tick), so a full-width stream stays cheap)."""
    opens, bids = [], {}
    for i in range(total):
        if i % OPEN_EVERY == 0:
            opens.append(((i // OPEN_EVERY) % N_AUCTIONS, _ts(i)))
        else:
            bids.setdefault((_auction(i), _ts(i)), []).append(_price(i))
    out = []
    for a, ots in opens:
        for bts in range(ots, ots + q.JOIN_WINDOW + 1):
            out.extend((a, ots, bts, p) for p in bids.get((a, bts), ()))
    return sorted(out)


def q5_session(total):
    """[(bidder, ordinal, start, end, n, bids, spend)] per closed session
    (gap-chained in event time per bidder)."""
    per_key = {}
    for i in range(total):
        per_key.setdefault(_bidder(i), []).append((_ts(i), _price(i)))
    out = []
    for k, events in per_key.items():
        ordinal = 0
        start, end, n, spend = None, None, 0, 0
        for ts, p in events:                    # already event-time ordered
            if start is None:
                start, end, n, spend = ts, ts, 1, p
            elif ts - end <= q.SESSION_GAP:
                end, n, spend = max(end, ts), n + 1, spend + p
            else:
                out.append((k, ordinal, start, end, n, n, spend))
                ordinal += 1
                start, end, n, spend = ts, ts, 1, p
        if start is not None:
            out.append((k, ordinal, start, end, n, n, spend))
    return sorted(out)


def q6_topn(total):
    """[(auction, rank, id, price)] — the final top-N leaderboard."""
    per_key = {}
    for i in range(total):
        per_key.setdefault(_auction(i), []).append((-_price(i), i))
    out = []
    for a, cands in per_key.items():
        for rank, (np_, i) in enumerate(sorted(cands)[:q.TOP_N]):
            out.append((a, rank, i, -np_))
    return sorted(out)


def q7_distinct(total):
    """[(id, auction)] — the first bid of each selected auction."""
    seen, out = set(), []
    for i in range(total):
        a = _auction(i)
        if a % q.SELECT_MOD == 0 and a not in seen:
            seen.add(a)
            out.append((i, a))
    return sorted(out)


ORACLES = {
    "q1_currency": q1_currency,
    "q2_selection": q2_selection,
    "q3_enrich_join": q3_enrich_join,
    "q4_interval_join": q4_interval_join,
    "q5_session": q5_session,
    "q6_topn": q6_topn,
    "q7_distinct": q7_distinct,
}

"""Nexmark query builders: ``(source, ops)`` per query, for any sink.

Counterpart of ``windflow_tpu/nexmark/queries.py``, with its constants and
parameters. Every builder takes ``device=`` (None means ``"cuda"``).

====================  ===================================================
q1_currency           per-bid dollar -> euro projection (Map)
q2_selection          selection filter: auctions of interest (Filter)
q3_enrich_join        stream-table join: each bid enriched with its
                      auction's category (StreamTableJoin; kernel K5)
q4_interval_join      not ported yet (IntervalJoin)
q5_session            not ported yet (SessionWindow)
q6_topn               incremental top-``TOP_N`` bid prices per auction
                      (TopN; kernel K4)
q7_distinct           first bid per selected auction (Filter, Distinct;
                      kernel K5)
====================  ===================================================
"""

from __future__ import annotations

from ..observability.names import NEXMARK_QUERIES as QUERIES
from ..operators.filter import Filter
from ..operators.join import StreamTableJoin
from ..operators.map import Map
from ..operators.rank import Distinct, TopN
from . import generators as g

#: euro conversion: integer, exact (the reference multiplies by 0.89)
EURO_NUM, EURO_DEN = 89, 100
#: q2/q7 selection predicate: auctions divisible by this
SELECT_MOD = 4
#: q4 interval-join window, ticks
JOIN_WINDOW = 4
#: q5 session gap, ticks
SESSION_GAP = 2
#: q6 leaderboard depth
TOP_N = 3


def q1_currency(total: int, device=None):
    src = g.make_bid_source(total, device=device)
    ops = [Map(lambda t: {"auction": t.auction,
                          "euro": (t.price * EURO_NUM) // EURO_DEN},
               name="nexmark_currency", device=device)]
    return src, ops


def q2_selection(total: int, device=None):
    src = g.make_bid_source(total, device=device)
    ops = [Filter(lambda t: t.auction % SELECT_MOD == 0, name="nexmark_select",
                  device=device)]
    return src, ops


def q3_enrich_join(total: int, n_auctions: int = g.N_AUCTIONS, num_slots: int = None,
                   tiered=None, device=None):
    """``n_auctions`` scales the key space; ``num_slots`` sizes the table
    apart from it (default: ``n_auctions``)."""
    src = g.make_enrich_source(total, n_auctions=n_auctions, device=device)
    ops = [StreamTableJoin(
        lambda t: t.side == 1,                 # auction definitions build
        lambda t: t.auction,
        lambda t: {"category": t.category},    # the enrichment column
        num_slots=int(num_slots if num_slots is not None else n_auctions),
        tiered=tiered, name="nexmark_enrich_join", device=device)]
    return src, ops


def q4_interval_join(total: int, max_matches: int = 8, tiered=None, device=None):
    raise NotImplementedError(
        "q4_interval_join: IntervalJoin is not ported yet (ROADMAP Queue 1 item 11)")


def q5_session(total: int, tiered=None, device=None):
    raise NotImplementedError(
        "q5_session: SessionWindow is not ported yet (ROADMAP Queue 1 item 11)")


def q6_topn(total: int, tiered=None, device=None):
    src = g.make_bid_source(total, device=device)
    ops = [TopN(lambda t: t.price, TOP_N, num_keys=g.N_AUCTIONS, tiered=tiered,
                name="nexmark_topn", device=device)]
    return src, ops


def q7_distinct(total: int, tiered=None, device=None):
    src = g.make_bid_source(total, device=device)
    ops = [Filter(lambda t: t.auction % SELECT_MOD == 0, name="nexmark_select",
                  device=device),
           Distinct(lambda t: t.auction, num_slots=g.N_AUCTIONS, tiered=tiered,
                    name="nexmark_distinct", device=device)]
    return src, ops


_BUILDERS = {
    "q1_currency": q1_currency,
    "q2_selection": q2_selection,
    "q3_enrich_join": q3_enrich_join,
    "q4_interval_join": q4_interval_join,
    "q5_session": q5_session,
    "q6_topn": q6_topn,
    "q7_distinct": q7_distinct,
}

assert set(_BUILDERS) == set(QUERIES), "queries drifted from names.py"

#: the queries the port runs
PORTED = ("q1_currency", "q2_selection", "q3_enrich_join", "q6_topn", "q7_distinct")


def make_query(name: str, total: int, **kw):
    """``(source, ops)`` for one registered query name."""
    return _BUILDERS[name](total, **kw)

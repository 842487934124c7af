"""Nexmark-style benchmark suite of the port.

Counterpart of ``windflow_tpu/nexmark``: the synthetic auction and bid
sources (:mod:`generators`), one builder per query (:mod:`queries`) and the
dense host-side oracles (:mod:`oracles`). The port runs q1, q2, q3, q6 and
q7; q4 (interval join) and q5 (session window) raise until their operators
are ported (ROADMAP Queue 1 item 11).
"""

from . import generators, oracles, queries
from .queries import PORTED, QUERIES, make_query

__all__ = ["generators", "oracles", "queries", "PORTED", "QUERIES", "make_query"]

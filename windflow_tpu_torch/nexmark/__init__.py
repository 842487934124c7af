"""Nexmark-style benchmark suite of the port.

Counterpart of ``windflow_tpu/nexmark``: the synthetic auction and bid
sources (:mod:`generators`), one builder per query (:mod:`queries`) and the
dense host-side oracles (:mod:`oracles`). The port runs every query, q1 to
q7 (q4 on the interval join, q5 on the session window).
"""

from . import generators, oracles, queries
from .queries import PORTED, QUERIES, make_query

__all__ = ["generators", "oracles", "queries", "PORTED", "QUERIES", "make_query"]

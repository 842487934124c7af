"""Name registries the port's operators and benchmarks check against.

The port's own copy of three registries of ``windflow_tpu/observability/
names.py`` (that module imports no JAX, but the port imports nothing of the
JAX package). Keep the tuples equal to the JAX package's:
``tests/test_torch_package.py`` compares them.
"""

#: per-stage counters an operator may bump through ``ops/lookup.py::
#: count_drops`` (a name outside this tuple is refused)
STAGE_COUNTERS = (
    "sessions_closed",     # operators/session.py: sessions the triggerer closed
    "topn_evictions",      # operators/rank.py: leaderboard candidates evicted
    "match_drops",         # operators/join.py IntervalJoin: per-probe overflow
    "arch_drops",          # operators/join.py IntervalJoin: archive overwrites
    "overflow_drops",      # ops/lookup.py JoinTable: pending-ring/table drops
    "old_drops",           # session/win_seqffat OLD straggler drops
    # tiered keyed state: device rows spilled to the outbox, cold rows
    # re-admitted on probe miss, host-store rows retired by compaction
    "state_spills", "state_readmits", "state_compactions",
)

#: the Nexmark-style benchmark queries (``nexmark/queries.py``)
NEXMARK_QUERIES = (
    "q1_currency",       # currency-map: per-bid dollar -> euro projection
    "q2_selection",      # selection-filter: auctions of interest
    "q3_enrich_join",    # stream-table join: bid -> auction category
    "q4_interval_join",  # interval join: bid within an auction's open window
    "q5_session",        # session-aggregate: per-bidder activity sessions
    "q6_topn",           # top-N-by-key: highest bids per auction
    "q7_distinct",       # distinct: first bid per selected auction
)

#: process-wide recovery counters (``runtime/faults.py::bump``)
RECOVERY_COUNTERS = (
    "restarts", "backoff_sleeps", "backoff_seconds",
    "dead_letters", "watchdog_timeouts", "faults_injected",
    "checkpoint_saves", "checkpoint_corrupt_skipped",
    "checkpoint_fallbacks",
    "recovery_seconds",
)

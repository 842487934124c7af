"""Name registries the port's operators, drivers and exporters check against.

The port's own copy of the registries of ``windflow_tpu/observability/
names.py`` that it emits (that module imports no JAX, but the port imports
nothing of the JAX package). Keep the tuples equal to the JAX package's:
``tests/test_torch_monitoring.py`` compares them.
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

#: per-stage gauges an operator may publish beside its counters
#: (``Basic_Operator._publish_stage_counters``)
STAGE_GAUGES = (
    "join_table_version",  # applied upsert count of the op's own JoinTable
    # tiered keyed state: hot-table occupancy (slots in use) and cold-tier
    # key count
    "tier_hot_used", "tier_cold_keys",
)

#: per-shard rows of the sharded supervisors' ``shard_report()``
#: (``runtime/supervisor.py``)
SHARD_GAUGES = (
    "occupancy_tuples",     # live tuples this shard processed since commit
    "restarts",             # shard-local recoveries (global restarts excluded)
    "last_recovery_s",      # duration of the most recent shard restore+replay
    "dead_letters",         # sub-batches this shard quarantined
    "reshard_moves",        # times this shard's key range changed in a reshard
    "committed_pos",        # stream position of the shard's last commit
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


#: process-wide control counters (``control.py``; the snapshot's
#: ``control`` section)
CONTROL_COUNTERS = (
    "admitted_batches", "admitted_tuples", "shed_batches", "shed_tuples",
    "throttle_events", "throttle_seconds", "capacity_switches",
    "tuning_decisions", "tuning_cache_hits",
    # nexmark-class operator family (operators/session.py, operators/
    # rank.py): sessions closed by the data-dependent triggerer, and
    # leaderboard candidates evicted by the top-N rank merge
    "sessions_closed", "topn_evictions",
    # self-driving remediation (control/remediation.py): policy actions
    # that fired an actuator, and actions held back (cooldown / budget /
    # damping / unbound / gate / arbitration)
    "remediation_actions", "remediation_skips",
)

#: per-operator and graph-level event-time gauges (``metrics.py``)
EVENT_TIME_GAUGES = (
    "watermark",           # operator event-time frontier (max ts applied)
    "lag", "occupancy_pct", "pending_depth", "open_sessions",
    "oldest_open_age", "archive_fill_pct",
    "lateness_p50", "lateness_p99",        # lateness histogram quantiles
    "min_watermark", "skew",               # graph frontier + per-edge skew
)

#: runtime-health gauges of the snapshot's ``health`` section (``metrics.py``)
HEALTH_GAUGES = (
    "hbm_headroom_bytes",      # per device: bytes_limit - bytes_in_use —
    #                            THE eviction signal for tiered state
    "hbm_bytes_in_use", "hbm_bytes_limit",
    "live_buffer_bytes", "live_buffer_count",
    "state_bytes",             # per operator: state-pytree footprint
    "compiles", "retraces", "retraces_unexpected",  # compile ledger totals
    "compile_seconds",
    "device_ms", "dispatch_ms",                     # per stage label
    "dispatch_ratio",          # host dispatch / device time — >= 0.5 names
    #                            a fusion candidate (dispatch-bound edge)
)

"""Name registries the port's operators, drivers and exporters check against.

The port's own copy of the registries of ``windflow_tpu/observability/
names.py`` that it emits (that module imports no JAX, but the port imports
nothing of the JAX package). Keep the tuples equal to the JAX package's:
``tests/test_torch_monitoring.py`` compares them. One differs on purpose:
:data:`KERNEL_IMPLS` names the port's implementations.
"""

#: every journal event name emitted via ``journal.record``/``EventJournal.
#: event`` and every span name opened via ``journal.span`` (spans appear as
#: ``phase=begin/end`` pairs under the same name)
JOURNAL_EVENTS = (
    # observability lifecycle (observability/__init__.py Monitor)
    "monitoring_start", "monitoring_end",
    # compiled-chain hot path (runtime/pipeline.py, sampled): per-batch
    # "launch", and "dispatch_fused" for a sampled K-batch scan dispatch
    # (runtime/dispatch.py scan dispatcher; k= says how many batches rode
    # the one compiled program)
    "launch", "dispatch_fused",
    # EOS protocol (runtime/pipeline.py, runtime/pipegraph.py)
    "eos", "eos_flush", "eos_propagate",
    # ordering buffer (parallel/ordering.py, via its _journal_release wrapper)
    "ordering_flush", "ordering_close_channel",
    # supervision / recovery (runtime/supervisor.py, runtime/faults.py,
    # runtime/checkpoint.py, runtime/threaded.py)
    "checkpoint", "restore",                       # spans
    "checkpoint_invalid", "checkpoint_fallback",
    "restart_exhausted", "dead_letter", "backoff",
    "watchdog_timeout", "watchdog_stale",
    "fault_injected",
    # control plane (control/admission.py, control/governor.py,
    # control/autotune.py, runtime/supervisor.py warm start)
    "shed", "throttle", "throttle_end",
    "capacity_switch", "tuning_converged", "tuning_warm_start",
    # per-batch causal tracing lifecycle (observability/tracing.py Tracer)
    "trace_start", "trace_end",
    # event-time forensics (runtime/pipeline.py CompiledChain, event_time
    # monitoring only): a stateful operator's drop counter advanced — the
    # record carries (op, kind, n) plus the trace coordinates
    # (tid/pos) of the sampled batch the readback rode, so wf_trace.py /
    # wf_state.py join drops to traced batches
    "lateness_drop",
    # runtime health ledger (observability/device_health.py, health
    # monitoring only): "compile" = one jit trace of a CompiledChain
    # step/scan program (cause, cache key, compile duration, AOT cost
    # flops/bytes); "retrace_unexpected" = the live retrace detector — a
    # warm executable re-traced under an ALREADY-TRACED signature (jit
    # cache eviction/clear, the WF102/WF109 hazard caught at runtime);
    # "kernel_resolve" = a per-backend kernel registry resolution
    # (ops/registry.py) observed while the ledger was active
    "compile", "retrace_unexpected", "kernel_resolve",
    # tiered keyed state (state/tiered.py TieredTable, maintain cadence):
    # "spill" = outbox rows settled into the host store, "readmit" = cold
    # rows handed back to the device tier on probe miss — both carry
    # (table, n, total); emitted on the driver thread only
    "spill", "readmit",
    # shard-local supervision (runtime/supervisor.py ShardedSupervisor):
    # "shard_restore" = ONE shard restored + replayed its own key range
    # while peers kept serving (shard id + replay extent: replay_from/
    # at_batch); "reshard" = a live re-sharding span (from_shards/
    # to_shards/moves/at_pos; discarded=True marks an in-flight handoff
    # manifest dropped on restore — replay re-derives the move)
    "shard_restore", "reshard",
    # SLO engine (observability/slo.py, Reporter-tick evaluation):
    # "slo_page" = an SLO's multi-window burn crossed page_burn on BOTH
    # windows (slo/signal/value/target/burn_fast/burn_slow/tick — incident
    # capture follows, rate-limited); "slo_recover" = a warned/paged SLO
    # returned to OK (from_state says which)
    "slo_page", "slo_recover",
    # fleet telemetry plane (observability/fleet.py):
    # "telemetry_connect"/"telemetry_lost" = the host agent's sender thread
    # (re)gained / dropped its aggregator connection (host/endpoint) — a
    # flapping link shows as a connect/lost train in the HOST journal;
    # "fleet_host_join"/"fleet_host_leave" = the AGGREGATOR saw a new host
    # tag's first frame / a host stream close (host, mon_dir on join)
    "telemetry_connect", "telemetry_lost",
    "fleet_host_join", "fleet_host_leave",
    # self-driving remediation (control/remediation.py, evaluated on the
    # Reporter tick in live mode / at commit barriers in supervised mode):
    # "remediation_apply" = a policy action fired an actuator (action/
    # actuator/slo + burn or barrier pos + setpoint details);
    # "remediation_skip" = an action wanted to fire but was held back —
    # reason says why (cooldown, run/action budget, damped, unbound
    # actuator, gate, arbitration loss to auto-reshard); "tuning_reclimb" =
    # a converged autotuner was un-converged to re-explore its ladder
    "remediation_apply", "remediation_skip", "tuning_reclimb",
    # serving front-end (serving/runtime.py ServingRuntime):
    # "serving_start"/"serving_end" frame one service run (endpoint +
    # tenant ids / batch + swap totals); "graph_swap" is BOTH the
    # quiesce->warm->cutover span around a zero-downtime chain swap AND
    # the point records inside it (applied=True with carried_state/
    # warmed/quiesce_ms, or rejected=True for an unregistered wire swap)
    "serving_start", "serving_end", "graph_swap",
)


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

#: control-plane gauges (``control/_state.py::set_gauge``; Prometheus
#: ``windflow_control_<name>``)
CONTROL_GAUGES = (
    "chosen_capacity",
    # scan dispatch (runtime/dispatch.py MicrobatchAccumulator + the
    # autotuner's K ladder): batches buffered awaiting a fused launch, and
    # the K rung the dispatch tuner currently runs
    "dispatch_linger_depth", "dispatch_k",
    # versioned join-state table (ops/lookup.py join_table_*): applied
    # upsert count of the most recently synced table (last-write-wins
    # across tables, the chosen_capacity convention)
    "join_table_version",
    # actuator setpoints (remediation observability): current
    # admission bucket refill rate (control/admission.py, updated by
    # scale_rate), governor high/low queue-depth watermarks
    # (control/governor.py), and the tiered hot-capacity target the run
    # was built with (operators/join.py / operators/rank.py tier wiring,
    # last-write-wins across tables) — so remediation deltas are
    # observable before/after each action
    "bucket_rate", "governor_high_watermark", "governor_low_watermark",
    "hot_capacity",
    # advisory remediation recommendations (control/remediation.py):
    # geometry-baked setpoints (tiered hot capacity, watermark delay) are
    # traced constants, so their actuators gauge a recommendation for the
    # next restart instead of mutating a live trace
    "remediation_hot_capacity", "remediation_recommended_delay",
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

#: per-SLO gauges of the snapshot's ``slo`` section (``slo.py``; rendered as
#: ``windflow_slo_<name>{graph,slo=...}`` by ``metrics.py``)
SLO_GAUGES = (
    "state",            # health state code: 0 ok, 1 warn, 2 page
    "burn_fast",        # error-budget burn over the fast window
    "burn_slow",        # error-budget burn over the slow window
    "signal",           # latest observed signal value
    "target",           # the spec's target threshold
    "pages",            # PAGE transitions this run
)

#: gauges of the host's ``telemetry`` section (``fleet.py`` TelemetryAgent)
TELEMETRY_GAUGES = (
    "frames_sent",      # frames delivered to the aggregator socket
    "frames_dropped",   # frames evicted by the bounded drop-oldest outbox
    "reconnects",       # successful reconnects after a lost aggregator
    "outbox_depth",     # frames queued right now (bounded by the outbox)
    "connected",        # 1 = live aggregator connection, 0 = not
)

#: gauges of the aggregator's ``fleet`` section (``fleet.py``
#: FleetAggregator; ``fleet._FLEET_HELP`` names the same)
FLEET_GAUGES = (
    "hosts_connected",  # hosts with a live telemetry stream right now
    "hosts_seen",       # distinct host tags seen since the serve started
    "frames_received",  # telemetry frames decoded across all hosts
    "frames_torn",      # frames lost to torn/corrupt wire data (resync'd)
    "ticks",            # fleet merge ticks emitted
)

#: run-level gauges of the snapshot's ``serving`` section
#: (``serving/runtime.py`` ServingRuntime.serving_section)
SERVING_GAUGES = (
    "swaps_applied",     # zero-downtime graph_swap cutovers completed
    "swaps_rejected",    # wire swap frames naming an unregistered graph
    "frames_decoded",    # intact WFS1 record frames ingested
    "frames_torn",       # bytes resync'd past (torn client / garbage)
    "frames_dup",        # reconnect-overlap frames deduped by tenant seq
    "clients_seen",      # ingest connections accepted since start
    "unknown_offered",   # batches from tenant ids nobody declared
)

#: per-tenant gauges of the ``serving.tenants`` rows (``serving/tenants.py``
#: TenantRegistry.counters and the registry's per-tenant latency rows)
TENANT_GAUGES = (
    "offered",           # batches this tenant offered to its bucket
    "admitted",          # batches its controller admitted
    "shed",              # batches its controller shed
    "shed_tuples",       # tuple capacity those shed batches carried
    "rate",              # the bucket's live refill rate (remediation moves it)
    "e2e_p50_ms", "e2e_p95_ms", "e2e_p99_ms",
    "e2e_p99_tick_ms",   # windowed p99 over the last reporter tick: the
    #                      tenant_e2e_p99_ms SLO signal
    "e2e_samples", "e2e_samples_tick",
    "e2e_p99_exemplar",  # trace id of a batch observed in the p99 bucket
)

#: kernel families selectable through the kernel registry
#: (``ops/registry.py``): the JAX registry's families
KERNELS = (
    "histogram",        # ops/histogram.py keyed_pane_histogram
    "lookup",           # ops/lookup.py table_lookup
    "ordering_merge",   # parallel/ordering.py bitonic merge/sort network
    "segment_fold",     # ops/segment.py segment_fold (window fold path)
    "join_probe",       # ops/lookup.py join_probe (stream-table join)
)

#: non-kernel proxy-microbench families the hermetic perf gate must ALSO
#: cover (``analysis/perfgate.py::compare``: a family without a proxy row is
#: a coverage finding, the KERNELS convention). "dispatch" times the scan
#: dispatcher's fused ``push_many`` and carries its launch counts; "join"
#: the full versioned JoinTable step (upsert + probe); "spill" the tiered
#: state's eviction/pack path; "shard" the sharded supervisor's
#: key-ownership splitter.
PERF_PROXY_FAMILIES = (
    "dispatch",
    "join",
    "spill",
    "shard",
)

#: implementation names a kernel family registers under in the port (the
#: JAX package's are "xla", "pallas" and "pallas_mm")
KERNEL_IMPLS = (
    "torch",            # the plain PyTorch version (the reference)
    "cuda",             # the hand-written kernel (a CUDA tensor only)
)

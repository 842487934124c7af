#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``windflow_tpu_torch``) on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py              # the default run, one card
    python3 chip_smoke.py --profile    # adds torch.profiler breakdowns of
                                       # every loop's steps, captured and eager
    python3 chip_smoke.py --split-only # phases 1-3's split of K1's, K2's and
                                       # K3's time, then stops (no result
                                       # line); copied with PROBES_SRC into
                                       # another tree, it splits that tree's
                                       # kernels
    python3 chip_smoke.py --only lookup --only path_b # the build, then only
                                       # the named phases (no result line):
                                       # lookup (K2's split and checks),
                                       # nexmark_loop, path_b, sweep, chaos
    python3 chip_smoke.py --helper-times # K2's (every main-path case), the
                                       # fold's, cold_fetch's and
                                       # cold_probe's (2^18 keys, q3's
                                       # shape) times on their check
                                       # inputs, nothing checked, then stops
                                       # (``--helper-times lookup``: K2's
                                       # alone); copied into another tree,
                                       # it times that tree's designs

Phases (each raises on a mismatch, so any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every CUDA kernel from ``windflow_tpu_torch/ops/csrc`` with nvcc
   for sm_90a (one nvcc per source, all started together), and its time;
3. where K1's and K3's time goes (graph replay; K1 at YSB's shape, panes
   past the window and 40,000 keys; K3 at path B's counts, YSB-sum and
   random ids): a zero fill of the output alone, a probe that only reads
   the same 9 bytes a lane, a probe that adds every counted lane with one
   global atomic, the kernel's C entry point, the wrapper (the probes are
   ``PROBES_SRC``, built beside the kernels);
   then each kernel (K1 histogram, K2 lookup, K3 segment_fold, K4
   ordering_merge, K5 join_probe) at main-path shapes (K2 and K3 also at
   the window paths' per-key count and next_win tables, 512 and 100 rows)
   and on adversarial inputs:
   bit-identical to its plain PyTorch version, with the kernel's, the plain
   version's and one library call's device times (CUDA-graph replay; eager
   times beside them; K1's and K3's library call is one ``index_add_`` into
   a fresh zeroed output, dropped lanes adding 0 at a spread index) and the
   bound (the larger of bytes moved / 3.35 TB/s and operations / 67 T/s).
   K1, K3, K4 and K5 also run once in each regime of their designs (K1:
   window, global tiles, empty tiles, every lane on one cell, panes near
   the int32 limits, K * P near 2^31; K3: direct partials with the
   workspace reduce or the atomic flush, global tiles, S = 1, one segment
   with wrapping sums, one segment of 409,600, each input dtype; both at
   ragged lengths, one lane and unaligned inputs; K2: every element
   size, -0.0 and NaN, a one-row float table, an index view off 16-byte
   alignment, a ragged lane count, nine tables of nine dtypes in one
   launch, tables past 48 KB alone and together, an empty table, 17
   tables (two launches); K4: one
   CTA, one cluster in one launch, several waves of clusters, beyond one
   cluster; K5: shared-memory and device-memory hash table, colliding and
   repeated keys, one row, one lane, ragged lane counts), bit-identical to
   the plain version (each K4 network also to a stable lexsort), with the
   kernel's time alone; K1 and K3 log each case's plan
   (``histogram_plan`` / ``segment_fold_plan``) and counters, and the phase
   fails unless every regime ran. K2 (since its redesign) is also split
   at YSB's shape (the staging alone, the lanes alone through L2, both;
   in the parent's geometry and in the redesign's), checked as every
   table group its callers read in one launch (path B's next_win and
   count; q5's two and nine tables) and from CUDA graphs replayed twice,
   and timed beside the launch floor (an empty kernel's replay time);
4. YSB at full width through ``Pipeline(...).run()`` and a host ``Sink``:
   2^20-event batches with ``bench.py``'s geometry, every per-window count
   against a numpy dense oracle, and K1 and K2 launched once per batch;
   first with scan dispatch off, then at K = 3 (``dispatch=3``: 8 batches in
   groups of 3, 3 and 2, so the K = 3 graph replays twice and the K = 2
   tail graph once), whose sink rows must equal the first run's byte for
   byte, with the same launches counted through the replays. Every
   Pipeline phase below runs the same pair (``DISPATCH_K``), logs each
   run's peak device memory, and checks the graphs' replays. No chain here
   has a float reduction whose order is not fixed (K6 and the float fold sum
   in a fixed order, every other sum is an integer one), so byte identity
   is the check;
5. YSB through the ``device_cursor_step`` loop, captured (the whole step one
   CUDA graph replay), then the eager step on a fresh chain (the plain loop
   of ``apply`` that was timed before scan dispatch): tuples/s and ms/step
   of both. Every loop phase below times both forms, and checks its oracle
   and launches on the captured one;
6. YSB-sum (Key_FFAT summing an int32 field) for 4 batches, dispatch off
   and at K = 2: dense-oracle check and K3's launches; then YSB-sum through
   the loop;
7. ``bench.py::bench_dispatch``'s counterpart: its Map -> Filter ->
   ReduceSink chain over 96 batches of 2^18, per batch and at K = 8 in
   turns: tuples/s, the entry op's launches a batch, equal results;
8. Nexmark q1-q7 through ``Pipeline(...).run()`` at ``bench_nexmark``'s
   batch (2^14) for 16 batches, dispatch off and at K = 5: every sink row
   against the dense oracle, and the exact K2, K3, K4 and K5 launches of
   each query (q5's SessionWindow: ``Q5_APPLY`` an apply; q4's IntervalJoin
   none: it is plain PyTorch), with q4's and q5's drop counters and every
   run's peak device memory; before them, K3 at q5's shapes on q5's
   traffic (``session_kernel_phase``; K2's are in phase 3);
9. the same seven queries through the loop; then ``nexmark_graph``: q4 as
   two sources (opens and bids) through ``join_with`` in a DETERMINISTIC
   PipeGraph, serial and ``threaded=True``, its rows equal to the dense
   oracle (the one-source Pipeline's rows);
10. q3 at full width (2^20-event batches, 2048 auctions): 4 batches through
    ``Pipeline(...).run()``, dispatch off and at K = 2, then the loop; every
    emitted row against a numpy int32 oracle;
11. K6 (masked_window_reduce) at ``bench.py::bench_pallas_ab``'s shapes and
    at the window paths' shapes: bit-identical to its plain version on int32
    and integer-valued float32, within rtol = atol = 1e-4 on random float32,
    the same bits on two launches; its time, its bound and the time of
    ``torch.sum(torch.where(mask, vals, 0), dim=1)``;
12. path A, the windowed-operator matrix at full width (``bench_keyed_cb``'s
    geometry through Key_Farm): ``Pipeline(...).run()`` of 4 batches of 2^20,
    dispatch off and at K = 2, against a numpy oracle of all 8192 windows,
    then the loop; K2, K3 and K6 once per apply, K6 alone in the flush;
13. path B, YSB-WMR at ``bench_ysb_wmr``'s geometry: ``Pipeline(...).run()``,
    dispatch off and at K = 2, against a dense per-window count and the
    stream's view total, then the loop with ``bench_ysb_wmr``'s undercount
    self-check; K2 twice (the campaign join; next_win and count in one
    launch), K3 and K6 once per apply, K6 alone in the flush;
14. the other window patterns at small depth (Win_Farm, Pane_Farm CB and
    TB, Win_MapReduce with a K6 MAP, Win_Farm(Pane_Farm), Key_Farm(Win_MapReduce),
    an incremental fold, a TB window with lateness), each against a plain
    Win_Seq run on the card or a Python oracle;
15. ``pipegraph_ysb`` (after phase 4): the YSB chain as a one-source
    ``PipeGraph`` at the same geometry, dispatch off and at K = 3: sink rows
    byte for byte equal to phase 4's Pipeline rows and the dense oracle, the
    same K1 and K2 launches;
16. ``ordering``: ``bench.py::bench_ordering_overhead``'s graph (two sources
    of 200,000, batch 4096, merge -> Map -> ReduceSink) in DEFAULT and
    DETERMINISTIC mode, equal sums, tuples/s of each and their ratio; then
    the same graph at batch 2^16 with 2^22 tuples a source into a Sink: the
    released stream is the input sorted by (ts, id, chan), and K4's network
    calls (a sort a push, a merge a push after the first) and their CUDA
    launches (``network_plan``) are counted exactly;
17. ``graph_windows``: split -> two branches -> a DETERMINISTIC merge-partial
    (TS_RENUMBERING) -> CB Win_Seq sum -> Sink at path A's keys and window,
    batch 2^16 over 2^21 tuples, against a numpy oracle; K2, K3 and K6 once
    a Win_Seq apply, K4 as the Ordering_Node called it; before it,
    ``host_io``: a GeneratorSource of string-keyed numpy chunks (pinned
    host-to-device copies) into a Sink, synchronous and with
    ``async_depth=3``, the same rows in order;
18. the fixed-order float fold (``fold_checks`` over ``fold_cases``), bit
    for bit against the CPU and run to run: random ids in 4096 segments
    (the fold's repair: the same bits on two card runs and on the CPU), the
    keyed paths' shapes (Key_FFAT's pane sums at S = 2^21 on
    ``bench_keyed_cb``'s traffic; the Accumulator's batch totals at S = 8,
    500 and 10,000), each with its split (mask, sort, gather, the C entry
    point), and K2 on the Accumulator's float carry tables (phase 3 also
    holds K3 at ``bench_keyed_cb``'s occupancy counts, S = 2^21); runs of
    1, 31, 32, 33, 255, 256, 1023 and 1025 lanes with -0.0, inf and NaN at
    D = 1, 3 and 64 in float32, float64, float16 and bfloat16, one run of
    2^20 lanes in the three other dtypes, and a graph replayed twice over
    an input changed in place;
19. ``keyed_cb``: ``bench.py::bench_keyed_cb``'s operator as written (the
    per-key CB Key_FFAT over 512 keys, CB 1024 slide 512, batch 2^20):
    ``Pipeline(...).run()`` of 4 batches, dispatch off and at K = 2, every
    window against numpy byte for byte, P = 4096 and W = 2112, K2 once, K3
    twice and the float fold once an apply and nothing in the flush; then
    the loops, with the state's and the peak device memory;
20. ``keyed_stateful``: ``bench.py::bench_keyed_stateful`` at K = 1, 500
    and 10,000 (Accumulator -> ReduceSink): 4 batches, dispatch off and at
    K = 2, every tuple's running sum against a float64 oracle within
    ``STATEFUL_TOL``; the float32 and int32 streams for 2 batches byte for
    byte against the CPU port; the loops;
21. ``keyed_small``: KeyedMap, FlatMap word counts, general ReduceSink
    combines, per-key TB Key_FFAT with lateness, CB Key_FFAT max and the
    2x2 matrix product, the Accumulator's max, each against the CPU port
    and captured (dispatch = 2) where it can be; a KeyedMap without
    ``max_key_multiplicity=1`` must refuse the capture;
22. ``ring``: ``native.queue_selfbench`` (tokens/s through one native SPSC
    ring between two unpinned threads of the card's host, the fastest of 16
    slices by the threads' CPU time),
    three times; the port's native library is built by ``g++`` into
    ``build/native/`` at first use;
23. ``handoff``: a batch written on one CUDA stream after a deliberate
    ``torch.cuda._sleep`` and read on another through
    ``runtime/handoff.py``: the same bytes, and the host did not wait;
24. ``threaded_ysb``: YSB at ``bench_ysb``'s geometry, 40 batches of 2^20,
    through the serial Pipeline and ``ThreadedPipeline(src, [[Filter, join],
    [KeyBy, Key_FFAT]], sink)``, each eager and at dispatch K = 4: rows byte
    for byte equal to the serial eager run's and the dense oracle, K1 and K2
    40 each and nothing else; tuples/s, ms a batch, peak memory, the
    threaded/serial ratios, and with ``--profile`` the threaded runs' idle
    share and each stage thread's CPU and wall seconds (pinned, unpinned,
    one segment: rows asserted equal);
25. ``record_ysb``: the same stream as 16-byte AoS records (``pack_records``
    from the DeviceSource's columns) through ``RecordSource(key_field=
    "campaign", ts_field="ts")`` at framing_workers 1 and
    hardware_concurrency(), prefetch 0 and 3 (and once at K = 4), into the
    threaded chain: rows equal to ``threaded_ysb``'s, the same launches;
    framing ms a batch, host-to-device bytes, tuples/s;
26. ``threaded_graph_windows``: ``graph_windows`` with ``run(threaded=True)``,
    eager and at K = 4: windows equal to phase 17's and the oracle (as a
    set: their emission follows the release chunks), K2, K3 and K6 exact
    per Win_Seq apply and flush call, K4 and branch 2's host-constant count
    equal to phase 17's, ms a push against phase 17's; then the merge
    straight into a Sink, serial and threaded: DETERMINISTIC rows byte for
    byte in delivery order, DEFAULT rows once sorted;
27. ``checkpoint`` (after phase 10): YSB (8 x 2^20) and q5 (16 x 2^14)
    run half their batches, ``save_chain``, ``load_chain`` into a fresh
    chain whose K-step graph was captured before the restore, and the rest
    at dispatch K: rows byte for byte equal to an uninterrupted run, exact
    launches, the file's bytes and the save and load ms;
28. ``faults`` (after phase 25): threaded YSB (40 x 2^20) under a
    ``queue.stall`` plan (segment 1 sleeps 1.5 s at one batch, heartbeat
    0.5 s): rows equal to the serial run's byte for byte, the watchdog names
    ``seg1``, the stall fired once;
29. ``supervised_ysb`` (after phase 15): YSB (8 x 2^20) through
    ``SupervisedPipeline`` with a checkpoint every 2 batches, dispatch off
    and at K = 3, an ``EventJournal`` active, in four cases: no plan;
    seeded chain.step, sink.consume and source.next errors; a 1.0 s step
    stall under a 0.5 s watchdog, run on a side CUDA stream; a poison batch
    into a ``DeadLetterQueue``. Rows byte for byte equal to phase 4's plain
    rows (the poison case: the plain rows without that batch), the restarts
    and dead letters the plan implies, K1 and K2 once a batch pushed
    (replays included), the journal's checkpoint and restore spans; logs
    each restore span's ``dur_s`` and the ``recovery_seconds`` counter (the
    time to recover), the run's seconds against the plain Pipeline's and
    the snapshot's bytes;
30. ``supervised_q3`` (after phase 8): q3 (16 x 2^14) under
    ``SupervisedPipeline`` with one chain.step error: phase 8's q3 rows byte
    for byte, K5 twice a batch pushed;
31. ``supervised_graph`` (after phase 17): ``graph_windows`` under
    ``run_supervised(checkpoint_every=4)`` with a chain.step and a
    sink.consume error: phase 17's windows in delivery order, two restarts,
    K2, K3, K4 and K6 counted exactly with the replays;
32. ``tiered_q3`` (tiered keyed state, after phase 26): ``bench.py``'s
    tiered row as written (``benchmarks/tiered.py``: batch 1024, hot 4096,
    keys 102,400, 12 probe batches through ``chain.push``), then the same
    workload at batch 2^14 with the row's ratios (hot 65,536, keys
    1,638,400: 100 definition batches and 12 probe batches, a host store of
    about 1.6 M rows), eager (each push timed to completion; spills,
    readmits and cold keys of every step logged) and at
    ``Pipeline(dispatch=4)``: rows equal to the dense oracle and byte for
    byte between the two, ``overflow_drops == 0``, K5 four times and
    ``cold_probe`` once an apply, counted through the replays; ms and p99 of
    a step;
33. ``cold_probe`` (kernel check, after ``link_reads``: the host link's
    rate of 16-byte system-scope reads of random lines, a probe of
    ``PROBES_SRC``): the cold-tier probe against its plain version (the
    store's host lookup) bit for bit at R = 49,152 over that 1.6 M-row
    store (hits, misses, unwanted lanes; then every lane a hit, every lane
    a miss), over a 2^18-key store as built, after a reindexing
    ``compact_below``, after ``pop_keys``' backward shifts and after a
    restore that fits, and graphs captured before a store grew (by upserts,
    by a restore), replayed after; the index mirror equal to the host index
    after each write; ``cold_scatter`` (the mirror's upkeep) against its
    plain version; the whole index's upload timed; times and bounds (link
    reads over the measured rate, device bytes over 3.35 TB/s);
34. ``tiered_queries``: q5, q6 and q7 at 2^14 tiered (``TIERED_QUERIES``),
    eager and at K = 4: the untiered rows (the dense oracle), byte for byte
    between the two, each apply's K2, K3, K4, K5 and ``cold_probe``
    launches exact, spills on every query;
35. ``tiered_recovery``: tiered q3 at batch 1024 under
    ``SupervisedPipeline`` (a checkpoint every 6 batches, a chain.step
    fault at batch 30 with spills in flight, a journal active), dispatch
    off and K = 3, then ``save_chain`` half way and ``load_chain`` into a
    chain whose K = 3 graph was captured before the restore: rows byte for
    byte equal to an uninterrupted run, the restore span's ``dur_s``;
36. ``tiered_rotating``: q5 and q6 over a key space that rotates with the
    stream (``rotating_query``: 64 bidders, 128 auctions, a 2^14 batch
    touching a quarter of them) with hot capacities below the key space
    (``TIERED_ROTATING``: 32, 48), eager and at K = 4: rows equal to the
    untiered run's, byte for byte between the two, exact launches, spills
    and readmissions;
37. ``tiered_inputs``: the tiered runs of phases 32, 34 and 36 once more,
    eagerly, with every K2, K3, K4 and K5 call's arguments cloned as it
    launches; the last four calls of each distinct signature rerun through
    the kernel and its plain version, bit for bit;
38. ``cold_fetch`` (kernel check): the archive tier's multimap read
    against its plain version (the store's host ``fetch_multi``) bit for bit
    at R = 2^14 and M = 8 over a store of 4096 keys with chains of 0 to 20
    rows, compacted so rows in the middle of chains are gone; over a store
    with row widths of 1, 2, 4, 8, 12, 16 and 24 bytes at M = 1, 8 and 20
    and one of 1072-byte records (wider than the kernel stages) at M = 8,
    with keys whose probe wraps the index (``fetch_cases``); and a graph
    captured before the store grew 128x, replayed after; its time and its
    bound (as ``cold_probe``'s);
39. ``tiered_q4``: q4 at 2^14 tiered (the dense oracle, ``cold_fetch`` twice
    an apply), then q4's operator over the ring-overwrite stream at full
    width (``tq4_query``: archive 2^14, a window of 24,576 ticks): the rows
    of an untiered archive that never overwrites, the small untiered ring
    losing rows, tiered eager and at K = 4 byte for byte with spills (and,
    eager, readmissions), ``cold_fetch`` twice an apply counted through the
    replays, and a supervised tiered run with one chain.step fault giving
    the uninterrupted rows;
40. ``sharded_supervision``, three parts run after their unsharded
    counterparts: YSB (8 x 2^20, after phase 29) under
    ``SupervisedPipeline(shards=4)`` with ownership by campaign, a
    ``shard.kill`` on shard 2 and a live reshard 4 -> 8 at batch 4, sharded
    checkpoint files reloaded into every shard's committed state, then again
    with the first handoff seal torn (re-derived, no seal left); q3 (16 x
    2^14, after phase 30) at shards 4; ``graph_windows`` (after phase 31)
    under ``run_supervised(shards=2)``. Each gives the unsharded rows
    (sorted: a batch's rows arrive shard by shard), with K1/K2 (YSB), K5
    (q3) and K2/K3/K4 (graph) counted a shard's push, and logs ms a batch
    beside the unsharded supervised run's and each shard's restore;
41. ``control`` (``control_phase``): the control plane and kernel selection.
    YSB (100 x 2^20, the operators bound at 2^22) under
    ``Pipeline(control=ControlConfig(decide_every=2, settle_batches=0,
    cache_path=...))``, the ladder 2^18 .. 2^22: the windows of the same run
    uncontrolled, one first run a rung at prewarm in the capture ledger and
    none after (no unexpected recapture), K1 and K2 once a push plus once a
    rung's warm step, a converged plan persisted in the tuning cache, each
    rung's host ms a push as the tuner measured it and its captured ms a
    push (a K = 2 graph replayed); a second run warm-starts (one cache hit,
    no switch, the key's device kind ``gpu:<card>``). Then ``dispatch={"k":
    4}`` under control: the K ladder's graphs captured at prewarm, the
    dispatch-off windows. Kernel selection: every family resolves ``cuda``
    by default and the main path's records hold only ``cuda``; YSB built
    under ``WF_KERNEL_IMPL=torch`` gives phase 4's rows with no hand-kernel
    launch; ``impl="cuda"`` on a CPU tensor raises; a graph captured before
    the change is named by ``stale_selections()`` and its replay counts the
    K1 and K2 it captured. The governor: a fast source straight into a slow
    sink through ``ThreadedPipeline`` (one ring of 8, watermarks 0.5/0.25,
    admission at 20,000 tuples/s) keeps the ring at or below 5 while
    throttling and shedding, and without control the ring pegs at 8; the
    governed threaded
    ``graph_windows`` gives phase 17's windows with K2, K3, K4 and K6 as
    counted. q3 (16 x 2^14) under supervised admission (``refill_per_batch``
    = half a batch, a checkpoint every 2): a fault plan replays to the clean
    run's rows, shed positions and bucket; with ``remediation=True`` the
    barrier remediation fires and the faulted replay decides the same;
    ``shards=2, reshard="auto"`` gives the ``nexmark`` phase's q3 rows
    (sorted);
42. ``monitoring`` (``monitoring_phase``), after every other phase: YSB (8 x
    2^20) captured at ``DISPATCH_K["ysb"]`` with ``Pipeline(monitoring=,
    trace=)`` (event time, health, a trace sampling every 4th batch; the
    artifacts under ``build/monitoring``, removed after), against the same
    run unmonitored: rows byte for byte phase 4's, launches equal phase 4's
    in both, the global-time ``lat_hist`` equal to a numpy recount with the
    port's ``bucket_of``, the allocator's memory gauges (headroom = limit -
    in use), one ledger capture a graph and no unexpected recapture, the
    four artifacts with ``launch``/``dispatch_fused`` records; ms a batch of
    both runs, ms a captured K-step replay of both chains (their difference:
    what the lateness histogram costs a step) and ``lateness_update`` alone
    at 2^20 lanes; q5 at 2^14 over a stream with stragglers, unmonitored and
    monitored: rows byte for byte, ``lateness_drop`` records summing to the
    drop counter; ``graph_windows`` threaded with ``trace=``: phase 17's
    windows, every traced id's ``enq``/``deq`` on every ring edge it
    crosses and one service span a pipe, ``to_chrome_trace`` as JSON; YSB
    supervised with one ``chain.step`` fault and ``trace=``: phase 4's rows
    and the failed attempt's span closed ``aborted: restore``;
43. ``serving`` (``serving_phase``), after ``monitoring``: the YSB stream
    as packed records (40 frames of 2^20 records, 16 B each) from a
    ``RecordClient`` over loopback TCP into ``ServingRuntime(SocketSource,
    YSB ops, sink)`` (a replay ring of 4 frames, 64 MiB), two tenants
    alternating frames and a wire swap to a registered YSB chain after frame
    20 (warmed, state carried): rows byte for byte threaded_ysb's and the
    dense oracle, K1 and K2 once a frame plus the swapped-in chain's warm
    step; ms a batch wire to sink against record_ysb's, and the wire, queue,
    framing and copy ms and the swap's quiesce ms apart. Then a quiet and a
    slow tenant under ``slo=[tenant_e2e_p99_ms]``, ``profile=``,
    ``remediation=[tenant_rate]`` and telemetry to a loopback
    ``FleetAggregator``; the slow tenant's frames stall on the wire: its
    SLO pages and recovers, one bundle commits ``profile.json`` before its
    manifest with a trace naming K1's or K2's kernel, only its bucket
    tightens, the aggregator receives the host's frames, and
    ``scripts/wf_slo.py``, ``wf_profile.py`` and ``wf_fleet.py status``
    exit 0 over the artifacts (under ``build/serving``, removed after);
44. ``mesh`` (``mesh_phase``), after ``serving``: the mesh half of
    ``parallel``. (a) YSB (8 x 2^20, 100 campaigns) through ``ShardedChain``
    over ``make_mesh(4, axis="key")`` with every position on cuda:0: the
    unsharded chain's rows (sorted) and the dense oracle, each ``[K]`` leaf's
    shards 25 rows, the replicated leaves equal on every position, K1 and K2
    launches a batch as found and eager ms a batch beside the unsharded
    chain's; (b) the JAX tests' 2-D layouts at 2^16: Key_FFAT over a 2 x 4
    ``dp x key`` mesh and a keyed Win_Farm over a 4 x 2 ``key x win`` mesh
    (archive shards of K/4 rows, window rows split over ``win``; K3 and
    K6), rows and gathered states bit for bit the unsharded chain's; (c)
    the four collectives at 2^20 lanes over 4 positions against the same
    calls over 4 CPU positions (bit for bit, the generic mean's float sum
    within rtol 1e-5), with their eager ms; (d) two processes
    (``tests/torch_multihost_driver.py``, gloo, both on cuda:0, started
    first and run beside (b)) each supervising half of a 4-shard YSB stream
    with a shard-kill drill, the union held to the unsharded supervised
    run, then ``keyed_all_to_all`` and its lossless variant across the
    process axis; and ``multihost.initialize()`` over NCCL at world size 1
    with one exchange over the process axis, against the CPU;
45. ``examples`` (``examples_phase``), after ``mesh``: the port's six
    user-facing examples (``python -m windflow_tpu_torch.examples.<name>``:
    ysb_windows, wordcount, checkpoint_resume, multichip over a 2 x 4
    ``dp x key`` mesh of cuda:0 positions, recovery_and_backpressure,
    serving over loopback TCP), each a process on the card and then one
    with ``--device cpu``: every run passes its own oracle, the card's
    result numbers equal the CPU's, and every kernel ``examples.EXAMPLES``
    names for it launched on the card (ysb_windows: K1 and K2), with each
    run's seconds and launches;
46. ``sweep`` (``sweep_phase``), after ``examples``:
    ``windflow_tpu_torch/benchmarks/sweep.py`` at its defaults (36 fixed
    rows: map_stateless, map_stateful, filter and win_kf at 2^16, 2^18 and
    2^20 lanes over 1, 500 and 10,000 keys, 20 captured steps each; the
    14 Nexmark rows at 2^12 and 2^14), each row logged with its tuples/s
    and launches, and ``run_adaptive`` over 500 keys twice with a tuning
    cache in a temporary directory (the rerun warm-starts: one cache hit a
    row, no capacity switch); then the four workloads' states after the
    timed steps at 2^18 lanes and 500 keys against the CPU port's after
    the same steps, byte for byte (NaN as NaN);
47. ``chaos`` (``chaos_phase``): ``windflow_tpu_torch/scripts/chaos_sweep.py``'s
    ``main`` in six modes at the JAX script's defaults with ``--seeds 2``
    (plain, ``--controller``, ``--dispatch 4``, ``--shards 4``,
    ``--remediate``, ``--serve``; an empty CUDA graph is an error, F24),
    each exiting 0 with its seconds, faults fired a driver and launches
    logged, then the plain mode over 2^18 tuples (``CHAOS_FULL``), whose
    fault-free baselines must equal the CPU port's; then
    ``python -m windflow_tpu_torch.scripts.wf_profile --capture`` (its
    ``main``, in a thread) over a running Key_FFAT chain at 2^18 lanes:
    exit 0 and a trace with CUDA kernel events;
48. ``analysis`` (``analysis_phase``), last: building YSB (2^20), q3
    (2^14) and served YSB launches no kernel (every operator's spec probe
    runs on the meta device); ``validate()`` of each, and of
    ``graph_windows`` for the threaded driver, launches nothing, allocates
    nothing, captures no graph and reports clean, with its ms; after YSB's
    K-step graph is captured, ``WF_KERNEL_IMPL=torch`` gives WF109 on K1 and
    K2 naming that graph; progcheck of the card's YSB step lists
    ``histogram`` and ``lookup`` in its kernels and fingerprints as the same
    chain built on the CPU, with its trace ms; the perfgate proxy rows time
    the hand kernels (advisory);
49. the ``{"kernels": [...]}`` summary (the six TPU kernels, the
    fixed-order float fold at ``keyed_cb``'s shape, ``cold_probe`` at
    tiered q3's, ``cold_fetch`` at tiered q4's and ``cold_scatter`` over
    tiered q3's index, launches summed over the paths, each counted from
    zero just before it), then the result line
    ``{"ok": true, "device": {...}}`` as the last line.

Phase 3 also holds K4 at the Ordering_Node's shapes (merges of [1, 8192]
and [1, 2^17], sorts of [1, 4096] and [1, 2^16]) and at TopN's tiered
directories (17 and 48 rows), and K5 over tiered q3's live hot table
(65,536 slots, 16,384 keys, the sentinel elsewhere) at 49,152 and 16,384
lanes, and K2 and K3 at q5's tiered directories (9 and 32 slots); phase 11
holds K6 on
every dtype the JAX package sums (uint8 and uint16 into uint32 bit for bit,
float16 and bfloat16 within 1e-2, float64 within 1e-12).

It exits non-zero, printing no result, without CUDA or without the package.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

BATCH = 1 << 20           # bench.py's YSB batch
YSB_BATCHES = 8           # batches of the Pipeline.run phase (plus the flush)
LOOP_STEPS = 40           # timed steps of the device_cursor_step loop
PROFILE_STEPS = 5         # profiled steps after a loop (--profile); the sources
                          # are sized so that these steps read real events
SUM_BATCHES = 4           # batches of the YSB-sum phase
SUM_LOOP_STEPS = 20       # timed steps of the YSB-sum loop
NEX_BATCH = 1 << 14       # bench.py::bench_nexmark's batch
NEX_BATCHES = 16          # batches of the Nexmark Pipeline phase (262,144 events)
NEX_STEPS = 20            # timed steps of the Nexmark loops (after 2 warm-up)
Q3_AUCTIONS = 2048        # q3 at full width: auctions = table slots
WIN_KEYS = 512            # path A: bench.py::bench_keyed_cb's keys and windows
WIN_LEN, WIN_SLIDE = 1024, 512
WIN_BATCHES = 4           # batches of the path A and B Pipeline phases (plus the flush)
WIN_STEPS = 20            # timed steps of the path A and B loops
Q3_BATCHES = 4            # batches of the q3 full-width Pipeline phase
#: scan dispatch's K in each Pipeline phase's dispatch run: YSB 8 batches at
#: 3 (groups 3, 3, 2: a tail graph), the Nexmark queries 16 at 5 (a tail of
#: 1, which is push), the others 4 at 2
DISPATCH_K = {"ysb": 3, "ysb_sum": 2, "nexmark": 5, "q3_full": 2, "path_a": 2,
              "path_b": 2, "keyed_cb": 2, "keyed_stateful": 2}
BENCH_DISPATCH_BATCHES = 96     # bench.py::bench_dispatch: 96 batches of 2^18
BENCH_DISPATCH_BATCH = 1 << 18  # (BATCH // 4) at K = 8
BENCH_DISPATCH_K = 8
WMR_WIN_LEN = 1000        # path B: bench.py::bench_ysb_wmr's window (ticks)
WMR_MAP = 4               # and its map_parallelism
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores (data sheet),
                          # the rate used for int32 compares and selects
ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
PROBES_SRC = os.path.join("windflow_tpu_torch", "benchmarks", "csrc", "split_probes.cu")


def log(obj):
    """One output line: a dict as JSON (a phase's or a kernel check's line
    with ``t_s``, the seconds since the script started), anything else as
    it is."""
    if isinstance(obj, dict) and ("phase" in obj or "kernel_check" in obj):
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean time of one eager ``fn()`` call over ``iters`` back-to-back calls,
    by CUDA events: device time, or the host's launch rate where the host
    cannot keep the card busy."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def collection_paused():
    """``runtime/graphs.py::collection_paused``: no cyclic GC inside a
    capture (a CUDA graph freed there would invalidate it)."""
    from windflow_tpu_torch.runtime.graphs import collection_paused as paused
    return paused()


def graph_ms(torch, fn, iters=20, reps=5):
    """Device time of one ``fn()`` call: ``iters`` calls captured in one CUDA
    graph and replayed ``reps`` times, so no host launch cost is in the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with collection_paused(), torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _bits(torch, t):
    """The tensor's bits as an integer tensor of the same element size."""
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def compare(torch, got, want):
    """(bit-identical, max abs error) over a tensor or a tuple of tensors;
    NaN against NaN counts as no error."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    same, err = len(got) == len(want), 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            return False, float("inf")
        same = same and torch.equal(_bits(torch, g), _bits(torch, w))
        if g.numel():
            if g.dtype.is_floating_point:
                d = (g.double() - w.double()).abs()
                d = torch.where(torch.isnan(g) & torch.isnan(w), 0.0, d)
                d = torch.where(torch.isnan(d), float("inf"), d)
            else:
                d = (_bits(torch, g).long() - _bits(torch, w).long()).abs()
            err = max(err, float(d.max()))
    return bool(same), err


def check_kernel(torch, name, case, kernel, plain, library, nbytes, shape,
                 ops=0, tol=None, counted=None, extra=None, timed=True, time_kernel=True):
    """Kernel vs plain version (bit for bit, or within ``tol`` = rtol = atol
    where float sums are taken in different orders) and their times.
    ``*_ms`` are device times from graph replay; ``*_eager_ms`` time eager
    calls. ``library=None`` means no single PyTorch call computes the function. The
    bound is the larger of ``nbytes`` over the memory rate and ``ops`` over
    the operation rate; ``counted`` says what they count. ``timed=False``
    (a regime case, not a main-path shape) times the kernel alone, by graph
    replay, and leaves the plain version and the library call untimed;
    ``time_kernel=False`` times nothing (ragged and outsized cases)."""
    got = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    # a plain version slower than 2.5 ms a call (the sort networks', the join
    # probe's) is timed over fewer calls, each timing loop near 50 ms
    plain_s = time.perf_counter() - t0
    depth = ({} if plain_s < 2.5e-3 else
             {"iters": max(3, int(0.05 / plain_s)), "reps": 1})
    same, err = compare(torch, got, want)
    ok = same if tol is None else bool(torch.allclose(got, want, rtol=tol, atol=tol))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    row = {"kernel_check": name, "case": case, "shape": shape, **(extra or {}),
           "bit_identical": same, "max_abs_err": err, "tolerance": tol,
           "kernel_ms": graph_ms(torch, kernel) if time_kernel else None,
           "plain_ms": graph_ms(torch, plain, **depth) if timed else None,
           "library_ms": (None if library is None or not timed else
                          graph_ms(torch, library)),
           "kernel_eager_ms": time_ms(torch, kernel) if timed else None,
           "plain_eager_ms": (time_ms(torch, plain, iters=depth["iters"], warmup=1)
                              if depth else time_ms(torch, plain)) if timed else None,
           "bytes": nbytes, "ops": ops, "counted": counted,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(row)
    if not ok:
        raise AssertionError(f"{name} [{case}]: kernel differs from its plain version")
    return row


def ysb_traffic(torch, ysb, start):
    """Key, pane, valid and ad ids of one full-width YSB batch at the window's
    input (source -> filter -> join -> KeyBy), built with the port's own ops."""
    src = ysb.make_source(start + BATCH)
    ops = ysb.make_ops_sum(**ysb.bench_geometry(BATCH))
    b = src.make_batch(start, BATCH)
    for op in ops[:-1]:
        _, b = op.apply(None, b)
    return b, ops[-1]


def replayed(torch, fn):
    """``fn()``'s outputs (a tuple) from a CUDA graph that captured one call,
    after two replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with collection_paused(), torch.cuda.graph(g):
        out = fn()
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    return tuple(o.clone() for o in out)


def q5_traffic(torch):
    """q5's SessionWindow input at 2^14 (a batch of bids keyed by bidder) and
    what its apply reads tables through: (batch, keys K, the (key, ts, id)
    sort's permutation, sorted keys ``sk``, fragment ids ``seg``, fragment
    keys ``fkey``)."""
    from windflow_tpu_torch.nexmark import make_query
    from windflow_tpu_torch.nexmark.queries import SESSION_GAP
    from windflow_tpu_torch.ops import lookup as L

    dev = torch.device("cuda")
    C = NEX_BATCH
    src, ops = make_query("q5_session", 4 * C)
    _, b = ops[0].apply(None, src.make_batch(3 * C, C))
    K = ops[1].num_keys
    perm = L._lexsort([b.id, b.ts, b.key])
    sk, sts = b.key[perm].contiguous(), b.ts[perm]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), sk[1:] != sk[:-1]])
    brk = ~first & (sts - torch.cat([sts[:1], sts[:-1]]) > SESSION_GAP)
    seg = torch.clamp(torch.cumsum((first | brk).to(torch.int32), 0, dtype=torch.int32) - 1,
                      min=0)
    fkey = torch.zeros((C,), dtype=torch.int32, device=dev).scatter_reduce_(
        0, seg.long(), sk, "amax")
    return b, K, perm, sk, seg, fkey


def k2_main_cases(torch, ysb):
    """K2's inputs at the main paths' shapes, made from one seed: ``(case,
    tables, idx, timed)``. YSB's campaign join (C = 2^20, 1000 rows) and
    indices out of range; the window paths' Win_Seq._insert reads (path A's
    count over 512 keys; path B's count and next_win over YSB's 100
    campaigns, alone and as the one grouped read path B makes), one lane in
    64 moved out of range; q5's reads at 2^14 on its own traffic (the
    batch's keys into an [8]-row table, the sorted keys into two, the
    fragments' keys into nine: the grouped reads of its apply) and the
    tiered phases' hot directories (9 and 32 slots, untimed); and, untimed,
    tables of 24 and 48 KB read by 2^20 random lanes, which no main path
    reads (an earlier design staged them in shared memory)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)
    C = BATCH
    b, window = ysb_traffic(torch, ysb, 3 * BATCH)
    K = window.num_keys
    campaigns = ysb.campaign_table(dev)
    Kc = campaigns.shape[0]
    ad_id = ysb.make_source(4 * BATCH).make_batch(3 * BATCH, BATCH).payload["ad_id"]

    def stray(keys, Sn):
        """``keys`` with one lane in 64 moved out of ``[0, Sn)``."""
        n = keys.shape[0]
        off = torch.randint(1, 101, (n,), device=dev, generator=gen, dtype=torch.int32)
        far = torch.where(torch.rand((n,), device=dev, generator=gen) < 0.5,
                          -off, Sn - 1 + off)
        return torch.where(torch.rand((n,), device=dev, generator=gen) < 1 / 64,
                           far, keys).to(torch.int32).contiguous()

    def ctrl_table(n, hi):
        return torch.randint(0, hi, (n,), device=dev, generator=gen, dtype=torch.int32)

    def q5_table(n):
        return torch.randint(-2 ** 31, 2 ** 31, (n,), device=dev, generator=gen,
                             dtype=torch.int64).to(torch.int32)
    a_keys = stray((torch.arange(C, device=dev) % WIN_KEYS).to(torch.int32), WIN_KEYS)
    b_keys = stray(b.key, K)
    count, next_win = ctrl_table(K, 2 ** 31 - 1), ctrl_table(K, 1 << 20)
    q5, K5, _, sk, _, fkey = q5_traffic(torch)
    key5 = q5.key.contiguous()
    tq, tr = TIERED_QUERIES["q5_session"], TIERED_ROTATING["q5_session"]
    return [
        ("ysb", [campaigns], ad_id, True),
        ("out_of_range", [campaigns], torch.randint(-100, Kc + 100, (C,), device=dev,
                                                     generator=gen, dtype=torch.int32), True),
        ("path_a_count", [ctrl_table(WIN_KEYS, 2 ** 31 - 1)], a_keys, True),
        ("path_b_count", [count], b_keys, True),
        ("path_b_next_win", [next_win], b_keys, True),
        ("path_b_next_win_count", [next_win, count], b_keys, True),
        (f"q5_table_K{K5}", [q5_table(K5)], key5, True),
        ("q5_sorted_keys_open_last", [q5_table(K5) for _ in range(2)], sk, True),
        ("q5_fragment_keys_9_tables", [q5_table(K5) for _ in range(9)], fkey, True),
        (f"q5_table_K{tq}", [q5_table(tq)], key5, False),
        (f"q5_table_K{tr}", [q5_table(tr)], key5, False),
        ("table_24KB", [q5_table(6000)], torch.randint(-10, 6010, (C,), device=dev,
                                                       generator=gen, dtype=torch.int32),
         False),
        ("table_48KB", [q5_table(12000)], torch.randint(-10, 12010, (C,), device=dev,
                                                        generator=gen, dtype=torch.int32),
         False),
    ]


def k2_call(L, tables, idx):
    """The tree's K2 on ``tables`` read through ``idx``, as a tuple: one
    launch of the grouped entry point for several tables, or, in a tree
    without one, one launch a table (``--helper-times`` on an older tree)."""
    if len(tables) == 1:
        return (L.lookup_cuda(tables[0], idx),)
    if hasattr(L, "lookup_many_cuda"):
        return tuple(L.lookup_many_cuda(tables, idx))
    return tuple(L.lookup_cuda(t, idx) for t in tables)


def k2_check(torch, L, case, tables, idx, timed=True, extra=None):
    """K2 (one launch: ``lookup_cuda``, or ``lookup_many_cuda`` for several
    tables) against its plain version, bit for bit, eagerly and from a CUDA
    graph replayed twice; the library call is one ``index_select`` a table
    (on clamped indices). The bound counts the indices read once, each
    table read once and each output written once."""
    C = idx.shape[0]
    safe = [idx.clamp(0, max(t.shape[0] - 1, 0)) for t in tables]
    if len(tables) == 1:
        kernel = lambda: L.lookup_cuda(tables[0], idx)  # noqa: E731
        plain = lambda: L.lookup_plain(tables[0], idx)  # noqa: E731
    else:
        kernel = lambda: tuple(L.lookup_many_cuda(tables, idx))  # noqa: E731
        plain = lambda: tuple(L.lookup_many_plain(tables, idx))  # noqa: E731
    library = (None if any(t.shape[0] == 0 for t in tables) else
               lambda: tuple(t.index_select(0, s) for t, s in zip(tables, safe)))
    rep_same, rep_err = compare(torch, replayed(torch, kernel), plain())
    nbytes = C * idx.element_size() + sum((C + t.shape[0]) * t.element_size()
                                          for t in tables)
    shape = {"C": C, "K": [t.shape[0] for t in tables],
             "dtype": [str(t.dtype).replace("torch.", "") for t in tables]}
    row = check_kernel(torch, "lookup", case, kernel, plain, library, nbytes, shape,
                       counted="idx + tables + outputs",
                       extra={"tables": len(tables), "replay_bit_identical": rep_same,
                              **(extra or {})}, timed=timed)
    if not rep_same:
        raise AssertionError(f"lookup [{case}]: the replayed kernel differs from its plain "
                             f"version (max abs err {rep_err})")
    return row


def k2_regime_checks(torch):
    """K2 on what its design must get right beyond the main paths' shapes,
    each bit for bit against the plain version eagerly and replayed, timed
    alone: every element size (1, 2, 4, 8 bytes); a float table holding
    -0.0 and NaN (-0.0 read as +0.0, a NaN's bits kept; timed in full) and
    a one-row float table (-0.0 kept); an index view one element off
    16-byte alignment and a lane count that is not a multiple of 4 (the
    scalar path); nine tables of nine dtypes at q5's shape (the mixed-size
    kernel); three tables of 24 KB in one group and a table of 80 KB; an
    empty table in a group; 17 tables, which
    ``lookup_many_cuda`` refuses and ``table_lookup_many`` splits into two
    launches."""
    from windflow_tpu_torch.ops import lookup as L, registry

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261023)
    C = BATCH

    def idx_for(K, n=C, spread=10):
        return torch.randint(-spread, K + spread, (n,), device=dev, generator=gen,
                             dtype=torch.int32)

    def table(K, dtype):
        if dtype.is_floating_point:
            t = torch.randn((K,), device=dev, generator=gen).to(dtype)
            t[::3] = -0.0
            return t
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, (K,), device=dev, generator=gen,
                             dtype=torch.int64).to(dtype)
    for dtype in (torch.uint8, torch.int16, torch.float16, torch.int32, torch.float64,
                  torch.int64):
        k2_check(torch, L, f"elem_{str(dtype).replace('torch.', '')}",
                 [table(1000, dtype)], idx_for(1000), timed=False)
    nz = torch.randn((1000,), device=dev, generator=gen)
    nz[::3] = -0.0
    nz[1::7] = float("nan")
    idx = idx_for(1000)
    k2_check(torch, L, "float_negative_zero", [nz], idx)
    got = L.lookup_cuda(nz, idx)
    if bool(torch.signbit(got[got == 0]).any()):
        raise AssertionError("K2 returned -0.0 from a float table of 1000 rows")
    one = torch.tensor([-0.0], device=dev)
    idx = idx_for(1, spread=3)
    k2_check(torch, L, "float_one_row", [one], idx, timed=False)
    got = L.lookup_cuda(one, idx)
    if not bool(torch.signbit(got[idx == 0]).all()):
        raise AssertionError("K2 read -0.0 from a one-row float table as +0.0")
    campaigns = table(1000, torch.int32)
    base = idx_for(1000, C + 1)
    k2_check(torch, L, "idx_offset_view", [campaigns], base[1:], timed=False,
             extra={"idx_align": base[1:].data_ptr() % 16})
    k2_check(torch, L, "ragged_C", [campaigns, table(1000, torch.int8)],
             idx_for(1000, C - 3), timed=False)
    _, K5, _, _, _, fkey = q5_traffic(torch)
    k2_check(torch, L, "q5_fragment_keys_9_dtypes",
             [table(K5, dt) for dt in (torch.int8, torch.uint8, torch.int16, torch.float16,
                                       torch.bfloat16, torch.int32, torch.float32,
                                       torch.int64, torch.float64)], fkey, timed=False)
    k2_check(torch, L, "group_past_48KB", [table(6000, torch.int32) for _ in range(3)],
             idx_for(6000), timed=False)
    k2_check(torch, L, "table_80KB", [table(20000, torch.int32)], idx_for(20000),
             timed=False)
    k2_check(torch, L, "empty_table_in_group",
             [torch.empty((0,), dtype=torch.int32, device=dev), table(8, torch.int32)],
             idx_for(8), timed=False)
    many = [table(k + 2, torch.int32) for k in range(17)]
    idx = idx_for(20)
    try:
        L.lookup_many_cuda(many, idx)
    except ValueError:
        pass
    else:
        raise AssertionError("lookup_many_cuda took 17 tables")
    with registry.collect() as launched:
        got = L.table_lookup_many(many, idx)
    torch.cuda.synchronize()
    same, err = compare(torch, tuple(got), tuple(L.lookup_many_plain(many, idx)))
    log({"kernel_check": "lookup", "case": "17_tables", "launches": launched,
         "bit_identical": same, "max_abs_err": err})
    if launched != {"lookup": 2} or not same:
        raise AssertionError(f"table_lookup_many over 17 tables: launches {launched}, "
                             f"bit identical {same}")


def launch_floor_ms(torch, probes):
    """An empty kernel's time, as ``check_kernel`` times a kernel (graph
    replay): the least any launch costs."""
    import ctypes
    from windflow_tpu_torch.ops import cuda
    fn = probes.wf_launch_floor
    fn.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    return graph_ms(torch, lambda: cuda.check(fn(cuda.stream_ptr(dev)), "launch floor"))


def lookup_split(torch, ysb, probes, card):
    """Where K2's time goes at YSB's shape (C = 2^20 lanes, the 1000-row
    int32 campaign table), by graph replay: in the earlier design's
    geometry ("parent": a block a 2048 lanes, 512 blocks, a scalar 4-byte
    index load and store a lane) and in the redesign's (two blocks a SM, 16-byte vectors
    of four lanes, two in flight a thread), each as the staging alone
    (every block copies the table into shared memory and waits on its
    barrier, no lane), the lane stream alone through the L2-resident table
    (no staging), and both (``PROBES_SRC``'s ``wf_k2_part``); then the
    tree's C entry point into a preallocated output, its wrapper and the
    launch floor (an empty kernel). Returns the row."""
    import ctypes
    from windflow_tpu_torch.ops import cuda, lookup as L

    dev = torch.device("cuda")
    table = ysb.campaign_table(dev)
    K = table.shape[0]
    idx = ysb.make_source(4 * BATCH).make_batch(3 * BATCH, BATCH).payload["ad_id"]
    n = idx.shape[0]
    want = L.lookup_plain(table, idx)
    out = torch.empty_like(want)
    part = probes.wf_k2_part
    part.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    entry = cuda.function("lookup", "wf_table_lookup", L._ARGTYPES)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def run_part(stage, lanes, blocks):
        cuda.check(part(cuda.ptr(table), K, cuda.ptr(idx), cuda.ptr(out), n, stage, lanes,
                        blocks, cuda.stream_ptr(dev)), "K2 part")
    row = {"split": "lookup", "case": "ysb", "C": n, "K": K, "card": card, "sms": sms}
    for design, blocks, lanes in (("parent", (n + 2047) // 2048, 1),
                                  ("redesign", 2 * sms, 2)):
        for stage in (0, 1):
            out.zero_()
            run_part(stage, lanes, blocks)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"split lookup: the {design} probe (stage={stage}) "
                                     f"differs from the plain version")
        row[design] = {
            "blocks": blocks,
            "staging_alone_ms": graph_ms(torch, lambda: run_part(1, 0, blocks)),
            "lanes_through_l2_ms": graph_ms(torch, lambda: run_part(0, lanes, blocks)),
            "staging_and_lanes_ms": graph_ms(torch, lambda: run_part(1, lanes, blocks))}
    row["c_entry_ms"] = graph_ms(torch, lambda: cuda.check(entry(
        cuda.ptr(table), cuda.ptr(idx), cuda.ptr(out), n, K, 4, 0, cuda.stream_ptr(dev)),
        "K2 C entry"))
    row["wrapper_ms"] = graph_ms(torch, lambda: L.lookup_cuda(table, idx))
    row["launch_floor_ms"] = launch_floor_ms(torch, probes)
    row["bytes_bound_ms"] = (n * 8 + K * 4) / HBM_BYTES_PER_S * 1e3
    log(row)
    return row


def kernel_phase(torch, ysb, probes):
    """K2 at the main paths' shapes (``k2_main_cases``) and in its regimes
    (``k2_regime_checks``), then the launch floor. Returns K2's YSB row."""
    from windflow_tpu_torch.ops import lookup as L

    rows = {}
    for case, tables, idx, timed in k2_main_cases(torch, ysb):
        row = k2_check(torch, L, case, tables, idx, timed=timed)
        if case == "ysb":
            rows["lookup"] = row
    k2_regime_checks(torch)
    log({"kernel_check": "launch_floor", "ms": launch_floor_ms(torch, probes),
         "counted": "an empty kernel of one thread, graph replay"})
    return rows


#: K1's and K3's regimes: each must run at least once in the kernel phase
K1_REGIMES = ("window", "global", "empty")
K3_REGIMES = ("direct", "global")
K3_FLUSHES = ("workspace_reduce", "atomic")


def partials_kernel_phase(torch, ysb):
    """K1 and K3 at their main-path shapes and in each regime of their
    designs, bit for bit against the plain versions. Every case logs the
    plan (``histogram_plan`` / ``segment_fold_plan``: grid, shared bytes,
    path, flush, zero fill) and the launch's counters (tiles on each path,
    empty tiles); the phase fails unless every regime ran.
    Main-path shapes are timed with the plain version and the library call
    (one ``index_add_`` into a fresh zeroed output, the index prep outside
    the timed call, dropped lanes adding 0 at a spread index); regime cases
    time the kernel alone; the ragged and tiny cases are not timed."""
    from windflow_tpu_torch.ops import histogram as H, segment as S

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261022)
    C = BATCH
    rows = {}
    seen = {"histogram": set(), "segment_fold": set()}
    b, window = ysb_traffic(torch, ysb, 3 * BATCH)
    K, P = window.num_keys, window.P
    ysb_pane = torch.div(b.ts, window.pane_len, rounding_mode="floor").contiguous()

    def ints(lo, hi, n=C):
        return torch.randint(lo, hi, (n,), device=dev, generator=gen, dtype=torch.int64
                             ).to(torch.int32)

    def mask(p, n=C):
        return torch.rand((n,), device=dev, generator=gen) < p

    def counters(run):
        st = torch.zeros(len(H.STATS), dtype=torch.int32, device=dev)
        run(st)
        torch.cuda.synchronize()
        return dict(zip(H.STATS, st.tolist()))

    def k1(case, key, pane_, valid, Kh, Ph, main=False, timed=True):
        n = key.shape[0]
        plan = H.histogram_plan(n, Kh, Ph)
        stats = counters(lambda st: H.histogram_cuda(key, pane_, valid, Kh, Ph, stats=st))
        for regime, hit in (("window", stats["direct_or_window_tiles"]),
                            ("global", stats["global_tiles"]),
                            ("empty", stats["empty_tiles"])):
            if hit:
                seen["histogram"].add(regime)
        ok = valid & (key >= 0) & (key < Kh)
        lane = torch.arange(n, device=dev, dtype=torch.int64)
        idx = torch.where(ok, key.long() * Ph + torch.remainder(pane_, Ph).long(),
                          lane % (Kh * Ph))
        ones = ok.to(torch.int32)
        return check_kernel(
            torch, "histogram", case,
            lambda: H.histogram_cuda(key, pane_, valid, Kh, Ph),
            lambda: H.histogram_plain(key, pane_, valid, Kh, Ph),
            lambda: torch.zeros(Kh * Ph, dtype=torch.int32, device=dev).index_add_(
                0, idx, ones),
            n * 9 + Kh * Ph * 4, {"C": n, "K": Kh, "P": Ph}, timed=main and timed,
            time_kernel=timed,
            extra={"plan": plan, "stats": stats})

    # K1 at YSB's shape (the window), and adversarial keys and panes
    rows["histogram"] = k1("ysb", b.key, ysb_pane, b.valid, K, P, main=True)
    adv = (ints(-10, K + 10), ints(-10 ** 6, 10 ** 6), mask(0.7))
    k1("adversarial", *adv, K, P, main=True)
    k1("one_cell", torch.full((C,), 7, dtype=torch.int32, device=dev),
       torch.full((C,), -12345, dtype=torch.int32, device=dev), mask(0.9), K, P)
    near = torch.where(mask(0.5), ints(2 ** 31 - 3000, 2 ** 31), ints(-2 ** 31, -2 ** 31 + 3000))
    k1("panes_near_int32_limits", ints(0, K), near, mask(0.8), K, P)
    k1("panes_near_int32_max_sorted", ints(0, K),
       (2 ** 31 - 1 - (C - 1 - torch.arange(C, device=dev)) // 1000).to(torch.int32),
       mask(0.8), K, P)
    k1("window_wider_than_ring", ints(0, K), (torch.arange(C, device=dev) // 1000
                                              ).to(torch.int32), mask(0.8), K, 4)
    k1("span_past_window", ints(0, K), (torch.arange(C, device=dev) // 20).to(torch.int32),
       mask(0.8), K, P)
    k1("empty_tiles", ints(0, K), ysb_pane, mask(0.5) & (torch.arange(C, device=dev)
                                                        % 65536 < 8192), K, P)
    k1("large_k_global", ints(-5, 40005), ints(0, 3000), mask(0.8), 40000, 32)
    k1("k_times_p_near_2^31", ints(0, 65535), near, mask(0.8), 65535, 32768, timed=False)
    torch.cuda.empty_cache()
    for n in (C - 3, 4097, 1):
        k1(f"ragged_{n}", b.key[:n], ysb_pane[:n], b.valid[:n], K, P, timed=False)
    k1("unaligned", b.key[1:], ysb_pane[1:], b.valid[1:], K, P, timed=False)
    missing = set(K1_REGIMES) - seen["histogram"]
    if missing:
        raise AssertionError(f"K1 regimes never exercised: {sorted(missing)}")

    def k3(case, values, seg, valid, Sn, main=False, timed=True):
        n = values.shape[0]
        plan = S.segment_fold_plan(n, Sn, values.dtype)
        stats = counters(lambda st: S.segment_fold_cuda(values, seg, valid, Sn, stats=st))
        for regime, hit in (("direct", stats["direct_or_window_tiles"]),
                            ("global", stats["global_tiles"])):
            if hit:
                seen["segment_fold"].add(regime)
        seen["segment_fold"].add(plan["flush"])
        ok = valid & (seg >= 0) & (seg < Sn)
        lane = torch.arange(n, device=dev, dtype=torch.int64)
        idx = torch.where(ok, seg.long(), lane % Sn)
        masked = torch.where(ok, values.to(torch.int32), 0)
        return check_kernel(
            torch, "segment_fold", case,
            lambda: S.segment_fold_cuda(values, seg, valid, Sn),
            lambda: S.segment_fold_plain(values, seg, valid, Sn),
            lambda: torch.zeros(Sn, dtype=torch.int32, device=dev).index_add_(0, idx, masked),
            n * (5 + values.element_size()) + Sn * 4,
            {"C": n, "S": Sn, "dtype": str(values.dtype)}, timed=main and timed,
            time_kernel=timed,
            extra={"plan": plan, "stats": stats})

    ysb_seg = torch.where(b.valid, b.key * P + torch.remainder(ysb_pane, P), K * P)
    rows["segment_fold"] = k3("ysb_sum", b.payload["ad_id"], ysb_seg, b.valid, K * P,
                              main=True)
    for Sn in (K * P, 4096, 1024):
        k3(f"full_int32_S{Sn}", ints(-2 ** 31, 2 ** 31), ints(-5, Sn + 5), mask(0.8), Sn,
           main=True)
    # Win_Seq._insert's per-key counts: int32 ones of the valid lanes, path A
    # over 512 keys (key = i % 512), path B over YSB's 100 campaigns; one lane
    # in 64 of each moved out of range
    def stray(keys, Sn):
        off = ints(1, 101)
        far = torch.where(mask(0.5), -off, Sn - 1 + off)
        return torch.where(mask(1 / 64), far, keys).contiguous()
    a_valid = mask(0.9)
    a_keys = stray((torch.arange(C, device=dev) % WIN_KEYS).to(torch.int32), WIN_KEYS)
    b_keys = stray(b.key, K)
    k3(f"path_a_counts_S{WIN_KEYS}", a_valid.to(torch.int32), a_keys, a_valid, WIN_KEYS,
       main=True)
    k3(f"path_b_counts_S{K}", b.valid.to(torch.int32), b_keys, b.valid, K, main=True)
    # Key_FFAT's per-key insert on bench_keyed_cb's traffic: the occupancy
    # counts of (key, pane slot) at S = 512 * 4096 = 2^21, about 2560 hot
    # segments of 512 lanes a batch (K3's global path)
    _, kc_seg, kc_valid = keyed_cb_traffic(torch, 3)
    k3(f"keyed_cb_counts_S{KEYED_CB_S}", kc_valid.to(torch.int32), kc_seg, kc_valid,
       KEYED_CB_S, main=True)
    k3("S1", ints(-2 ** 31, 2 ** 31), ints(-1, 2), mask(0.8), 1)
    k3("one_segment_wrapping", ints(2 ** 31 - 100, 2 ** 31), torch.full(
        (C,), 77, dtype=torch.int32, device=dev), mask(0.9), 100)
    k3("S_past_direct_limit", ints(-2 ** 31, 2 ** 31), ints(0, 16385), mask(0.8), 16385)
    k3("random_segments_S2^24", ints(-2 ** 31, 2 ** 31), ints(0, 1 << 24), mask(0.95),
       1 << 24)
    # the global path's worst case: every lane on one segment of many
    k3(f"one_segment_S{K * P}", ints(-2 ** 31, 2 ** 31), torch.full(
        (C,), 4321, dtype=torch.int32, device=dev), mask(0.9), K * P)
    for dt, lo, hi in ((torch.int8, -128, 128), (torch.int16, -2 ** 15, 2 ** 15),
                       (torch.uint8, 0, 256)):
        for Sn in (K, K * P):
            k3(f"{str(dt)[6:]}_S{Sn}", ints(lo, hi).to(dt), ints(-5, Sn + 5), mask(0.8), Sn)
    for n in (C - 3, 4097, 1):
        k3(f"ragged_{n}_S{K}", b.valid[:n].to(torch.int32), b_keys[:n], b.valid[:n], K,
           timed=False)
        k3(f"ragged_{n}_S{K * P}", b.payload["ad_id"][:n], ysb_seg[:n], b.valid[:n], K * P,
           timed=False)
    k3("unaligned_int8", ints(-128, 128).to(torch.int8)[1:], b_keys[1:], b.valid[1:], K,
       timed=False)
    missing = set(K3_REGIMES + K3_FLUSHES) - seen["segment_fold"]
    if missing:
        raise AssertionError(f"K3 regimes never exercised: {sorted(missing)}")
    log({"phase": "partials_regimes", "seen": {k: sorted(v) for k, v in seen.items()}})
    return rows


def start_probe_build(cuda):
    """Start nvcc on the split's probe source (``PROBES_SRC``, no kernel of
    the port) beside the kernels' builds. Returns what
    :func:`finish_probe_build` takes."""
    import hashlib
    src = os.path.join(ROOT, PROBES_SRC)
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(cuda.NVCC_FLAGS).encode()).hexdigest()[:12]
    out = cuda.BUILD_DIR.parent / "probes" / f"libsplit_probes-{tag}.so"
    if out.exists():
        return None, out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(tmp), src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def finish_probe_build(job):
    import ctypes
    started, out = job
    if started is not None:
        proc, tmp = started
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe build failed (nvcc rc {proc.returncode}):\n{text}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def split_phase(torch, ysb, probes):
    """Where K1's and K3's time goes, by graph replay at 2^20 lanes: K1 at
    YSB's shape and on panes past the window and K = 40,000 keys, K3 at
    path B's counts (S = 100), YSB-sum and random ids (S = 409,600). Each
    row times a zero fill of the output alone (``torch.zeros``), the read
    floor (a probe that only reads the same 9 bytes a lane), the global fold
    (a probe that zeroes the output with a memset and adds every counted
    lane with one global atomic, on the kernels' tiles and loads: what the
    kernel would cost if every tile went global; its output is checked
    against the kernel's), the kernel's C entry point into a preallocated
    output and workspace (``c_entry_ms``: the memset and the kernel where
    the kernel flushes with atomics, the kernel alone where it writes every
    cell or where the wrapper zero-fills), and the whole wrapper.

    It also splits an older tree whose kernels have no plan queries (no
    ``histogram_plan``): their C entry points take no counters and no
    workspace, and their wrappers zero-fill the output."""
    import ctypes
    from windflow_tpu_torch.ops import cuda, histogram as H, segment as S

    dev = torch.device("cuda")
    C = BATCH
    planned = hasattr(H, "histogram_plan")
    gen = torch.Generator(device=dev).manual_seed(20261021)

    def ints(lo, hi):
        return torch.randint(lo, hi, (C,), device=dev, generator=gen, dtype=torch.int64
                             ).to(torch.int32)

    def mask(p):
        return torch.rand((C,), device=dev, generator=gen) < p

    b, window = ysb_traffic(torch, ysb, 3 * BATCH)
    K, P = window.num_keys, window.P
    pane = torch.div(b.ts, window.pane_len, rounding_mode="floor").contiguous()
    b_keys = torch.where(mask(1 / 64), K + 7, b.key).to(torch.int32).contiguous()
    ysb_seg = torch.where(b.valid, b.key * P + torch.remainder(pane, P), K * P
                          ).to(torch.int32).contiguous()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_fn = probes.wf_read_floor
    floor_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    global_fn = probes.wf_global_fold
    global_fn.argtypes = ([ctypes.c_void_p] * 4
                          + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    hist_fn = cuda.function("histogram", "wf_keyed_pane_histogram", H._ARGTYPES)
    fold_fn = cuda.function("segment", "wf_segment_fold", S._ARGTYPES)

    def hist_case(name, key, pn, valid, Kh, Ph):
        ok = valid & (key >= 0) & (key < Kh)
        ids = torch.where(ok, key * Ph + torch.remainder(pn, Ph), -1).to(torch.int32)
        out = torch.zeros((Kh, Ph), dtype=torch.int32, device=dev)
        probe_out = torch.zeros(Kh * Ph, dtype=torch.int32, device=dev)
        extra = (None,) if planned else ()

        def c_entry():
            cuda.check(hist_fn(cuda.ptr(key), cuda.ptr(pn), cuda.ptr(valid), cuda.ptr(out),
                               *extra, C, Kh, Ph, cuda.stream_ptr(dev)), "K1 C entry")
        return ("histogram", name, {"K": Kh, "P": Ph}, key, pn, valid, ids, None,
                Kh * Ph, c_entry, lambda: H.histogram_cuda(key, pn, valid, Kh, Ph),
                probe_out, H.histogram_plan(C, Kh, Ph) if planned else None)

    def fold_case(name, values, seg, valid, Sn):
        if values.dtype != torch.int32:
            raise ValueError(f"split {name}: int32 values only")
        out = torch.zeros((Sn,), dtype=torch.int32, device=dev)
        probe_out = torch.zeros(Sn, dtype=torch.int32, device=dev)
        plan = S.segment_fold_plan(C, Sn) if planned else None
        ws = torch.empty((max(1, plan["ws_ints"]),), dtype=torch.int32, device=dev) \
            if planned else None
        extra = (cuda.ptr(ws), None) if planned else ()

        def c_entry():
            cuda.check(fold_fn(cuda.ptr(values), 0, cuda.ptr(seg), cuda.ptr(valid),
                               cuda.ptr(out), *extra, C, Sn, cuda.stream_ptr(dev)),
                       "K3 C entry")
        return ("segment_fold", name, {"S": Sn}, values, seg, valid, seg, values, Sn,
                c_entry, lambda: S.segment_fold_cuda(values, seg, valid, Sn), probe_out, plan)

    cases = [
        hist_case("ysb", b.key, pane, b.valid, K, P),
        hist_case("span_past_window", ints(0, K), (torch.arange(C, device=dev) // 20
                                                   ).to(torch.int32), mask(0.8), K, P),
        hist_case("large_k", ints(-5, 40005), ints(0, 3000), mask(0.8), 40000, 32),
        fold_case(f"path_b_counts_S{K}", b.valid.to(torch.int32), b_keys, b.valid, K),
        fold_case("ysb_sum", b.payload["ad_id"].contiguous(), ysb_seg, b.valid, K * P),
        fold_case(f"random_S{K * P}", ints(-2 ** 31, 2 ** 31), ints(-5, K * P + 5),
                  mask(0.8), K * P)]
    rows = []
    for (kern, name, shape, a1, a2, valid, ids, vals, cells, c_entry, wrapper, probe_out,
         plan) in cases:
        def probe():
            cuda.check(global_fn(None if vals is None else cuda.ptr(vals), cuda.ptr(ids),
                                 cuda.ptr(valid), cuda.ptr(probe_out), C, cells,
                                 cuda.stream_ptr(dev)), "global fold probe")
        probe()
        want = wrapper().reshape(-1)
        torch.cuda.synchronize()
        if not torch.equal(probe_out, want):
            raise AssertionError(f"split {kern} [{name}]: global fold probe differs")
        row = {"split": kern, "case": name, "C": C, **shape, "plan": plan,
               "planned_tree": planned,
               "zero_fill_ms": graph_ms(torch, lambda: torch.zeros(
                   cells, dtype=torch.int32, device=dev)),
               "read_floor_ms": graph_ms(torch, lambda: cuda.check(floor_fn(
                   cuda.ptr(a1), cuda.ptr(a2), cuda.ptr(valid), cuda.ptr(sink), C,
                   cuda.stream_ptr(dev)), "read floor")),
               "global_fold_ms": graph_ms(torch, probe),
               "c_entry_ms": graph_ms(torch, c_entry),
               "wrapper_ms": graph_ms(torch, wrapper),
               "bytes_bound_ms": (C * 9 + cells * 4) / HBM_BYTES_PER_S * 1e3}
        log(row)
        rows.append(row)
    return rows


KEYED_CB_P = 4096                   # bench_keyed_cb's pane ring at batch 2^20
KEYED_CB_S = WIN_KEYS * KEYED_CB_P  # its (key, pane slot) segments: 2^21
STATEFUL_KEYS = (1, 500, 10000)     # bench_keyed_stateful's sweep


def keyed_cb_traffic(torch, b):
    """Values, segment ids and valid lanes of Key_FFAT's per-key insert on
    batch ``b`` of ``bench_keyed_cb``'s stream (``v = i % 97``, key
    ``i % 512``): lane j of the batch is its key's arrival ``2048 b + j //
    512``, in pane ``(2048 b + j // 512) // 512`` at slot ``pane mod 4096``."""
    dev = torch.device("cuda")
    j = torch.arange(BATCH, device=dev, dtype=torch.int32)
    i = b * BATCH + j
    pane = (b * (BATCH // WIN_KEYS) + j // WIN_KEYS) // WIN_SLIDE
    seg = (i % WIN_KEYS) * KEYED_CB_P + torch.remainder(pane, KEYED_CB_P)
    return (i % 97).float(), seg.to(torch.int32), torch.ones(BATCH, dtype=torch.bool,
                                                              device=dev)


def dev_ms(torch, fn):
    """``graph_ms`` of ``fn``, over fewer calls when one call takes more than
    2.5 ms (each timing window near 50 ms)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    if t < 2.5e-3:
        return graph_ms(torch, fn)
    return graph_ms(torch, fn, iters=max(2, min(20, int(0.05 / t))), reps=1)


def _row_width(t):
    n = 1
    for d in t.shape[1:]:
        n *= int(d)
    return n


def fold_same(torch, got, want):
    """(the card's fold has the CPU's bits, NaN payloads aside; the max abs
    error). NaN cells must be NaN in both: the CPU's payload depends on its
    own code path (a 1-D ``index_add_`` keeps the later NaN operand's for
    float32, the earlier one's for float16, and bfloat16 writes 0x7fc0),
    the card's adds give the canonical NaN."""
    got = got.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return False, float("inf")
    gn, wn = torch.isnan(got), torch.isnan(want)
    z = torch.zeros((), dtype=got.dtype)
    same = torch.equal(gn, wn) and torch.equal(_bits(torch, torch.where(gn, z, got)),
                                               _bits(torch, torch.where(wn, z, want)))
    return bool(same), compare(torch, got, want)[1]


def fold_row(torch, case, vals, seg, valid, Sn, extra=None):
    """The float fold on one input: two card runs' bits against each other
    and against the CPU's (``fold_same``), then the device times of the
    fold, of the plain version (``index_add_`` behind the masks: float
    atomics, no fixed order) and of one ``index_add_`` with the masks made
    beforehand, and the byte bound (values, ids and flags read once,
    ``[S, D]`` written once)."""
    from windflow_tpu_torch.ops import segment as S
    dev, C, D = vals.device, vals.shape[0], _row_width(vals)
    got = S.segment_fold_float_cuda(vals, seg, valid, Sn)
    again = S.segment_fold_float_cuda(vals, seg, valid, Sn)
    cpu = S._index_add_fold(vals.cpu(), seg.cpu(), valid.cpu(), Sn)
    torch.cuda.synchronize()
    same, err = fold_same(torch, got, cpu)
    repeats = torch.equal(_bits(torch, got), _bits(torch, again))
    tail = tuple(vals.shape[1:])
    ok = valid & (seg >= 0) & (seg < Sn)
    safe = torch.where(ok, seg, Sn).long()
    masked = torch.where(ok.reshape(ok.shape + (1,) * len(tail)), vals, 0.0)

    def plain():
        okp = valid & (seg >= 0) & (seg < Sn)
        return torch.zeros((Sn + 1,) + tail, dtype=vals.dtype, device=dev).index_add_(
            0, torch.where(okp, seg, Sn).long(),
            torch.where(okp.reshape(okp.shape + (1,) * len(tail)), vals, 0.0))[:Sn]
    nbytes = C * (D * vals.element_size() + 5) + Sn * D * vals.element_size()
    row = {"kernel_check": "segment_fold_float", "case": case,
           "shape": {"C": C, "S": Sn, "D": D, "dtype": str(vals.dtype).split(".")[-1]},
           **(extra or {}), "bit_identical_card_cpu": same, "repeats": repeats,
           "max_abs_err": err,
           "ms": dev_ms(torch, lambda: S.segment_fold_float_cuda(vals, seg, valid, Sn)),
           "plain_ms": dev_ms(torch, plain),
           "library_ms": dev_ms(torch, lambda: torch.zeros(
               (Sn + 1,) + tail, dtype=vals.dtype, device=dev).index_add_(0, safe, masked)),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(row)
    if not (same and repeats):
        raise AssertionError(f"the float fold [{case}] differs from the CPU's bits "
                             f"(card vs CPU {same}, run to run {repeats})")
    return row


def fold_split(torch, case, vals, seg, valid, Sn):
    """Where the fold's time goes at one shape (graph replay of each part
    alone): the mask and key, the stable sort, the row gather, the segment
    starts' search (the segments regime: S <= C or D > 1) and the C entry
    point (memsets, the segments' or the run walkers' kernel, streaming
    blocks); with the live runs, those streamed (``FOLD_RUN_LONG`` lanes or
    more at D = 1) and the longest."""
    from windflow_tpu_torch.ops import cuda, segment as S
    dev, C, D = vals.device, vals.shape[0], _row_width(vals)
    key = torch.where(valid & (seg >= 0) & (seg < Sn), seg, Sn)
    sorted_seg, perm = torch.sort(key, stable=True)
    rows = torch.empty((C + S._ROW_PAD, D), dtype=vals.dtype, device=dev)
    torch.index_select(vals.reshape(C, D), 0, perm, out=rows[:C])
    segments = D > 1 or Sn <= C

    def search():
        return torch.searchsorted(sorted_seg, torch.arange(Sn + 1, dtype=torch.int32,
                                                           device=dev))
    starts = search() if segments else None
    out = torch.empty((Sn, D), dtype=vals.dtype, device=dev)
    work = torch.empty((1 + 3 * (C // S.FOLD_RUN_LONG + 1),), dtype=torch.int64, device=dev)
    fn = cuda.function("segment", "wf_segment_fold_ordered", S._ORDERED_ARGTYPES)
    code = S._ORDERED_DTYPES[vals.dtype]

    def entry():
        cuda.check(fn(cuda.ptr(rows), cuda.ptr(sorted_seg),
                      cuda.ptr(starts) if segments else None, cuda.ptr(out), cuda.ptr(work), C,
                      Sn, D, code, cuda.stream_ptr(dev)), "wf_segment_fold_ordered")
    runs = torch.unique_consecutive(sorted_seg[sorted_seg < Sn], return_counts=True)[1]
    row = {"kernel_check": "segment_fold_float", "case": f"split_{case}",
           "regime": "segments" if segments else "runs",
           "mask_and_key_ms": dev_ms(torch, lambda: torch.where(
               valid & (seg >= 0) & (seg < Sn), seg, Sn)),
           "sort_ms": dev_ms(torch, lambda: torch.sort(key, stable=True)),
           "gather_ms": dev_ms(torch, lambda: torch.index_select(
               vals.reshape(C, D), 0, perm, out=rows[:C])),
           "search_ms": dev_ms(torch, search) if segments else 0.0,
           "entry_ms": dev_ms(torch, entry),
           "live_runs": int(runs.numel()),
           "streamed_runs": int((runs >= S.FOLD_RUN_LONG).sum()) if D == 1 else 0,
           "longest_run": int(runs.max()) if runs.numel() else 0}
    log(row)
    return row


#: lanes of the runs in the fold's regime cases: one lane, a warp's width and
#: one either side, the shortest run a block streams (256) and one below,
#: and either side of 1024
FOLD_RUNS = (1, 31, 32, 33, 255, 256, 1023, 1025)
FOLD_DS = (1, 3, 64)
FOLD_DTYPES = ("float32", "float64", "float16", "bfloat16")


def fold_regime_input(torch, D, dtype, seed):
    """Runs of every length of ``FOLD_RUNS`` on the even segment ids (the odd
    ones stay empty), repeated to about 2^19 values, their lanes shuffled
    into one stream with a twentieth more lanes out of range and a tenth of
    all lanes invalid; values normal * 100, where the run of one lane and
    the run of 31 are -0.0 only, the run of 32 holds +inf, the run of 33
    +inf and -inf (a NaN sum) and the first run of 255 a NaN."""
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    reps = max(1, min(256, (1 << 19) // (sum(FOLD_RUNS) * D)))
    counts = torch.tensor(FOLD_RUNS * reps, device=dev)
    Sn = 2 * counts.numel() + 1
    seg = torch.repeat_interleave(2 * torch.arange(counts.numel(), device=dev), counts)
    spill = seg.numel() // 40 + 1
    seg = torch.cat([seg, torch.randint(-40, 0, (spill,), generator=gen, device=dev),
                     torch.randint(Sn, Sn + 40, (spill,), generator=gen, device=dev)])
    seg = seg[torch.randperm(seg.numel(), generator=gen, device=dev)].to(torch.int32)
    C = seg.numel()
    valid = torch.rand(C, generator=gen, device=dev) >= 0.1
    valid |= (seg == 0) | (seg == 4) | (seg == 6) | (seg == 8)   # the specials count
    shape = (C,) if D == 1 else (C, D)
    vals = (torch.randn(shape, generator=gen, device=dev, dtype=torch.float64) * 100).to(dt)
    vals[(seg == 0) | (seg == 2)] = -0.0
    at = [torch.nonzero(seg == s).flatten() for s in (4, 6, 8)]
    vals[at[0][3]] = float("inf")
    vals[at[1][5]] = float("inf")
    vals[at[1][20]] = float("-inf")
    vals[at[2][100]] = float("nan")
    return vals.contiguous(), seg.contiguous(), valid, Sn


def fold_cases(torch):
    """Every input the fold is checked and timed on, one at a time: (case,
    values, seg, valid, S, extra). "determinism": random ids in 4096
    segments with dropped lanes; Key_FFAT's pane sums at S = 2^21 on
    ``bench_keyed_cb``'s traffic; the Accumulator's batch totals of
    ``bench_keyed_stateful`` (``v = i % 1000``) at S = 8 (K = 1: every lane
    on one segment, one run of 2^20 lanes), 500 and 10,000; every run length
    of ``FOLD_RUNS`` with -0.0, inf and NaN (``fold_regime_input``) at D =
    1, 3 and 64 in each of the four dtypes; one run of 2^20 lanes at S = 8
    in float64, float16 and bfloat16 (float32's is K = 1)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261019)
    Sn = 4096
    yield ("determinism", torch.randn((BATCH,), device=dev, generator=gen) * 1000,
           torch.randint(-5, Sn + 5, (BATCH,), device=dev, generator=gen, dtype=torch.int32),
           torch.rand((BATCH,), device=dev, generator=gen) < 0.9, Sn, None)
    yield (f"keyed_cb_S{KEYED_CB_S}", *keyed_cb_traffic(torch, 3), KEYED_CB_S, None)
    i = torch.arange(BATCH, device=dev, dtype=torch.int32) + 3 * BATCH
    ones = torch.ones(BATCH, dtype=torch.bool, device=dev)
    for K in STATEFUL_KEYS:
        Sn = max(K, 8)
        yield (f"keyed_stateful_K{K}_S{Sn}", (i % 1000).float(), (i % K).to(torch.int32),
               ones, Sn, None)
    for d_i, D in enumerate(FOLD_DS):
        for t_i, dtype in enumerate(FOLD_DTYPES):
            yield (f"runs_D{D}_{dtype}", *fold_regime_input(torch, D, dtype, 100 + 10 * d_i + t_i),
                   {"runs": FOLD_RUNS})
    gen = torch.Generator(device=dev).manual_seed(99)
    zero = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    for dtype in FOLD_DTYPES[1:]:
        scale = 1.0 if dtype == "float16" else 100.0          # float16's sum stays finite
        vals = (torch.randn(BATCH, generator=gen, device=dev, dtype=torch.float64)
                * scale).to(getattr(torch, dtype))
        yield f"hot_run_{dtype}", vals, zero, ones, 8, None


def fold_checks(torch):
    """The fixed-order float fold on every ``fold_cases`` input, bit for bit
    against the CPU and run to run, with its time, the plain version's and
    one ``index_add_``'s (``fold_row``); the split of the time
    (``fold_split``) at the keyed paths' shapes, the random 4096 segments
    and the D = 3 and 64 runs in float32; K2 on the Accumulator's float carry tables (8 and 500 rows);
    then a graph captured over the float32 D = 3 case, replayed, its input
    doubled in place, replayed again: the CPU's bits each time. Returns the
    S = 2^21 row."""
    from windflow_tpu_torch.ops import lookup as L, segment as S

    dev = torch.device("cuda")
    keyed_cb_row = None
    for case, vals, seg, valid, Sn, extra in fold_cases(torch):
        row = fold_row(torch, case, vals, seg, valid, Sn, extra)
        if case.startswith("keyed") or case in ("determinism", "runs_D3_float32",
                                                 "runs_D64_float32"):
            fold_split(torch, case, vals, seg, valid, Sn)
        if case.startswith("keyed_cb"):
            keyed_cb_row = row
        if case.startswith("keyed_stateful") and Sn <= 2048:
            table = torch.arange(Sn, device=dev, dtype=torch.float32) * 1.5e6
            check_kernel(torch, "lookup", f"keyed_stateful_carry_K{Sn}",
                         lambda: L.lookup_cuda(table, seg), lambda: L.lookup_plain(table, seg),
                         lambda: table.index_select(0, seg),
                         BATCH * 8 + Sn * 4, {"C": BATCH, "K": Sn, "dtype": "float32"})
    vals, seg, valid, Sn = fold_regime_input(torch, 3, "float32", 7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        S.segment_fold_float_cuda(vals, seg, valid, Sn)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with collection_paused(), torch.cuda.graph(g):
        gout = S.segment_fold_float_cuda(vals, seg, valid, Sn)
    same = []
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        same.append(fold_same(torch, gout, S._index_add_fold(vals.cpu(), seg.cpu(),
                                                             valid.cpu(), Sn))[0])
        vals.mul_(2)                      # exact: the next replay must see the new input
    log({"kernel_check": "segment_fold_float",
         "case": "graph replayed twice, the input doubled between", "bit_identical": same})
    if not all(same):
        raise AssertionError("the float fold's graph replays differ from the CPU's bits")
    return keyed_cb_row


def nexmark_kernel_phase(torch):
    """K5 at the q3/q7 bench shape, at q3's full width, above the TPU envelope
    and in each of its regimes (shared-memory and device-memory table,
    colliding and repeated keys, ragged C); K4 at TopN's bench shape and in
    each of its regimes (one CTA, one cluster, beyond a cluster), each sort
    and merge also against a stable lexsort."""
    from windflow_tpu_torch.ops import bitonic as B, lookup as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261019)
    rows = {}

    def k5(case, C, K, vals_dtype, keys=None, timed=True, live=None):
        """``live``: the table's keys the hits are drawn from (all by default)."""
        if keys is None:
            keys = (torch.randperm(8 * K, device=dev, generator=gen)[:K]
                    - 4 * K).to(torch.int32)
            if K > 4:
                keys[-2:] = L.JOIN_KEY_SENTINEL    # unused slots: repeated sentinel
        pick = keys if live is None else live
        hits = pick[torch.randint(0, len(pick), (C,), device=dev, generator=gen)]
        miss = torch.randint(-6 * K, 6 * K, (C,), device=dev, generator=gen,
                             dtype=torch.int32)
        probe = torch.where(torch.rand((C,), device=dev, generator=gen) < 0.7, hits, miss)
        probe[:3] = L.JOIN_KEY_SENTINEL
        valid = torch.rand((C,), device=dev, generator=gen) < 0.9
        if vals_dtype == torch.float32:
            vals = torch.randn((K,), device=dev, generator=gen)
            vals[::4] = -0.0
            vals[1::9] = float("nan")
        else:
            vals = torch.randint(-2 ** 31, 2 ** 31, (K,), device=dev, generator=gen,
                                 dtype=torch.int64).to(torch.int32)
        n_valid = int(valid.sum())
        slots = 1 << max(1, (2 * K - 1).bit_length())
        return check_kernel(
            torch, "join_probe", case,
            lambda: L.join_probe_cuda(keys, vals, probe, valid),
            lambda: L.join_probe_plain(keys, vals, probe, valid),
            None, C * 10 + K * 8, {"C": C, "K": K, "dtype": str(vals_dtype)},
            ops=n_valid, timed=timed,
            counted="bytes: each lane's probe, valid, value and hit once (10 B) and "
                    "each table row's key and value once (8 B); ops: one key "
                    "compare per valid lane (the function's need, not the C*K "
                    "compares of a scan)",
            extra={"table_slots": slots,
                   "table": "shared" if slots <= L.JOIN_PROBE_SMEM_SLOTS else "device"})
    rows["join_probe"] = k5("q3_full_width", 1 << 20, Q3_AUCTIONS, torch.int32)
    k5("q3_q7_bench", NEX_BATCH, 16, torch.int32)
    k5("above_tpu_envelope", 1 << 20, 5000, torch.int32)
    k5("float_nan_negative_zero", 1 << 20, Q3_AUCTIONS, torch.float32)
    k5("float_bench", NEX_BATCH, 16, torch.float32)
    k5("largest_shared_table", 1 << 20, 8192, torch.int32, timed=False)
    pow16 = (torch.randperm(1 << 16, device=dev, generator=gen)[:Q3_AUCTIONS]
             - (1 << 15)).to(torch.int32) * (1 << 16)
    k5("keys_multiples_of_2^16", 1 << 20, Q3_AUCTIONS, torch.int32, keys=pow16,
       timed=False)
    k5("one_key_all_rows", 1 << 20, Q3_AUCTIONS, torch.int32, timed=False,
       keys=torch.full((Q3_AUCTIONS,), 7, dtype=torch.int32, device=dev))
    k5("one_row", 1 << 20, 1, torch.float32, timed=False)
    k5("one_lane", 1, Q3_AUCTIONS, torch.int32, timed=False)
    k5("ragged_lanes", (1 << 20) - 3, Q3_AUCTIONS, torch.int32, timed=False)
    k5("device_memory_table", 1 << 18, 1 << 15, torch.int32, timed=False)
    # tiered q3 at 2^14 (tiered_q3): K5 over the live hot table of 65,536
    # slots, the hot target's 16,384 keys of 1,638,400 and the sentinel in
    # every other slot, for the resolve pass's hot-slot search (49,152 lanes:
    # the batch and the pending ring) and the upsert's, the probe's and the
    # touch's 16,384 lanes
    hot = torch.full((4 * NEX_BATCH,), L.JOIN_KEY_SENTINEL, dtype=torch.int32, device=dev)
    live = torch.randperm(100 * NEX_BATCH, device=dev, generator=gen)[:NEX_BATCH]
    hot[torch.randperm(4 * NEX_BATCH, device=dev, generator=gen)[:NEX_BATCH]] = \
        live.to(torch.int32)
    for case, C in (("tiered_q3_hot_slot", 3 * NEX_BATCH), ("tiered_q3_probe", NEX_BATCH)):
        k5(case, C, 4 * NEX_BATCH, torch.int32, keys=hot, live=live.to(torch.int32),
           timed=False)

    def lexsort(p, s, c, i):
        perm = torch.argsort(i, dim=-1, stable=True)
        for k in (c, s, p):
            perm = torch.gather(perm, -1, torch.argsort(torch.gather(k, -1, perm),
                                                        dim=-1, stable=True))
        return tuple(torch.gather(x, -1, perm) for x in (p, s, c, i))

    def k4(case, R, n, sort, ties=None, timed=True):
        """``ties``: None (random prim, sec), "ties" (prim, sec in [-4, 4)) or
        "repeated" (every whole tuple, idx too, drawn from four)."""
        hi = 4 if ties else 2 ** 31
        p = torch.randint(-hi, hi, (R, n), device=dev, generator=gen, dtype=torch.int64)
        s = torch.randint(-hi, hi, (R, n), device=dev, generator=gen, dtype=torch.int64)
        p, s = p.to(torch.int32), s.to(torch.int32)
        c = torch.zeros((R, n), dtype=torch.int32, device=dev)
        i = torch.arange(n, dtype=torch.int32, device=dev).expand(R, n).contiguous()
        if ties == "repeated":
            pool = torch.tensor([[-2 ** 31, 2 ** 31 - 1, 0, 3], [0, 0, 0, 0],
                                 [5, -1, 1, 2], [2 ** 31 - 1, -2 ** 31, 1, -2 ** 31]],
                                dtype=torch.int32, device=dev)
            pick = pool[torch.randint(0, 4, (R, n), device=dev, generator=gen)]
            p, s, c, i = (pick[..., j].contiguous() for j in range(4))
        if not sort:                              # bitonic input: up, then down
            p, s, c, i = lexsort(p, s, c, i)
            h = n // 2
            p, s, c, i = (torch.cat([x[:, :h], x[:, h:].flip(1)], 1).contiguous()
                          for x in (p, s, c, i))
        packed = (p.to(torch.int64) << 32) | (s.to(torch.int64) & 0xffffffff)
        m = n.bit_length() - 1
        stages = m * (m + 1) // 2 if sort else m
        plan = B.network_plan(n, sort=sort)
        row = check_kernel(
            torch, "ordering_merge", case,
            lambda: B.network_cuda(p, s, c, i, sort=sort),
            lambda: B.network_plain(p, s, c, i, sort=sort),
            lambda: torch.sort(packed, dim=-1, stable=True),
            R * n * 32, {"R": R, "n": n, "network": "sort" if sort else "merge",
                         "ties": ties},
            ops=R * (n // 2) * stages * 8, timed=timed,
            counted="bytes: each lane's four int32 read and written once; ops: 8 "
                    "int32 operations per compare-exchange of the network",
            extra={"cuda_launches_per_call": plan["launches"],
                   "cluster_ctas": plan["cluster"],
                   "clusters_at_once": plan["active_clusters"],
                   "regime": ("one CTA" if n <= 4096 else "one cluster"
                              if plan["launches"] == 1 else "beyond one cluster")})
        got = B.network_cuda(p, s, c, i, sort=sort)
        want = lexsort(p, s, c, i)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"ordering_merge [{case}]: differs from a stable lexsort")
        if n <= 1 << 15 and plan["launches"] != 1:
            raise AssertionError(f"ordering_merge [{case}]: {plan['launches']} CUDA "
                                 "launches a call where a row fits in one cluster")
        return row
    rows["ordering_merge"] = k4("topn_bench", 16, 1 << 15, True)
    k4("topn_bench_ties", 16, 1 << 15, True, ties="ties")
    k4("smallest", 1, 2, True)
    k4("beyond_tpu_envelope", 4, 1 << 16, True)
    k4("merge_one_row", 1, 1 << 15, False)
    k4("merge_rows", 8, 4096, False)
    for n in (2, 64, 4096):                   # one CTA (several rows a CTA)
        for R in (1, 3):
            k4(f"one_cta_R{R}_n{n}", R, n, True, timed=False)
    # the Ordering_Node's shapes (pipegraph phases): merges of one row of
    # pow2(pool + batch) lanes, sorts of one incoming batch
    rows["ordering_merge_8192"] = k4("ordering_merge_8192", 1, 8192, False)
    rows["ordering_merge_2^17"] = k4("ordering_merge_2^17", 1, 1 << 17, False)
    rows["ordering_sort_4096"] = k4("ordering_sort_4096", 1, 4096, True)
    rows["ordering_sort_2^16"] = k4("ordering_sort_2^16", 1, 1 << 16, True)
    k4("cluster_one_row", 1, 1 << 15, True, timed=False)
    k4("cluster_waves_R200", 200, 1 << 15, True, timed=False)
    k4("beyond_cluster", 2, 1 << 17, True, timed=False)
    k4("beyond_cluster_merge", 2, 1 << 17, False, timed=False)
    k4("repeated_tuples", 16, 1 << 15, True, ties="repeated", timed=False)
    k4("repeated_tuples_one_cta", 3, 4096, True, ties="repeated", timed=False)
    k4("merge_repeated_rows", 16, 1 << 15, False, ties="repeated", timed=False)
    # TopN's directory rows in the tiered phases (tiered_queries)
    for hot in (TIERED_QUERIES["q6_topn"], TIERED_ROTATING["q6_topn"]):
        k4(f"topn_tiered_hot_{hot}", hot, 1 << 15, True, timed=False)
    return rows


NEX_ROWS = {
    "q1_currency": ("id", "auction", "euro"),
    "q2_selection": ("id", "auction", "price"),
    "q3_enrich_join": ("id", "auction", "category", "price"),
    "q4_interval_join": ("auction", "open_ts", "bid_ts", "price"),
    "q5_session": ("key", "id", "start", "end", "n", "bids", "spend"),
    "q7_distinct": ("id", "auction"),
}

#: q5's launches a SessionWindow apply: K2 reads its [8]-row tables in 4
#: launches, one an index (the key's floor by the batch's keys; the open
#: flag and last end by the sorted keys; six carried fields, the session
#: ordinal and the fragment bounds by the fragments' keys; the close counts
#: n1), and K3 folds five int32 segment sums (the fragments' counts, bids
#: and spend at S = 2^14; the two close counts at S = 8); the flush
#: launches nothing
Q5_APPLY = {"lookup": 4, "segment_fold": 5}

#: exact launches per query in the Pipeline phase: K5 twice per StreamTableJoin
#: or Distinct apply (the upsert's slot probe and the probe), K4 once per TopN
#: apply, Q5_APPLY per SessionWindow apply; IntervalJoin (q4) is plain
#: PyTorch and launches no kernel
NEX_LAUNCHES = {"q1_currency": {}, "q2_selection": {},
                "q3_enrich_join": {"join_probe": 2 * NEX_BATCHES},
                "q4_interval_join": {},
                "q5_session": {k: n * NEX_BATCHES for k, n in Q5_APPLY.items()},
                "q6_topn": {"ordering_merge": NEX_BATCHES},
                "q7_distinct": {"join_probe": 2 * NEX_BATCHES}}


def nexmark_rows(np, name, views):
    if name == "q6_topn":
        final = {}
        for v in views:
            for k, r, i, sc in zip(v["key"].tolist(), v["payload"]["rank"].tolist(),
                                   v["id"].tolist(), v["payload"]["score"].tolist()):
                final[(k, r)] = (i, sc)
        return sorted((k, r, i, sc) for (k, r), (i, sc) in final.items())

    def col(v, c):
        if c in ("key", "id"):
            return v[c]
        return v["payload"]["agg"][c] if c in ("bids", "spend") else v["payload"][c]
    out = []
    for v in views:
        out.extend(zip(*(np.asarray(col(v, c)).tolist() for c in NEX_ROWS[name])))
    return sorted(out)


def nexmark_pipeline_phase(torch, np, wt, registry):
    """The five queries through Pipeline.run, dispatch off and at K = 5 (16
    batches: three replays and a tail of one, which is ``push``): every
    sink row against the dense oracle, exact K4 and K5 launches, and the
    two runs' rows byte for byte. Returns the launches and q3's
    dispatch-off sink views (``supervised_q3`` holds its rows to them)."""
    from windflow_tpu_torch.nexmark import PORTED, make_query, oracles

    total = NEX_BATCHES * NEX_BATCH
    k_on = DISPATCH_K["nexmark"]
    launches = dict.fromkeys(registry.KERNELS, 0)
    for name in PORTED:
        want = oracles.ORACLES[name](total)
        runs = {}
        for k in (None, k_on):
            src, ops = make_query(name, total)
            views = []
            pipe = wt.Pipeline(src, ops, wt.Sink(lambda v: views.append(v)),
                               batch_size=NEX_BATCH, dispatch=k or False)
            counts, dt, peak = run_pipeline(torch, registry, pipe, k)
            views = [v for v in views if v is not None]
            got = nexmark_rows(np, name, views)
            drops = (ops[-1].drop_counters(pipe.chain.states[-1])
                     if hasattr(ops[-1], "drop_counters") else {})
            log({"phase": "nexmark_pipeline", "query": name, "dispatch": k,
                 "batches": NEX_BATCHES, "batch": NEX_BATCH, "rows": len(got),
                 "run_s": dt, "tuples_per_s": total / dt, "launches": counts,
                 "peak_mib": peak / 2 ** 20, "drops": drops})
            if got != want:
                bad = sorted(set(got) ^ set(want))[:5]
                raise AssertionError(f"{name}: sink rows differ from the dense oracle: {bad}")
            expect = {c: NEX_LAUNCHES[name].get(c, 0) for c in counts}
            if counts != expect:
                raise AssertionError(f"{name}: launches {counts}, expected {expect}")
            runs[k] = (views, counts, pipe.chain.graphs)
        check_dispatch(np, f"nexmark_{name}", k_on, NEX_BATCHES, runs[None][:2],
                       runs[k_on][:2], runs[k_on][2])
        for c, n in runs[None][1].items():
            launches[c] += n
        if name == "q3_enrich_join":
            q3_views = runs[None][0]
    return launches, q3_views


def nexmark_loop_phase(torch, wt, card, profile):
    """Each query through the captured ``device_cursor_step`` loop, then the
    eager step on a fresh chain: tuples/s and ms/step of both."""
    from windflow_tpu_torch.benchmarks import device_cursor_step
    from windflow_tpu_torch.nexmark import PORTED, make_query

    warm = 2
    for name in PORTED:
        def make():
            src, ops = make_query(name, (NEX_STEPS + warm + PROFILE_STEPS) * NEX_BATCH)
            return src, wt.CompiledChain(ops, src.payload_spec(), batch_capacity=NEX_BATCH,
                                         event_time=False)
        src, chain = make()
        step = device_cursor_step(chain, src, NEX_BATCH)
        states = tuple(chain.states)
        cur = torch.zeros((), dtype=torch.int32, device="cuda")
        for _ in range(warm):
            states, cur, _ = step(states, cur)
        states, cur, out, ms = timed_steps(torch, step, states, cur, NEX_STEPS)
        if int(cur) != (NEX_STEPS + warm) * NEX_BATCH:
            raise AssertionError(f"{name} loop: unexpected cursor {int(cur)}")
        if profile:
            profile_steps(torch, f"nexmark_loop_{name}", step, states, cur, ms)
        row = {"phase": "nexmark_loop", "query": name, "steps": NEX_STEPS,
               "batch": NEX_BATCH, "tuples_per_s": NEX_BATCH / ms * 1e3,
               "ms_per_step": ms, "graph_launches": step.graph.launches, "card": card}
        del step, states, chain, src
        row["eager_ms_per_step"] = eager_loop(torch, make, NEX_BATCH, warm, NEX_STEPS,
                                              f"nexmark_loop_{name}", profile)
        log(row)


def session_kernel_phase(torch):
    """K3 at q5's shapes on q5's own traffic (a batch of 2^14 bids keyed by
    bidder): folding the lanes' prices by session fragment (S = 2^14, the
    fragment ids of the (bidder, ts) sorted batch) and a 0/1 close flag by
    bidder (S = 8; 9 and 32, the tiered phases' hot directories, untimed);
    each bit for bit against its plain version, with its time, bound and
    library call. (K2 at q5's shapes: ``k2_main_cases``.)"""
    from windflow_tpu_torch.ops import segment as S

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)
    C = NEX_BATCH
    b, K, perm, _, seg, _ = q5_traffic(torch)
    price = b.payload["price"][perm].contiguous()
    valid = torch.ones((C,), dtype=torch.bool, device=dev)
    flag = (torch.rand((C,), device=dev, generator=gen) < 0.3).to(torch.int32)
    key = b.key.contiguous()
    cases = [("q5_fragment_spend", price, seg, C)]
    for Kt in (K, TIERED_QUERIES["q5_session"], TIERED_ROTATING["q5_session"]):
        cases.append(("q5_closes_by_bidder", flag, key, Kt))
    for case, vals, ids, Sn in cases:
        idx = ids.long()
        check_kernel(torch, "segment_fold", f"{case}_S{Sn}",
                     lambda v=vals, i=ids, n=Sn: S.segment_fold_cuda(v, i, valid, n),
                     lambda v=vals, i=ids, n=Sn: S.segment_fold_plain(v, i, valid, n),
                     lambda v=vals, i=idx, n=Sn: torch.zeros(
                         n, dtype=torch.int32, device=dev).index_add_(0, i, v),
                     C * 9 + Sn * 4, {"C": C, "S": Sn, "dtype": "torch.int32"},
                     extra={"plan": S.segment_fold_plan(C, Sn, torch.int32),
                            "fragments": int(seg[-1]) + 1}, timed=Sn in (C, K))


def q4_two_sources(torch, wt, total):
    """q4's stream as two sources: the auction opens (events 16 j) and the
    bids (every other event), each event with its own fields and tick."""
    from windflow_tpu_torch.nexmark import generators as g

    def opens_ev(i):
        return i * g.OPEN_EVERY

    def bids_ev(i):
        return i + i // (g.OPEN_EVERY - 1) + 1

    def auction(e):
        return torch.where((e % g.OPEN_EVERY) == 0, (e // g.OPEN_EVERY) % g.N_AUCTIONS,
                           g.bid_auction(e))

    def source(ev, n, name):
        def gen(i):
            e = ev(i)
            is_open = (e % g.OPEN_EVERY) == 0
            return {"side": is_open.to(torch.int32), "auction": auction(e).to(torch.int32),
                    "price": torch.where(is_open, 0, g.bid_price(e)).to(torch.int32)}
        return wt.DeviceSource(gen, total=n, name=name, key_fn=lambda i: auction(ev(i)),
                               ts_fn=lambda i: ev(i) // g.EVENTS_PER_TICK)
    n_open = (total + g.OPEN_EVERY - 1) // g.OPEN_EVERY
    return source(opens_ev, n_open, "opens"), source(bids_ev, total - n_open, "bids")


def nexmark_graph_phase(torch, np, wt, registry, card):
    """q4 as two sources (opens and bids) through ``join_with`` in a
    DETERMINISTIC PipeGraph at 2^14 a batch over q4's 16 x 2^14 events,
    serial and ``threaded=True``: the join's rows equal the one-source
    Pipeline's (the dense oracle) as a set; K4's calls of the merge logged."""
    from windflow_tpu_torch.nexmark import make_query, oracles

    total = NEX_BATCHES * NEX_BATCH
    want = oracles.q4_interval_join(total)
    launches = dict.fromkeys(registry.KERNELS, 0)
    for threaded in (False, True):
        opens, bids = q4_two_sources(torch, wt, total)
        _, ops = make_query("q4_interval_join", total)
        views = []
        g = wt.PipeGraph("q4_graph", mode=wt.Mode.DETERMINISTIC, batch_size=NEX_BATCH)
        m = g.add_source(opens).join_with(g.add_source(bids), ops[0])
        m.add_sink(wt.Sink(lambda v: views.append(v) if v is not None else None))
        counts, dt, peak = counted_run(torch, registry, lambda: g.start(threaded=threaded),
                                       g.wait_end)
        got = nexmark_rows(np, "q4_interval_join", views)
        node = m._ordering
        log({"phase": "nexmark_graph", "query": "q4_interval_join", "threaded": threaded,
             "events": total, "batch": NEX_BATCH, "rows": len(got), "run_s": dt,
             "tuples_per_s": total / dt, "launches": counts,
             "peak_mib_above_start": peak / 2 ** 20, "card": card,
             "join_applies": m._chain._push_count,
             "k4_networks": {f"{'sort' if s_ else 'merge'}_{n_}": c
                             for (n_, s_), c in node.networks.items()},
             "drops": ops[0].drop_counters(m._chain.states[0])})
        if got != want:
            bad = sorted(set(got) ^ set(want))[:5]
            raise AssertionError(f"nexmark_graph threaded={threaded}: rows differ from "
                                 f"the one-source Pipeline's: {bad}")
        extra = {k: n for k, n in counts.items() if n and k != "ordering_merge"}
        if extra:
            raise AssertionError(f"nexmark_graph: unexpected launches {extra}")
        for k, n in counts.items():
            launches[k] += n
    return launches


CKPT_DIR = os.path.join(ROOT, "build", "checkpoints")


def host_rows(outs):
    """The live lanes of a list of output batches, as host views."""
    from windflow_tpu_torch.batch import host_view
    return [host_view(o) for o in outs]


def checkpoint_phase(torch, np, wt, ysb, registry, card):
    """YSB (8 x 2^20) and q5 (16 x 2^14) at full width: an uninterrupted
    dispatch-off run, then half the batches, ``save_chain``, a fresh chain
    with its K-step graph captured, ``load_chain`` into it and the rest at
    dispatch K (the restored state copied into the graph at its first
    replay): the two runs' rows byte for byte. Logs the file's bytes and
    the save and load ms."""
    import shutil
    from windflow_tpu_torch.nexmark import make_query
    from windflow_tpu_torch.runtime import checkpoint as ck

    os.makedirs(CKPT_DIR, exist_ok=True)
    launches = dict.fromkeys(registry.KERNELS, 0)
    cases = (("ysb", BATCH, YSB_BATCHES, DISPATCH_K["ysb"],
              lambda: (ysb.make_source(YSB_BATCHES * BATCH),
                       ysb.make_ops(**ysb.bench_geometry(BATCH))),
              {"histogram": 1, "lookup": 1}),
             ("q5_session", NEX_BATCH, NEX_BATCHES, DISPATCH_K["nexmark"],
              lambda: make_query("q5_session", NEX_BATCHES * NEX_BATCH), Q5_APPLY))
    try:
        for name, C, n, k, make, per_batch in cases:
            def chain():
                src, ops = make()
                return src, wt.CompiledChain(ops, src.payload_spec(),
                                             batch_capacity=src.out_capacity(C))
            src, c0 = chain()
            batches = list(src.batches(C))
            whole = host_rows([c0.push(b) for b in batches] + c0.flush())
            half = n // 2
            _, c1 = chain()
            _, c2 = chain()
            c2.warm_scan(k, src.out_capacity(C))          # captured before the restore
            torch.cuda.synchronize()
            registry.reset_launches()
            outs = [c1.push(b) for b in batches[:half]]
            t0 = time.perf_counter()
            path = ck.save_chain(c1, os.path.join(CKPT_DIR, name), meta={"batches_done": half})
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            meta = ck.load_chain(c2, path)
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
            rest = batches[half:]
            for i in range(0, len(rest), k):
                outs += c2.push_many(rest[i:i + k])
            outs += c2.flush()
            torch.cuda.synchronize()
            counts = registry.launch_counts()
            resumed = host_rows(outs)
            same = flat_bytes(np, resumed) == flat_bytes(np, whole)
            replays = {f"{kk}": g.replays for (_, kk, _), g in c2.graphs.items()}
            log({"phase": "checkpoint", "chain": name, "batch": C, "batches": n,
                 "resumed_at": meta["batches_done"], "dispatch_after": k,
                 "file_bytes": os.path.getsize(path), "save_ms": save_ms,
                 "load_ms": load_ms, "rows": sum(len(r["id"]) for r in whole),
                 "rows_byte_identical": same, "graph_replays": replays,
                 "launches": counts, "card": card})
            if meta["batches_done"] != half or not same:
                raise AssertionError(f"checkpoint {name}: the resumed run's rows differ "
                                     f"from the uninterrupted run's")
            if replays.get(f"{k}", 0) < 1:
                raise AssertionError(f"checkpoint {name}: the K = {k} graph never replayed")
            expect_launches(f"checkpoint {name}", counts, per_batch, n)
            for kk, nn in counts.items():
                launches[kk] += nn
            del batches, outs, whole, resumed, c0, c1, c2
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return launches


def faults_phase(torch, np, wt, ysb, registry, card, serial_parts):
    """Threaded YSB (40 x 2^20, two segments) under a ``queue.stall`` plan:
    segment 1 sleeps 1.5 s at its 6th batch with a 0.5 s heartbeat watchdog.
    The rows equal the serial Pipeline's byte for byte, the watchdog names
    ``seg1``, and the stall fired once."""
    from windflow_tpu_torch.runtime import faults as F

    F.reset_counters()
    plan = F.FaultPlan([F.FaultSpec("queue.stall", kind="stall", stall_s=1.5,
                                    where={"stage": "seg1", "pos": 5})])
    inj = F.FaultInjector(plan)
    parts, cb = collect_sink()
    tp = wt.ThreadedPipeline(ysb.make_source(THREADED_BATCHES * BATCH), ysb_segments(ysb),
                             wt.Sink(cb), batch_size=BATCH, heartbeat_timeout=0.5,
                             faults=inj)
    launches, dt, peak = counted_run(torch, registry, tp.start, tp.run)
    same = flat_bytes(np, parts) == flat_bytes(np, serial_parts)
    log({"phase": "faults", "driver": "threaded", "plan": json.loads(plan.to_json()),
         "fired": [(s_, n_, k_, c_) for s_, n_, k_, c_ in inj.fired],
         "site_counts": inj.counts, "watchdog_stale": tp.watchdog_stale,
         "counters": {k: v for k, v in F.counters().items() if v}, "run_s": dt,
         "rows_equal_serial_bytes": same, "launches": launches, "card": card})
    if not same:
        raise AssertionError("faults: the stalled threaded run's rows differ from the "
                             "serial Pipeline's")
    expect_launches("faults", launches, {"histogram": 1, "lookup": 1}, THREADED_BATCHES)
    if "seg1" not in tp.watchdog_stale or len(inj.fired) != 1:
        raise AssertionError(f"faults: watchdog {tp.watchdog_stale}, fired {inj.fired}")
    if F.counters()["watchdog_timeouts"] < 1:
        raise AssertionError("faults: no watchdog_timeouts counted")
    return launches


def q3_oracle_np(np, start, n, auctions=Q3_AUCTIONS):
    """q3's expected lanes for events ``start .. start+n-1`` in numpy int32
    arithmetic (wrapping products, floored %) over ``auctions`` auctions:
    (emitted, auction, category, price)."""
    i = np.arange(start, start + n, dtype=np.int64).astype(np.int32)
    auction = (i * np.int32(2477)) % np.int32(auctions)
    category = (auction * np.int32(13)) % np.int32(7)
    price = (i * np.int32(7919)) % np.int32(9973) + np.int32(100)
    return i >= auctions, auction, category, price


def q3_pipeline_phase(torch, np, wt, registry):
    """q3 at full width (2^20-event batches, 2048 auctions) through
    Pipeline.run, dispatch off and at K = 2 over ``Q3_BATCHES`` batches:
    every emitted row against the numpy int32 oracle, K5 twice a batch, the
    rows byte for byte."""
    from windflow_tpu_torch.nexmark import make_query

    total = Q3_BATCHES * BATCH
    emit, a, c, p = q3_oracle_np(np, 0, total)
    want = {"id": np.arange(total, dtype=np.int32)[emit], "auction": a[emit],
            "category": c[emit], "price": p[emit]}
    runs = {}
    for k in (None, DISPATCH_K["q3_full"]):
        src, ops = make_query("q3_enrich_join", total, n_auctions=Q3_AUCTIONS)
        views = []
        pipe = wt.Pipeline(src, ops, wt.Sink(lambda v: views.append(v)), batch_size=BATCH,
                           dispatch=k or False)
        launches, dt, peak = run_pipeline(torch, registry, pipe, k)
        views = [v for v in views if v is not None]
        got = {"id": np.concatenate([v["id"] for v in views])}
        for f in ("auction", "category", "price"):
            got[f] = np.concatenate([v["payload"][f] for v in views])
        log({"phase": "q3_full_width_pipeline", "dispatch": k, "batches": Q3_BATCHES,
             "batch": BATCH, "rows": len(got["id"]), "run_s": dt,
             "tuples_per_s": total / dt, "launches": launches, "peak_mib": peak / 2 ** 20})
        for f, w in want.items():
            if not np.array_equal(got[f], w):
                raise AssertionError(f"q3 full width pipeline: {f} differs from the oracle")
        expect_launches("q3 full width pipeline", launches, {"join_probe": 2}, Q3_BATCHES)
        runs[k] = (views, launches, pipe.chain.graphs)
    k = DISPATCH_K["q3_full"]
    check_dispatch(np, "q3_full_width", k, Q3_BATCHES, runs[None][:2], runs[k][:2],
                   runs[k][2])


def q3_full_width_phase(torch, np, wt, registry, card, profile):
    """q3 at full width through the captured loop (every emitted row of
    every step against the oracle, K5 twice a step), then the eager step."""
    from windflow_tpu_torch.benchmarks import device_cursor_step
    from windflow_tpu_torch.nexmark import make_query

    warm = 2
    out_fn = lambda b: (b.valid, b.id, b.payload["auction"],  # noqa: E731
                        b.payload["category"], b.payload["price"])

    def make():
        src, ops = make_query("q3_enrich_join", (NEX_STEPS + warm + PROFILE_STEPS) * BATCH,
                              n_auctions=Q3_AUCTIONS)
        return src, wt.CompiledChain(ops, src.payload_spec(), batch_capacity=BATCH,
                                     event_time=False)
    src, chain = make()
    step = device_cursor_step(chain, src, BATCH, out_fn=out_fn)
    states = tuple(chain.states)
    cur = torch.zeros((), dtype=torch.int32, device="cuda")
    outs = []
    for _ in range(warm):
        states, cur, out = step(states, cur)
        outs.append(out)
    torch.cuda.synchronize()
    registry.reset_launches()
    states, cur, out, ms = timed_steps(torch, step, states, cur, NEX_STEPS, outs)
    launches = registry.launch_counts()
    rows = 0
    for s, (valid, ids, auction, category, price) in enumerate(outs):
        emit, a, c, p = q3_oracle_np(np, s * BATCH, BATCH)
        v = valid.cpu().numpy()
        if not np.array_equal(v, emit) or not np.array_equal(
                ids.cpu().numpy(), np.arange(s * BATCH, (s + 1) * BATCH, dtype=np.int32)):
            raise AssertionError(f"q3 full width, step {s}: emitted lanes differ")
        for name, got, want in (("auction", auction, a), ("category", category, c),
                                ("price", price, p)):
            if not np.array_equal(got.cpu().numpy()[v], want[v]):
                raise AssertionError(f"q3 full width, step {s}: {name} differs")
        rows += int(v.sum())
    st = states[0]
    row = {"phase": "q3_full_width", "steps": NEX_STEPS, "batch": BATCH,
           "auctions": Q3_AUCTIONS, "tuples_per_s": BATCH / ms * 1e3,
           "ms_per_step": ms, "rows_checked": rows,
           "table_used": int(st["used"].sum()), "dropped": int(st["dropped"]),
           "launches": launches, "card": card}
    if launches["join_probe"] != 2 * NEX_STEPS or int(st["dropped"]) != 0 \
            or int(st["used"].sum()) != Q3_AUCTIONS:
        raise AssertionError(f"q3 full width: launches {launches}, table "
                             f"{int(st['used'].sum())} used, {int(st['dropped'])} dropped")
    del outs
    if profile:
        profile_steps(torch, "q3_full_width", step, states, cur, ms)
    del step, states, chain, src, st
    row["eager_ms_per_step"] = eager_loop(torch, make, BATCH, warm, NEX_STEPS,
                                          "q3_full_width", profile, out_fn)
    log(row)


def flat_bytes(np, tree):
    """Every array of a tree of sink rows in order, as (dtype, shape, bytes):
    what a byte-for-byte comparison of two runs compares."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_bytes(np, tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in flat_bytes(np, t)]
    a = np.asarray(tree)
    return [(a.dtype.str, a.shape, a.tobytes())]


def run_pipeline(torch, registry, pipe, k=None):
    """``pipe.run()`` with the launches counted from zero: (launches, run
    seconds, peak device bytes). With scan dispatch at ``k``, the K-step graph
    is captured first (``warm_scan``, whose eager warm-up step launches each
    kernel once before the counts are zeroed)."""
    if k:
        pipe.chain.warm_scan(k, pipe.source.out_capacity(pipe.batch_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    return registry.launch_counts(), time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def step_launches(counts):
    """Launch counts (a dict, or a tuple of them) without ``cold_scatter``:
    the stores' mirror upkeep follows the maintenance cadence (once a group
    at K), not the steps; ``expect_launches`` holds it against the stores."""
    if isinstance(counts, dict):
        return {c: v for c, v in counts.items() if c != "cold_scatter"}
    return tuple(step_launches(c) for c in counts)


def check_dispatch(np, what, k, batches, off, on, graphs):
    """A dispatch run against the dispatch-off run of the same phase
    (``off``/``on``: (sink rows, launches)): the sink rows byte for byte,
    the same launches, and the graphs replayed as the groups fall (the
    full-K graph at least twice, a tail of more than one batch once; a tail
    of one is ``push``). ``graphs``: the dispatch run's ``chain.graphs``."""
    replays = {kk: g.replays for (_, kk, _), g in graphs.items()}
    want = {k: batches // k}
    if batches % k > 1:
        want[batches % k] = 1
    same = flat_bytes(np, on[0]) == flat_bytes(np, off[0])
    row = {"phase": f"{what}_dispatch_check", "k": k, "batches": batches,
           "replays": replays, "rows_byte_identical": same,
           "graph_launches": {kk: g.launches for (_, kk, _), g in graphs.items()}}
    log(row)
    if replays != want or want[k] < 2:
        raise AssertionError(f"{what} dispatch: graph replays {replays}, expected {want}")
    if step_launches(on[1]) != step_launches(off[1]):
        raise AssertionError(f"{what} dispatch: launches {on[1]}, dispatch off {off[1]}")
    if not same:
        raise AssertionError(f"{what} dispatch: sink rows differ from the dispatch-off run")
    return row


def eager_cursor_step(src, chain, batch, out_fn=None):
    """The bench step as it ran before scan dispatch: ``make_batch`` and
    every ``apply`` launched op by op from the host (the plain loop that
    ``device_cursor_step`` now captures on the card)."""
    out_fn = out_fn or (lambda b: b.valid)

    def step(states, cur):
        b = src.make_batch(cur, batch)
        states = list(states)
        for j, op in enumerate(chain.ops):
            states[j], b = op.apply(states[j], b)
        return tuple(states), cur + batch, out_fn(b)
    return step


def timed_steps(torch, step, states, cur, n, outs=None):
    """``n`` steps between two synchronizes: (states, cur, last out, ms a step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        states, cur, out = step(states, cur)
        if outs is not None:
            outs.append(out)
    torch.cuda.synchronize()
    return states, cur, out, (time.perf_counter() - t0) / n * 1e3


def eager_loop(torch, make, batch, warm, steps, name, profile, out_fn=None):
    """ms a step of the eager step on a fresh chain (``make() -> (src,
    chain)``), after ``warm`` steps; ``--profile`` profiles it too."""
    src, chain = make()
    step = eager_cursor_step(src, chain, batch, out_fn)
    states = tuple(chain.states)
    cur = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(warm):
        states, cur, _ = step(states, cur)
    states, cur, _, ms = timed_steps(torch, step, states, cur, steps)
    if profile:
        profile_steps(torch, f"{name}_eager", step, states, cur, ms)
    return ms


def collect_sink():
    parts = []

    def cb(view):
        if view is not None:
            parts.append((view["key"], view["id"], view["payload"]))
    return parts, cb


def as_dict(np, parts):
    """``{(key, window): value}`` of a run's ``(key, id, payload)`` parts."""
    if not parts:
        return {}
    k, w, c = (np.concatenate(x) for x in zip(*parts))
    return dict(zip(zip(k.tolist(), w.tolist()), c.tolist()))


def ysb_pipeline_phase(torch, np, wt, ysb, registry):
    """YSB at full width through Pipeline.run, dispatch off and then at
    ``DISPATCH_K["ysb"]`` (8 batches at K = 3: groups of 3, 3 and a tail
    graph of 2): every per-window count against the dense oracle, K1 and K2
    once per batch, and the two runs' sink rows byte for byte."""
    total = YSB_BATCHES * BATCH
    want = ysb.dense_oracle(total)
    runs = {}
    for k in (None, DISPATCH_K["ysb"]):
        ops = ysb.make_ops(**ysb.bench_geometry(BATCH))
        parts, cb = collect_sink()
        pipe = wt.Pipeline(ysb.make_source(total), ops, wt.Sink(cb), batch_size=BATCH,
                           dispatch=k or False)
        launches, dt, peak = run_pipeline(torch, registry, pipe, k)
        got = as_dict(np, parts)
        log({"phase": "ysb_pipeline", "dispatch": k, "batches": YSB_BATCHES,
             "batch": BATCH, "P": ops[-1].P, "max_wins": ops[-1].max_wins,
             "count_lift": ops[-1].count_lift, "windows": len(got),
             "total": sum(got.values()), "oracle_total": ysb.oracle_totals(total),
             "run_s": dt, "tuples_per_s": total / dt, "launches": launches,
             "peak_mib": peak / 2 ** 20})
        if ops[-1].count_lift is not True:
            raise AssertionError("YSB's lift was not detected as a count lift")
        if got != want:
            bad = sorted(set(got.items()) ^ set(want.items()))[:5]
            raise AssertionError(f"YSB per-window counts differ from the dense oracle: {bad}")
        if launches["histogram"] != YSB_BATCHES or launches["lookup"] != YSB_BATCHES:
            raise AssertionError(f"expected K1 and K2 once per batch, got {launches}")
        runs[k] = (parts, launches, pipe.chain.graphs)
    check_dispatch(np, "ysb", DISPATCH_K["ysb"], YSB_BATCHES, runs[None][:2],
                   runs[DISPATCH_K["ysb"]][:2], runs[DISPATCH_K["ysb"]][2])
    return runs[None][1], runs[None][0]


def profile_steps(torch, phase, step, states, cur, ms_per_step, n=PROFILE_STEPS):
    """torch.profiler over ``n`` more steps: device busy time per step against
    the unprofiled step time gives the card's idle share; then the kernels
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile as prof
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(n):
            states, cur, out = step(states, cur)
        torch.cuda.synchronize()
    kern = [e for e in p.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.device_time_total for e in kern) / n
    log({"phase": f"{phase}_profile", "steps": n,
         "kernels_per_step": sum(e.count for e in kern) / n,
         "device_busy_ms_per_step": busy_us / 1e3,
         "idle_share": 1 - busy_us / 1e3 / ms_per_step})
    for e in sorted(kern, key=lambda e: -e.device_time_total)[:12]:
        log({"profile_kernel": e.key[:100], "per_step": e.count / n,
             "device_us_per_step": e.device_time_total / n})


def ysb_loop_phase(torch, wt, ysb, card, profile, name="ysb_loop", make_ops=None,
                   steps=LOOP_STEPS):
    """The YSB chain (or, with ``make_ops=ysb.make_ops_sum``, YSB-sum)
    through the captured ``device_cursor_step`` loop, then the eager step
    on a fresh chain: tuples/s and ms/step of both."""
    from windflow_tpu_torch.benchmarks import device_cursor_step

    warm = 3

    def make():
        src = ysb.make_source((steps + warm + PROFILE_STEPS) * BATCH)
        ops = (make_ops or ysb.make_ops)(**ysb.bench_geometry(BATCH))
        return src, wt.CompiledChain(ops, src.payload_spec(), batch_capacity=BATCH)
    src, chain = make()
    step = device_cursor_step(chain, src, BATCH)
    states = tuple(chain.states)
    cur = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(warm):
        states, cur, _ = step(states, cur)
    states, cur, out, ms = timed_steps(torch, step, states, cur, steps)
    win = states[-1]
    row = {"phase": name, "steps": steps, "batch": BATCH,
           "tuples_per_s": BATCH / ms * 1e3, "ms_per_step": ms,
           "graph_launches": step.graph.launches,
           "dropped_old": int(win.dropped_old), "card": card}
    if int(win.dropped_old) != 0 or int(cur) != (steps + warm) * BATCH:
        raise AssertionError(f"{name}: unexpected drops or cursor")
    if profile:
        profile_steps(torch, name, step, states, cur, ms)
    del step, states, chain, src
    row["eager_ms_per_step"] = eager_loop(torch, make, BATCH, warm, steps, name, profile)
    log(row)


def ysb_sum_phase(torch, np, wt, ysb, registry):
    """YSB-sum through Pipeline.run, dispatch off and at K = 2: the dense
    oracle, K3 once per batch, the rows byte for byte."""
    total = SUM_BATCHES * BATCH
    runs = {}
    for k in (None, DISPATCH_K["ysb_sum"]):
        ops = ysb.make_ops_sum(**ysb.bench_geometry(BATCH))
        parts, cb = collect_sink()
        pipe = wt.Pipeline(ysb.make_source(total), ops, wt.Sink(cb), batch_size=BATCH,
                           dispatch=k or False)
        launches, dt, peak = run_pipeline(torch, registry, pipe, k)
        got = as_dict(np, parts)
        log({"phase": "ysb_sum", "dispatch": k, "batches": SUM_BATCHES,
             "windows": len(got), "count_lift": ops[-1].count_lift, "run_s": dt,
             "launches": launches, "peak_mib": peak / 2 ** 20})
        if got != ysb.dense_oracle(total, "sum"):
            raise AssertionError("YSB-sum per-window sums differ from the dense oracle")
        if launches["segment_fold"] != SUM_BATCHES:
            raise AssertionError(f"expected K3 once per batch, got {launches}")
        runs[k] = (parts, launches, pipe.chain.graphs)
    k = DISPATCH_K["ysb_sum"]
    check_dispatch(np, "ysb_sum", k, SUM_BATCHES, runs[None][:2], runs[k][:2], runs[k][2])
    return runs[None][1]


# ------------------------------------------------------------------ K6 and the window paths

#: K6 cases: (case, W, L, data). bench_pallas_ab's three shapes, path A's
#: fired-window rows, path B's REDUCE rows and a ragged shape.
K6_CASES = [("ab_4096x512", 4096, 512, "float"), ("ab_1024x1024", 1024, 1024, "float"),
            ("ab_8192x256", 8192, 256, "float"), ("path_a", 2112, 1024, "float"),
            ("path_a_integer_valued", 2112, 1024, "integer_float"),
            ("path_a_int32", 2112, 1024, "int32"), ("path_b_reduce", 10700, 4, "int32"),
            ("ragged", 1000, 777, "float"), ("ragged_integer_valued", 1000, 777,
                                              "integer_float")]


def iterable_unsigned_check(torch, dev, gen):
    """Every Iterable reduction over uint8/uint16/uint32 fields (1-D and
    [L, 2]) under vmap on the card against the same on the CPU: sums into
    uint32 (K6 for the 1-D ones), max/min/at in the field's dtype, float32
    means; compared through int64 (uint32 has few operators)."""
    from windflow_tpu_torch.operators.window import Iterable

    def fn(d, i, t, m):
        it = Iterable(d, i, t, m)
        return {"sum": it.sum("u"), "sum2": it.sum("u2"), "max": it.max("u"),
                "min": it.min("u2"), "at": it.at(3).data["u"], "mean": it.mean("u")}
    W, L = 300, 45
    for dt, hi in ((torch.uint8, 256), (torch.uint16, 65536), (torch.uint32, 2 ** 32)):
        u = torch.randint(0, hi, (W, L), device=dev, generator=gen, dtype=torch.int64)
        mask = torch.rand((W, L), device=dev, generator=gen) < 0.6
        data = {"u": u.to(dt), "u2": torch.stack([u, u.flip(1)], -1).to(dt)}
        ids = torch.arange(W * L, device=dev, dtype=torch.int32).reshape(W, L)
        ts = ids % 100
        got = torch.func.vmap(fn)(data, ids, ts, mask)
        want = torch.func.vmap(fn)({k: v.cpu() for k, v in data.items()}, ids.cpu(),
                                   ts.cpu(), mask.cpu())
        for k in want:
            g, w = got[k].cpu(), want[k]
            same = (g.dtype == w.dtype and torch.equal(
                g.to(torch.float64 if k == "mean" else torch.int64),
                w.to(torch.float64 if k == "mean" else torch.int64)))
            if not same and k == "mean":
                same = g.dtype == w.dtype and torch.allclose(g, w, rtol=1e-6)
            if not same:
                raise AssertionError(f"Iterable over {dt} [{k}]: card differs from CPU")
    log({"phase": "iterable_unsigned", "dtypes": ["uint8", "uint16", "uint32"],
         "reductions": ["sum", "sum2", "max", "min", "at", "mean"], "equal": True})


def _k6_dtypes():
    """(dtype, tolerance or None for bit for bit, the library call's dtype)
    of the dtypes F4 added to K6."""
    import torch
    return [(torch.uint8, None, torch.int64), (torch.uint16, None, torch.int64),
            (torch.uint32, None, torch.int64),
            (torch.float16, 1e-2, torch.float32), (torch.bfloat16, 1e-2, torch.float32),
            (torch.float64, 1e-12, torch.float64)]


def window_reduce_kernel_phase(torch):
    """K6 against its plain version (bit for bit on int32 and integer-valued
    float32, within rtol = atol = 1e-4 on random float32), two launches
    giving the same bits, and the one PyTorch call computing the same sum."""
    from windflow_tpu_torch.ops import window_reduce as WR

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261020)
    rows = {}
    for case, W, L, kind in K6_CASES:
        if kind == "float":
            vals = torch.rand((W, L), device=dev, generator=gen)
        elif kind == "integer_float":          # every partial sum < 2^24
            vals = torch.randint(-1000, 1000, (W, L), device=dev, generator=gen).float()
        else:
            vals = torch.randint(-2 ** 31, 2 ** 31, (W, L), device=dev, generator=gen,
                                 dtype=torch.int64).to(torch.int32)
        mask = torch.rand((W, L), device=dev, generator=gen) < 0.7
        mask[W // 2] = False
        zero = torch.zeros((), dtype=vals.dtype, device=dev)
        row = check_kernel(
            torch, "masked_window_reduce", case,
            lambda: WR.masked_window_reduce_cuda(vals, mask),
            lambda: WR.masked_window_reduce_plain(vals, mask),
            lambda: torch.sum(torch.where(mask, vals, zero), dim=1, dtype=vals.dtype),
            W * L * 5 + W * 4, {"W": W, "L": L, "dtype": str(vals.dtype)},
            tol=1e-4 if kind == "float" else None)
        first = WR.masked_window_reduce_cuda(vals, mask)
        second = WR.masked_window_reduce_cuda(vals, mask)
        if not torch.equal(_bits(torch, first), _bits(torch, second)):
            raise AssertionError(f"masked_window_reduce [{case}]: two launches differ")
        rows[case] = row
    # F4: every dtype jnp.sum takes, at path A's shape; uint32 results are
    # compared as their int32 bits (torch's uint32 has few operators)
    for dt, tol, acc in _k6_dtypes():
        W, L = 2112, 1024
        if dt in (torch.uint8, torch.uint16, torch.uint32):
            hi = {torch.uint8: 256, torch.uint16: 65536, torch.uint32: 2 ** 32}[dt]
            vals = torch.randint(0, hi, (W, L), device=dev, generator=gen,
                                 dtype=torch.int64).to(dt)
        else:
            vals = torch.randn((W, L), device=dev, generator=gen, dtype=torch.float64).to(dt)
        mask = torch.rand((W, L), device=dev, generator=gen) < 0.7
        mask[W // 2] = False
        out_dt = WR.sum_dtype(dt)
        as_bits = (lambda t: t.view(torch.int32)) if out_dt == torch.uint32 else (lambda t: t)
        zero = torch.zeros((), dtype=dt, device=dev)
        row = check_kernel(
            torch, "masked_window_reduce", f"path_a_{str(dt).split('.')[-1]}",
            lambda: as_bits(WR.masked_window_reduce_cuda(vals, mask)),
            lambda: as_bits(WR.masked_window_reduce_plain(vals, mask)),
            # torch has no where for uint16/uint32 on the card: no library call
            None if dt in (torch.uint16, torch.uint32) else
            (lambda: torch.sum(torch.where(mask, vals, zero), dim=1, dtype=acc)),
            W * L * (vals.element_size() + 1) + W * out_dt.itemsize,
            {"W": W, "L": L, "dtype": str(dt), "out_dtype": str(out_dt)}, tol=tol,
            counted="bytes: each value and flag read once, each row's sum written "
                    "once; the library call sums in " + str(acc))
        first = as_bits(WR.masked_window_reduce_cuda(vals, mask))
        second = as_bits(WR.masked_window_reduce_cuda(vals, mask))
        if not torch.equal(_bits(torch, first), _bits(torch, second)):
            raise AssertionError(f"masked_window_reduce [{dt}]: two launches differ")
        rows[row["case"]] = row
    iterable_unsigned_check(torch, dev, gen)
    log({"phase": "window_reduce_kernel",
         "ab_kernel_over_library": {c: rows[c]["kernel_ms"] / rows[c]["library_ms"]
                                    for c in rows if rows[c]["library_ms"]}})
    return rows["path_a"]


def run_with_flush_launches(registry, pipe, op_index):
    """``pipe.run()`` with the launches made inside the window operator's
    flush counted apart: (launches outside the flush, launches in it, flush
    calls)."""
    op = pipe.chain.ops[op_index]
    inner, flushed = op.flush, {"calls": 0, "launches": dict.fromkeys(registry.KERNELS, 0)}

    def flush(state):
        before = registry.launch_counts()
        out = inner(state)
        for k, n in registry.launch_counts().items():
            flushed["launches"][k] += n - before[k]
        flushed["calls"] += 1
        return out
    op.flush = flush
    registry.reset_launches()
    try:
        pipe.run()
    finally:
        del op.flush
    total = registry.launch_counts()
    applied = {k: total[k] - flushed["launches"][k] for k in total}
    return applied, flushed["launches"], flushed["calls"]


def expect_launches(what, got, per, n, scatters=0):
    """``got`` is ``per`` an apply times ``n`` applies, and ``scatters``
    launches of the host stores' mirror upkeep (``cold_scatter``: one a
    store write that changed index slots, which the tiered paths' stores
    count, ``mirror_scatters``; none elsewhere)."""
    want = {k: per.get(k, 0) * n for k in got}
    if scatters or "cold_scatter" in got:
        want["cold_scatter"] = scatters
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def tier_stores(ops):
    """The host stores of every tiered operator in ``ops``."""
    return [t.store for op in ops for t in op.tier_controllers()]


def mirror_scatters(stores):
    """The ``cold_scatter`` launches the stores' writes made."""
    return sum(st.mirror_scatters for st in stores)


def check_mirrors(torch, what, stores):
    """Each store's index mirror in the card's memory equals its host index
    (read after the copies in flight land); the stores' mirror upkeep is
    logged. Fails where stores that hold rows made no scatter."""
    torch.cuda.synchronize()
    for st in stores:
        if not torch.equal(st.mirror.cpu(), torch.from_numpy(st.index_slots())):
            raise AssertionError(f"{what}: store {st.name!r}'s mirror differs from its "
                                 f"host index")
    row = {"mirror_check": what, "stores": len(stores),
           "scatters": mirror_scatters(stores),
           "uploads": sum(st.mirror_uploads for st in stores),
           "rows": sum(len(st) for st in stores)}
    log(row)
    if row["rows"] and not row["scatters"]:
        raise AssertionError(f"{what}: the stores hold rows and made no cold_scatter")
    return row


def path_a_source(wt, batches):
    return wt.DeviceSource(lambda i: {"v": (i % 97).float()}, total=batches * BATCH,
                           num_keys=WIN_KEYS)


def path_a_op(wt):
    return wt.Key_Farm(lambda wid, it: it.sum("v"), wt.WindowSpec(WIN_LEN, WIN_SLIDE),
                       num_keys=WIN_KEYS)


#: exact launches of one apply on each window path (the flush launches K6 once
#: per call and nothing else); path B's K2: YSB's campaign join, and its TB
#: Win_Seq's next_win and count read in one launch
PATH_A_APPLY = {"lookup": 1, "segment_fold": 1, "masked_window_reduce": 1}
PATH_B_APPLY = {"lookup": 2, "segment_fold": 1, "masked_window_reduce": 1}


def window_loop(torch, registry, name, make, per_apply, card, profile, check,
                out_fn=None):
    """``WIN_STEPS`` timed steps of the captured ``device_cursor_step`` after
    two warm-up steps (``make() -> (src, chain)``); exact launches per step;
    ``check(states, out, steps_run)``; then the eager step on a fresh chain."""
    from windflow_tpu_torch.benchmarks import device_cursor_step

    warm = 2
    src, chain = make()
    step = device_cursor_step(chain, src, BATCH, out_fn=out_fn)
    states = tuple(chain.states)
    cur = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(warm):
        states, cur, _ = step(states, cur)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    states, cur, out, ms = timed_steps(torch, step, states, cur, WIN_STEPS)
    launches = registry.launch_counts()
    row = {"phase": f"{name}_loop", "steps": WIN_STEPS, "batch": BATCH,
           "tuples_per_s": BATCH / ms * 1e3, "ms_per_step": ms,
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "launches": launches, "card": card}
    row.update(check(states, out, warm + WIN_STEPS))
    expect_launches(f"{name} loop", launches, per_apply, WIN_STEPS)
    if profile:
        profile_steps(torch, f"{name}_loop", step, states, cur, ms)
    del step, states, out, chain, src
    torch.cuda.empty_cache()
    row["eager_ms_per_step"] = eager_loop(torch, make, BATCH, warm, WIN_STEPS,
                                          f"{name}_loop", profile, out_fn)
    torch.cuda.empty_cache()
    log(row)


def path_a_phase(torch, np, wt, registry, card, profile):
    """Path A: Key_Farm keyed CB sliding-window sum at bench_keyed_cb's
    geometry, its 2^21-slot ring per key (16 GiB of archive): Pipeline.run
    dispatch off and at K = 2, then the loops."""
    from windflow_tpu_torch.benchmarks import keyed as KB

    k_on = DISPATCH_K["path_a"]
    want = KB.keyed_cb_oracle(WIN_BATCHES * BATCH)   # bench_keyed_cb's stream
    runs = {}
    for k in (None, k_on):
        torch.cuda.empty_cache()
        parts, cb = collect_sink()
        pipe = wt.Pipeline(path_a_source(wt, WIN_BATCHES), [path_a_op(wt)], wt.Sink(cb),
                           batch_size=BATCH, dispatch=k or False)
        op = pipe.chain.ops[0]
        if k:
            pipe.chain.warm_scan(k, BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        applied, flushed, calls = run_with_flush_launches(registry, pipe, 0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k_, w_, v_ = (np.concatenate(x) for x in zip(*parts))
        got = {(a, b): c for a, b, c in zip(k_.tolist(), w_.tolist(), v_.tolist())}
        log({"phase": "windows_pipeline", "dispatch": k, "batches": WIN_BATCHES,
             "batch": BATCH, "keys": WIN_KEYS, "ring": op.A, "max_wins": op._w,
             "windows": len(got), "run_s": dt, "tuples_per_s": WIN_BATCHES * BATCH / dt,
             "archive_gib": 4 * WIN_KEYS * op.A * 4 / 2 ** 30,
             "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
             "launches_apply": applied, "launches_flush": flushed, "flush_calls": calls})
        if got != want:
            bad = sorted(set(got.items()) ^ set(want.items()))[:5]
            raise AssertionError(f"path A: windows differ from the numpy oracle: {bad}")
        # bench_keyed_cb's geometry: 16 windows a key, A = 2^21, W = 2112
        per_key = WIN_BATCHES * BATCH // WIN_KEYS
        if (len(want) != WIN_KEYS * ((per_key - 1) // WIN_SLIDE + 1)
                or op.A != 1 << (WIN_LEN + BATCH - 1).bit_length()
                or op._w != -(-BATCH // WIN_SLIDE) + 64):
            raise AssertionError(f"path A geometry: {len(want)} windows, A={op.A}, W={op._w}")
        expect_launches("path A apply", applied, PATH_A_APPLY, WIN_BATCHES)
        expect_launches("path A flush", flushed, {"masked_window_reduce": 1}, calls)
        runs[k] = (parts, (applied, flushed), pipe.chain.graphs)
        del pipe, op
    check_dispatch(np, "path_a", k_on, WIN_BATCHES, runs[None][:2], runs[k_on][:2],
                   runs[k_on][2])
    applied, flushed = runs[None][1]
    del runs
    torch.cuda.empty_cache()

    def make():
        src = path_a_source(wt, 2 + WIN_STEPS + PROFILE_STEPS)
        return src, wt.CompiledChain([path_a_op(wt)], src.payload_spec(),
                                     batch_capacity=BATCH)

    def check(states, out, steps_run):
        fired = int(out.sum())           # 4 windows a key a step
        if fired != WIN_KEYS * (BATCH // WIN_KEYS // WIN_SLIDE):
            raise AssertionError(f"path A loop: {fired} windows in a step")
        return {"windows_per_step": fired}
    window_loop(torch, registry, "windows", make, PATH_A_APPLY, card, profile, check)
    launches = dict(applied)
    launches["masked_window_reduce"] += flushed["masked_window_reduce"]
    torch.cuda.empty_cache()
    return launches


def path_b_phase(torch, np, wt, ysb, registry, card, profile):
    """Path B: YSB-WMR at bench_ysb_wmr's geometry (1000-tick windows,
    map_parallelism 4, an 8192-slot ring per campaign, 10,700 fired windows
    a batch): Pipeline.run dispatch off and at K = 2, then the loops."""
    geo = ysb.wmr_bench_geometry(BATCH, WMR_WIN_LEN)

    def ops():
        return ysb.make_ops_wmr(win_len=WMR_WIN_LEN, map_parallelism=WMR_MAP, **geo) + [
            wt.ReduceSink(lambda t: t.data, name="wmr_total")]
    total = WIN_BATCHES * BATCH
    k_on = DISPATCH_K["path_b"]
    runs = {}
    for k in (None, k_on):
        parts, cb = collect_sink()
        pipe = wt.Pipeline(ysb.make_source(total), ops(), wt.Sink(cb), batch_size=BATCH,
                           dispatch=k or False)
        engine = pipe.chain.ops[-2].engine
        if k:
            pipe.chain.warm_scan(k, BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        applied, flushed, calls = run_with_flush_launches(registry, pipe, -2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = as_dict(np, parts)
        counted = int(pipe.chain.result()["wmr_total"])
        log({"phase": "ysb_wmr_pipeline", "dispatch": k, "batches": WIN_BATCHES,
             "batch": BATCH, "ring": engine.A, "max_wins": engine.max_wins,
             "windows": len(got), "total": counted, "oracle_total": ysb.oracle_totals(total),
             "run_s": dt, "tuples_per_s": total / dt,
             "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
             "launches_apply": applied, "launches_flush": flushed, "flush_calls": calls})
        if counted != ysb.oracle_totals(total) or sum(got.values()) != counted:
            raise AssertionError(f"YSB-WMR: {counted} views counted, expected "
                                 f"{ysb.oracle_totals(total)}")
        if got != ysb.dense_oracle(total, win_len=WMR_WIN_LEN):
            raise AssertionError("YSB-WMR per-window counts differ from the dense oracle")
        if engine.A != geo["tb_capacity"] or engine.max_wins != geo["max_wins"]:
            raise AssertionError(f"YSB-WMR geometry: A={engine.A}, W={engine.max_wins}")
        expect_launches("YSB-WMR apply", applied, PATH_B_APPLY, WIN_BATCHES)
        expect_launches("YSB-WMR flush", flushed, {"masked_window_reduce": 1}, calls)
        runs[k] = ((parts, counted), (applied, flushed), pipe.chain.graphs)
        del pipe, engine
    check_dispatch(np, "ysb_wmr", k_on, WIN_BATCHES, runs[None][:2], runs[k_on][:2],
                   runs[k_on][2])
    applied, flushed = runs[None][1]
    del runs
    torch.cuda.empty_cache()

    def make():
        src = ysb.make_source((2 + WIN_STEPS + PROFILE_STEPS) * BATCH)
        return src, wt.CompiledChain(ops(), src.payload_spec(), batch_capacity=BATCH)

    def check(states, out, steps_run):
        # bench_ysb_wmr's self-check: every window whose span is fully
        # delivered and past the flush horizon fired with its full count
        counted = int(states[-1])
        ticks = steps_run * BATCH // ysb.EVENTS_PER_TICK
        complete_ticks = (ticks // WMR_WIN_LEN - 1) * WMR_WIN_LEN
        expect_min = (complete_ticks * ysb.EVENTS_PER_TICK + 2) // 3
        if counted < expect_min:
            raise AssertionError(f"YSB-WMR loop undercounted: {counted} < {expect_min}")
        return {"views_counted": counted, "expect_min": expect_min}
    window_loop(torch, registry, "ysb_wmr", make, PATH_B_APPLY, card, profile, check)
    launches = dict(applied)
    launches["masked_window_reduce"] += flushed["masked_window_reduce"]
    torch.cuda.empty_cache()
    return launches


def bench_dispatch_phase(torch, wt, card):
    """The counterpart of ``bench.py::bench_dispatch``: its Map -> Filter ->
    ReduceSink chain over 96 batches of 2^18 through Pipeline.run, per batch
    and at K = 8, in turns (per batch, fused, fused, per batch): tuples/s of
    each run (the capture is made before the timed run, and timed apart),
    the entry op's launches a batch from its stats record, and the
    ReduceSink results equal bit for bit."""
    n, base, k = BENCH_DISPATCH_BATCHES, BENCH_DISPATCH_BATCH, BENCH_DISPATCH_K

    def run(dispatch):
        src = wt.DeviceSource(lambda i: {"v": (i % 1000).float()}, total=n * base,
                              num_keys=512)
        pipe = wt.Pipeline(src, [wt.Map(lambda t: {"v": t.v * 2.0 + 1.0}),
                                 wt.Filter(lambda t: t.v > 100.0),
                                 wt.ReduceSink(lambda t: t.v)],
                           batch_size=base, dispatch=dispatch or False)
        t0 = time.perf_counter()
        if dispatch:
            pipe.chain.warm_scan(dispatch, base)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = pipe.run()["reduce_sink"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = pipe.chain.ops[0].get_StatsRecords()[0]
        return {"dispatch_k": dispatch, "tuples_per_s": n * base / dt, "run_s": dt,
                "capture_s": capture_s, "batches": rec.batches_received,
                "launches": rec.num_kernels,
                "launches_per_batch": rec.num_kernels / max(rec.batches_received, 1),
                "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}, result
    runs = [run(d) for d in (None, k, k, None)]
    for r, _ in runs:
        log({"phase": "bench_dispatch_run", **r, "card": card})
    per_batch = [r["tuples_per_s"] for r, _ in runs if r["dispatch_k"] is None]
    fused = [r["tuples_per_s"] for r, _ in runs if r["dispatch_k"] == k]
    same = all(torch.equal(_bits(torch, res), _bits(torch, runs[0][1])) for _, res in runs)
    log({"phase": "bench_dispatch", "dispatch_k": k, "base_capacity": base,
         "per_batch_tuples_per_s": per_batch, "fused_tuples_per_s": fused,
         "speedup": sum(fused) / sum(per_batch), "results_equal": same,
         "launches_per_batch": {"per_batch": runs[0][0]["launches_per_batch"],
                                "fused": runs[1][0]["launches_per_batch"]},
         "card": card})
    if not same:
        raise AssertionError("bench_dispatch: the ReduceSink results differ between runs")
    if runs[1][0]["launches_per_batch"] != 1 / k or runs[0][0]["launches_per_batch"] != 1:
        raise AssertionError("bench_dispatch: launches a batch are not 1/K fused, 1 per batch")


def small_collect(wt, op, total, K, batch, src_fn=None, ts_fn=None):
    """Sorted (key, wid, value) sink tuples of one small pipeline on the card."""
    fn = src_fn or (lambda i: {"v": (i // K).float()})
    src = wt.Source(fn, total=total, num_keys=K, ts_fn=ts_fn)
    out = []

    def cb(view):
        if view is not None:
            out.extend(zip(view["key"].tolist(), view["id"].tolist(),
                           [round(float(x), 3) for x in view["payload"].tolist()]))
    wt.Pipeline(src, [op], wt.Sink(cb), batch_size=batch).run()
    return sorted(out)


def oracle_cb(total, K, L, S):
    per_key = {k: [] for k in range(K)}
    for i in range(total):
        per_key[i % K].append(float(i // K))
    out = []
    for k, vals in per_key.items():
        for w in range((len(vals) - 1) // S + 1 if vals else 0):
            if vals[w * S: w * S + L]:
                out.append((k, w, sum(vals[w * S: w * S + L])))
    return sorted(out)


def windows_small_phase(wt, registry):
    """The other patterns at small depth on the card, each against a plain
    Win_Seq run on the card (itself against a Python oracle)."""
    TB = wt.win_type_t.TB
    sum_v = lambda wid, it: it.sum("v")  # noqa: E731
    red = lambda wid, it: it.sum()  # noqa: E731

    def seq(spec, K, **kw):
        return wt.Win_Seq(sum_v, spec, num_keys=K, **kw)

    def pf(spec, K):
        return wt.Pane_Farm(lambda pid, it: it.sum("v"), red, spec, num_keys=K)

    def wmr(spec, K, M):
        return wt.Win_MapReduce(sum_v, red, spec, map_parallelism=M, num_keys=K)
    cb62, cb84, tb84 = wt.WindowSpec(6, 2), wt.WindowSpec(8, 4), wt.WindowSpec(8, 4, TB)
    cases = [
        ("win_seq_cb_vs_python", seq(cb62, 3), 3000, 3, 512, oracle_cb(3000, 3, 6, 2)),
        ("win_farm_keyless", wt.Win_Farm(sum_v, cb84, parallelism=4), 2000, 1, 512, seq(cb84, 1)),
        ("pane_farm_cb", pf(cb62, 3), 3000, 3, 512, seq(cb62, 3)),
        # TB Pane_Farm at batch 64: at batch 512 over 3000 tuples the JAX
        # package's own Pane_Farm and Win_Seq disagree (ROADMAP Queue 3)
        ("pane_farm_tb", pf(tb84, 2), 600, 2, 64, seq(tb84, 2)),
        ("win_mapreduce_k6_map", wmr(cb84, 2, 4), 3000, 2, 512, seq(cb84, 2)),
        ("win_farm_pane_farm", wt.Win_Farm(pf(cb62, 3), parallelism=4), 3000, 3, 512,
         seq(cb62, 3)),
        ("key_farm_win_mapreduce", wt.Key_Farm(wmr(wt.WindowSpec(6, 3), 2, 3),
                                               parallelism=2), 3000, 2, 512,
         seq(wt.WindowSpec(6, 3), 2)),
        ("incremental_fold", wt.Win_Seq(lambda wid, t, acc: acc + t.v, wt.WindowSpec(4, 4),
                                        init_acc=0.0, num_keys=2), 2000, 2, 256,
         seq(wt.WindowSpec(4, 4), 2)),
    ]
    for name, op, total, K, batch, want in cases:
        if not isinstance(want, list):
            want = small_collect(wt, want, total, K, batch)
        registry.reset_launches()
        got = small_collect(wt, op, total, K, batch)
        log({"phase": "windows_small", "case": name, "windows": len(got),
             "launches": {k: n for k, n in registry.launch_counts().items() if n}})
        if got != want or not got:
            raise AssertionError(f"windows_small [{name}]: differs from the plain run")
    # a TB window with lateness: out-of-order timestamps within the allowance
    total, L, S, delay = 1200, 10, 5, 16
    ts_of = [i + (i % 3) * 2 - 2 for i in range(total)]
    want = sorted((0, w, float(sum(i for i in range(total) if w * S <= ts_of[i] < w * S + L)))
                  for w in range(max(ts_of) // S + 1)
                  if any(w * S <= t < w * S + L for t in ts_of))
    got = small_collect(wt, seq(wt.WindowSpec(L, S, TB, delay=delay), 1, archive_capacity=256),
                        total, 1, 30, src_fn=lambda i: {"v": i.float()},
                        ts_fn=lambda i: i + (i % 3) * 2 - 2)
    log({"phase": "windows_small", "case": "tb_lateness", "windows": len(got)})
    if got != want:
        raise AssertionError("windows_small [tb_lateness]: differs from the Python oracle")


# ------------------------------------------------------------- PipeGraph phases

ORD_TOTAL = 200_000       # bench.py::bench_ordering_overhead: tuples a source
ORD_BATCH = 4096          # and its batch
ORD_FULL_TOTAL = 1 << 22  # the same graph at full width: tuples a source
ORD_FULL_BATCH = 1 << 16  # and its batch
GW_TOTAL = 1 << 21        # graph_windows: tuples (path A's keys and window)
GW_BATCH = 1 << 16        # and its batch


def pipegraph_ysb_phase(torch, np, wt, ysb, registry, pipe_parts, pipe_launches):
    """The YSB chain as a one-source PipeGraph at bench_ysb's geometry, 8
    batches, dispatch off and at K = 3: the sink rows byte for byte equal to
    ysb_pipeline_phase's Pipeline rows and to the dense oracle, and the same
    launches (K1 and K2 once a batch) as the Pipeline run."""
    total = YSB_BATCHES * BATCH
    want = ysb.dense_oracle(total)
    runs = {}
    for k in (None, DISPATCH_K["ysb"]):
        parts, cb = collect_sink()
        g = wt.PipeGraph("pipegraph_ysb", batch_size=BATCH, dispatch=k or False)
        mp = g.add_source(ysb.make_source(total))
        for op in ysb.make_ops(**ysb.bench_geometry(BATCH)):
            mp.add(op)
        mp.add_sink(wt.Sink(cb))
        g.start()                     # with dispatch: the K-step graph made ready
        torch.cuda.synchronize()
        registry.reset_launches()
        t0 = time.perf_counter()
        g.wait_end()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = registry.launch_counts()
        got = as_dict(np, parts)
        same = flat_bytes(np, parts) == flat_bytes(np, pipe_parts)
        log({"phase": "pipegraph_ysb", "dispatch": k, "batches": YSB_BATCHES,
             "batch": BATCH, "windows": len(got), "run_s": dt,
             "tuples_per_s": total / dt, "launches": launches,
             "rows_equal_pipeline_bytes": same})
        if got != want:
            raise AssertionError("pipegraph_ysb: per-window counts differ from the oracle")
        if not same:
            raise AssertionError("pipegraph_ysb: sink rows differ from the Pipeline run's")
        if launches != pipe_launches:
            raise AssertionError(f"pipegraph_ysb: launches {launches}, Pipeline "
                                 f"{pipe_launches}")
        runs[k] = (parts, launches, mp._chain.graphs)
    check_dispatch(np, "pipegraph_ysb", DISPATCH_K["ysb"], YSB_BATCHES, runs[None][:2],
                   runs[DISPATCH_K["ysb"]][:2], runs[DISPATCH_K["ysb"]][2])
    return runs[None][1]


def ordering_graph(torch, wt, mode, batch, total, sink=None):
    """bench.py::bench_ordering_overhead's graph: two sources (ts 2i and
    2i + 1, 8 keys) -> merge -> Map(v * 2) -> ReduceSink (or ``sink``)."""
    g = wt.PipeGraph("ord", mode=mode, batch_size=batch)
    sa = wt.Source(lambda i: {"v": i.to(torch.float32)}, total=total, num_keys=8,
                   ts_fn=lambda i: 2 * i, name="a")
    sb = wt.Source(lambda i: {"v": -i.to(torch.float32)}, total=total, num_keys=8,
                   ts_fn=lambda i: 2 * i + 1, name="b")
    m = g.add_source(sa).merge(g.add_source(sb))
    m.add(wt.Map(lambda t: {"v": t.v * 2.0}))
    if sink is None:
        m.add(wt.ReduceSink(lambda t: t.v, name="out"))
    else:
        m.add_sink(sink)
    return g, m


def k4_launches(B, networks):
    """(network calls, CUDA launches) of an Ordering_Node's K4 calls: each
    call's launches from ``network_plan`` at its row length."""
    calls = sum(networks.values())
    cuda = sum(c * B.network_plan(n, sort=s)["launches"] for (n, s), c in networks.items())
    return calls, cuda


def ordering_phase(torch, np, wt, registry, card, profile=False):
    """bench_ordering_overhead at its geometry, DEFAULT and DETERMINISTIC
    (equal sums; tuples/s of each and their ratio); then the same graph at
    full width (batch 2^16, 2^22 tuples a source) into a Sink: the released
    stream a permutation of the input sorted by (ts, id, chan), and K4's
    calls and CUDA launches counted exactly against network_plan."""
    from windflow_tpu_torch.ops import bitonic as B

    tps, sums = {}, {}
    for mode in (wt.Mode.DEFAULT, wt.Mode.DETERMINISTIC):
        for rep in range(2):                       # the first run warms up
            g, _ = ordering_graph(torch, wt, mode, ORD_BATCH, ORD_TOTAL)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = g.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        tps[mode.name], sums[mode.name] = 2 * ORD_TOTAL / dt, float(res["out"])
    log({"phase": "ordering_bench", "card": card, "batch": ORD_BATCH,
         "tuples_per_source": ORD_TOTAL, "tuples_per_s": tps, "sums": sums,
         "deterministic_over_default": tps["DETERMINISTIC"] / tps["DEFAULT"]})
    if sums["DEFAULT"] != sums["DETERMINISTIC"]:
        raise AssertionError(f"ordering: sums differ between modes {sums}")

    parts = []

    def cb(view):
        if view is not None:
            parts.append((view["ts"], view["id"], view["key"], view["payload"]["v"]))
    g, m = ordering_graph(torch, wt, wt.Mode.DETERMINISTIC, ORD_FULL_BATCH,
                          ORD_FULL_TOTAL, wt.Sink(cb))
    g.start()
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    g.wait_end()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = registry.launch_counts()
    ts, ids, keys, v = (np.concatenate(x) for x in zip(*parts))
    n = 2 * ORD_FULL_TOTAL
    want_ts = np.arange(n, dtype=np.int32)
    half = want_ts // 2
    ok = (len(ts) == n and np.array_equal(ts, want_ts) and np.array_equal(ids, half)
          and np.array_equal(keys, half % 8)
          and np.array_equal(v, np.where(want_ts % 2 == 0, half, -half).astype(np.float32)
                             * 2.0))
    node = m._ordering
    calls, cuda_launches = k4_launches(B, node.networks)
    pushes = 2 * ORD_FULL_TOTAL // ORD_FULL_BATCH
    sorts = sum(c for (_, srt), c in node.networks.items() if srt)
    merges = {f"{n_}": c for (n_, srt), c in node.networks.items() if not srt}
    log({"phase": "ordering_full_width", "card": card, "batch": ORD_FULL_BATCH,
         "tuples_per_source": ORD_FULL_TOTAL, "run_s": dt, "tuples_per_s": n / dt,
         "released_sorted_permutation": bool(ok), "pushes": pushes, "sort_calls": sorts,
         "merge_calls_by_lanes": merges, "k4_calls": calls,
         "k4_cuda_launches": cuda_launches,
         "k4_cuda_launches_per_merge": {f"{n_}": B.network_plan(n_, sort=False)["launches"]
                                        for (n_, srt) in node.networks if not srt},
         "launches": launches})
    if not ok:
        raise AssertionError("ordering: the released stream is not the sorted input")
    if sorts != pushes or sum(merges.values()) != pushes - 1:
        raise AssertionError(f"ordering: {sorts} sorts and {merges} merges for "
                             f"{pushes} pushes")
    if launches["ordering_merge"] != calls:
        raise AssertionError(f"ordering: K4 counted {launches['ordering_merge']}, the "
                             f"node made {calls} network calls")
    node_phase(torch, wt, card, profile)
    return launches


def node_phase(torch, wt, card, profile=False):
    """The Ordering_Node alone on the full-width ordering traffic: the two
    sources' batches made first, then ms a push (push and the counts' host
    wait) with nothing downstream; ``--profile`` profiles the first pushes
    of a fresh node (device busy time a push, idle share, top kernels)."""
    from windflow_tpu_torch.parallel.ordering import Ordering_Node
    srcs = [wt.Source(lambda i: {"v": i.to(torch.float32)}, total=ORD_FULL_TOTAL,
                      num_keys=8, ts_fn=(lambda i, c=c: 2 * i + c), name=f"s{c}")
            for c in range(2)]
    its = [s.batches(ORD_FULL_BATCH) for s in srcs]
    batches = [(c, b) for pair in zip(*its) for c, b in enumerate(pair)]
    node = Ordering_Node(2, wt.ordering_mode_t.TS)
    for c, b in batches[:8]:                   # warm-up on a node of its own
        node.push(c, b)
        node.last_release_count
    node = Ordering_Node(2, wt.ordering_mode_t.TS)
    released = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c, b in batches:
        node.push(c, b)
        released += node.last_release_count
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    log({"phase": "ordering_node_alone", "card": card, "batch": ORD_FULL_BATCH,
         "pushes": len(batches), "ms_per_push": ms,
         "tuples_per_s": len(batches) * ORD_FULL_BATCH / (ms * len(batches) / 1e3),
         "released_before_flush": released})
    if profile:
        def push(state, cur):
            nd, k = state
            nd.push(*batches[k])
            nd.last_release_count
            return (nd, k + 1), cur, None
        fresh = Ordering_Node(2, wt.ordering_mode_t.TS)
        state = push((fresh, 0), None)[0]         # past the first push (no merge)
        profile_steps(torch, "ordering_node", push, state, None, ms)


def host_io_phase(torch, np, wt):
    """GeneratorSource (numpy chunks with string keys: pinned host-to-device
    copies) -> Map -> Sink, synchronous and with ``async_depth=3`` (pinned
    device-to-host copies behind CUDA events): the same rows, in order."""
    names = np.asarray(["alpha", "beta", "gamma", "delta", "eps"])

    def gen():
        rng = np.random.default_rng(20261017)
        for c in range(8):
            n = (1 << 16) - 17 * c
            yield ({"v": rng.integers(-1000, 1000, n).astype(np.float32)},
                   names[rng.integers(0, 5, n)], np.arange(n) + c * (1 << 16))
    runs = {}
    for depth in (0, 3):
        parts = []

        def cb(view):
            if view is not None:
                parts.append((view["key"], view["id"], view["ts"], view["payload"]["v"]))
        src = wt.GeneratorSource(gen, {"v": torch.zeros(())}, num_keys=64)
        t0 = time.perf_counter()
        wt.Pipeline(src, [wt.Map(lambda t: {"v": t.v * 3.0})],
                    wt.Sink(cb, async_depth=depth), batch_size=1 << 16).run()
        torch.cuda.synchronize()
        runs[depth] = (flat_bytes(np, parts), time.perf_counter() - t0,
                       src.get_StatsRecords()[0].bytes_copied_hd, len(parts))
    same = runs[0][0] == runs[3][0]
    log({"phase": "host_io", "batches": 8, "async_depth": 3, "rows_equal": same,
         "run_s": {d: r[1] for d, r in runs.items()}, "h2d_bytes": runs[0][2],
         "sink_calls": runs[0][3]})
    if not same or runs[0][3] != 8:
        raise AssertionError("host_io: the async sink's rows differ from the sync sink's")


def graph_windows_oracle(np, total, keys, win_len, slide):
    """``{(key, window): sum}`` of the graph_windows graph: tuples i with
    i % 3 != 2 (branches 0 and 1 of the split), merged in (ts, id, chan)
    order (ts = id = i, so ascending i), key i % keys, value i % 97, per-key
    CB windows of ``win_len`` sliding by ``slide`` (the partial ones at EOS
    too)."""
    out = {}
    i = np.arange(total, dtype=np.int64)
    for k in range(keys):
        sel = i[k::keys]
        vals = sel[sel % 3 != 2] % 97
        csum = np.concatenate([[0], np.cumsum(vals)])
        n = len(vals)
        for w in range((n - 1) // slide + 1):
            lo, hi = w * slide, min(w * slide + win_len, n)
            out[(k, w)] = int(csum[hi] - csum[lo])
    return out


def graph_windows(torch, wt, total, keys, win_len, slide, batch, cb, device=None,
                  dispatch=False, trace=None, control=False):
    """split (id % 3) -> branches 0 and 1 (a Map each) merged partially in
    DETERMINISTIC mode -> CB Win_Seq sum -> Sink; branch 2 counted by a
    ReduceSink. Returns (graph, source pipe, merged pipe)."""
    kw = {} if device is None else {"device": device}
    g = wt.PipeGraph("graph_windows", mode=wt.Mode.DETERMINISTIC, batch_size=batch,
                     dispatch=dispatch, trace=trace, control=control, **kw)
    mp = g.add_source(wt.DeviceSource(lambda i: {"v": (i % 97).to(torch.float32)},
                                      total=total, num_keys=keys, **kw))
    mp.split(lambda t: (t.id % 3).to(torch.int32), 3)
    b0 = mp.select(0).chain(wt.Map(lambda t: {"v": t.v + 0.0}, name="b0", **kw))
    b1 = mp.select(1).chain(wt.Map(lambda t: {"v": t.v * 1.0}, name="b1", **kw))
    mp.select(2).add(wt.ReduceSink(lambda t: torch.ones((), dtype=torch.int32),
                                   name="rest", **kw))
    m = b0.merge(b1)                                   # merge-partial
    m.add(wt.Win_Seq(lambda wid, it: it.sum("v"),
                     wt.WindowSpec(win_len, slide, wt.win_type_t.CB), num_keys=keys,
                     **kw)).add_sink(wt.Sink(cb, **kw))
    return g, mp, m


def graph_windows_phase(torch, np, wt, registry):
    """split -> select -> merge-partial (DETERMINISTIC, TS_RENUMBERING) -> CB
    Win_Seq sum -> Sink at path A's keys and window, batch 2^16 over 2^21
    tuples: every window against the numpy oracle; K2, K3 and K6 once per
    Win_Seq apply (K6 once per flush call), K4's calls as the node made them.
    Returns the launches, the windows, the run's seconds and the sink parts
    in delivery order."""
    from windflow_tpu_torch.ops import bitonic as B

    parts, cb = collect_sink()
    g, mp, m = graph_windows(torch, wt, GW_TOTAL, WIN_KEYS, WIN_LEN, WIN_SLIDE,
                             GW_BATCH, cb)
    if m._merge_parent is not mp or m._covers_idx != (0, 1):
        raise AssertionError("graph_windows: the merge is not merge-partial")
    op = m.ops[0]
    inner, flushed = op.flush, {"calls": 0, "launches": dict.fromkeys(registry.KERNELS, 0)}

    def flush(state):
        before = registry.launch_counts()
        out = inner(state)
        for k, n in registry.launch_counts().items():
            flushed["launches"][k] += n - before[k]
        flushed["calls"] += 1
        return out
    op.flush = flush
    g.start()
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    try:
        res = g.wait_end()
    finally:
        del op.flush
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = registry.launch_counts()
    applied = {k: total[k] - flushed["launches"][k] for k in total}
    got = as_dict(np, parts)
    want = graph_windows_oracle(np, GW_TOTAL, WIN_KEYS, WIN_LEN, WIN_SLIDE)
    node = m._ordering
    calls, cuda_launches = k4_launches(B, node.networks)
    applies = m._chain._push_count
    log({"phase": "graph_windows", "batch": GW_BATCH, "tuples": GW_TOTAL,
         "keys": WIN_KEYS, "ordering_mode": node.mode.name, "windows": len(got),
         "rest": int(res["rest"]), "run_s": dt, "tuples_per_s": GW_TOTAL / dt,
         "win_seq_applies": applies, "flush_calls": flushed["calls"],
         "launches_apply": applied, "launches_flush": flushed["launches"],
         "k4_calls": calls, "k4_cuda_launches": cuda_launches,
         "k4_networks": {f"{'sort' if s_ else 'merge'}_{n_}": c
                         for (n_, s_), c in node.networks.items()}})
    if node.mode.name != "TS_RENUMBERING":
        raise AssertionError(f"graph_windows: ordering mode {node.mode.name}")
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))[:5]
        raise AssertionError(f"graph_windows: windows differ from the numpy oracle: {bad}")
    if int(res["rest"]) != len(range(2, GW_TOTAL, 3)):
        raise AssertionError("graph_windows: branch 2's count is wrong")
    expect_launches("graph_windows apply",
                    {k: applied[k] for k in ("lookup", "segment_fold", "masked_window_reduce")},
                    PATH_A_APPLY, applies)
    expect_launches("graph_windows flush", flushed["launches"],
                    {"masked_window_reduce": 1}, flushed["calls"])
    if applied["ordering_merge"] != calls or total["ordering_merge"] != calls:
        raise AssertionError(f"graph_windows: K4 counted {total['ordering_merge']}, the "
                             f"node made {calls} network calls")
    return total, got, dt, parts


# ------------------------------------------------------------- keyed-state phases

#: exact launches of one apply of bench_keyed_cb's Key_FFAT (the per-key CB
#: path): K2 reads the per-key count, K3 folds the occupancy counts (S = 2^21)
#: and the per-key counts (S = 512), the float fold the pane sums (S = 2^21);
#: the flush launches nothing
KEYED_CB_APPLY = {"lookup": 1, "segment_fold": 2, "segment_fold_float": 1}
STATEFUL_BATCHES = 4      # batches of each keyed_stateful Pipeline run
STATEFUL_CPU_BATCHES = 2  # batches of its runs held to the CPU port
#: the stated tolerance of keyed_stateful's float32 sums against float64: a
#: lane's error at most 2^-8 (G + |want|), G the batch's global prefix total
#: (every lane's value summed, about 5.2e8). Sequential float32 summation of
#: this stream is off by 9.7e-4 of its total after 2^20 lanes (numpy's
#: sequential cumsum): the float fold sums K = 1's 2^20 lanes in that order.
STATEFUL_TOL = 2.0 ** -8


def keyed_stateful_apply(K):
    """Exact launches of one Accumulator apply at K source keys (a table of
    max(K, 8) rows): K2 reads the carry where the float table has at most
    2048 rows (``take`` above, as ``jnp.take`` in the JAX package), the float
    fold folds the batch totals."""
    return {"lookup": int(max(K, 8) <= 2048), "segment_fold_float": 1}


def keyed_cb_phase(torch, np, wt, registry, card, profile):
    """bench_keyed_cb's operator as written: Key_FFAT(lambda t: t.v, torch.add,
    WindowSpec(1024, 512), num_keys=512) at batch 2^20, Pipeline.run dispatch
    off and at K = 2 against the numpy oracle byte for byte, its geometry
    (P = 4096, W = 2112) and exact launches, then the captured and eager
    loops."""
    from windflow_tpu_torch.benchmarks import keyed as KB

    k_on = DISPATCH_K["keyed_cb"]
    want = {kw: float(v) for kw, v in KB.keyed_cb_oracle(WIN_BATCHES * BATCH).items()}
    runs = {}
    for k in (None, k_on):
        torch.cuda.empty_cache()
        parts, cb = collect_sink()
        src, ops = KB.make_keyed_cb(WIN_BATCHES * BATCH)
        pipe = wt.Pipeline(src, ops, wt.Sink(cb), batch_size=BATCH, dispatch=k or False)
        op = pipe.chain.ops[0]
        state_bytes = sum(t.numel() * t.element_size()
                          for t in flat_tensors(pipe.chain.states[0]))
        if k:
            pipe.chain.warm_scan(k, BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        applied, flushed, calls = run_with_flush_launches(registry, pipe, 0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k_, w_, v_ = (np.concatenate(x) for x in zip(*parts))
        got = {(a, b): c for a, b, c in zip(k_.tolist(), w_.tolist(), v_.tolist())}
        log({"phase": "keyed_cb_pipeline", "dispatch": k, "batches": WIN_BATCHES,
             "batch": BATCH, "keys": WIN_KEYS, "P": op.P, "max_wins": op._w,
             "windows": len(got), "run_s": dt, "tuples_per_s": WIN_BATCHES * BATCH / dt,
             "state_mib": state_bytes / 2 ** 20,
             "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
             "launches_apply": applied, "launches_flush": flushed, "flush_calls": calls})
        if got != want or v_.dtype != np.float32:
            bad = sorted(set(got.items()) ^ set(want.items()))[:5]
            raise AssertionError(f"keyed_cb: windows differ from the numpy oracle: {bad}")
        if op.P != KEYED_CB_P or op._w != -(-BATCH // WIN_SLIDE) + 64 or op.global_time:
            raise AssertionError(f"keyed_cb geometry: P={op.P}, W={op._w}")
        expect_launches("keyed_cb apply", applied, KEYED_CB_APPLY, WIN_BATCHES)
        expect_launches("keyed_cb flush", flushed, {}, calls)
        runs[k] = (parts, (applied, flushed), pipe.chain.graphs)
        del pipe, op
    check_dispatch(np, "keyed_cb", k_on, WIN_BATCHES, runs[None][:2], runs[k_on][:2],
                   runs[k_on][2])
    applied = runs[None][1][0]
    del runs

    def make():
        src, ops = KB.make_keyed_cb((2 + WIN_STEPS + PROFILE_STEPS) * BATCH)
        return src, wt.CompiledChain(ops, src.payload_spec(), batch_capacity=BATCH)

    def check(states, out, steps_run):
        fired = int(out.sum())           # 4 windows a key a step
        if fired != WIN_KEYS * (BATCH // WIN_KEYS // WIN_SLIDE):
            raise AssertionError(f"keyed_cb loop: {fired} windows in a step")
        if int(states[0].count.sum()) != steps_run * BATCH:
            raise AssertionError("keyed_cb loop: per-key counts do not add up")
        return {"windows_per_step": fired,
                "state_mib": sum(t.numel() * t.element_size()
                                 for t in flat_tensors(states[0])) / 2 ** 20}
    window_loop(torch, registry, "keyed_cb", make, KEYED_CB_APPLY, card, profile, check)
    torch.cuda.empty_cache()
    return applied


def flat_tensors(tree):
    """The tensors of a state (dataclasses, dicts, lists)."""
    from windflow_tpu_torch.runtime.graphs import leaves
    return [t for t in leaves(tree) if hasattr(t, "numel")]


def stateful_rows():
    """A Sink collecting (id, payload) of every live lane."""
    parts = []

    def cb(view):
        if view is not None:
            parts.append((view["id"], view["payload"]))
    return parts, cb


def keyed_stateful_phase(torch, np, wt, registry, card, profile):
    """bench_keyed_stateful at K = 1, 500 and 10,000 (Accumulator of max(K, 8)
    keys -> ReduceSink) at batch 2^20: Pipeline.run of 4 batches dispatch off
    and at K = 2, every tuple's running sum against the float64 oracle
    within STATEFUL_TOL and the two runs byte for byte, exact launches; the
    float32 and int32 streams for 2 batches byte for byte against the CPU
    port (int32 also against the wrapped numpy oracle); then the captured
    and eager loops."""
    from windflow_tpu_torch.benchmarks import keyed as KB

    k_on = DISPATCH_K["keyed_stateful"]
    total = STATEFUL_BATCHES * BATCH
    launches_all = dict.fromkeys(registry.KERNELS, 0)
    for K in STATEFUL_KEYS:
        want = KB.keyed_stateful_oracle(K, total)
        i = np.arange(total)
        batch_total = np.bincount(i // BATCH, weights=(i % 1000).astype(np.float64))
        runs = {}
        for k in (None, k_on):
            parts, cb = stateful_rows()
            src, ops = KB.make_keyed_stateful(K, total)
            pipe = wt.Pipeline(src, ops, wt.Sink(cb), batch_size=BATCH, dispatch=k or False)
            launches, dt, peak = run_pipeline(torch, registry, pipe, k)
            ids = np.concatenate([p[0] for p in parts])
            got = np.concatenate([p[1] for p in parts]).astype(np.float64)
            err = np.abs(got - want[ids])
            scale = batch_total[ids // BATCH] + np.abs(want[ids])
            res = float(pipe.chain.result()["keyed_stateful_total"])
            log({"phase": "keyed_stateful_pipeline", "keys": K, "dispatch": k,
                 "batches": STATEFUL_BATCHES, "batch": BATCH, "run_s": dt,
                 "tuples_per_s": total / dt, "launches": launches,
                 "peak_mib": peak / 2 ** 20, "lanes": int(ids.size),
                 "max_abs_err": float(err.max()),
                 "max_err_over_scale": float((err / scale).max()),
                 "tolerance": STATEFUL_TOL, "total": res,
                 "total_rel_err": abs(res - float(want.sum())) / float(want.sum())})
            if ids.size != total or not np.array_equal(np.sort(ids), i):
                raise AssertionError(f"keyed_stateful K={K}: lanes missing")
            if bool((err > STATEFUL_TOL * scale).any()):
                raise AssertionError(f"keyed_stateful K={K}: sums beyond the tolerance")
            expect_launches(f"keyed_stateful K={K}", launches, keyed_stateful_apply(K),
                            STATEFUL_BATCHES)
            runs[k] = (parts, launches, pipe.chain.graphs)
            del pipe
        check_dispatch(np, f"keyed_stateful_K{K}", k_on, STATEFUL_BATCHES, runs[None][:2],
                       runs[k_on][:2], runs[k_on][2])
        for name, n in runs[None][1].items():
            launches_all[name] += n
        del runs
        # the card against the CPU port, byte for byte: every tuple's sum in
        # float32 (the prefix sums in one fixed order on both) and int32 (also
        # equal to the wrapped oracle); the ReduceSink's total too for int32
        # (torch.sum adds floats in another order on the CPU)
        n_cpu = STATEFUL_CPU_BATCHES * BATCH
        wrapped = KB.keyed_stateful_oracle(K, n_cpu).astype(np.int64).astype(np.int32)
        for dtype in (torch.float32, torch.int32):
            outs = {}
            for dev in ("cuda", "cpu"):
                parts, cb = stateful_rows()
                src, ops = KB.make_keyed_stateful(K, n_cpu, dtype=dtype, device=dev)
                res = wt.Pipeline(src, ops, wt.Sink(cb, device=dev), batch_size=BATCH,
                                  device=dev).run()
                outs[dev] = (parts, res["keyed_stateful_total"].cpu().numpy())
            ids = np.concatenate([p[0] for p in outs["cuda"][0]])
            cmp = (lambda o: o) if dtype == torch.int32 else (lambda o: o[0])  # noqa: E731
            same = flat_bytes(np, cmp(outs["cuda"])) == flat_bytes(np, cmp(outs["cpu"]))
            exact = (dtype != torch.int32 or np.array_equal(
                np.concatenate([p[1] for p in outs["cuda"][0]]), wrapped[ids]))
            log({"phase": "keyed_stateful_card_vs_cpu", "keys": K, "dtype": str(dtype),
                 "batches": STATEFUL_CPU_BATCHES, "card_equals_cpu": same,
                 "int32_equals_oracle": exact})
            if not (same and exact):
                raise AssertionError(f"keyed_stateful {dtype} K={K}: card, CPU or oracle differ")
            del outs

        def make(K=K):
            src, ops = KB.make_keyed_stateful(K, (2 + WIN_STEPS + PROFILE_STEPS) * BATCH)
            return src, wt.CompiledChain(ops, src.payload_spec(), batch_capacity=BATCH)

        def check(states, out, steps_run):
            if int(out.sum()) != BATCH:
                raise AssertionError("keyed_stateful loop: lanes lost")
            return {"keys": K}
        window_loop(torch, registry, f"keyed_stateful_K{K}", make, keyed_stateful_apply(K),
                    card, profile, check)
        torch.cuda.empty_cache()
    return launches_all


def keyed_small_phase(torch, np, wt, registry):
    """The other keyed operators at small depth on the card, each against the
    CPU port (itself held to the JAX package by the CPU tests): KeyedMap with
    duplicate keys, and under max_key_multiplicity=1 captured (dispatch = 2);
    a KeyedMap without the promise under dispatch, which must raise naming
    the host read; FlatMap word counts (dispatch off and 2); general
    ReduceSink combines (dispatch off and 2); per-key TB Key_FFAT with
    lateness; CB Key_FFAT max and the 2x2 matrix product (rtol = atol =
    1e-4); an Accumulator with the max combine."""
    def run(dev, make_src, make_ops, batch, dispatch=False):
        rows = []

        def cb(view):
            if view is not None:
                rows.append((view["key"], view["id"], view["payload"]))
        res = wt.Pipeline(make_src(dev), make_ops(dev), wt.Sink(cb, device=dev),
                          batch_size=batch, device=dev, dispatch=dispatch).run()
        return rows, {k: v.cpu().numpy() for k, v in res.items()}

    def cursor_check(case, make_src, make_ops, batch, steps=4):
        """``steps`` steps of ``device_cursor_step`` (captured at its second
        call) against the eager step on a fresh chain: every state tensor
        byte for byte."""
        from windflow_tpu_torch.benchmarks import device_cursor_step
        finals = []
        for captured in (True, False):
            src = make_src("cuda")
            chain = wt.CompiledChain(make_ops("cuda"), src.payload_spec(), batch_capacity=batch)
            step = (device_cursor_step(chain, src, batch) if captured
                    else eager_cursor_step(src, chain, batch))
            states = tuple(chain.states)
            cur = torch.zeros((), dtype=torch.int32, device="cuda")
            for _ in range(steps):
                states, cur, _ = step(states, cur)
            if captured:
                graph = step.graph
            finals.append(flat_bytes(np, [t.cpu().numpy() for t in flat_tensors(states)]))
        ok = finals[0] == finals[1] and graph.replays == steps - 1
        log({"phase": "keyed_small", "case": case, "cursor_step_captured": ok,
             "graph_launches": graph.launches})
        if not ok:
            raise AssertionError(f"keyed_small [{case}]: the captured step differs")

    def compare_runs(case, make_src, make_ops, batch, dispatch=(False,), tol=None):
        if 2 in dispatch:
            cursor_check(case, make_src, make_ops, batch)
        registry.reset_launches()
        want = run("cpu", make_src, make_ops, batch)
        for d in dispatch:
            got = run("cuda", make_src, make_ops, batch, d)
            if tol is None:
                ok = flat_bytes(np, got) == flat_bytes(np, want)
            else:       # the same windows; values within the tolerance
                ok = len(got[0]) == len(want[0]) and all(
                    np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    and np.allclose(a[2], b[2], rtol=tol, atol=tol)
                    for a, b in zip(got[0], want[0]))
            log({"phase": "keyed_small", "case": case, "dispatch": d, "rows": len(got[0]),
                 "equal_to_cpu": ok, "tolerance": tol,
                 "launches": {k: n for k, n in registry.launch_counts().items() if n}})
            if not ok or not got[0] and not got[1]:
                raise AssertionError(f"keyed_small [{case}]: the card differs from the CPU")

    src_k = lambda K, total: lambda dev: wt.Source(  # noqa: E731
        lambda i: {"v": (i % 13).float()}, total=total, num_keys=K, device=dev)
    compare_runs("keyed_map_duplicates", src_k(4, 600), lambda dev: [wt.KeyedMap(
        lambda t, st: ({"n": st + t.v}, st + t.v), 0.0, num_keys=4, device=dev)], 64)
    compare_runs("keyed_map_promise_captured", src_k(64, 640), lambda dev: [wt.KeyedMap(
        lambda t, st: ({"n": st + t.v}, st + t.v), 0.0, num_keys=64,
        max_key_multiplicity=1, device=dev)], 64, dispatch=(False, 2))
    counter = lambda dev: [wt.KeyedMap(lambda t, st: ({"n": st + 1}, st + 1), 0,  # noqa: E731
                                       num_keys=4, device=dev)]
    refused = {}
    for how in ("dispatch", "cursor_step"):
        try:
            if how == "dispatch":
                run("cuda", src_k(4, 600), counter, 64, 2)
            else:
                cursor_check("keyed_map_no_promise", src_k(4, 600), counter, 64)
        except RuntimeError as e:
            refused[how] = "host read" in str(e) and "max_rank" in str(e)
        else:
            refused[how] = False
    log({"phase": "keyed_small", "case": "keyed_map_capture_refused", "refused": refused})
    if not all(refused.values()):
        raise AssertionError("a KeyedMap without max_key_multiplicity=1 ran captured")

    def words(dev):
        return wt.Source(lambda i: {"w": torch.stack([(i * 7) % 50, (i * 13) % 50,
                                                      (i * 29) % 50])},
                         total=3000, device=dev)

    def split(t, shipper):
        for j in range(3):
            shipper.push({"word": t.w[j]}, key=t.w[j])
    compare_runs("flatmap_wordcount", words, lambda dev: [
        wt.FlatMap(split, max_fanout=3, device=dev),
        wt.Accumulator(lambda t: t.data["word"] * 0 + 1, init_value=0, num_keys=50,
                       device=dev)], 256, dispatch=(False, 2))
    compare_runs("reduce_sink_general", src_k(1, 5000), lambda dev: [
        wt.ReduceSink(lambda t: (t.v * 7).int(), combine=torch.bitwise_xor, name="xor",
                      device=dev),
        wt.ReduceSink(lambda t: t.v, combine=lambda a, b: torch.maximum(a, b),
                      identity=-1e30, name="max", device=dev)], 512, dispatch=(False, 2))
    TB = wt.win_type_t.TB
    compare_runs("key_ffat_per_key_tb_lateness", lambda dev: wt.Source(
        lambda i: {"v": ((i * 17) % 23).float()}, total=3000, num_keys=3,
        ts_fn=lambda i: torch.clamp(i - (i * 7) % 10, min=0), device=dev),
        lambda dev: [wt.Key_FFAT(lambda t: t.v, torch.add,
                                 spec=wt.WindowSpec(16, 8, TB, delay=2), num_keys=3,
                                 global_time=False, device=dev)], 128, dispatch=(False, 2))
    compare_runs("key_ffat_cb_max", src_k(2, 3000), lambda dev: [wt.Key_FFAT(
        lambda t: t.v, torch.maximum, spec=wt.WindowSpec(4, 2), identity=-1e30,
        num_keys=2, device=dev)], 256, dispatch=(False, 2))

    def shear(t):
        one = t.v * 0 + 1
        return torch.stack([torch.stack([one, t.v]), torch.stack([t.v * 0.5, one])])
    compare_runs("key_ffat_cb_matmul", lambda dev: wt.Source(
        lambda i: {"v": (i % 5).float() * 0.1}, total=960, num_keys=2, device=dev),
        lambda dev: [wt.Key_FFAT(shear, lambda a, b: torch.einsum("...ij,...jk->...ik", a, b),
                                 spec=wt.WindowSpec(8, 4), identity=torch.eye(2),
                                 num_keys=2, device=dev)], 64, tol=1e-4)
    compare_runs("accumulator_max", src_k(4, 3000), lambda dev: [wt.Accumulator(
        lambda t: t.v, combine=torch.maximum, identity=-1e30, init_value=-1e30,
        num_keys=4, device=dev)], 256, dispatch=(False, 2))


# ------------------------------------------------------------- threaded phases

THREADED_BATCHES = 40     # bench.py::bench_ysb: 40 batches of 2^20
THREADED_K = 4            # scan dispatch of the threaded phases
#: the YSB stream as AoS records: 16 B a record, 16 MiB a batch of 2^20
YSB_RECORD = [("ad_id", "<i4"), ("event_type", "<i4"), ("campaign", "<i4"), ("ts", "<i4")]
HANDOFF_SLEEP_CYCLES = 200_000_000   # the producer stream's deliberate delay


def ysb_segments(ysb):
    """The YSB chain at bench_ysb's geometry cut into two segments:
    [Filter, BatchMap join] and [KeyBy, Key_FFAT]."""
    ops = ysb.make_ops(**ysb.bench_geometry(BATCH))
    return [ops[:2], ops[2:]]


def counted_run(torch, registry, prepare, run):
    """``prepare()`` (chain builds, warm-up steps and captures, outside the
    count), then ``run()`` with the launches counted from zero: (launches,
    seconds, peak device bytes the run allocated above what was allocated
    when it started)."""
    prepare()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    registry.reset_launches()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (registry.launch_counts(), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def profile_run(torch, phase, run, unprofiled_s):
    """torch.profiler over one whole run: the device's busy time (summed over
    every stream, so overlapping stages can add up past the wall time)
    against the unprofiled run's time gives the idle share."""
    from torch.profiler import ProfilerActivity, profile as prof
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        run()
        torch.cuda.synchronize()
    kern = [e for e in p.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.device_time_total for e in kern) / 1e3
    log({"phase": f"{phase}_profile", "kernels": sum(e.count for e in kern),
         "device_busy_ms": busy_ms, "unprofiled_ms": unprofiled_s * 1e3,
         "idle_share": 1 - busy_ms / (unprofiled_s * 1e3)})


def threaded_ysb_phase(torch, np, wt, ysb, registry, card, profile):
    """YSB at bench_ysb's geometry (40 batches of 2^20) through the serial
    Pipeline and through ``ThreadedPipeline(src, [[Filter, join], [KeyBy,
    Key_FFAT]], sink)``, each eager and at dispatch K = 4: every run's sink
    rows byte for byte equal to the serial eager run's and to the dense
    oracle, K1 and K2 once a batch and nothing else launched; tuples/s, ms a
    batch and peak device memory of each. Returns the threaded eager run's
    launches and the serial rows."""
    total = THREADED_BATCHES * BATCH
    rows, times, launch_of = {}, {}, {}
    expect = dict.fromkeys(registry.KERNELS, 0)
    expect.update(histogram=THREADED_BATCHES, lookup=THREADED_BATCHES)
    for driver in ("serial", "threaded"):
        for k in (None, THREADED_K):
            parts, cb = collect_sink()
            src = ysb.make_source(total)
            if driver == "serial":
                pipe = wt.Pipeline(src, ysb.make_ops(**ysb.bench_geometry(BATCH)),
                                   wt.Sink(cb), batch_size=BATCH, dispatch=k or False)

                def prepare(pipe=pipe, k=k):
                    if k:
                        pipe.chain.warm_scan(k, BATCH)
            else:
                pipe = wt.ThreadedPipeline(src, ysb_segments(ysb), wt.Sink(cb),
                                           batch_size=BATCH, dispatch=k or False)
                prepare = pipe.start
            launches, dt, peak = counted_run(torch, registry, prepare, pipe.run)
            rows[(driver, k)] = parts
            if (driver, k) == ("serial", None):
                # the first run against the oracle, every run against it byte for byte
                if as_dict(np, parts) != ysb.dense_oracle(total):
                    raise AssertionError("threaded_ysb serial: counts differ from the "
                                         "dense oracle")
                serial_bytes = flat_bytes(np, parts)
            same = flat_bytes(np, parts) == serial_bytes
            graphs = ({f"{kk}": g.replays for (_, kk, _), g in pipe.chain.graphs.items()}
                      if driver == "serial" else
                      [{f"{kk}": g.replays for (_, kk, _), g in c.graphs.items()}
                       for c in pipe.chains])
            log({"phase": "threaded_ysb", "driver": driver, "dispatch": k,
                 "batches": THREADED_BATCHES, "batch": BATCH, "card": card,
                 "windows": sum(len(p[0]) for p in parts), "run_s": dt,
                 "tuples_per_s": total / dt,
                 "ms_per_batch": dt / THREADED_BATCHES * 1e3, "launches": launches,
                 "graph_replays": graphs, "peak_mib_above_start": peak / 2 ** 20,
                 "rows_equal_serial_bytes": same})
            if not same:
                raise AssertionError(f"threaded_ysb {driver} K={k}: rows differ from the "
                                     f"serial Pipeline's")
            if launches != expect:
                raise AssertionError(f"threaded_ysb {driver} K={k}: launches {launches}")
            times[(driver, k)] = dt
            launch_of[(driver, k)] = launches
    log({"phase": "threaded_ysb_ratio", "card": card,
         "threaded_over_serial_eager": times[("threaded", None)] / times[("serial", None)],
         "threaded_over_serial_k4": (times[("threaded", THREADED_K)]
                                     / times[("serial", THREADED_K)])})
    if profile:
        threaded_ysb_threads(torch, np, wt, ysb, registry, card, rows[("serial", None)])
        for k in (None, THREADED_K):
            tp = wt.ThreadedPipeline(ysb.make_source(total), ysb_segments(ysb),
                                     wt.Sink(lambda v: None), batch_size=BATCH,
                                     dispatch=k or False)
            tp.start()
            profile_run(torch, f"threaded_ysb_k{k or 1}", tp.run, times[("threaded", k)])
    return launch_of[("threaded", None)], rows[("serial", None)]


def threaded_ysb_threads(torch, np, wt, ysb, registry, card, serial_parts):
    """Where the threaded eager YSB run's host time goes (``--profile``):
    each stage thread's CPU seconds against its wall seconds, pinned,
    unpinned and with one segment, and the serial Pipeline's process CPU
    seconds; every threaded variant's rows byte for byte the serial
    run's."""
    total = THREADED_BATCHES * BATCH
    for variant, segs, pin in (("two_segments_pinned", ysb_segments(ysb), True),
                               ("two_segments_unpinned", ysb_segments(ysb), False),
                               ("one_segment_pinned",
                                [[op for seg in ysb_segments(ysb) for op in seg]], True)):
        parts, cb = collect_sink()
        tp = wt.ThreadedPipeline(ysb.make_source(total), segs, wt.Sink(cb),
                                 batch_size=BATCH, pin=pin)
        stages = {}

        def timed(body, name, stages=stages):
            def run(*a):
                c0, w0 = time.thread_time(), time.perf_counter()
                try:
                    body(*a)
                finally:
                    stages[name] = {"cpu_s": time.thread_time() - c0,
                                    "wall_s": time.perf_counter() - w0}
            return run
        tp._source_body = timed(tp._source_body, "source")
        tp._sink_body = timed(tp._sink_body, "sink")
        seg = tp._segment_body
        tp._segment_body = lambda i, core, stream, seg=seg: timed(seg, f"seg{i}")(
            i, core, stream)
        c0 = time.process_time()
        _, dt, _ = counted_run(torch, registry, tp.start, tp.run)
        same = flat_bytes(np, parts) == flat_bytes(np, serial_parts)
        log({"phase": "threaded_ysb_threads", "variant": variant, "card": card,
             "run_s": dt, "ms_per_batch": dt / THREADED_BATCHES * 1e3,
             "process_cpu_s": time.process_time() - c0, "stages": stages,
             "rows_equal_serial_bytes": same})
        if not same:
            raise AssertionError(f"threaded_ysb_threads {variant}: rows differ from the "
                                 f"serial Pipeline's")
    parts, cb = collect_sink()
    pipe = wt.Pipeline(ysb.make_source(total), ysb.make_ops(**ysb.bench_geometry(BATCH)),
                       wt.Sink(cb), batch_size=BATCH)
    c0 = time.process_time()
    _, dt, _ = counted_run(torch, registry, lambda: None, pipe.run)
    log({"phase": "threaded_ysb_threads", "variant": "serial", "card": card, "run_s": dt,
         "ms_per_batch": dt / THREADED_BATCHES * 1e3,
         "process_cpu_s": time.process_time() - c0})


def record_ysb_phase(torch, np, wt, ysb, registry, card, want_parts, want_launches):
    """The same YSB stream as AoS records (int32 ad_id, event_type, campaign,
    ts: 16 B a record), packed once with ``pack_records`` from the
    DeviceSource's columns, through ``RecordSource(key_field="campaign",
    ts_field="ts")`` at framing_workers 1 and hardware_concurrency(),
    prefetch 0 and 3, into the threaded YSB chain (and once at dispatch
    K = 4): the rows byte for byte equal to threaded_ysb's, the same
    launches; the framing ms a batch alone, the host-to-device bytes and
    tuples/s of each form."""
    from windflow_tpu_torch import native
    total = THREADED_BATCHES * BATCH
    dt_rec = np.dtype(YSB_RECORD)
    t0 = time.perf_counter()
    recs = ysb_records(np, ysb, total)
    pack_s = time.perf_counter() - t0
    hc = native.hardware_concurrency()

    def source(workers):
        return wt.RecordSource(lambda: iter(recs), dt_rec, key_field="campaign",
                               ts_field="ts", framing_workers=workers)
    framing = {}
    for workers in (1, hc):
        src = source(workers)
        t0 = time.perf_counter()
        n = sum(1 for _ in src._host_batches(BATCH))
        framing[workers] = (time.perf_counter() - t0) / n * 1e3
    log({"phase": "record_ysb_framing", "card": card, "record_bytes": dt_rec.itemsize,
         "batch_mib": BATCH * dt_rec.itemsize / 2 ** 20, "pack_s": pack_s,
         "hardware_concurrency": hc,
         "framing_ms_per_batch": {f"{w}": ms for w, ms in framing.items()}})
    first = first_ms = None
    for workers, prefetch, k in ((1, 0, None), (1, 3, None), (hc, 0, None), (hc, 3, None),
                                 (hc, 3, THREADED_K)):
        parts, cb = collect_sink()
        src = source(workers)
        tp = wt.ThreadedPipeline(src, ysb_segments(ysb), wt.Sink(cb), batch_size=BATCH,
                                 prefetch=prefetch, dispatch=k or False)
        launches, dt, peak = counted_run(torch, registry, tp.start, tp.run)
        same = flat_bytes(np, parts) == flat_bytes(np, want_parts)
        h2d = src.get_StatsRecords()[0].bytes_copied_hd
        log({"phase": "record_ysb", "card": card, "framing_workers": workers,
             "prefetch": prefetch, "dispatch": k, "batches": THREADED_BATCHES,
             "run_s": dt, "tuples_per_s": total / dt,
             "ms_per_batch": dt / THREADED_BATCHES * 1e3, "h2d_bytes": h2d,
             "h2d_bytes_per_batch": h2d / THREADED_BATCHES, "launches": launches,
             "peak_mib_above_start": peak / 2 ** 20, "rows_equal_threaded_ysb_bytes": same})
        if not same:
            raise AssertionError(f"record_ysb workers={workers} prefetch={prefetch} "
                                 f"K={k}: rows differ from threaded_ysb's")
        if launches != want_launches:
            raise AssertionError(f"record_ysb: launches {launches}, threaded_ysb "
                                 f"{want_launches}")
        first = first or launches
        first_ms = first_ms or dt / THREADED_BATCHES * 1e3
    return first, first_ms


def ysb_records(np, ysb, total):
    """The YSB stream of ``total`` events as packed AoS records
    (``YSB_RECORD``, 16 B each), one array of ``BATCH`` records a batch."""
    from windflow_tpu_torch import native
    dt_rec = np.dtype(YSB_RECORD)
    recs = []
    for b in ysb.make_source(total).batches(BATCH):
        h = b.to_host()
        recs.append(native.pack_records({"ad_id": h["payload"]["ad_id"],
                                         "event_type": h["payload"]["event_type"],
                                         "campaign": h["key"], "ts": h["ts"]}, dt_rec))
    return recs


def merge_graph(torch, wt, mode, total, keys, batch, cb):
    """graph_windows' split and branches with a merge in ``mode`` straight
    into a Sink: the merged stream itself, which a DETERMINISTIC merge
    releases in one order whatever the threads do, and a DEFAULT merge in
    a free interleave (so that one is compared sorted)."""
    g = wt.PipeGraph(f"graph_{mode.name.lower()}", mode=mode, batch_size=batch)
    mp = g.add_source(wt.DeviceSource(lambda i: {"v": (i % 97).to(torch.float32)},
                                      total=total, num_keys=keys))
    mp.split(lambda t: (t.id % 3).to(torch.int32), 3)
    b0 = mp.select(0).chain(wt.Map(lambda t: {"v": t.v + 0.0}, name="b0"))
    b1 = mp.select(1).chain(wt.Map(lambda t: {"v": t.v * 1.0}, name="b1"))
    mp.select(2).add(wt.ReduceSink(lambda t: torch.ones((), dtype=torch.int32),
                                   name="rest"))
    b0.merge(b1).add_sink(wt.Sink(cb))
    return g


def threaded_graph_windows_phase(torch, np, wt, registry, card, serial_rows,
                                 serial_launches, serial_s):
    """graph_windows at full width with ``run(threaded=True)``, eager and at
    dispatch K = 4: every window against the serial run's and the numpy
    oracle (each window's sum exact; the emission order across batches
    follows the release chunks, which the threads' interleave moves); the
    launches exact per Win_Seq apply (K2, K3, K6 once, K6 once a flush
    call) and K4 as the Ordering_Node called it, next to the serial run's;
    ms a push against the serial graph; K4's count and the ReduceSink's
    host-constant count equal the serial run's. Then the merge straight
    into a Sink, serial and threaded: in DETERMINISTIC mode the merged
    rows, in delivery order, equal the serial run's byte for byte; in
    DEFAULT mode they equal once sorted, and equal the input's."""
    from windflow_tpu_torch.ops import bitonic as B
    want = graph_windows_oracle(np, GW_TOTAL, WIN_KEYS, WIN_LEN, WIN_SLIDE)
    pushes = GW_TOTAL // GW_BATCH
    first = None
    for k in (None, THREADED_K):
        parts, cb = collect_sink()
        g, mp, m = graph_windows(torch, wt, GW_TOTAL, WIN_KEYS, WIN_LEN, WIN_SLIDE,
                                 GW_BATCH, cb, dispatch=k or False)
        op = m.ops[0]
        inner, flushes = op.flush, []

        def flush(state, inner=inner, flushes=flushes):
            flushes.append(1)
            return inner(state)
        op.flush = flush
        res = {}
        try:
            launches, dt, peak = counted_run(torch, registry,
                                             lambda g=g: g.start(threaded=True),
                                             lambda g=g, res=res: res.update(g.wait_end()))
        finally:
            del op.flush
        got = as_dict(np, parts)
        node = m._ordering
        calls, cuda_launches = k4_launches(B, node.networks)
        applies = m._chain._push_count
        expect = dict.fromkeys(registry.KERNELS, 0)
        expect.update(lookup=applies, segment_fold=applies, ordering_merge=calls,
                      masked_window_reduce=applies + len(flushes))
        log({"phase": "threaded_graph_windows", "dispatch": k, "card": card,
             "batch": GW_BATCH, "tuples": GW_TOTAL, "windows": len(got), "run_s": dt,
             "ms_per_push": dt / pushes * 1e3, "serial_ms_per_push": serial_s / pushes * 1e3,
             "tuples_per_s": GW_TOTAL / dt, "win_seq_applies": applies,
             "flush_calls": len(flushes), "rest": int(res["rest"]), "k4_calls": calls,
             "k4_cuda_launches": cuda_launches,
             "launches": launches, "serial_launches": serial_launches,
             "launches_equal_serial": launches == serial_launches,
             "peak_mib_above_start": peak / 2 ** 20})
        if got != want or got != serial_rows:
            raise AssertionError(f"threaded_graph_windows K={k}: windows differ from the "
                                 f"serial run's or the oracle")
        if launches != expect:
            raise AssertionError(f"threaded_graph_windows K={k}: launches {launches}, "
                                 f"expected {expect}")
        if launches["ordering_merge"] != serial_launches["ordering_merge"]:
            raise AssertionError(f"threaded_graph_windows K={k}: K4 launched "
                                 f"{launches['ordering_merge']} times, serially "
                                 f"{serial_launches['ordering_merge']}")
        if int(res["rest"]) != len(range(2, GW_TOTAL, 3)):
            raise AssertionError(f"threaded_graph_windows K={k}: branch 2's count is wrong")
        first = first or launches

    def rows_cb(parts):
        def cb(view):
            if view is not None:
                parts.append((view["id"], view["key"], view["ts"], view["payload"]["v"]))
        return cb
    i = np.arange(GW_TOTAL, dtype=np.int32)
    i = i[i % 3 != 2]
    want_cols = [i, i % WIN_KEYS, i, (i % 97).astype(np.float32)]
    for mode in (wt.Mode.DETERMINISTIC, wt.Mode.DEFAULT):
        merged = {}
        for threaded in (False, True):
            parts = []
            g = merge_graph(torch, wt, mode, GW_TOTAL, WIN_KEYS, GW_BATCH, rows_cb(parts))
            t0 = time.perf_counter()
            g.run(threaded=threaded)
            torch.cuda.synchronize()
            merged[threaded] = ([np.concatenate(x) for x in zip(*parts)],
                                time.perf_counter() - t0)
        rows = {t: cols for t, (cols, _) in merged.items()}
        if mode == wt.Mode.DEFAULT:
            rows = {t: [c[np.argsort(cols[0], kind="stable")] for c in cols]
                    for t, cols in rows.items()}
        same = all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                   for a, b in zip(rows[True], rows[False]))
        ok = len(rows[True][0]) == len(i) and (
            mode != wt.Mode.DEFAULT or all(a.dtype == b.dtype and np.array_equal(a, b)
                                           for a, b in zip(rows[True], want_cols)))
        log({"phase": "threaded_graph_merge", "mode": mode.name, "card": card,
             "tuples": GW_TOTAL, "merged_rows": len(rows[True][0]),
             "serial_s": merged[False][1], "threaded_s": merged[True][1],
             "compared": "sorted" if mode == wt.Mode.DEFAULT else "delivery order",
             "rows_equal_serial_bytes": same, "rows_as_input": ok})
        if not (same and ok):
            raise AssertionError(f"threaded_graph_merge {mode.name}: merged rows differ")
    return first


def handoff_phase(torch, wt):
    """A batch written on a producer stream after a deliberate device sleep
    (``torch.cuda._sleep``), handed to a consumer stream through
    ``runtime/handoff.py`` and copied there: the copy's bytes equal what
    the producer wrote, while the host spent far less than the sleep in
    the hand-off (the wait is the consumer stream's, not the host's)."""
    from windflow_tpu_torch.batch import Batch
    from windflow_tpu_torch.runtime import handoff
    n = BATCH
    prod, cons = torch.cuda.Stream(), torch.cuda.Stream()
    i = torch.arange(n, dtype=torch.int32, device="cuda")
    want = [i % 100, i, i // 10, i % 3 == 0, i.to(torch.float32) * 0.5]
    # every allocation made before the sleep: a cudaMalloc could wait for it
    with torch.cuda.stream(prod):
        b = Batch(key=torch.zeros_like(i), id=torch.zeros_like(i), ts=torch.zeros_like(i),
                  payload={"v": torch.zeros(n, dtype=torch.float32, device="cuda")},
                  valid=torch.zeros(n, dtype=torch.bool, device="cuda"))
    with torch.cuda.stream(cons):
        copies = [torch.empty_like(t) for t in handoff.batch_tensors(b)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.cuda.stream(prod):
        torch.cuda._sleep(HANDOFF_SLEEP_CYCLES)
        for t, w in zip(handoff.batch_tensors(b), want):
            t.copy_(w)
        item = handoff.send(b)
    with torch.cuda.stream(cons):
        got = handoff.receive(item)
        for c, t in zip(copies, handoff.batch_tensors(got)):
            c.copy_(t)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(_bits(torch, a), _bits(torch, w)) for a, w in zip(copies, want))
    log({"phase": "handoff", "lanes": n, "sleep_cycles": HANDOFF_SLEEP_CYCLES,
         "host_ms_to_queue_both_sides": host_ms, "wall_ms_to_result": wall_ms,
         "bytes_equal_producer": same})
    if not same:
        raise AssertionError("handoff: the consumer read other bytes than the producer wrote")
    if host_ms > wall_ms / 2:
        raise AssertionError("handoff: the host waited for the producer's sleep")


def ring_phase(card):
    """``queue_selfbench``: tokens/s through one native SPSC ring between two
    unpinned threads of the card's host, the fastest of 16 slices by the
    threads' CPU time (the counterpart of bench.py::bench_native_ring)."""
    from windflow_tpu_torch import native
    rates = [native.queue_selfbench(2_000_000, 1024) for _ in range(3)]
    log({"phase": "ring", "card": card, "tokens": 2_000_000, "capacity": 1024,
         "tokens_per_s": rates, "hardware_concurrency": native.hardware_concurrency(),
         "library": native.build().name})
    if min(rates) <= 0:
        raise AssertionError("ring: the selfbench moved no tokens")


# ------------------------------------------------------------- supervised phases

SUP_EVERY = 2             # supervised_ysb: a checkpoint every 2 batches
SUP_K = 3                 # its scan dispatch; a commit flushes the accumulator,
#                           so the groups hold SUP_EVERY batches
SUP_BACKOFF = {"backoff_base": 0.001, "backoff_cap": 0.01}
SUP_POISON = 3            # case (d)'s poison_threshold
SUP_STALL_S = 1.0         # case (c): the stall of one step
SUP_TIMEOUT_S = 0.5       # and the step watchdog
SUP_DIR = os.path.join(ROOT, "build", "supervised")
SUP_Q3_EVERY = 4          # supervised_q3: a checkpoint every 4 batches
SUP_GRAPH_EVERY = 4       # supervised_graph: a checkpoint every 4 root batches


def sup_case(F, case, k):
    """Plan and expectations of a ``supervised_ysb`` case over YSB_BATCHES =
    8 batches at dispatch ``k`` (None = off): the batches pushed (replays
    included), the restarts, the checkpoints ended without and with an
    error (``at_batch``: a commit every 2 batches, then the EOS commit after
    the flush, at 8 again), the dead-letter positions. A fused group fires
    ``chain.step`` at its head, so at K a fault meant for position p names
    the head of p's group."""
    head = (lambda p: p - p % SUP_EVERY) if k else (lambda p: p)
    once = lambda site, p, **kw: F.FaultSpec(site, where={"pos": p}, max_fires=1, **kw)  # noqa: E731
    if case == "none":
        return None, {"pushed": 8, "restarts": 0, "ok": [2, 4, 6, 8, 8], "err": [], "dead": []}
    if case == "errors":
        # the step holding batch 3 (a replay of batch 2 at dispatch off), the
        # second commit's first delivery, the read of batch 6 (nothing to replay)
        plan = F.FaultPlan([once("chain.step", head(3)), once("sink.consume", 4),
                            once("source.next", 6)], seed=11)
        return plan, {"pushed": 8 if k else 9, "restarts": 3, "ok": [2, 6, 8, 8], "err": [4],
                      "dead": []}
    if case == "stall":
        plan = F.FaultPlan([once("chain.step", head(5), kind="stall", stall_s=SUP_STALL_S)])
        return plan, {"pushed": 8 if k else 9, "restarts": 1, "ok": [2, 4, 6, 8, 8], "err": [],
                      "dead": []}
    plan = F.FaultPlan([F.FaultSpec("chain.step", where={"pos": 4}, max_fires=SUP_POISON)])
    return plan, {"pushed": 7, "restarts": SUP_POISON, "ok": [2, 4, 6, 8, 8], "err": [],
                  "dead": [4]}


def count_pushes(chain):
    """Count the batches ``chain`` takes through completed ``push`` and
    ``push_many`` calls (replays included): a dict whose ``n`` grows."""
    n = {"n": 0}
    push, push_many = chain.push, chain.push_many

    def counted_push(batch, from_op=0):
        out = push(batch, from_op=from_op)
        n["n"] += from_op == 0
        return out

    def counted_many(batches, from_op=0):
        outs = push_many(batches, from_op=from_op)
        n["n"] += len(outs) if from_op == 0 and len(outs) > 1 else 0
        return outs
    chain.push, chain.push_many = counted_push, counted_many
    return n


def journal_spans(records, event):
    """The end records of ``event``'s spans."""
    return [r for r in records if r["event"] == event and r.get("phase") == "end"]


def supervised_ysb_phase(torch, np, wt, ysb, registry, card, ysb_parts):
    """YSB at full width (8 x 2^20) through ``SupervisedPipeline`` with
    checkpoints every 2 batches, at dispatch off and K = 3, an EventJournal
    active, in four cases: (a) no plan; (b) a chain.step error at batch 3, a
    sink.consume error at the second commit and a source.next error at batch
    6; (c) a 1.0 s chain.step stall at batch 5 under a 0.5 s step watchdog,
    run on a side CUDA stream (the watchdog's worker must enter it); (d)
    poison at batch 4 for poison_threshold attempts, into a DeadLetterQueue.
    Each case: rows byte for byte equal to the ``ysb`` phase's plain rows
    ((d): the plain rows of the stream without batch 4), the restarts and
    dead letters the plan implies, K1 and K2 once a batch pushed (replays
    included) and nothing else, the checkpoint and restore spans the plan
    implies. Logs each restore's ``dur_s`` and the ``recovery_seconds``
    counter (the time to recover), the run's seconds against the plain
    Pipeline's, and the snapshot's bytes."""
    import shutil
    import tempfile
    from windflow_tpu_torch.observability import journal as J
    from windflow_tpu_torch.runtime import faults as F
    from windflow_tpu_torch.runtime.graphs import leaves

    if YSB_BATCHES != 8:
        raise AssertionError("supervised_ysb's expectations are written for 8 batches")
    total = YSB_BATCHES * BATCH
    make = lambda: (ysb.make_source(total), ysb.make_ops(**ysb.bench_geometry(BATCH)))  # noqa: E731
    # the plain Pipeline's seconds, dispatch off and at K, beside the supervised runs
    plain_s = {}
    for k in (None, SUP_K):
        src, ops = make()
        _, plain_s[k], _ = run_pipeline(torch, registry, wt.Pipeline(
            src, ops, wt.Sink(lambda v: None), batch_size=BATCH, dispatch=k or False), k)
    # case (d)'s reference: the plain chain over the stream without batch 4
    parts_d, cb_d = collect_sink()
    src, ops = make()
    chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=src.out_capacity(BATCH))
    sink = wt.Sink(cb_d)
    for i, b in enumerate(src.batches(BATCH)):
        if i != 4:
            sink.consume(chain.push(b))
    for out in chain.flush():
        sink.consume(out)
    del chain
    os.makedirs(os.path.dirname(SUP_DIR), exist_ok=True)
    jdir = tempfile.mkdtemp(prefix="journal-", dir=os.path.dirname(SUP_DIR))
    launches = dict.fromkeys(registry.KERNELS, 0)
    try:
        for case in ("none", "errors", "stall", "poison"):
            for k in (None, SUP_K):
                plan, want = sup_case(F, case, k)
                parts, cb = collect_sink()
                dlq = F.DeadLetterQueue() if case == "poison" else None
                src, ops = make()
                sp = wt.SupervisedPipeline(
                    src, ops, wt.Sink(cb), batch_size=BATCH, checkpoint_every=SUP_EVERY,
                    max_restarts=3, dispatch=k or False, faults=plan or False,
                    dead_letter=dlq, poison_threshold=SUP_POISON,
                    step_timeout=SUP_TIMEOUT_S if case == "stall" else None, **SUP_BACKOFF)
                pushed = count_pushes(sp.chain)
                path = os.path.join(jdir, f"{case}_{k}.jsonl")
                journal = J.EventJournal(path)
                side = torch.cuda.Stream() if case == "stall" else None

                def run():
                    J.set_active(journal)
                    try:
                        if side is None:
                            sp.run()
                        else:
                            side.wait_stream(torch.cuda.current_stream())
                            with torch.cuda.stream(side):
                                sp.run()
                            torch.cuda.current_stream().wait_stream(side)
                    finally:
                        J.set_active(None)
                        journal.close()
                F.reset_counters()
                counts, dt, peak = counted_run(torch, registry, sp.start, run)
                recs = J.read_journal(path)
                restores = journal_spans(recs, "restore")
                cks = journal_spans(recs, "checkpoint")
                ctr = F.counters()
                ref = parts_d if case == "poison" else ysb_parts
                same = flat_bytes(np, parts) == flat_bytes(np, ref)
                dead = [e["pos"] for e in dlq.entries] if dlq is not None else []
                snap_bytes = sum(x.numel() * x.element_size()
                                 for x in leaves(sp._snapshot()[0])
                                 if isinstance(x, torch.Tensor))
                log({"phase": "supervised_ysb", "case": case, "dispatch": k,
                     "batches": YSB_BATCHES, "batch": BATCH, "checkpoint_every": SUP_EVERY,
                     "plan": json.loads(plan.to_json()) if plan else None,
                     "restarts": sp.restarts, "pushed": pushed["n"], "dead_letters": dead,
                     "rows_byte_identical": same, "run_s": dt, "plain_run_s": plain_s[k],
                     "supervised_over_plain": dt / plain_s[k],
                     "restore_dur_s": [r["dur_s"] for r in restores],
                     "recovery_seconds": ctr["recovery_seconds"],
                     "backoff_seconds": ctr["backoff_seconds"],
                     "checkpoints": len(cks),
                     "checkpoint_dur_s": [r["dur_s"] for r in cks],
                     "snapshot_bytes": snap_bytes, "launches": counts,
                     "peak_mib": peak / 2 ** 20, "side_stream": side is not None,
                     "card": card})
                if not same:
                    raise AssertionError(f"supervised_ysb {case} K={k}: rows differ from "
                                         f"the plain run's")
                if (sp.restarts, pushed["n"], dead) != (want["restarts"], want["pushed"],
                                                        want["dead"]):
                    raise AssertionError(f"supervised_ysb {case} K={k}: restarts "
                                         f"{sp.restarts}, pushed {pushed['n']}, dead "
                                         f"{dead}, expected {want}")
                expect_launches(f"supervised_ysb {case} K={k}", counts,
                                {"histogram": 1, "lookup": 1}, pushed["n"])
                ok = [r["at_batch"] for r in cks if "error" not in r]
                err = [r["at_batch"] for r in cks if "error" in r]
                if ok != want["ok"] or err != want["err"] or len(restores) != sp.restarts:
                    raise AssertionError(f"supervised_ysb {case} K={k}: checkpoints {ok} "
                                         f"(errors at {err}), {len(restores)} restores, "
                                         f"expected {want}")
                if sp.restarts and not ctr["recovery_seconds"] > 0:
                    raise AssertionError(f"supervised_ysb {case}: no recovery_seconds")
                if case == "none" and k is None:
                    SUP_RUN_S["ysb"] = dt
                for kk, nn in counts.items():
                    launches[kk] += nn
                del sp, parts
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    return launches


def supervised_q3_phase(torch, np, wt, registry, card, q3_views):
    """Nexmark q3 (16 x 2^14) through ``SupervisedPipeline`` with a
    checkpoint every 4 batches and one chain.step error at batch 5 (batch 4
    is replayed): rows byte for byte equal to the ``nexmark`` phase's q3
    rows, one restart, K5 twice a batch pushed and nothing else."""
    from windflow_tpu_torch.nexmark import make_query
    from windflow_tpu_torch.runtime import faults as F

    plan = F.FaultPlan([F.FaultSpec("chain.step", where={"pos": 5}, max_fires=1)], seed=3)
    views = []
    src, ops = make_query("q3_enrich_join", NEX_BATCHES * NEX_BATCH)
    sp = wt.SupervisedPipeline(src, ops, wt.Sink(views.append), batch_size=NEX_BATCH,
                               checkpoint_every=SUP_Q3_EVERY, faults=plan, **SUP_BACKOFF)
    pushed = count_pushes(sp.chain)
    F.reset_counters()
    counts, dt, peak = counted_run(torch, registry, sp.start, sp.run)
    views = [v for v in views if v is not None]
    same = flat_bytes(np, views) == flat_bytes(np, q3_views)
    SUP_RUN_S["q3"] = dt
    log({"phase": "supervised_q3", "batches": NEX_BATCHES, "batch": NEX_BATCH,
         "checkpoint_every": SUP_Q3_EVERY, "restarts": sp.restarts, "pushed": pushed["n"],
         "rows_byte_identical": same, "run_s": dt,
         "recovery_seconds": F.counters()["recovery_seconds"], "launches": counts,
         "peak_mib": peak / 2 ** 20, "card": card})
    if not same:
        raise AssertionError("supervised_q3: rows differ from the nexmark phase's q3 rows")
    if sp.restarts != 1 or pushed["n"] != NEX_BATCHES + 1:
        raise AssertionError(f"supervised_q3: {sp.restarts} restarts, {pushed['n']} pushed")
    expect_launches("supervised_q3", counts, {"join_probe": 2}, pushed["n"])
    return counts


def supervised_graph_phase(torch, np, wt, registry, card, gw_parts, gw_s):
    """``graph_windows`` (phase 17) under ``run_supervised`` with a
    checkpoint every 4 root batches, a chain.step error at root batch 9 and
    a sink.consume error at the third delivery: the windows byte for byte
    equal to phase 17's in delivery order, two restarts, K2, K3 and K6 once
    a Win_Seq apply and K6 once a flush call (replays included), K4 as every
    Ordering_Node the run made called it."""
    from collections import Counter
    from windflow_tpu_torch.ops import bitonic as B
    from windflow_tpu_torch.runtime import faults as F

    parts, cb = collect_sink()
    g, mp, m = graph_windows(torch, wt, GW_TOTAL, WIN_KEYS, WIN_LEN, WIN_SLIDE,
                             GW_BATCH, cb)
    op = m.ops[0]
    inner, flushed = op.flush, {"calls": 0, "launches": dict.fromkeys(registry.KERNELS, 0)}

    def flush(state):
        before = registry.launch_counts()
        out = inner(state)
        for k, n in registry.launch_counts().items():
            flushed["launches"][k] += n - before[k]
        flushed["calls"] += 1
        return out
    op.flush = flush
    nodes = []
    ordering_of = g._ordering_of

    def counted_ordering_of(merged):
        o = ordering_of(merged)
        if all(o is not n for n in nodes):
            nodes.append(o)
        return o
    g._ordering_of = counted_ordering_of
    plan = F.FaultPlan([F.FaultSpec("chain.step", where={"pos": 9}, max_fires=1),
                        F.FaultSpec("sink.consume", at=[3])], seed=17)
    g.start()
    F.reset_counters()
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    try:
        res = g.run_supervised(checkpoint_every=SUP_GRAPH_EVERY, faults=plan, **SUP_BACKOFF)
    finally:
        del op.flush
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    SUP_RUN_S["graph"] = dt
    total = registry.launch_counts()
    applied = {k: total[k] - flushed["launches"][k] for k in total}
    networks = sum((n.networks for n in nodes), Counter())
    calls, cuda_launches = k4_launches(B, networks)
    applies = m._chain._push_count
    same = flat_bytes(np, parts) == flat_bytes(np, gw_parts)
    log({"phase": "supervised_graph", "batch": GW_BATCH, "tuples": GW_TOTAL,
         "checkpoint_every": SUP_GRAPH_EVERY, "restarts": g.supervised_restarts,
         "windows_byte_identical": same, "run_s": dt, "graph_windows_run_s": gw_s,
         "recovery_seconds": F.counters()["recovery_seconds"],
         "win_seq_applies": applies, "flush_calls": flushed["calls"],
         "launches_apply": applied, "launches_flush": flushed["launches"],
         "ordering_nodes": len(nodes), "k4_calls": calls, "k4_cuda_launches": cuda_launches,
         "card": card})
    if not same:
        raise AssertionError("supervised_graph: windows differ from phase 17's")
    if g.supervised_restarts != 2:
        raise AssertionError(f"supervised_graph: {g.supervised_restarts} restarts")
    if int(res["rest"]) != len(range(2, GW_TOTAL, 3)):
        raise AssertionError("supervised_graph: branch 2's count is wrong")
    expect_launches("supervised_graph apply",
                    {k: applied[k] for k in ("lookup", "segment_fold", "masked_window_reduce")},
                    PATH_A_APPLY, applies)
    expect_launches("supervised_graph flush", flushed["launches"],
                    {"masked_window_reduce": 1}, flushed["calls"])
    if total["ordering_merge"] != calls or applied["ordering_merge"] != calls:
        raise AssertionError(f"supervised_graph: K4 counted {total['ordering_merge']}, the "
                             f"nodes made {calls} network calls")
    others = {k: n for k, n in total.items() if n and k not in (
        "lookup", "segment_fold", "masked_window_reduce", "ordering_merge")}
    if others:
        raise AssertionError(f"supervised_graph: unexpected launches {others}")
    return total


# ------------------------------------------------------- tiered keyed state

TIERED_STEPS = 12         # bench.py's tiered row: probe batches after the definitions
TIERED_BENCH_BATCH = 1024  # and its batch as written (keys 100x, hot 4x)
TIERED_K = 4              # scan dispatch of the tiered phases
#: hot capacity of each tiered query at 2^14: q7's JoinTable below its 16
#: auctions; q5's and q6's slot directories at the least a 2^14 batch admits
#: (every batch touches every key, and the hot target is one slot), so each
#: batch still spills all but one key and readmits them
TIERED_QUERIES = {"q5_session": 9, "q6_topn": 17, "q7_distinct": 12}
#: hot capacity of q5 and q6 over a rotating key space (rotating_query):
#: below the 64 bidders and 128 auctions, above the keys a 2^14 batch
#: touches (two blocks: 16 bidders, 32 auctions) plus the sessions it keeps open
TIERED_ROTATING = {"q5_session": 32, "q6_topn": 48}
ROTATE_EVENTS = 1 << 13   # events a key block (half a 2^14 batch)
ROTATE_BLOCKS = 8         # blocks before a block's keys come back
#: launches a tiered apply: K5 for the hot-slot searches (the resolve pass,
#: the touch), the JoinTable's upsert and probe; the cold probe once; q5 and
#: q6 keep their untiered kernels
TIERED_APPLY = {"q3_enrich_join": {"join_probe": 4, "cold_probe": 1},
                "q7_distinct": {"join_probe": 4, "cold_probe": 1},
                "q6_topn": {"join_probe": 2, "cold_probe": 1, "ordering_merge": 1},
                "q5_session": {"join_probe": 2, "cold_probe": 1, **Q5_APPLY}}
HOST_LINK_BYTES_PER_S = 64e9  # H100 SXM: PCIe Gen5 x16, a direction (data sheet)
COLD_PROBE_R = 49_152     # the cold probe's lanes at 2^14: the batch and the pending ring
TIERED_REC_EVERY = 6      # tiered_recovery: a checkpoint every 6 batches
TIERED_REC_FAULT = 30     # and a chain.step fault at batch 30 (a group head at K = 3)
TIERED_REC_K = 3


def live_views(views):
    """The sink views a Sink delivers: not None, with live lanes."""
    return [v for v in views if v is not None and len(v["id"])]


def tiered_views(np, views):
    """q3's sink views as the oracle's columns (id, auction, category, price)."""
    return {"id": np.concatenate([v["id"] for v in views]),
            **{f: np.concatenate([v["payload"][f] for v in views])
               for f in ("auction", "category", "price")}}


def check_q3_oracle(np, what, views, keys, total):
    emit, a, c, p = q3_oracle_np(np, 0, total, auctions=keys)
    want = {"id": np.arange(total, dtype=np.int32)[emit], "auction": a[emit],
            "category": c[emit], "price": p[emit]}
    got = tiered_views(np, views)
    for f, w in want.items():
        if not np.array_equal(got[f], w):
            raise AssertionError(f"{what}: {f} differs from the dense oracle")
    return len(got["id"])


def tiered_q3_profile(torch, wt, make, b, n_def, ms_per_step):
    """torch.profiler over tiered q3's probe pushes (after its definition
    pushes, unprofiled): device busy ms and kernels a step, the idle share
    against the unprofiled step, the kernels with the most device time, and
    the host seconds of the spill maintenance a step, and of the store's
    mirror upkeep within it (``HostStore._slots_written``: staging and
    launching ``cold_scatter``, a whole-index copy and its wait)."""
    from torch.profiler import ProfilerActivity, profile as prof
    src, ops = make()
    chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=b)
    ctl = ops[0].tier_controllers()[0]
    maintain, spent = ctl.maintain, []

    def timed(state):
        t0 = time.perf_counter()
        out = maintain(state)
        spent.append(time.perf_counter() - t0)
        return out
    ctl.maintain = timed
    upkeep, written = [], ctl.store._slots_written

    def timed_upkeep(slots):
        t0 = time.perf_counter()
        written(slots)
        upkeep.append(time.perf_counter() - t0)
    ctl.store._slots_written = timed_upkeep
    batches = list(src.batches(b))
    for x in batches[:n_def]:
        chain.push(x)
    torch.cuda.synchronize()
    spent.clear()
    upkeep.clear()
    probe = batches[n_def:]
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for x in probe:
            chain.push(x)
            torch.cuda.synchronize()
    kern = [e for e in p.key_averages() if str(e.device_type).endswith("CUDA")]
    n = len(probe)
    busy_us = sum(e.device_time_total for e in kern) / n
    log({"phase": "tiered_q3_profile", "steps": n,
         "kernels_per_step": sum(e.count for e in kern) / n,
         "device_busy_ms_per_step": busy_us / 1e3,
         "maintain_host_ms_per_step": sum(spent) / n * 1e3,
         "mirror_upkeep_host_ms_per_step": sum(upkeep) / n * 1e3,
         "mirror_upkeep_calls": len(upkeep),
         "idle_share": 1 - busy_us / 1e3 / ms_per_step})
    for e in sorted(kern, key=lambda e: -e.device_time_total)[:10]:
        log({"profile_kernel": e.key[:100], "per_step": e.count / n,
             "device_us_per_step": e.device_time_total / n})


def tiered_q3_phase(torch, np, wt, registry, card, profile=False):
    """bench.py's tiered row as written (batch 1024), then the same workload
    at the Nexmark batch 2^14 with the row's ratios (hot 65,536 = 4b, keys
    1,638,400 = 100b, 100 definition batches then 12 probe batches): eager
    ``chain.push`` (the bench function, each push timed to completion, the
    spills, readmits and cold keys of every step logged), then
    ``Pipeline(dispatch=4)``: rows equal to the dense oracle and byte for
    byte between the two, ``overflow_drops == 0``, K5 four times and the
    cold probe once an apply, counted through the replays (``profile``: a
    profile of the probe pushes, ``tiered_q3_profile``). Returns the
    launches and the 2^14 eager chain (its 1.6 M-row store is the cold
    probe's case)."""
    from windflow_tpu_torch.batch import host_view
    from windflow_tpu_torch.benchmarks.tiered import bench_nexmark_tiered_100x
    from windflow_tpu_torch.nexmark import make_query

    row = bench_nexmark_tiered_100x(TIERED_BENCH_BATCH, TIERED_STEPS)
    log({"phase": "tiered_q3_bench_row", **row, "card": card})
    if row["overflow_drops"]:
        raise AssertionError(f"tiered q3 bench row: {row['overflow_drops']} overflow drops")
    b = NEX_BATCH
    keys, total = 100 * b, 100 * b + TIERED_STEPS * b
    per_step, views, box = [], [], {}

    def on_out(out, chain):
        views.append(host_view(out))
        st = chain.states[0]
        per_step.append((int(st["spills"]), int(st["readmits"]),
                         chain.ops[0]._tier.store.key_count()))
        box["chain"] = chain
    torch.cuda.synchronize()
    registry.reset_launches()
    row = bench_nexmark_tiered_100x(b, TIERED_STEPS, on_out=on_out)
    eager_counts = registry.launch_counts()
    n = row["batches"]
    rows = check_q3_oracle(np, "tiered q3 eager", views, keys, total)
    log({"phase": "tiered_q3", "dispatch": None, **row, "ms_per_step": row["step_s"] * 1e3,
         "p99_ms": row["p99_step_s"] * 1e3, "rows": rows, "launches": eager_counts,
         "card": card})
    log({"phase": "tiered_q3_per_step", "spills": [s for s, _, _ in per_step],
         "readmits": [r for _, r, _ in per_step], "cold_keys": [c for _, _, c in per_step]})
    if row["overflow_drops"]:
        raise AssertionError(f"tiered q3: {row['overflow_drops']} overflow drops")
    eager_stores = tier_stores(box["chain"].ops)
    eager_scat = mirror_scatters(eager_stores)
    check_mirrors(torch, "tiered q3 eager", eager_stores)
    expect_launches("tiered q3 eager", eager_counts, TIERED_APPLY["q3_enrich_join"], n,
                    eager_scat)
    # the same stream at dispatch K: one replay of a K-step graph a group,
    # one maintenance point a group
    src, ops = make_query("q3_enrich_join", total, n_auctions=keys, num_slots=4 * b,
                          tiered=dict())
    dviews, group_s = [], []
    pipe = wt.Pipeline(src, ops, wt.Sink(dviews.append), batch_size=b, dispatch=TIERED_K)
    push_many = pipe.chain.push_many

    def timed_many(batches, from_op=0):
        # each group timed to completion, as the eager run times each push
        t0 = time.perf_counter()
        outs = push_many(batches, from_op=from_op)
        torch.cuda.synchronize()
        group_s.append(time.perf_counter() - t0)
        return outs
    pipe.chain.push_many = timed_many
    counts, dt, peak = run_pipeline(torch, registry, pipe, TIERED_K)
    scat = mirror_scatters(tier_stores(ops))
    check_mirrors(torch, "tiered q3 dispatch", tier_stores(ops))
    dviews = live_views(dviews)
    st = pipe.chain.states[0]
    per_group = sorted(t / TIERED_K for t in group_s[1:])
    same = flat_bytes(np, dviews) == flat_bytes(np, live_views(views))
    replays = {kk: g.replays for (_, kk, _), g in pipe.chain.graphs.items()}
    log({"phase": "tiered_q3", "dispatch": TIERED_K, "batches": n, "batch": b,
         "run_s": dt, "ms_per_step": sum(per_group) / len(per_group) * 1e3,
         "p99_ms": per_group[min(len(per_group) - 1, int(0.99 * len(per_group)))] * 1e3,
         "overflow_drops": int(st["dropped"]), "state_spills": int(st["spills"]),
         "state_readmits": int(st["readmits"]),
         "cold_keys": ops[0]._tier.store.key_count(), "rows_byte_identical": same,
         "graph_replays": replays, "launches": counts, "peak_mib": peak / 2 ** 20,
         "card": card})
    if not same:
        raise AssertionError("tiered q3: the dispatch rows differ from the eager rows")
    if int(st["dropped"]):
        raise AssertionError(f"tiered q3 dispatch: {int(st['dropped'])} overflow drops")
    if replays != {TIERED_K: n // TIERED_K}:
        raise AssertionError(f"tiered q3 dispatch: graph replays {replays}")
    expect_launches("tiered q3 dispatch", counts, TIERED_APPLY["q3_enrich_join"], n, scat)
    launches = {k: eager_counts[k] + counts[k] for k in counts}
    if profile:
        tiered_q3_profile(torch, wt, lambda: make_query(
            "q3_enrich_join", total, n_auctions=keys, num_slots=4 * b, tiered=dict()),
            b, keys // b, row["step_s"] * 1e3)
    return launches, box["chain"]


def index_of(store):
    """(keys, head rows) of a store's index slots: the 16-byte slots, or an
    older tree's two arrays (``--helper-times`` in a ``git archive``)."""
    if hasattr(store, "index_slots"):
        idx = store.index_slots()
        return idx[:, 0], idx[:, 1]
    return store._ikey, store._irow


def probe_walk(np, store, keys, want):
    """The walk of each wanted lane over the store's index, in its probe
    order (``native/csrc/host_store.cpp``): (slots read, the lanes that
    hit)."""
    ikey, irow = index_of(store)
    lg = store._lg
    mask = (1 << lg) - 1
    k = np.asarray(keys).astype(np.int64)
    lanes = np.flatnonzero(want)
    kk = k[lanes]
    s = ((kk.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
         >> np.uint64(64 - lg)).astype(np.int64)
    live, hit, read = np.ones(len(lanes), bool), np.zeros(len(k), bool), 0
    while live.any():
        a = np.flatnonzero(live)
        read += len(a)
        ss = s[a]
        empty = irow[ss] < 0
        match = ~empty & (ikey[ss] == kk[a])
        hit[lanes[a[match]]] = True
        live[a[empty | match]] = False
        s[a] = (ss + 1) & mask
    return read, hit


def row_bytes_of(np, store):
    return sum(int(np.prod(store.col_shape(k), dtype=np.int64))
               * np.dtype(store._dtypes[k]).itemsize for k in store.col_names)


def record_lines(np, rb):
    """Mean 128-byte lines a record of ``rb`` bytes spans, over the row
    offsets ``row * rb`` from a line-aligned base."""
    start = np.arange(128, dtype=np.int64) * rb
    return float(np.mean((start + rb - 1) // 128 - start // 128 + 1))


def cold_bound(np, store, keys, want, rows_read, out_bytes, link_rate):
    """A cold read's bound: the largest of its host-link requests (a line
    of every record it reads, ``record_lines``) over the link's measured
    rate of requests (``link_read_phase``), its host-link bytes (the
    records) over 64 GB/s, and its device-memory bytes (the index slots
    its walks read, the keys and want read once, ``out_bytes`` written
    once) over 3.35 TB/s."""
    walked, hit = probe_walk(np, store, keys.cpu().numpy(), want.cpu().numpy())
    reads = rows_read * record_lines(np, store.record_bytes)
    hbm = 16 * walked + keys.shape[0] * 5 + out_bytes
    t_link = max(reads / link_rate, rows_read * store.record_bytes / HOST_LINK_BYTES_PER_S)
    t_link, t_hbm = t_link * 1e3, hbm / HBM_BYTES_PER_S * 1e3
    return {"link_reads": reads, "walk_slots": walked, "hbm_bytes": hbm,
            "link_reads_per_s": link_rate, "bound_ms": max(t_link, t_hbm),
            "bound_by": "operations" if t_link >= t_hbm else "bytes",
            "counted": "host-link requests (the lines of the records read) over the "
                       "measured rate, or their bytes over 64 GB/s; device bytes (walked "
                       "slots, keys, want, outputs) over 3.35 TB/s"}, hit


def probe_case(torch, np, card, case, store, keys, want, link_rate, timed=True, extra=None):
    """``cold_probe`` against its plain version (the store's host lookup, a
    synchronous round trip), bit for bit, the kernel's found lanes folded
    into the store's readmissions as many as the plain version counts, with
    the kernel's time by graph replay (``timed``), the plain version's by
    CUDA events around its round trips, and the bound (``cold_bound``)."""
    from windflow_tpu_torch.ops.cold_probe import cold_probe_cuda, cold_probe_plain

    def kernel():
        return cold_probe_cuda(store, keys, want)

    def plain():
        return cold_probe_plain(store, keys, want)
    r0 = store.counters()["state_readmits"]
    got = kernel()
    torch.cuda.synchronize()
    r1 = store.counters()["state_readmits"]
    ref = plain()
    same, err = compare(torch, got, ref)
    found = int(ref[0].sum())
    folded = (r1 - r0, store.counters()["state_readmits"] - r1)
    R = keys.shape[0]
    bound, hit = cold_bound(np, store, keys, want, found, R * (1 + 12 + row_bytes_of(np, store)),
                            link_rate)
    row = {"kernel_check": "cold_probe", "case": case, "lanes": R, "store_rows": len(store),
           "record_bytes": store.record_bytes, "wanted": int(want.sum()), "found": found,
           **(extra or {}), "readmits_folded": folded[0], "bit_identical": same,
           "max_abs_err": err,
           "kernel_ms": graph_ms(torch, kernel) if timed else None,
           "kernel_eager_ms": time_ms(torch, kernel) if timed else None,
           "plain_ms": time_ms(torch, plain, iters=5, warmup=1) if timed else None,
           "library_ms": None, **bound, "card": card}
    log(row)
    if not same:
        raise AssertionError(f"cold_probe [{case}]: kernel differs from its plain version")
    if folded != (found, found) or int(hit.sum()) != found:
        raise AssertionError(f"cold_probe [{case}]: readmissions counted {folded}, found "
                             f"{found}, the walk finds {int(hit.sum())}")
    return row


def probe_lanes(torch, gen, R, lo, hi, p_want=0.8):
    keys = torch.randint(lo, hi, (R,), generator=gen, device="cuda", dtype=torch.int32)
    return keys, torch.rand((R,), generator=gen, device="cuda") < p_want


def scatter_check(torch, np, card, store, n):
    """``cold_scatter`` against its plain version (one indexed copy) bit for
    bit: ``n`` distinct slots of ``store``'s index, staged in mapped memory as
    the store stages a write's slots, written into a zeroed copy of its
    mirror; the kernel's time by graph replay, the plain version's (the
    entries copied to the card, then the indexed copy) by CUDA events, the
    library call's by CUDA events over the same work (the staged entries
    copied from the host to the card, then ``index_copy_``), and
    ``index_copy_`` alone from entries already on the card by graph replay
    (``library_on_card_ms``); the bound: the entries' bytes over the host
    link (64 GB/s) against the slots' bytes over 3.35 TB/s."""
    from windflow_tpu_torch.ops.cold_probe import (MappedBuffer, cold_scatter_cuda,
                                                   cold_scatter_plain)
    idx = store.index_slots()
    slots = np.random.default_rng(31).choice(len(idx), n, replace=False)
    buf = MappedBuffer(32 * n)
    ent = buf.array(np.int64, (n, 4))
    ent[:, :2] = idx[slots]
    ent[:, 2] = slots
    a = torch.zeros_like(store.mirror)
    b, c = a.clone(), a.clone()
    sl, pairs = torch.from_numpy(slots).cuda(), torch.from_numpy(idx[slots]).cuda()

    def kernel():
        cold_scatter_cuda(a, buf.dev, n)
        return a

    def plain():
        cold_scatter_plain(b, ent)
        return b
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    same, err = compare(torch, got, ref)
    t_link, t_hbm = 32 * n / HOST_LINK_BYTES_PER_S * 1e3, 16 * n / HBM_BYTES_PER_S * 1e3
    staged = torch.from_numpy(ent)          # the entries in the mapped host buffer

    def library():
        e = staged.to("cuda", non_blocking=True)
        c.index_copy_(0, e[:, 2], e[:, :2])
    row = {"kernel_check": "cold_scatter", "case": f"{n} slots of a {len(idx)}-slot index",
           "bit_identical": same, "max_abs_err": err,
           "kernel_ms": graph_ms(torch, kernel), "kernel_eager_ms": time_ms(torch, kernel),
           "plain_ms": time_ms(torch, plain, iters=5, warmup=1),
           "library_ms": time_ms(torch, library),
           "library_on_card_ms": graph_ms(torch, lambda: c.index_copy_(0, sl, pairs)),
           "bytes": 32 * n, "counted": "staged entries over the host link (64 GB/s); slots "
                                       "written over 3.35 TB/s",
           "bound_ms": max(t_link, t_hbm), "bound_by": "bytes", "card": card}
    log(row)
    if not same:
        raise AssertionError("cold_scatter: kernel differs from its plain version")
    return row


def mirror_kept(store):
    """What a restore that fits keeps: the mapped buffers and the mirror."""
    return [b.host for b in store._bufs], store.mirror.data_ptr()


def cold_probe_phase(torch, np, registry, card, chain, link_rate):
    """The cold probe against its plain version (``probe_case``) at R =
    49,152 lanes over the tiered_q3 chain's 1.6 M-row store: keys in twice
    the key space (hits and misses) with a fifth of the lanes not wanted,
    then every lane a hit and every lane a miss (all wanted), whose times
    split the walk (device memory) from the record read (the host link);
    the whole index's upload to the mirror timed (64 MiB); ``cold_scatter``
    checked (``scatter_check``). Then a store of 2^18 keys (two columns):
    as built, after a ``compact_below`` that reindexes (three quarters
    retired: the rebuild), after ``pop_keys``' backward shifts (one
    scatter) and after a restore that fits (buffers and mirror kept). Then
    a graph captured over a 200-row store, the store grown to 2^18 rows,
    the graph replayed, three restores that fit, replayed again; and a
    graph captured over a 200-row store restored from a 2^18-row manifest
    (a restore that grows), replayed. After each write the mirror equals
    the host index (``check_mirrors``). Returns the main case's row and
    the scatter's."""
    from windflow_tpu_torch.ops.cold_probe import cold_probe_cuda, cold_probe_plain
    from windflow_tpu_torch.state import HostStore

    store = chain.ops[0]._tier.store
    check_mirrors(torch, "cold_probe: tiered q3's store", [store])
    gen = torch.Generator(device="cuda").manual_seed(12)
    keyspace = 2 * store.key_count()
    R = COLD_PROBE_R
    keys, want = probe_lanes(torch, gen, R, 0, keyspace)
    row = probe_case(torch, np, card, "q3 2^14 store", store, keys, want, link_rate)
    live = store._key[:store._n][store._live[:store._n]]
    rng = np.random.default_rng(13)
    every = torch.ones((R,), dtype=torch.bool, device="cuda")
    hits = torch.from_numpy(rng.choice(live, R).astype(np.int32)).cuda()
    hit_row = probe_case(torch, np, card, "q3 store, every lane a hit", store, hits, every,
                         link_rate)
    misses = torch.randint(keyspace, 2 * keyspace, (R,), generator=gen, device="cuda",
                           dtype=torch.int32)
    miss_row = probe_case(torch, np, card, "q3 store, every lane a miss", store, misses,
                          every, link_rate)
    if hit_row["found"] != R or miss_row["found"] != 0:
        raise AssertionError(f"cold_probe: all-hit found {hit_row['found']}, all-miss "
                             f"{miss_row['found']}")
    mirror_bytes = store.mirror.numel() * 8
    upload_ms = time_ms(torch, lambda: store.mirror.copy_(store._idx_t, non_blocking=True),
                        iters=10, warmup=2)
    log({"cold_probe_split": "q3 store", "lanes": R, "all_miss_ms": miss_row["kernel_ms"],
         "all_hit_ms": hit_row["kernel_ms"], "mixed_ms": row["kernel_ms"],
         "walk_slots_a_lane": {"miss": miss_row["walk_slots"] / R,
                               "hit": hit_row["walk_slots"] / R},
         "index_upload_bytes": mirror_bytes, "index_upload_ms": upload_ms,
         "index_upload_gb_s": mirror_bytes / upload_ms / 1e6, "card": card})
    scatter_row = scatter_check(torch, np, card, store, NEX_BATCH)

    # a store of 2^18 keys: as built, compacted (reindexed), drained, restored
    big = HostStore("probe", {"v0": np.int32, "v1": np.float32}, device="cuda")
    k = np.arange(HELPER_PROBE_ROWS, dtype=np.int32)
    big.upsert(k, k, k, k, {"v0": k * 3, "v1": k.astype(np.float32) / 7})
    full_man = big.manifest()
    bkeys, bwant = probe_lanes(torch, gen, R, 0, 2 * HELPER_PROBE_ROWS)
    check_mirrors(torch, "cold_probe: 2^18-key store", [big])
    probe_case(torch, np, card, f"{HELPER_PROBE_ROWS}-key store, two columns", big, bkeys,
               bwant, link_rate)
    up0 = big.mirror_uploads
    retired = big.compact_below("m0", 3 << 16)
    check_mirrors(torch, "cold_probe: after compact_below", [big])
    if big.mirror_uploads == up0 or retired != 3 << 16:
        raise AssertionError(f"cold_probe: compact_below retired {retired} and uploaded "
                             f"{big.mirror_uploads - up0} times")
    probe_case(torch, np, card, "2^18-key store after compact_below (reindexed)", big, bkeys,
               bwant, link_rate, timed=False, extra={"retired": retired})
    c0, sc0 = registry.launch_counts()["cold_scatter"], big.mirror_scatters
    popped, _ = big.pop_keys(4096)
    scat = (registry.launch_counts()["cold_scatter"] - c0, big.mirror_scatters - sc0)
    check_mirrors(torch, "cold_probe: after pop_keys", [big])
    if scat != (1, 1) or len(popped) != 4096:
        raise AssertionError(f"cold_probe: pop_keys scattered {scat}")
    pk = torch.from_numpy(np.concatenate([np.resize(popped, R // 2), rng.choice(
        big._key[:big._n][big._live[:big._n]], R - R // 2)]).astype(np.int32)).cuda()
    probe_case(torch, np, card, "after pop_keys (backward shifts)", big, pk, every, link_rate,
               timed=False, extra={"popped": 4096})
    kept = mirror_kept(big)
    big.restore(full_man)
    check_mirrors(torch, "cold_probe: after a restore that fits", [big])
    if mirror_kept(big) != kept:
        raise AssertionError("cold_probe: a restore that fits replaced the buffers or mirror")
    probe_case(torch, np, card, "after a restore that fits", big, bkeys, bwant, link_rate,
               timed=False)

    # a graph captured before the store grows reads the grown store
    def captured(st, gkeys, gwant):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            cold_probe_cuda(st, gkeys, gwant)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with collection_paused(), torch.cuda.graph(g):
            gout = cold_probe_cuda(st, gkeys, gwant)
        return g, gout

    def replayed(st, g, gout, gkeys, gwant):
        g.replay()
        torch.cuda.synchronize()
        gref = cold_probe_plain(st, gkeys, gwant)
        return compare(torch, tuple(gout), gref) + (int(gref[0].sum()),)

    small = HostStore("grow", {"v0": np.int32, "v1": np.float32}, device="cuda")

    def fill(st, n, lo):
        k = np.arange(lo, lo + n, dtype=np.int32)
        st.upsert(k, k, k, k, {"v0": k * 3, "v1": k.astype(np.float32) / 7})
    fill(small, 200, 0)
    gkeys = torch.from_numpy(rng.integers(0, 1 << 18, 4096).astype(np.int32)).cuda()
    gwant = torch.ones((4096,), dtype=torch.bool, device="cuda")
    g, gout = captured(small, gkeys, gwant)
    fill(small, (1 << 18) - 200, 200)
    gsame, gerr, gfound = replayed(small, g, gout, gkeys, gwant)
    check_mirrors(torch, "cold_probe: grown past the capture", [small])
    log({"kernel_check": "cold_probe", "case": "graph captured at 200 rows, replayed at "
                                               "2^18", "bit_identical": gsame,
         "max_abs_err": gerr, "found": gfound, "card": card})
    if not gsame or gfound != 4096:
        raise AssertionError("cold_probe: a graph captured before the store grew reads "
                             "stale memory")
    # restores that fit rewrite the mapped arrays and the mirror in place (no
    # pinned memory is kept or allocated), and the graph reads what they wrote
    kept = mirror_kept(small)
    man = small.manifest()
    for _ in range(3):
        small.restore(man)
    rsame, _, _ = replayed(small, g, gout, gkeys, gwant)
    check_mirrors(torch, "cold_probe: three restores that fit", [small])
    log({"kernel_check": "cold_probe", "case": "graph replayed after three restores",
         "bit_identical": rsame, "buffers_kept": mirror_kept(small) == kept, "card": card})
    if not rsame or mirror_kept(small) != kept:
        raise AssertionError("cold_probe: a restore that fits reallocated the store, or "
                             "the graph reads stale memory after it")
    # a restore that grows the store under a captured graph
    regrown = HostStore("regrow", {"v0": np.int32, "v1": np.float32}, device="cuda")
    fill(regrown, 200, 0)
    g2, gout2 = captured(regrown, bkeys, bwant)
    kept = mirror_kept(regrown)
    regrown.restore(full_man)
    gsame, gerr, gfound = replayed(regrown, g2, gout2, bkeys, bwant)
    check_mirrors(torch, "cold_probe: a restore that grows", [regrown])
    log({"kernel_check": "cold_probe", "case": "graph captured at 200 rows, a 2^18-row "
                                               "restore (grows), replayed",
         "bit_identical": gsame, "max_abs_err": gerr, "found": gfound,
         "reallocated": mirror_kept(regrown) != kept, "card": card})
    if not gsame or mirror_kept(regrown) == kept or not gfound:
        raise AssertionError("cold_probe: a graph captured before a growing restore reads "
                             "stale memory")
    return row, scatter_row


def link_read_phase(torch, probes, card):
    """The host link's rate of 16-byte system-scope reads of random lines
    of a mapped buffer (``split_probes.cu``'s ``wf_link_reads``: 2^20 reads
    over the first 2^13 (1 MiB) or all 2^19 (64 MiB) lines of 128 bytes,
    one to four in flight a thread), by graph replay; returns the best
    rate, the cold reads' bound (``cold_bound``)."""
    import ctypes
    from windflow_tpu_torch.ops import cuda

    alloc = probes.wf_probe_host_alloc
    alloc.argtypes = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
                      ctypes.POINTER(ctypes.c_void_p)]
    fn = probes.wf_link_reads
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    lines, n = 1 << 19, 1 << 20
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    cuda.check(alloc(lines * 128, ctypes.byref(host), ctypes.byref(dev)), "probe host alloc")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    rates = {}
    try:
        ctypes.memset(host, 1, lines * 128)
        for span in (1 << 13, lines):
            for per in (1, 2, 4):
                ms = graph_ms(torch, lambda: cuda.check(
                    fn(dev, span, n, per, cuda.ptr(sink), cuda.stream_ptr("cuda")),
                    "link reads"), iters=5, reps=3)
                rates[f"{span * 128 >> 20} MiB, {per} a thread"] = n / ms * 1e3
    finally:
        torch.cuda.synchronize()
        cuda.check(probes.wf_probe_host_free(host), "probe host free")
    log({"phase": "link_reads", "reads": n, "lines": lines, "line_bytes": 128,
         "reads_per_s": rates,
         "best_reads_per_s": max(rates.values()), "card": card})
    return max(rates.values())


def tiered_queries_phase(torch, np, wt, registry, card):
    """q5, q6 and q7 at 2^14 for 16 batches, tiered (``TIERED_QUERIES``),
    eager and at dispatch K = 4: rows equal to the dense oracle (the
    untiered rows), the two runs byte for byte, each apply's kernels counted
    exactly (``TIERED_APPLY``), spills on every query."""
    from windflow_tpu_torch.nexmark import make_query, oracles

    total = NEX_BATCHES * NEX_BATCH
    launches = dict.fromkeys(registry.KERNELS, 0)
    for name, hot in TIERED_QUERIES.items():
        want = oracles.ORACLES[name](total)
        runs = {}
        for k in (None, TIERED_K):
            src, ops = make_query(name, total, tiered=dict(hot_capacity=hot))
            views = []
            pipe = wt.Pipeline(src, ops, wt.Sink(views.append), batch_size=NEX_BATCH,
                               dispatch=k or False)
            counts, dt, peak = run_pipeline(torch, registry, pipe, k)
            scat = mirror_scatters(tier_stores(ops))
            views = [v for v in views if v is not None]
            got = nexmark_rows(np, name, views)
            pipe.chain.tier_settle()
            check_mirrors(torch, f"tiered {name} (dispatch {k})", tier_stores(ops))
            st = pipe.chain.states[-1]
            tier = ops[-1]._tier.controller.stats()
            log({"phase": "tiered_queries", "query": name, "hot_capacity": hot,
                 "dispatch": k, "batches": NEX_BATCHES, "batch": NEX_BATCH,
                 "rows": len(got), "run_s": dt, "ms_per_step": dt / NEX_BATCHES * 1e3,
                 "state_spills": int(st["spills"]), "state_readmits": int(st["readmits"]),
                 "tier": tier, "launches": counts, "peak_mib": peak / 2 ** 20,
                 "card": card})
            if got != want:
                raise AssertionError(f"tiered {name}: rows differ from the untiered oracle")
            if int(st["spills"]) == 0:
                raise AssertionError(f"tiered {name}: nothing spilled")
            expect_launches(f"tiered {name}", counts, TIERED_APPLY[name], NEX_BATCHES, scat)
            runs[k] = (views, counts, pipe.chain.graphs)
        check_dispatch(np, f"tiered_{name}", TIERED_K, NEX_BATCHES, runs[None][:2],
                       runs[TIERED_K][:2], runs[TIERED_K][2])
        for c, nn in runs[None][1].items():
            launches[c] += nn
    return launches


def rotating_query(torch, wt, name, total, tiered):
    """q5 or q6 over a key space that rotates with the stream: the bids of
    block ``(i // 2^13) % 8`` go to that block's own 8 bidders (q5) or 16
    auctions (q6), so a 2^14 batch touches a quarter of the 64 or 128 keys
    and a key comes back every four batches, from the cold tier when tiered."""
    from windflow_tpu_torch.nexmark import generators as g
    from windflow_tpu_torch.nexmark.queries import SESSION_GAP, TOP_N

    def blk(i):
        return (i // ROTATE_EVENTS) % ROTATE_BLOCKS

    def gen(i):
        return {"auction": g.bid_auction(i).to(torch.int32),
                "bidder": (g.bid_bidder(i) + g.N_BIDDERS * blk(i)).to(torch.int32),
                "price": g.bid_price(i).to(torch.int32)}
    src = wt.DeviceSource(gen, total=total, name="rotating_bids",
                          key_fn=lambda i: g.bid_auction(i) + g.N_AUCTIONS * blk(i),
                          ts_fn=lambda i: i // g.EVENTS_PER_TICK)
    if name == "q5_session":
        K = g.N_BIDDERS * ROTATE_BLOCKS
        return src, [wt.KeyBy(lambda t: t.bidder, K),
                     wt.SessionWindow(lambda t: {"bids": torch.ones((), dtype=torch.int32),
                                                 "spend": t.price},
                                      wt.WindowSpec.session(SESSION_GAP), num_keys=K,
                                      tiered=tiered)]
    return src, [wt.TopN(lambda t: t.price, TOP_N, num_keys=g.N_AUCTIONS * ROTATE_BLOCKS,
                         tiered=tiered)]


def tiered_rotating_phase(torch, np, wt, registry, card):
    """q5 and q6 over the rotating key space (``rotating_query``) at 2^14
    for 16 batches with a hot capacity below the key space
    (``TIERED_ROTATING``), eager and at dispatch K = 4: rows equal to the
    untiered run's, the two tiered runs byte for byte, each apply's kernels
    counted exactly (``TIERED_APPLY``), spills and readmissions on both."""
    total = NEX_BATCHES * NEX_BATCH
    launches = dict.fromkeys(registry.KERNELS, 0)
    for name, hot in TIERED_ROTATING.items():
        src, ops = rotating_query(torch, wt, name, total, None)
        ref = []
        wt.Pipeline(src, ops, wt.Sink(ref.append), batch_size=NEX_BATCH).run()
        want = nexmark_rows(np, name, [v for v in ref if v is not None])
        runs = {}
        for k in (None, TIERED_K):
            src, ops = rotating_query(torch, wt, name, total, dict(hot_capacity=hot))
            views = []
            pipe = wt.Pipeline(src, ops, wt.Sink(views.append), batch_size=NEX_BATCH,
                               dispatch=k or False)
            counts, dt, peak = run_pipeline(torch, registry, pipe, k)
            scat = mirror_scatters(tier_stores(ops))
            views = [v for v in views if v is not None]
            got = nexmark_rows(np, name, views)
            pipe.chain.tier_settle()
            check_mirrors(torch, f"rotating {name} (dispatch {k})", tier_stores(ops))
            st = pipe.chain.states[-1]
            log({"phase": "tiered_rotating", "query": name, "hot_capacity": hot,
                 "num_keys": ops[-1].num_keys, "dispatch": k, "batches": NEX_BATCHES,
                 "batch": NEX_BATCH, "rows": len(got), "rows_equal_untiered": got == want,
                 "run_s": dt, "ms_per_step": dt / NEX_BATCHES * 1e3,
                 "state_spills": int(st["spills"]), "state_readmits": int(st["readmits"]),
                 "tier": ops[-1]._tier.controller.stats(), "launches": counts,
                 "peak_mib": peak / 2 ** 20, "card": card})
            if got != want:
                raise AssertionError(f"rotating {name}: rows differ from the untiered run")
            if int(st["spills"]) == 0 or int(st["readmits"]) == 0:
                raise AssertionError(f"rotating {name}: no spill or no readmission")
            expect_launches(f"rotating {name}", counts, TIERED_APPLY[name], NEX_BATCHES,
                            scat)
            runs[k] = (views, counts, pipe.chain.graphs)
        check_dispatch(np, f"rotating_{name}", TIERED_K, NEX_BATCHES, runs[None][:2],
                       runs[TIERED_K][:2], runs[TIERED_K][2])
        for c, nn in runs[None][1].items():
            launches[c] += nn
    return launches


#: the kernel wrappers the tiered paths launch, each with its plain version:
#: (kernel, module, wrapper, plain)
TIERED_WRAPPERS = (("join_probe", "lookup", "join_probe_cuda", "join_probe_plain"),
                   ("lookup", "lookup", "lookup_cuda", "lookup_plain"),
                   ("lookup", "lookup", "lookup_many_cuda", "lookup_many_plain"),
                   ("segment_fold", "segment", "segment_fold_cuda", "segment_fold_plain"),
                   ("ordering_merge", "bitonic", "network_cuda", "network_plain"))
KEPT_CALLS = 4            # the last calls kept a distinct argument signature


def tiered_inputs_phase(torch, np, wt, card):
    """Every kernel held against its plain version on the inputs the tiered
    paths gave it: tiered q3 at 2^14 (``bench_nexmark_tiered_100x``), the
    tiered queries and the rotating cases run eagerly once more with each
    wrapper's arguments cloned as it launches, the last ``KEPT_CALLS`` calls
    of every distinct signature (kernel, shapes and dtypes, other arguments)
    kept, then each kept call rerun through the kernel and the plain
    version, bit for bit. Outside every counted window."""
    import importlib
    from windflow_tpu_torch.benchmarks.tiered import bench_nexmark_tiered_100x
    from windflow_tpu_torch.nexmark import make_query

    def sig_of(x):
        if isinstance(x, (list, tuple)):            # a grouped K2's tables
            return tuple(sig_of(t) for t in x)
        return (tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor) else x

    def clone(x):
        if isinstance(x, (list, tuple)):
            return [clone(t) for t in x]
        return x.clone() if isinstance(x, torch.Tensor) else x

    def results(out):
        return tuple(out) if isinstance(out, list) else out

    def capture(run):
        kept, saved = {}, []
        for name, mod, cu, pl in TIERED_WRAPPERS:
            m = importlib.import_module(f"windflow_tpu_torch.ops.{mod}")
            inner = getattr(m, cu)

            def wrapper(*args, _n=name, _m=m, _pl=pl, _inner=inner, **kw):
                sig = (_n,) + tuple(sig_of(a) for a in args) + tuple(sorted(kw.items()))
                calls = kept.setdefault(sig, (_inner, getattr(_m, _pl), []))[2]
                calls.append((tuple(clone(a) for a in args), dict(kw)))
                del calls[:-KEPT_CALLS]
                return _inner(*args, **kw)
            saved.append((m, cu, inner))
            setattr(m, cu, wrapper)
        try:
            run()
        finally:
            for m, cu, inner in saved:
                setattr(m, cu, inner)
        return kept

    def query(name, hot, make):
        def run():
            src, ops = make(name, dict(hot_capacity=hot))
            wt.Pipeline(src, ops, wt.Sink(lambda v: None), batch_size=NEX_BATCH).run()
        return run
    total = NEX_BATCHES * NEX_BATCH
    runs = {"tiered_q3": lambda: bench_nexmark_tiered_100x(NEX_BATCH, TIERED_STEPS)}
    for name, hot in TIERED_QUERIES.items():
        runs[f"tiered_{name}"] = query(name, hot, lambda n, t: make_query(n, total, tiered=t))
    for name, hot in TIERED_ROTATING.items():
        runs[f"rotating_{name}"] = query(
            name, hot, lambda n, t: rotating_query(torch, wt, n, total, t))
    checked = 0
    for what, run in runs.items():
        rows = []
        for sig, (kernel, plain, calls) in capture(run).items():
            same, err = True, 0.0
            for args, kw in calls:
                ok, e = compare(torch, results(kernel(*args, **kw)),
                                results(plain(*args, **kw)))
                same, err = same and ok, max(err, e)
            checked += len(calls)
            rows.append({"kernel": sig[0], "signature": repr(sig[1:]), "calls": len(calls),
                         "bit_identical": same, "max_abs_err": err})
            if not same:
                log({"kernel_check": sig[0], "case": f"{what} inputs", **rows[-1]})
                raise AssertionError(f"{sig[0]} [{what} inputs]: kernel differs from "
                                     f"its plain version")
        log({"phase": "tiered_inputs", "run": what, "signatures": rows, "card": card})
    return checked


def tiered_recovery_phase(torch, np, wt, registry, card):
    """Tiered q3 at bench.py's batch (1024; keys 102,400, hot 4096) under
    ``SupervisedPipeline`` with a checkpoint every 6 batches and a chain.step
    fault at batch 30 (spills in flight), dispatch off and K = 3, a journal
    active; then ``save_chain`` half way and ``load_chain`` into a chain
    whose K = 3 graph was captured before the restore. Rows byte for byte
    equal to an uninterrupted run; each restore span's ``dur_s`` logged."""
    import shutil
    from windflow_tpu_torch.batch import host_view
    from windflow_tpu_torch.nexmark import make_query
    from windflow_tpu_torch.observability import journal as J
    from windflow_tpu_torch.runtime import checkpoint as ck
    from windflow_tpu_torch.runtime import faults as F

    b = TIERED_BENCH_BATCH
    keys, total = 100 * b, 100 * b + TIERED_STEPS * b
    n = total // b

    def make():
        return make_query("q3_enrich_join", total, n_auctions=keys, num_slots=4 * b,
                          tiered=dict())
    src, ops = make()
    c0 = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=b)
    batches = list(src.batches(b))
    whole = host_rows([c0.push(x) for x in batches] + c0.flush())
    del c0
    launches = dict.fromkeys(registry.KERNELS, 0)
    jpath = os.path.join(ROOT, "build", "tiered_journal.jsonl")
    for k in (None, TIERED_REC_K):
        plan = F.FaultPlan([F.FaultSpec("chain.step", where={"pos": TIERED_REC_FAULT},
                                        max_fires=1)], seed=7)
        src, ops = make()
        views = []
        sp = wt.SupervisedPipeline(src, ops, wt.Sink(views.append), batch_size=b,
                                   checkpoint_every=TIERED_REC_EVERY, faults=plan,
                                   dispatch=k or False, **SUP_BACKOFF)
        if os.path.exists(jpath):
            os.unlink(jpath)
        j = wt.EventJournal(jpath)
        J.set_active(j)
        try:
            F.reset_counters()
            counts, dt, peak = counted_run(torch, registry, sp.start, sp.run)
        finally:
            J.set_active(None)
            j.close()
        recs = wt.read_journal(jpath)
        spans = [r["dur_s"] for r in journal_spans(recs, "restore")]
        same = flat_bytes(np, live_views(views)) == flat_bytes(np, live_views(whole))
        log({"phase": "tiered_recovery", "case": "supervised", "dispatch": k, "batch": b,
             "batches": n, "checkpoint_every": TIERED_REC_EVERY, "restarts": sp.restarts,
             "restore_dur_s": spans,
             "recovery_seconds": F.counters()["recovery_seconds"],
             "spill_records": sum(r["event"] == "spill" for r in recs),
             "readmit_records": sum(r["event"] == "readmit" for r in recs),
             "rows_byte_identical": same, "run_s": dt, "launches": counts,
             "peak_mib": peak / 2 ** 20, "card": card})
        if not same or sp.restarts != 1 or len(spans) != 1:
            raise AssertionError(f"tiered_recovery (dispatch {k}): rows identical {same}, "
                                 f"{sp.restarts} restarts, {len(spans)} restore spans")
        if counts["cold_probe"] < n:
            raise AssertionError(f"tiered_recovery: cold_probe {counts['cold_probe']} < {n}")
        check_mirrors(torch, f"tiered_recovery supervised (dispatch {k})", tier_stores(ops))
        for c, nn in counts.items():
            launches[c] += nn
    os.makedirs(CKPT_DIR, exist_ok=True)
    try:
        def chain():
            s, o = make()
            return wt.CompiledChain(o, s.payload_spec(), batch_capacity=b)
        c1, c2 = chain(), chain()
        c2.warm_scan(TIERED_REC_K, b)                 # captured before the restore
        torch.cuda.synchronize()
        registry.reset_launches()
        half = n // 2
        outs = [c1.push(x) for x in batches[:half]]
        t0 = time.perf_counter()
        path = ck.save_chain(c1, os.path.join(CKPT_DIR, "tiered_q3"), meta={"done": half})
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ck.load_chain(c2, path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        rest = batches[half:]
        for i in range(0, len(rest), TIERED_REC_K):
            outs += c2.push_many(rest[i:i + TIERED_REC_K])
        outs += c2.flush()
        torch.cuda.synchronize()
        counts = registry.launch_counts()
        stores = tier_stores(c1.ops) + tier_stores(c2.ops)
        scat = mirror_scatters(stores)
        check_mirrors(torch, "tiered_recovery checkpoint", stores)
        same = flat_bytes(np, host_rows(outs)) == flat_bytes(np, whole)
        replays = {f"{kk}": g.replays for (_, kk, _), g in c2.graphs.items()}
        log({"phase": "tiered_recovery", "case": "checkpoint", "batch": b, "batches": n,
             "resumed_at": half, "file_bytes": os.path.getsize(path),
             "tier_arrays": sorted(k for k in np.load(path).files if k.startswith("tier")),
             "save_ms": save_ms, "load_ms": load_ms, "rows_byte_identical": same,
             "graph_replays": replays, "launches": counts, "card": card})
        if not same or replays.get(f"{TIERED_REC_K}", 0) < 1:
            raise AssertionError(f"tiered_recovery checkpoint: rows identical {same}, "
                                 f"replays {replays}")
        expect_launches("tiered_recovery checkpoint", counts,
                        TIERED_APPLY["q3_enrich_join"], n, scat)
        for c, nn in counts.items():
            launches[c] += nn
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return launches

# -- shard-local supervision on one card -----------------------------------------------

SHARDS = 4                # the sharded runs' shard count
SHARD_RESHARD = {"new_shards": 8, "at_pos": 4}   # sharded YSB's live 4 -> 8
SHARD_KILL = {"shard": 2, "pos": 1}              # its shard.kill, before the reshard
SHARD_GRAPH = 2           # graph_windows' shard count
SHARD_DIR = os.path.join(ROOT, "build", "sharded")
#: the unsharded supervised runs' seconds, beside the sharded ones
SUP_RUN_S = {}


def sorted_rows(np, parts):
    """A run's live ``(key, id, payload)`` rows sorted (a sharded run delivers
    a batch's rows shard by shard): one array a field, for ``flat_bytes``."""
    if not parts:
        return []
    k, w, c = (np.concatenate([np.asarray(x) for x in col]) for col in zip(*parts))
    flat = c.reshape(len(c), -1)
    order = np.lexsort([flat[:, j] for j in reversed(range(flat.shape[1]))] + [w, k])
    return [k[order], w[order], c[order]]


def sharded_ysb_phase(torch, np, wt, ysb, registry, card, ysb_parts):
    """YSB at full width (8 x 2^20) under ``SupervisedPipeline(shards=4)``
    with a checkpoint every 2 batches, sharded checkpoint files, a journal,
    ``shard.kill`` on shard 2 at batch 1 and a live reshard 4 -> 8 at the
    barrier of batch 4: the plain rows (sorted: a batch's rows arrive shard
    by shard) byte for byte, one restart, on shard 2, no whole-domain
    restore, K1 and K2 once a shard's push (replays and the re-sharding
    prefix included), the files reloaded into every shard's committed
    states. Then the same run with the first handoff seal torn: the same
    rows, the move re-derived, no seal left behind. ms a batch against the
    unsharded supervised run's."""
    import shutil
    from windflow_tpu_torch.observability import journal as J
    from windflow_tpu_torch.runtime import checkpoint as ck
    from windflow_tpu_torch.runtime import faults as F
    from windflow_tpu_torch.runtime.graphs import leaves
    from windflow_tpu_torch.runtime.supervisor import _fresh_states

    total = YSB_BATCHES * BATCH
    want = flat_bytes(np, sorted_rows(np, ysb_parts))
    launches = dict.fromkeys(registry.KERNELS, 0)
    os.makedirs(SHARD_DIR, exist_ok=True)
    try:
        for case in ("kill_and_reshard", "torn_handoff"):
            if case == "kill_and_reshard":
                plan = F.FaultPlan([F.FaultSpec("shard.kill", where=SHARD_KILL,
                                                max_fires=1)], seed=31)
            else:
                plan = F.FaultPlan([F.FaultSpec("reshard.handoff", kind="torn",
                                                max_fires=1)], seed=32)
            path = os.path.join(SHARD_DIR, f"ysb_{case}.npz")
            parts, cb = collect_sink()
            src, ops = ysb.make_source(total), ysb.make_ops(**ysb.bench_geometry(BATCH))
            # ownership follows the campaign the windows group on (the KeyBy's
            # key), not the source's key
            sp = wt.SupervisedPipeline(src, ops, wt.Sink(cb), batch_size=BATCH,
                                       checkpoint_every=SUP_EVERY, max_restarts=3,
                                       shards=SHARDS, reshard=SHARD_RESHARD, faults=plan,
                                       spill_path=path,
                                       shard_key=lambda t: t.data["ad_id"]
                                       // ysb.ADS_PER_CAMPAIGN, **SUP_BACKOFF)
            pushed = count_pushes(sp.chain)
            jpath = os.path.join(SHARD_DIR, f"{case}.jsonl")
            journal = J.EventJournal(jpath)

            def run():
                J.set_active(journal)
                try:
                    sp.run()
                finally:
                    J.set_active(None)
                    journal.close()
            F.reset_counters()
            counts, dt, peak = counted_run(torch, registry, sp.start, run)
            recs = J.read_journal(jpath)
            rep = sp.shard_report()
            same = flat_bytes(np, sorted_rows(np, parts)) == want
            row = {"phase": "sharded_supervision", "case": f"ysb {case}", "shards": SHARDS,
                   "reshard": SHARD_RESHARD, "batches": YSB_BATCHES, "batch": BATCH,
                   "rows_byte_identical": same, "restarts": sp.restarts,
                   "shard_report": rep, "pushed": pushed["n"],
                   "shard_restores": [r for r in recs if r["event"] == "shard_restore"],
                   "restore_spans": len(journal_spans(recs, "restore")),
                   "recovery_seconds": F.counters()["recovery_seconds"],
                   "reshard_spans": [r["dur_s"] for r in journal_spans(recs, "reshard")],
                   "run_s": dt, "ms_per_batch": dt / YSB_BATCHES * 1e3,
                   "unsharded_supervised_ms_per_batch":
                       SUP_RUN_S.get("ysb", float("nan")) / YSB_BATCHES * 1e3,
                   "launches": counts, "peak_mib": peak / 2 ** 20, "card": card}
            if not same:
                log(row)
                raise AssertionError(f"sharded ysb {case}: rows differ from the plain rows")
            if len(rep) != 8 or sp._sharded.reshard_count != 1:
                raise AssertionError(f"sharded ysb {case}: the reshard did not apply")
            expect_launches(f"sharded ysb {case}", counts, {"histogram": 1, "lookup": 1},
                            pushed["n"])
            if case == "kill_and_reshard":
                if (sp.restarts, rep[2]["restarts"], row["restore_spans"]) != (1, 1, 0):
                    raise AssertionError(f"sharded ysb: restarts {sp.restarts}, shard 2 "
                                         f"{rep[2]['restarts']}, {row['restore_spans']} "
                                         f"whole-domain restores")
                t0 = time.perf_counter()
                states, layout, meta = ck.load_sharded(_fresh_states(sp.chain), path)
                row["load_sharded_ms"] = (time.perf_counter() - t0) * 1e3
                row["sharded_files"] = sorted(os.listdir(SHARD_DIR))
                for k, unit in enumerate(sp._sharded.shards):
                    a = [x for x in leaves(states[k]) if isinstance(x, torch.Tensor)]
                    b = [x for x in leaves(unit.snap) if isinstance(x, torch.Tensor)]
                    if len(a) != len(b) or not all(
                            torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b)):
                        raise AssertionError(f"sharded ysb: shard {k}'s file differs from "
                                             f"its committed snapshot")
                if layout["num_shards"] != 8 or meta["batches_done"] != YSB_BATCHES:
                    raise AssertionError(f"sharded ysb: layout {layout}, meta {meta}")
            else:
                debris = [f for f in os.listdir(SHARD_DIR) if ".handoff" in f]
                if sp.restarts != 1 or debris:
                    raise AssertionError(f"sharded ysb torn handoff: {sp.restarts} "
                                         f"restarts, seals left {debris}")
            log(row)
            for kk, nn in counts.items():
                launches[kk] += nn
            del sp, parts
    finally:
        shutil.rmtree(SHARD_DIR, ignore_errors=True)
    return launches


def sharded_q3_phase(torch, np, wt, registry, card, q3_views):
    """Nexmark q3 (16 x 2^14) under ``SupervisedPipeline(shards=4)``: the
    ``nexmark`` phase's q3 rows (sorted), K5 twice a shard's push."""
    from windflow_tpu_torch.nexmark import make_query

    def rows(views):
        return [(v["key"], v["id"], np.stack([np.asarray(v["payload"][f])
                                              for f in sorted(v["payload"])], 1))
                for v in views if v is not None]
    views = []
    src, ops = make_query("q3_enrich_join", NEX_BATCHES * NEX_BATCH)
    sp = wt.SupervisedPipeline(src, ops, wt.Sink(views.append), batch_size=NEX_BATCH,
                               checkpoint_every=SUP_Q3_EVERY, shards=SHARDS, **SUP_BACKOFF)
    pushed = count_pushes(sp.chain)
    counts, dt, peak = counted_run(torch, registry, sp.start, sp.run)
    same = (flat_bytes(np, sorted_rows(np, rows(views)))
            == flat_bytes(np, sorted_rows(np, rows(q3_views))))
    log({"phase": "sharded_supervision", "case": "q3", "shards": SHARDS,
         "batches": NEX_BATCHES, "batch": NEX_BATCH, "rows_byte_identical": same,
         "pushed": pushed["n"], "run_s": dt, "ms_per_batch": dt / NEX_BATCHES * 1e3,
         "unsharded_supervised_ms_per_batch":
             SUP_RUN_S.get("q3", float("nan")) / NEX_BATCHES * 1e3,
         "launches": counts, "peak_mib": peak / 2 ** 20, "card": card})
    if not same:
        raise AssertionError("sharded q3: rows differ from the nexmark phase's q3 rows")
    if pushed["n"] != SHARDS * NEX_BATCHES:
        raise AssertionError(f"sharded q3: {pushed['n']} pushes")
    expect_launches("sharded q3", counts, {"join_probe": 2}, pushed["n"])
    return counts


def sharded_graph_phase(torch, np, wt, registry, card, gw_parts):
    """``graph_windows`` (phase 17) under ``run_supervised(shards=2)`` with a
    checkpoint every 4 root batches: phase 17's windows (sorted), branch 2's
    count merged over the shards, K2, K3 and K6 once a Win_Seq apply and K6
    once a flush call, K4 as the shards' Ordering_Nodes called it."""
    from collections import Counter
    from windflow_tpu_torch.ops import bitonic as B

    parts, cb = collect_sink()
    g, mp, m = graph_windows(torch, wt, GW_TOTAL, WIN_KEYS, WIN_LEN, WIN_SLIDE,
                             GW_BATCH, cb)
    nodes = []
    ordering_of = g._ordering_of

    def counted_ordering_of(merged):
        o = ordering_of(merged)
        if all(o is not n for n in nodes):
            nodes.append(o)
        return o
    g._ordering_of = counted_ordering_of
    g.start()
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    res = g.run_supervised(checkpoint_every=SUP_GRAPH_EVERY, shards=SHARD_GRAPH,
                           **SUP_BACKOFF)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = registry.launch_counts()
    calls, cuda_launches = k4_launches(B, sum((n.networks for n in nodes), Counter()))
    same = (flat_bytes(np, sorted_rows(np, parts))
            == flat_bytes(np, sorted_rows(np, gw_parts)))
    log({"phase": "sharded_supervision", "case": "graph_windows", "shards": SHARD_GRAPH,
         "batch": GW_BATCH, "tuples": GW_TOTAL, "windows_byte_identical": same,
         "shard_report": g._shard_report, "run_s": dt,
         "unsharded_supervised_run_s": SUP_RUN_S.get("graph", float("nan")),
         "win_seq_applies": m._chain._push_count, "launches": total,
         "k4_calls": calls, "k4_cuda_launches": cuda_launches, "card": card})
    if not same:
        raise AssertionError("sharded graph_windows: windows differ from phase 17's")
    if int(res["rest"]) != len(range(2, GW_TOTAL, 3)):
        raise AssertionError("sharded graph_windows: branch 2's count is wrong")
    if total["ordering_merge"] != calls:
        raise AssertionError(f"sharded graph_windows: K4 counted {total['ordering_merge']}, "
                             f"the nodes made {calls} network calls")
    for k in ("lookup", "segment_fold"):
        if total[k] != m._chain._push_count:
            raise AssertionError(f"sharded graph_windows: {k} {total[k]}, "
                                 f"{m._chain._push_count} Win_Seq applies")
    return total


# -- the interval join's archive tier (tiered q4) --------------------------------------

COLD_FETCH_R = NEX_BATCH  # the fetch's lanes: one a q4 probing lane at 2^14
COLD_FETCH_M = 8          # TierConfig.readmit_rows' default
#: tiered_q4: the JAX package's ring-overwrite test (opens every 8 events,
#: ts = i // 8, bids on random keys) at batch 2^14 and archive 2^14. q4's
#: own window (4 ticks) keeps about 40 rows live, so a ring of 2^14 never
#: overwrites one; here 4096 auctions and a window of 24,576 ticks keep
#: 24,576 opens live: from the 9th batch on each batch overwrites 2048 live
#: opens, which stay live 4 to 5 batches, so they are matched from the
#: outbox and then from the host store; each bid matches 6 or 7 opens,
#: below q4's max_matches of 8
TQ4_KEYS = 4096
TQ4_WINDOW = 24_576
#: a window whose spills expire before they reach the host store (17,000
#: ticks: 2048 spills a batch, live 1 to 2 batches): eager and K = 4 then
#: take every cold row from the outbox in the same order, so their rows
#: match byte for byte; over TQ4_WINDOW a row moves to the store at a
#: maintain, which comes every batch eager and every 4 at K = 4, so its
#: candidate position (outbox or fetched) and the order of a lane's matches
#: differ between the two, the pairs do not (the JAX package's cadence too)
TQ4_OUTBOX_WINDOW = 17_000
TQ4_ARCHIVE = NEX_BATCH
TQ4_BATCHES = 16
TQ4_K = 4                 # its scan dispatch
TQ4_EVERY = 4             # its supervised run: a checkpoint every 4 batches
TQ4_FAULT = 10            # and a chain.step fault at batch 10
#: a tiered IntervalJoin apply: one cold_fetch a side
TQ4_APPLY = {"cold_fetch": 2}


def archive_store(np, tier_cfg, name, n_keys, rows_per_key, seed):
    """An ArchiveTier's multimap store on the card with q4's row schema
    (``ts``, ``id`` and the open/bid payload): ``rows_per_key`` rows a key,
    appended in rounds so every key's chain interleaves with the others',
    with ts drawn so that compacting below 100 retires rows in the middle
    of chains."""
    from windflow_tpu_torch.nexmark import generators as g
    from windflow_tpu_torch.state.tiered import ArchiveTier
    src = g.make_open_bid_source(64)
    tier = ArchiveTier(name, src.payload_spec(), tier_cfg, "l", lambda wm: wm, "cuda")
    rng = np.random.default_rng(seed)
    store = tier.store
    for r in range(int(rows_per_key.max())):
        keys = np.flatnonzero(rows_per_key > r).astype(np.int32)
        n = len(keys)
        z = np.zeros(n, np.int64)
        cols = {"ts": rng.integers(0, 1000, n).astype(np.int32),
                "id": (r * n_keys + keys).astype(np.int32)}
        for c in store.col_names[2:]:
            cols[c] = rng.integers(-1000, 1000, n).astype(store._dtypes[c])
        store.append(keys, z, z, z, cols)
    return tier


#: the fetch's row widths: one column a width (bytes a row), in one store
FETCH_WIDTHS = {"w1": ("uint8", ()), "w2": ("int16", ()), "w4": ("int32", ()),
                "w8": ("int64", ()), "w12": ("int32", (3,)), "w16": ("int32", (4,)),
                "w24": ("int64", (3,))}
FETCH_WIDTH_R = 4096      # its lanes
#: records wider than the fetch stages (1 KB): a float32 leaf of 256 (1024
#: bytes) beside a narrow and a short column (a record of 1072 bytes)
FETCH_WIDE = {"wide": ("float32", (256,)), "w24": ("int64", (3,)), "w4": ("int32", ())}
FETCH_WIDTH_MS = (1, 8, 20)  # rows a lane: one, TierConfig's default, more than most chains


def fetch_case(torch, np, card, case, store, keys, want, M, link_rate, extra=None):
    """``cold_fetch`` against its plain version (the store's host
    ``fetch_multi``) bit for bit, with its time by graph replay, the plain
    version's by CUDA events around its round trips, and the bound
    (``cold_bound``: every chunk of every record fetched over the link)."""
    from windflow_tpu_torch.ops.cold_probe import cold_fetch_cuda, cold_fetch_plain

    def kernel():
        return cold_fetch_cuda(store, keys, want, M)

    def plain():
        return cold_fetch_plain(store, keys, want, M)
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    same, err = compare(torch, got, ref)
    fetched = int(ref[0].sum())
    R = keys.shape[0]
    bound, _ = cold_bound(np, store, keys, want, fetched,
                          R * M * (1 + row_bytes_of(np, store)), link_rate)
    row = {"kernel_check": "cold_fetch", "case": case, "lanes": R,
           "rows_per_lane": M, "store_rows": len(store), **(extra or {}),
           "wanted": int(want.sum()), "fetched": fetched, "bit_identical": same,
           "max_abs_err": err, "kernel_ms": graph_ms(torch, kernel),
           "kernel_eager_ms": time_ms(torch, kernel),
           "plain_ms": time_ms(torch, plain, iters=5, warmup=1), "library_ms": None,
           **bound, "card": card}
    log(row)
    if not same:
        raise AssertionError(f"cold_fetch [{case}]: kernel differs from its plain version")
    return row, ref


def widths_store(np, rng, widths=FETCH_WIDTHS, n_keys=2048, most=25):
    """A multimap store with one column of each of ``widths`` (name: (dtype,
    shape)): ``n_keys`` keys with chains of 0 to ``most`` rows appended in
    rounds, then three keys whose home slot is the index's last, two rows
    each, so the second and third wrap to the index's first slots. Returns
    the store, those three keys and a fourth such key left absent (its probe
    wraps too)."""
    from windflow_tpu_torch.state import HostStore
    widths = {k: (np.dtype(dt), sh) for k, (dt, sh) in widths.items()}
    store = HostStore("widths", {k: dt for k, (dt, _) in widths.items()},
                      {k: sh for k, (_, sh) in widths.items()}, unique=False, device="cuda")

    def put(keys):
        z = np.zeros(len(keys), np.int64)
        store.append(keys, z, z, z, {k: rng.integers(-100, 100, (len(keys),) + sh).astype(dt)
                                     for k, (dt, sh) in widths.items()})
    per_key = rng.integers(0, most + 1, n_keys)
    for r in range(int(per_key.max())):
        put(np.flatnonzero(per_key > r).astype(np.int32))
    lg = store._lg
    ks = np.arange(1 << 13, (1 << 13) + (1 << 23), dtype=np.uint64)
    home = (ks * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(64 - lg)
    wrap = ks[home == (1 << lg) - 1][:4].astype(np.int32)
    for _ in range(2):
        put(wrap[:3])
    ikey, irow = index_of(store)
    slots = [int(np.flatnonzero((ikey == k) & (irow >= 0))[0]) for k in wrap[:3]]
    if store._lg != lg or len(wrap) < 4 or min(slots) >= (1 << lg) - 1:
        raise AssertionError(f"cold_fetch: no key wraps the index (lg {lg}, slots {slots})")
    return store, wrap


def fetch_cases(torch, np):
    """Every input ``cold_fetch`` is checked and timed on: (case, store,
    keys, want, M, extra). R = 2^14 lanes at M = 8 over a store of 4096
    keys with chains of 0 to 20 rows (longer than M, so the truncation
    shows), after compacting below ts 100 (rows retired in the middle of
    chains); keys in 5000 (some absent), a fifth of the lanes not wanted.
    Then row widths of 1, 2, 4, 8, 12, 16 and 24 bytes at M = 1, 8 and 20
    over ``widths_store``, and records wider than the kernel stages
    (``FETCH_WIDE``) at M = 8, each with lanes on the keys that wrap the
    index."""
    from windflow_tpu_torch.state import TierConfig

    cfg = TierConfig()
    rng = np.random.default_rng(21)
    per_key = rng.integers(0, 21, TQ4_KEYS)
    store = archive_store(np, cfg, "fetch", TQ4_KEYS, per_key, 22).store
    retired = store.compact_below("ts", 100)
    gen = torch.Generator(device="cuda").manual_seed(23)
    keys = torch.randint(0, 5000, (COLD_FETCH_R,), generator=gen, device="cuda",
                         dtype=torch.int32)
    want = torch.rand((COLD_FETCH_R,), generator=gen, device="cuda") < 0.8
    M = COLD_FETCH_M
    truncated = int(((torch.from_numpy(per_key).cuda()[keys.long().clamp(max=TQ4_KEYS - 1)]
                      > M) & want & (keys < TQ4_KEYS)).sum())
    cases = [("4096 keys, chains 0-20, compacted", store, keys, want, M,
              {"retired": retired, "lanes_truncated_at_M": truncated})]
    for name, widths, ms, n_keys, most in (("widths 1-24 bytes", FETCH_WIDTHS, FETCH_WIDTH_MS,
                                            2048, 25),
                                           ("records over 1 KB", FETCH_WIDE, (COLD_FETCH_M,),
                                            1024, 12)):
        wstore, wrap = widths_store(np, rng, widths, n_keys, most)
        wkeys = rng.integers(0, n_keys + n_keys // 4, FETCH_WIDTH_R).astype(np.int32)
        wkeys[:64] = np.repeat(wrap, 16)
        wkeys = torch.from_numpy(wkeys).cuda()
        wwant = torch.rand((FETCH_WIDTH_R,), generator=gen, device="cuda") < 0.9
        wwant[:64] = True
        # record_bytes None: a store of an older tree (``--helper-times``)
        extra = {"widths": {k: int(np.prod(sh, dtype=np.int64)) * np.dtype(dt).itemsize
                            for k, (dt, sh) in widths.items()},
                 "record_bytes": getattr(wstore, "record_bytes", None),
                 "wrapped_keys": wrap.tolist()}
        cases += [(f"{name}, M = {m}", wstore, wkeys, wwant, m, extra) for m in ms]
    return cases


def cold_fetch_phase(torch, np, card, link_rate):
    """The archive tier's multimap read against its plain version, bit for
    bit (``fetch_case``), on every ``fetch_cases`` input: the main case
    must retire, truncate and fetch rows, and the wrapped keys give their
    rows as appended. Then a graph captured over a 2-row-a-key store, the
    store grown to 2^18 rows, the graph replayed: the replay reads the grown
    store and its links."""
    from windflow_tpu_torch.ops.cold_probe import cold_fetch_cuda, cold_fetch_plain
    from windflow_tpu_torch.state import TierConfig

    main_row = None
    for case, store, keys, want, m, extra in fetch_cases(torch, np):
        check_mirrors(torch, f"cold_fetch [{case}]", [store])
        row, ref = fetch_case(torch, np, card, case, store, keys, want, m, link_rate, extra)
        if main_row is None:
            main_row = row
            if not (extra["retired"] and extra["lanes_truncated_at_M"] and row["fetched"]):
                raise AssertionError(f"cold_fetch: the case lacks a regime ({extra}, "
                                     f"fetched {row['fetched']})")
        elif int(ref[0][:48].sum()) != 48 * min(m, 2) or bool(ref[0][48:64].any()):
            raise AssertionError(f"cold_fetch [{case}]: the wrapped keys' rows are not as "
                                 f"appended")
    # a graph captured before the store grows reads the grown store
    rng = np.random.default_rng(25)
    M = COLD_FETCH_M
    small = archive_store(np, TierConfig(), "grow", 1 << 10, np.full(1 << 10, 2), 24).store
    gkeys = torch.from_numpy(rng.integers(0, 1 << 10, 4096).astype(np.int32)).cuda()
    gwant = torch.ones((4096,), dtype=torch.bool, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cold_fetch_cuda(small, gkeys, gwant, M)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with collection_paused(), torch.cuda.graph(g):
        gout = cold_fetch_cuda(small, gkeys, gwant, M)
    bufs = [b.host for b in small._bufs]
    n = (1 << 18) - len(small)
    k = np.arange(n, dtype=np.int32) % (1 << 10)
    z = np.zeros(n, np.int64)
    small.append(k, z, z, z, {c: (np.arange(n) % 997).astype(small._dtypes[c])
                              for c in small.col_names})
    grown = [b.host for b in small._bufs] != bufs
    g.replay()
    torch.cuda.synchronize()
    check_mirrors(torch, "cold_fetch: grown past the capture", [small])
    gref = cold_fetch_plain(small, gkeys, gwant, M)
    gsame, gerr = compare(torch, tuple(gout), gref)
    log({"kernel_check": "cold_fetch", "case": "graph captured at 2 rows a key, replayed "
                                               "at 256", "store_rows": len(small),
         "store_reallocated": grown, "bit_identical": gsame, "max_abs_err": gerr,
         "fetched": int(gref[0].sum()), "card": card})
    if not (gsame and grown and int(gref[0].sum()) == 4096 * M):
        raise AssertionError("cold_fetch: a graph captured before the store grew reads "
                             "stale memory")
    return main_row


HELPER_PROBE_ROWS = 1 << 18   # helper_times' probe store: its keys
Q3_STORE_KEYS = 100 * NEX_BATCH  # tiered q3's store at 2^14: its keys


def helper_times(torch, np, ysb, card, lookup_only=False):
    """K2 and the helper kernels timed alone on their check inputs, nothing
    checked: K2 on every ``k2_main_cases`` input (a group of tables in one
    launch where the tree has ``lookup_many_cuda``, one launch a table
    where it has not; ``lookup_only`` stops there); the float fold on every
    ``fold_cases`` input, ``cold_fetch`` on
    every ``fetch_cases`` input and ``cold_probe`` at R = 49,152 over a
    store of 2^18 keys (two columns) and over a store shaped as tiered q3's
    at 2^14 (1,638,400 keys upserted in a seeded order, one int32 column;
    keys in twice the key space, a fifth of the lanes not wanted). It calls
    only the wrappers and the store's public methods (and ``index_of``), so
    the script copied into an older tree times that tree's designs on the
    same inputs (``--helper-times``)."""
    from windflow_tpu_torch.ops import lookup as L, segment as S

    for case, tables, idx, _ in k2_main_cases(torch, ysb):
        log({"helper_times": "lookup", "case": case, "card": card,
             "grouped": len(tables) > 1 and hasattr(L, "lookup_many_cuda"),
             "tables": len(tables), "ms": graph_ms(torch, lambda: k2_call(L, tables, idx))})
    if lookup_only:
        return
    from windflow_tpu_torch.ops.cold_probe import cold_fetch_cuda, cold_probe_cuda
    from windflow_tpu_torch.state import HostStore

    for case, vals, seg, valid, Sn, _ in fold_cases(torch):
        log({"helper_times": "segment_fold_float", "case": case, "card": card,
             "ms": dev_ms(torch, lambda: S.segment_fold_float_cuda(vals, seg, valid, Sn))})
    for case, store, keys, want, m, _ in fetch_cases(torch, np):
        log({"helper_times": "cold_fetch", "case": case, "card": card,
             "ms": graph_ms(torch, lambda: cold_fetch_cuda(store, keys, want, m))})
    store = HostStore("probe", {"v0": np.int32, "v1": np.float32}, device="cuda")
    k = np.arange(HELPER_PROBE_ROWS, dtype=np.int32)
    store.upsert(k, k, k, k, {"v0": k * 3, "v1": k.astype(np.float32) / 7})
    gen = torch.Generator(device="cuda").manual_seed(12)
    keys = torch.randint(0, 2 * HELPER_PROBE_ROWS, (COLD_PROBE_R,), generator=gen,
                         device="cuda", dtype=torch.int32)
    want = torch.rand((COLD_PROBE_R,), generator=gen, device="cuda") < 0.8
    log({"helper_times": "cold_probe", "case": f"{HELPER_PROBE_ROWS}-key store, two columns",
         "card": card, "ms": graph_ms(torch, lambda: cold_probe_cuda(store, keys, want))})
    del store
    q3 = HostStore("q3", {"v0": np.int32}, device="cuda")
    k = np.random.default_rng(14).permutation(Q3_STORE_KEYS).astype(np.int32)
    q3.upsert(k, k, k, k, {"v0": k % 50})
    keys = torch.randint(0, 2 * Q3_STORE_KEYS, (COLD_PROBE_R,), generator=gen,
                         device="cuda", dtype=torch.int32)
    want = torch.rand((COLD_PROBE_R,), generator=gen, device="cuda") < 0.8
    log({"helper_times": "cold_probe", "case": f"q3-shaped store, {Q3_STORE_KEYS} keys",
         "record_bytes": getattr(q3, "record_bytes", None), "card": card,
         "ms": graph_ms(torch, lambda: cold_probe_cuda(q3, keys, want))})


def tq4_query(torch, wt, total, archive, tiered, window=TQ4_WINDOW):
    """q4's IntervalJoin (its emit, q4's max_matches) over the ring-overwrite
    stream at full width (``TQ4_*``): opens every 8 events on auction
    ``(i // 8) % 4096``, bids on ``(i * 2477) % 4096``, ts = i // 8, a
    window of ``window`` ticks."""
    from windflow_tpu_torch.nexmark import make_query

    def is_open(i):
        return (i % 8) == 0

    def key(i):
        return torch.where(is_open(i), (i // 8) % TQ4_KEYS, (i * 2477) % TQ4_KEYS)

    def gen(i):
        return {"side": is_open(i).to(torch.int32), "auction": key(i).to(torch.int32),
                "price": (i % 1000).to(torch.int32)}
    src = wt.DeviceSource(gen, total=total, key_fn=key, ts_fn=lambda i: i // 8,
                          name="tq4_open_bid")
    q4 = make_query("q4_interval_join", 64)[1][0]
    op = wt.IntervalJoin(q4.side_fn, 0, window, archive=archive,
                         max_matches=q4.max_matches, emit=q4.emit, tiered=tiered,
                         name="tq4_interval_join")
    return src, [op]


def tiered_q4_phase(torch, np, wt, registry, card):
    """The interval join's archive tier at full width. Nexmark q4 itself at
    2^14, tiered, for 16 batches: the dense oracle's rows, nothing spilled
    (its 4-tick window keeps about 40 rows live), ``cold_fetch`` twice an
    apply. Then q4's operator over the ring-overwrite stream (``tq4_query``)
    with archive 2^14: untiered with an archive that never overwrites (the
    reference rows), untiered with 2^14 (must lose rows), tiered eager and at
    dispatch K = 4 (the reference rows, spills, eager readmissions,
    ``cold_fetch`` twice an apply counted through the replays) and tiered
    under ``SupervisedPipeline`` with one chain.step fault (the reference
    rows, one restart); the rows are compared sorted (see
    ``TQ4_OUTBOX_WINDOW``). Then the same stream over ``TQ4_OUTBOX_WINDOW``,
    tiered eager and at K = 4: byte for byte in delivery order. ms a step
    eager and at K = 4."""
    from windflow_tpu_torch.nexmark import make_query, oracles
    from windflow_tpu_torch.runtime import faults as F

    total = NEX_BATCHES * NEX_BATCH
    launches = dict.fromkeys(registry.KERNELS, 0)
    src, ops = make_query("q4_interval_join", total, tiered=dict())
    views = []
    pipe = wt.Pipeline(src, ops, wt.Sink(views.append), batch_size=NEX_BATCH,
                       dispatch=False)
    counts, dt, peak = run_pipeline(torch, registry, pipe)
    scat = mirror_scatters(tier_stores(ops))
    got = nexmark_rows(np, "q4_interval_join", [v for v in views if v is not None])
    pipe.chain.tier_settle()
    st = pipe.chain.states[0]
    log({"phase": "tiered_q4", "case": "q4 tiered", "batches": NEX_BATCHES,
         "batch": NEX_BATCH, "rows": len(got), "state_spills": int(st["spills"]),
         "run_s": dt, "ms_per_step": dt / NEX_BATCHES * 1e3, "launches": counts,
         "peak_mib": peak / 2 ** 20, "card": card})
    if got != oracles.ORACLES["q4_interval_join"](total):
        raise AssertionError("tiered q4: rows differ from the dense oracle")
    expect_launches("tiered q4", counts, TQ4_APPLY, NEX_BATCHES, scat)
    for c, nn in counts.items():
        launches[c] += nn

    total = TQ4_BATCHES * NEX_BATCH

    def run(archive, tiered, k=None, window=TQ4_WINDOW):
        src, ops = tq4_query(torch, wt, total, archive, tiered, window)
        views = []
        pipe = wt.Pipeline(src, ops, wt.Sink(views.append), batch_size=NEX_BATCH,
                           dispatch=k or False)
        counts, dt, peak = run_pipeline(torch, registry, pipe, k)
        scat = mirror_scatters(tier_stores(ops))
        views = [v for v in views if v is not None]
        pipe.chain.tier_settle()
        if tiered is not None:
            check_mirrors(torch, f"tiered_q4 (archive {archive}, window {window}, dispatch "
                                 f"{k})", tier_stores(ops))
        st = pipe.chain.states[0]
        info = {"archive": archive, "scatters": scat, "window": window, "tiered": tiered is not None,
                "dispatch": k, "rows": 0, "match_drops": int(st["match_drops"]),
                "arch_drops": int(st["arch_drops"]), "run_s": dt,
                "ms_per_step": dt / TQ4_BATCHES * 1e3, "launches": counts,
                "peak_mib": peak / 2 ** 20}
        if tiered is not None:
            info.update(state_spills=int(st["spills"]), state_readmits=int(st["readmits"]),
                        cold_rows=len(ops[0]._tier_l.store) + len(ops[0]._tier_r.store))
        rows = nexmark_rows(np, "q4_interval_join", views)
        info["rows"] = len(rows)
        return rows, views, counts, pipe.chain.graphs, info
    ref, _, _, _, info = run(total, None)
    log({"phase": "tiered_q4", "case": "untiered, archive never overwrites", **info,
         "card": card})
    if info["match_drops"] or info["arch_drops"]:
        raise AssertionError(f"tiered_q4 reference run dropped: {info}")
    lost, _, _, _, info = run(TQ4_ARCHIVE, None)
    log({"phase": "tiered_q4", "case": "untiered, archive 2^14", **info, "card": card})
    if not len(lost) < len(ref) or not info["arch_drops"]:
        raise AssertionError(f"tiered_q4: the small untiered archive lost no rows ({info})")
    for k in (None, TQ4_K):
        rows, views, counts, graphs, info = run(TQ4_ARCHIVE, dict(), k)
        log({"phase": "tiered_q4", "case": "tiered, archive 2^14", **info,
             "rows_equal_reference": rows == ref, "card": card})
        if rows != ref:
            raise AssertionError(f"tiered_q4 (dispatch {k}): rows differ from the "
                                 f"reference run's")
        # eager, a spill reaches the store two maintains later and is still
        # live there; at K = 4 (a maintain every 4 batches) it expires first
        if (not info["state_spills"] or info["arch_drops"]
                or (k is None and not info["state_readmits"])):
            raise AssertionError(f"tiered_q4 (dispatch {k}): spills and drops {info}")
        expect_launches(f"tiered_q4 (dispatch {k})", counts, TQ4_APPLY, TQ4_BATCHES,
                        info["scatters"])
        for c, nn in counts.items():
            launches[c] += nn
    runs = {}
    for k in (None, TQ4_K):
        rows, views, counts, graphs, info = run(TQ4_ARCHIVE, dict(), k,
                                                window=TQ4_OUTBOX_WINDOW)
        log({"phase": "tiered_q4", "case": "tiered, archive 2^14, outbox window", **info,
             "card": card})
        if not info["state_spills"] or info["state_readmits"] or info["arch_drops"]:
            raise AssertionError(f"tiered_q4 outbox window (dispatch {k}): {info}")
        expect_launches(f"tiered_q4 outbox window (dispatch {k})", counts, TQ4_APPLY,
                        TQ4_BATCHES, info["scatters"])
        runs[k] = (views, counts, graphs)
    check_dispatch(np, "tiered_q4", TQ4_K, TQ4_BATCHES, runs[None][:2], runs[TQ4_K][:2],
                   runs[TQ4_K][2])
    plan = F.FaultPlan([F.FaultSpec("chain.step", where={"pos": TQ4_FAULT},
                                    max_fires=1)], seed=9)
    src, ops = tq4_query(torch, wt, total, TQ4_ARCHIVE, dict())
    views = []
    sp = wt.SupervisedPipeline(src, ops, wt.Sink(views.append), batch_size=NEX_BATCH,
                               checkpoint_every=TQ4_EVERY, faults=plan, dispatch=False,
                               **SUP_BACKOFF)
    counts, dt, peak = counted_run(torch, registry, sp.start, sp.run)
    rows = nexmark_rows(np, "q4_interval_join", [v for v in views if v is not None])
    log({"phase": "tiered_q4", "case": "supervised, one chain.step fault",
         "checkpoint_every": TQ4_EVERY, "fault_at": TQ4_FAULT, "restarts": sp.restarts,
         "rows": len(rows), "rows_equal_reference": rows == ref, "run_s": dt,
         "ms_per_step": dt / TQ4_BATCHES * 1e3, "launches": counts,
         "peak_mib": peak / 2 ** 20, "card": card})
    if rows != ref or sp.restarts != 1:
        raise AssertionError(f"tiered_q4 supervised: rows equal {rows == ref}, "
                             f"{sp.restarts} restarts")
    return launches


# ------------------------------------------------------------------ monitoring

MON_DIR = os.path.join(ROOT, "build", "monitoring")
MON_TRACE_SAMPLE = 4      # the monitored YSB traces every 4th batch
MON_REPLAYS = 20          # timed K-step replays of each YSB chain


def ysb_lateness_recount(np, et, total, batch):
    """The YSB window's ``lat_hist`` recounted in numpy: lanes ``i`` with
    ``i % 3 == 0`` (the filter's views), ``ts = i // 10``, each batch's
    lateness against the batch's post-batch watermark (the running max of
    the views' ts), bucketed with the port's own ``bucket_of``."""
    hist = np.zeros(et.NB, np.int64)
    wm = -1
    for lo in range(0, total, batch):
        i = np.arange(lo, min(lo + batch, total), dtype=np.int64)
        ts = i[i % 3 == 0] // 10
        if len(ts):
            wm = max(wm, int(ts.max()))
        lat, inv = np.unique(np.maximum(wm - ts, 0), return_inverse=True)
        buckets = np.array([et.bucket_of(int(v)) for v in lat], np.int64)
        np.add.at(hist, buckets[inv], 1)
    return hist.tolist()


def late_bid_source(torch, wt, total):
    """Nexmark's bid stream with stragglers: one event in 13 arrives 40 ticks
    late, behind its session's floor (q5 drops it as OLD)."""
    from windflow_tpu_torch.nexmark import generators as g

    def gen(i):
        return {"auction": g.bid_auction(i).to(torch.int32),
                "bidder": g.bid_bidder(i).to(torch.int32),
                "price": g.bid_price(i).to(torch.int32)}

    def ts(i):
        return (i // 8 - torch.where((i * 7919) % 13 == 0, 40, 0)).to(torch.int32)
    return wt.DeviceSource(gen, total=total, name="nexmark_late_bids",
                           key_fn=g.bid_auction, ts_fn=ts)


def replay_ms(torch, chain, batches):
    """ms a batch of ``MON_REPLAYS`` ``push_many`` replays of ``batches`` (one
    K-step graph) on ``chain``, after one untimed replay."""
    chain.push_many(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MON_REPLAYS):
        chain.push_many(batches)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (MON_REPLAYS * len(batches)) * 1e3


def monitoring_phase(torch, np, wt, ysb, registry, card, ysb_ref, ysb_launches,
                     gw_rows):
    """Phase 42 (see the module docstring). ``ysb_ref``: phase 4's sink rows
    (``flat_bytes``), ``ysb_launches``: its launches, ``gw_rows``: phase 17's
    windows. Returns the monitored YSB run's launches."""
    import shutil
    from windflow_tpu_torch.nexmark import make_query
    from windflow_tpu_torch.observability import (MonitoringConfig, TraceConfig,
                                                  event_time, journal, tracing)
    from windflow_tpu_torch.runtime import faults as F

    shutil.rmtree(MON_DIR, ignore_errors=True)
    k = DISPATCH_K["ysb"]
    total = YSB_BATCHES * BATCH
    cap = BATCH
    runs = {}
    for monitored in (False, True):
        out = os.path.join(MON_DIR, "ysb")
        mon = (MonitoringConfig(out_dir=out, event_time=True, health=True, interval_s=0.5)
               if monitored else False)
        trace = (TraceConfig(out_dir=os.path.join(out, "trace"),
                             sample_every=MON_TRACE_SAMPLE) if monitored else False)
        parts, cb = collect_sink()
        ops = ysb.make_ops(**ysb.bench_geometry(BATCH))
        pipe = wt.Pipeline(ysb.make_source(total), ops, wt.Sink(cb), batch_size=BATCH,
                           dispatch=k, monitoring=mon, trace=trace)
        # the eager step's first build outside the count; the K-step graph is
        # captured in run() (prewarm), under the ledger when monitored
        launches, dt, peak = counted_run(torch, registry,
                                         lambda: pipe.chain.warm_scan(1, cap), pipe.run)
        runs[monitored] = {"parts": parts, "launches": launches, "run_s": dt, "pipe": pipe,
                           "peak": peak}
    mon_run, off_run = runs[True], runs[False]
    chain = mon_run["pipe"].chain
    got_hist = event_time.read_hist(chain.states[-1].lat_hist)
    want_hist = ysb_lateness_recount(np, event_time, total, BATCH)
    # each chain's K-step graph replayed (the monitor finished: no sampled
    # wait); the difference is what the lateness histogram costs a step
    three = list(ysb.make_source(k * BATCH).batches(BATCH))
    step_ms = {m: replay_ms(torch, r["pipe"].chain, three) for m, r in runs.items()}
    hist_dev = torch.zeros(event_time.NB, dtype=torch.int32, device="cuda")
    lane = torch.arange(BATCH, dtype=torch.int32, device="cuda")
    ts_dev = lane // 10
    wm_dev = ts_dev.max()
    mask = lane % 3 == 0
    upd = lambda: event_time.lateness_update(hist_dev, wm_dev, ts_dev, mask)  # noqa: E731
    lat_eager_ms = time_ms(torch, upd)
    lat_graph_ms = graph_ms(torch, upd)

    out = os.path.join(MON_DIR, "ysb")
    with open(os.path.join(out, "snapshot.json")) as f:
        snap = json.load(f)
    recs = journal.read_journal(os.path.join(out, "events.jsonl"))
    dev = snap["health"]["devices"][0]
    ledger = snap["health"]["compile"]
    scans = [r for r in recs if r["event"] == "compile" and r["kind"] == "scan"]
    sampled = [r for r in recs if r["event"] in ("launch", "dispatch_fused")]
    artifacts = {n: os.path.getsize(os.path.join(out, n))
                 for n in ("snapshot.json", "metrics.prom", "topology.json", "events.jsonl")}
    flight, _meta = tracing.load_flight(os.path.join(out, "trace"))
    row = {"phase": "monitoring_ysb", "card": card, "batches": YSB_BATCHES, "batch": BATCH,
           "dispatch": k, "run_ms_per_batch": mon_run["run_s"] / YSB_BATCHES * 1e3,
           "unmonitored_run_ms_per_batch": off_run["run_s"] / YSB_BATCHES * 1e3,
           "captured_step_ms": step_ms[True], "unmonitored_captured_step_ms": step_ms[False],
           "lateness_update_ms": lat_eager_ms, "lateness_update_graph_ms": lat_graph_ms,
           "launches": mon_run["launches"], "unmonitored_launches": off_run["launches"],
           "phase4_launches": ysb_launches, "lat_hist": got_hist,
           "memory": dev, "ledger": ledger, "graphs": len(chain.graphs),
           "scan_captures": len(scans), "sampled_records": len(sampled),
           "flight_records": len(flight), "artifact_bytes": artifacts,
           "device_time": snap["health"].get("device_time"),
           "peak_mib": mon_run["peak"] / 2 ** 20,
           "unmonitored_peak_mib": off_run["peak"] / 2 ** 20}
    log(row)
    for m, r in runs.items():
        if flat_bytes(np, r["parts"]) != ysb_ref:
            raise AssertionError(f"monitoring_ysb (monitored={m}): rows differ from phase 4's")
        if r["launches"] != ysb_launches:
            raise AssertionError(f"monitoring_ysb (monitored={m}): launches {r['launches']}, "
                                 f"phase 4 {ysb_launches}")
    if got_hist != want_hist:
        raise AssertionError(f"monitoring_ysb: lat_hist {got_hist}, numpy {want_hist}")
    if not (dev.get("bytes_in_use", 0) > 0 and dev.get("bytes_limit", 0) > 0
            and dev["headroom_bytes"] == dev["bytes_limit"] - dev["bytes_in_use"]):
        raise AssertionError(f"monitoring_ysb: memory gauges {dev}")
    if (len(scans) != len(chain.graphs) or ledger["retraces_unexpected"]
            or len({r["cache_key"] for r in scans}) != len(scans)):
        raise AssertionError(f"monitoring_ysb: ledger {ledger}, {len(scans)} scan captures, "
                             f"{len(chain.graphs)} graphs")
    if not sampled or not all(artifacts.values()):
        raise AssertionError(f"monitoring_ysb: artifacts {artifacts}, {len(sampled)} sampled")
    if {r["tid"] for r in flight if r["kind"] == "ingest"} != {
            tracing.mint_trace_id("ysb_source-pipeline", 0, p)
            for p in range(0, YSB_BATCHES, MON_TRACE_SAMPLE)}:
        raise AssertionError("monitoring_ysb: traced ids are not the sampled positions'")
    del runs, mon_run, off_run, chain

    # q5 over stragglers, unmonitored then monitored
    qtotal = NEX_BATCHES * NEX_BATCH
    q5 = {}
    for monitored in (False, True):
        out = os.path.join(MON_DIR, "q5")
        _src, ops = make_query("q5_session", qtotal)
        views = []
        pipe = wt.Pipeline(late_bid_source(torch, wt, qtotal), ops,
                           wt.Sink(lambda v: views.append(v) if v is not None else None),
                           batch_size=NEX_BATCH,
                           monitoring=(MonitoringConfig(out_dir=out, event_time=True,
                                                        interval_s=60) if monitored else False))
        launches, dt, _ = counted_run(torch, registry, lambda: None, pipe.run)
        drops = ops[-1].drop_counters(pipe.chain.states[-1])
        q5[monitored] = (flat_bytes(np, views), launches, dt, drops)
    recs = journal.read_journal(os.path.join(MON_DIR, "q5", "events.jsonl"))
    late = [r for r in recs if r["event"] == "lateness_drop"]
    n_late = sum(r["n"] for r in late)
    log({"phase": "monitoring_q5", "card": card, "batches": NEX_BATCHES, "batch": NEX_BATCH,
         "rows_bytes_equal": q5[True][0] == q5[False][0], "drops": q5[True][3],
         "lateness_drop_records": len(late), "lateness_drop_n": n_late,
         "run_ms_per_batch": q5[True][2] / NEX_BATCHES * 1e3,
         "unmonitored_run_ms_per_batch": q5[False][2] / NEX_BATCHES * 1e3,
         "launches": q5[True][1], "unmonitored_launches": q5[False][1]})
    if q5[True][0] != q5[False][0] or not q5[True][0]:
        raise AssertionError("monitoring_q5: monitored rows differ from the unmonitored run's")
    if q5[True][1] != q5[False][1]:
        raise AssertionError("monitoring_q5: monitoring changed the launches")
    if not (n_late == q5[True][3]["old_drops"] > 0):
        raise AssertionError(f"monitoring_q5: lateness_drop n {n_late}, drops {q5[True][3]}")

    # graph_windows, threaded, traced
    out = os.path.join(MON_DIR, "graph_windows")
    parts, cb = collect_sink()
    g, _mp, merged = graph_windows(torch, wt, GW_TOTAL, WIN_KEYS, WIN_LEN, WIN_SLIDE,
                                   GW_BATCH, cb, trace=TraceConfig(out_dir=out))
    t0 = time.perf_counter()
    g.start(threaded=True)
    g.wait_end()
    torch.cuda.synchronize()
    gw_s = time.perf_counter() - t0
    flight, meta = tracing.load_flight(out)
    chrome = json.loads(json.dumps(tracing.to_chrome_trace(flight, meta=meta)))
    ids = {r["tid"] for r in flight if r["kind"] == "ingest"}
    # every id crosses every ring (the source's, the three split rings, the
    # two merge rings) and has one service span on every pipe but the
    # merged one, whose Ordering_Node releases re-sliced batches (no id)
    edges = [label for _p, _c, label, _i in g._iter_edges()]
    spans = [g._trace_label(p) for p in g._all_pipes() if p is not merged]
    bad = 0
    for tid in ids:
        kinds = [(r["stage"], r["kind"]) for r in flight if r["tid"] == tid]
        bad += any(kinds.count((e, "enq")) != 1 or kinds.count((e, "deq")) != 1
                   for e in edges) or any(
            kinds.count((p, "begin")) != 1 or kinds.count((p, "end")) != 1 for p in spans)
    log({"phase": "monitoring_graph_windows", "card": card, "tuples": GW_TOTAL,
         "batch": GW_BATCH, "traced_ids": len(ids), "flight_records": len(flight),
         "edges": edges, "span_stages": spans,
         "chrome_events": len(chrome["traceEvents"]), "ids_off_path": bad, "run_s": gw_s})
    if as_dict(np, parts) != gw_rows:
        raise AssertionError("monitoring_graph_windows: windows differ from phase 17's")
    if not ids or bad or meta["dropped"]:
        raise AssertionError(f"monitoring_graph_windows: {bad} of {len(ids)} traced ids "
                             f"miss a ring edge or a pipe span ({meta['dropped']} dropped)")

    # supervised YSB, one fault, traced
    out = os.path.join(MON_DIR, "supervised")
    parts, cb = collect_sink()
    sp = wt.SupervisedPipeline(
        ysb.make_source(total), ysb.make_ops(**ysb.bench_geometry(BATCH)), wt.Sink(cb),
        batch_size=BATCH, checkpoint_every=SUP_EVERY, trace=TraceConfig(out_dir=out),
        faults=F.FaultPlan([F.FaultSpec("chain.step", where={"pos": 3}, max_fires=1)]),
        **SUP_BACKOFF)
    sp.run()
    flight, _meta = tracing.load_flight(out)
    aborted = [r for r in flight if r.get("aborted") == "restore"]
    begins = sum(r["kind"] == "begin" for r in flight)
    ends = sum(r["kind"] == "end" for r in flight)
    log({"phase": "monitoring_supervised", "card": card, "restarts": sp.restarts,
         "aborted_spans": len(aborted), "begins": begins, "ends": ends,
         "rows_equal_phase4": flat_bytes(np, parts) == ysb_ref})
    if flat_bytes(np, parts) != ysb_ref:
        raise AssertionError("monitoring_supervised: rows differ from phase 4's")
    if sp.restarts != 1 or len(aborted) != 1 or begins != ends:
        raise AssertionError(f"monitoring_supervised: {sp.restarts} restarts, "
                             f"{len(aborted)} aborted spans, {begins} begins, {ends} ends")
    shutil.rmtree(MON_DIR, ignore_errors=True)
    return row["launches"]



CTL_BATCHES = 100         # control: batches of each controlled YSB run (2^20 each)
CTL_DIR = os.path.join(ROOT, "build", "control")
CTL_Q3_EVERY = 2          # control: supervised q3's checkpoint interval
CTL_OVERLOAD_BATCHES = 50  # control: the overload run's batches of 32 tuples
CTL_OVERLOAD_SLEEP_S = 0.004  # and its sink's sleep a batch
CTL_OVERLOAD_REFILL = 24.0  # and the tuples its positional bucket adds an offer


def control_ysb_runs(torch, np, wt, ysb, registry, card):
    """The controlled YSB runs of ``control_phase``: the uncontrolled
    reference, the capacity ladder 2^18 .. 2^22 (one first run a rung at
    prewarm, none after), its warm start from the tuning cache, and the
    dispatch K tuner. Returns the controlled run's launches."""
    import shutil
    from windflow_tpu_torch import control as C
    from windflow_tpu_torch.observability import device_health as dh

    shutil.rmtree(CTL_DIR, ignore_errors=True)
    os.makedirs(CTL_DIR)
    total = CTL_BATCHES * BATCH
    ladder = C.build_ladder(BATCH, up=2, down=2)
    geometry = ysb.bench_geometry(ladder[-1])

    def run(control, dispatch=False, ledger=None):
        parts, cb = collect_sink()
        pipe = wt.Pipeline(ysb.make_source(total), ysb.make_ops(**geometry), wt.Sink(cb),
                           batch_size=BATCH, control=control, dispatch=dispatch)
        chain = pipe.chain
        pushes, warms = {}, []
        push, warm = chain.push, chain.warm

        def counted_push(batch, from_op=0):
            if from_op == 0:
                pushes[batch.capacity] = pushes.get(batch.capacity, 0) + 1
            return push(batch, from_op=from_op)

        def timed_warm(capacity):
            t0 = time.perf_counter()
            warm(capacity)
            torch.cuda.synchronize()
            warms.append((capacity, time.perf_counter() - t0))
        chain.push, chain.warm = counted_push, timed_warm
        C.reset()
        dh.set_active(ledger)
        try:
            launches, dt, peak = run_pipeline(torch, registry, pipe)
        finally:
            dh.set_active(None)
        return dict(pipe=pipe, parts=parts, launches=launches, run_s=dt, peak=peak,
                    pushes=pushes, warms=warms, counters=C.counters(), gauges=C.gauges())

    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now
    def windows(parts):
        # every (key, window, count) row, sorted: the rebatched runs fire
        # the same windows at other pushes
        return flat_bytes(np, sorted_rows(np, parts))
    ref = run(False)
    lap("ref_run")
    want = windows(ref["parts"])
    lap("ref_rows")
    cache = os.path.join(CTL_DIR, "tuning.json")
    cfg = C.ControlConfig(decide_every=2, settle_batches=0, cache_path=cache)
    ledger = dh.HealthLedger()
    tuned = run(cfg, ledger=ledger)
    lap("tuned_run")
    tuner = tuned["pipe"].tuner
    plan = tuner.plan()
    health = ledger.snapshot_section()
    notes = [r for r in health["compile_log"] if r["from_op"] == 0 and r["kind"] == "step"]
    key = C.tuning_key(C.chain_signature(tuned["pipe"].chain.ops),
                       C.payload_signature(tuned["pipe"].chain.specs[0]),
                       C.device_kind(torch.device("cuda")))
    entry = json.load(open(cache)).get(key) if os.path.exists(cache) else None
    warm = run(cfg)
    lap("warm_run")
    wtuner = warm["pipe"].tuner
    pushed = sum(tuned["pushes"].values())
    row = {"phase": "control_ysb", "card": card, "batches": CTL_BATCHES, "batch": BATCH,
           "ladder": ladder, "geometry": geometry, "plan": plan["capacity"],
           "converged": plan["converged"],
           "host_ms_per_push": {str(c): c / r * 1e3 for c, r in plan["rates"].items()},
           "host_ms_per_2_20": {str(c): BATCH / r * 1e3 for c, r in plan["rates"].items()},
           "prewarm_s": {str(c): s for c, s in tuned["warms"]},
           "pushes_by_capacity": {str(c): n for c, n in sorted(tuned["pushes"].items())},
           "launches": tuned["launches"], "run_s": tuned["run_s"], "ref_run_s": ref["run_s"],
           "counters": tuned["counters"], "gauges": tuned["gauges"],
           "ledger_compile": health["compile"],
           "ledger_step_notes": [(r["capacity"], r["cause"]) for r in notes],
           "device_kind": C.device_kind(torch.device("cuda")), "cache_entry": entry,
           "warm_start": {"capacity": wtuner.capacity, "counters": warm["counters"],
                          "prewarm": [c for c, _ in warm["warms"]], "run_s": warm["run_s"]},
           "peak_mib": tuned["peak"] / 2 ** 20}
    same = windows(tuned["parts"]) == want and windows(warm["parts"]) == want
    lap("rows")
    log(dict(row, step_s=laps))
    if not same:
        raise AssertionError("control_ysb: windows differ from the uncontrolled run's")
    if sorted(c for c, _ in tuned["warms"]) != ladder:
        raise AssertionError(f"control_ysb: prewarm {tuned['warms']}, ladder {ladder}")
    if (sorted(r["capacity"] for r in notes) != ladder
            or {r["cause"] for r in notes} != {"autotune_prewarm"}
            or health["compile"]["retraces_unexpected"]):
        raise AssertionError(f"control_ysb: capture ledger {notes}, {health['compile']}")
    for name in ("histogram", "lookup"):
        if tuned["launches"][name] != pushed + len(ladder):
            raise AssertionError(f"control_ysb: {name} launched {tuned['launches'][name]}, "
                                 f"{pushed} pushes and {len(ladder)} warm steps")
    if not (plan["converged"] and entry and entry["capacity"] == plan["capacity"]
            and tuned["counters"]["capacity_switches"] > 0):
        raise AssertionError(f"control_ysb: plan {plan}, cache entry {entry}")
    if not (warm["counters"]["tuning_cache_hits"] == 1
            and warm["counters"]["capacity_switches"] == 0
            and wtuner.capacity == plan["capacity"] and wtuner.cache_key == key
            and C.device_kind(torch.device("cuda")).startswith("gpu:")):
        raise AssertionError(f"control_ysb: warm start {warm['counters']}, "
                             f"rung {wtuner.capacity}")

    # each rung's captured ms a batch: a K = 2 graph at that capacity on a
    # chain bound at the top rung, replayed
    chain = wt.CompiledChain(ysb.make_ops(**geometry), ysb.make_source(1).payload_spec(),
                             batch_capacity=ladder[-1])
    lap("rung_chain")
    per_rung, rung_s = {}, {}
    for c in ladder:
        t0 = time.perf_counter()
        batches = list(ysb.make_source(2 * c).batches(c))
        per_rung[str(c)] = replay_ms(torch, chain, batches)
        rung_s[str(c)] = time.perf_counter() - t0
    lap("rungs")
    log({"phase": "control_ysb_rungs", "card": card, "step_s": rung_s,
         "captured_ms_per_push": per_rung,
         "captured_ms_per_2_20": {c: ms * BATCH / int(c) for c, ms in per_rung.items()}})

    kcfg = C.ControlConfig(ladder_up=0, ladder_down=0, decide_every=2, settle_batches=0,
                           cache_path=os.path.join(CTL_DIR, "tuning_k.json"))
    kled = dh.HealthLedger()
    krun = run(kcfg, dispatch={"k": 4}, ledger=kled)
    lap("k_run")
    kpipe = krun["pipe"]
    kplan = kpipe.ktuner.plan()
    scans = [r for r in kled.snapshot_section()["compile_log"] if r["kind"] == "scan"]
    prewarmed = sorted(r["k"] for r in scans if r["cause"] == "autotune_prewarm")
    log({"phase": "control_dispatch_k", "card": card, "batches": CTL_BATCHES,
         "k_ladder": kplan["ladder"], "plan": kplan["capacity"],
         "converged": kplan["converged"],
         "host_ms_per_batch": {str(k): BATCH / r * 1e3 for k, r in kplan["rates"].items()},
         "prewarmed_k": prewarmed,
         "graph_replays": {f"k{kk}": g.replays for (_, kk, _), g in kpipe.chain.graphs.items()},
         "launches": krun["launches"], "run_s": krun["run_s"],
         "gauges": krun["gauges"], "counters": krun["counters"], "step_s": laps})
    if windows(krun["parts"]) != want:
        raise AssertionError("control_dispatch_k: windows differ from dispatch off")
    if prewarmed != [2, 4]:
        raise AssertionError(f"control_dispatch_k: K ladder prewarmed as {prewarmed}")
    for name in ("histogram", "lookup"):
        if krun["launches"][name] != CTL_BATCHES + 1:
            raise AssertionError(f"control_dispatch_k: {name} launched "
                                 f"{krun['launches'][name]} times")
    shutil.rmtree(CTL_DIR, ignore_errors=True)
    return tuned["launches"]


def control_selection_checks(torch, np, wt, ysb, registry, card, ysb_ref):
    """Kernel selection on the card: every family resolves ``cuda`` by
    default; a YSB chain built under ``WF_KERNEL_IMPL=torch`` gives phase 4's
    rows with no hand-kernel launch; ``impl="cuda"`` on a CPU tensor
    raises; a graph captured before the env changed is named by
    ``stale_selections`` and its replays count the kernels it captured."""
    from windflow_tpu_torch.observability import names
    from windflow_tpu_torch.ops.histogram import keyed_pane_histogram

    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now
    defaults = {k: registry.resolve_impl(k, device=torch.device("cuda"), record=False)
                for k in names.KERNELS}
    recorded = {k: sorted(v) for k, v in registry.trace_records().items()
                if k[2].startswith("gpu:")}
    families = sorted({k[0] for k in recorded})
    if set(defaults.values()) != {"cuda"} or families != sorted(names.KERNELS) or \
            any(v != ["cuda"] for v in recorded.values()):
        raise AssertionError(f"control_selection: defaults {defaults}, records {recorded}")
    lap("defaults")
    chain = wt.CompiledChain(ysb.make_ops(**ysb.bench_geometry(BATCH)),
                             ysb.make_source(1).payload_spec(), batch_capacity=BATCH)
    chain.warm_scan(2, BATCH)                    # captured under the default
    graph = chain.graphs[(0, 2, BATCH)]
    lap("capture")
    old = os.environ.get("WF_KERNEL_IMPL")
    os.environ["WF_KERNEL_IMPL"] = "torch"
    try:
        parts, cb = collect_sink()
        pipe = wt.Pipeline(ysb.make_source(YSB_BATCHES * BATCH),
                           ysb.make_ops(**ysb.bench_geometry(BATCH)), wt.Sink(cb),
                           batch_size=BATCH)
        lap("forced_build")
        forced, dt, _ = run_pipeline(torch, registry, pipe)
        same = flat_bytes(np, parts) == ysb_ref
        lap("forced_run")
        stale = [r for r in registry.stale_selections() if graph.name in r.get("graphs", ())]
        lap("stale")
        batches = list(ysb.make_source(2 * BATCH).batches(BATCH))
        registry.reset_launches()
        chain.push_many(batches)
        torch.cuda.synchronize()
        replayed = registry.launch_counts()
        lap("replay")
    finally:
        if old is None:
            os.environ.pop("WF_KERNEL_IMPL")
        else:
            os.environ["WF_KERNEL_IMPL"] = old
    try:
        keyed_pane_histogram(torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
                             torch.ones(8, dtype=torch.bool), 2, 4, impl="cuda")
        refused = False
    except ValueError:
        refused = True
    log({"phase": "control_selection", "card": card, "defaults": defaults,
         "recorded_families": families, "forced_torch_launches": forced,
         "forced_torch_rows_byte_identical": same, "forced_torch_run_s": dt,
         "stale_of_graph": stale, "graph": graph.name, "graph_launches": graph.launches,
         "replay_launches": replayed, "cuda_on_cpu_refused": refused, "step_s": laps})
    if not same or any(forced.values()):
        raise AssertionError(f"control_selection: forced torch rows {same}, launches {forced}")
    if not stale or {r["recorded"] for r in stale} != {"cuda"} or \
            {r["current"] for r in stale} != {"torch"}:
        raise AssertionError(f"control_selection: stale selections {stale}")
    want = {k: 2 if k in ("histogram", "lookup") else 0 for k in replayed}
    if replayed != want or graph.launches != {"histogram": 2, "lookup": 2}:
        raise AssertionError(f"control_selection: replay launches {replayed}")
    if not refused:
        raise AssertionError("control_selection: impl='cuda' on a CPU tensor ran")


def overload_run(torch, wt, control):
    """A fast source straight into a slow sink through ``ThreadedPipeline``
    (one ring of 8, the one the governor bounds: it throttles the source, so
    a stage between two rings would forward what the first held into the
    second): (batches delivered, the deepest ring seen, the pipeline)."""
    import threading
    got, depth = [0], [0]

    def sink(v):
        if v is not None:
            time.sleep(CTL_OVERLOAD_SLEEP_S)
            got[0] += 1
    tp = wt.ThreadedPipeline(wt.Source(lambda i: {"v": i.float()},
                                       total=CTL_OVERLOAD_BATCHES * 32),
                             [], wt.Sink(sink), batch_size=32, pin=False, queue_capacity=8,
                             control=control)
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            depth[0] = max(depth[0], *tp.queue_depths().values())
            time.sleep(0.0005)
    w = threading.Thread(target=watch)
    w.start()
    try:
        tp.run()
    finally:
        stop.set()
        w.join()
    return got[0], depth[0], tp


def control_governor_checks(torch, np, wt, registry, card, gw_rows):
    """The governor on the card: overload bounded at the high watermark (+1)
    with shedding under control, the ring pegged at capacity without; the
    governed threaded ``graph_windows`` gives the serial run's windows, K2,
    K3 and K6 once a Win_Seq apply and K4 as the node called it. Returns
    the governed graph's launches."""
    from windflow_tpu_torch import control as C
    from windflow_tpu_torch.ops import bitonic as B

    C.reset()
    # the positional bucket (24 tuples an offer, 2 batches of burst) admits 3
    # offers of 4, faster than the sink drains (32 tuples / 4 ms): the governor
    # throttles, and the bucket sheds the offers its schedule names, however
    # the source's bursts fall against the sink's pops (a wall-clock bucket
    # refills while the throttled source waits, so its sheds were a race)
    on = C.ControlConfig(autotune=False, backpressure=True, high_watermark=0.5,
                         low_watermark=0.25, admission=True,
                         refill_per_batch=CTL_OVERLOAD_REFILL, burst_tuples=64.0)
    got_on, depth_on, tp = overload_run(torch, wt, on)
    c_on = C.counters()
    tokens, want_shed = 64.0, 0
    for _ in range(CTL_OVERLOAD_BATCHES):
        tokens = min(64.0, tokens + CTL_OVERLOAD_REFILL)
        if tokens >= 32.0:
            tokens -= 32.0
        else:
            want_shed += 1
    C.reset()
    got_off, depth_off, _ = overload_run(torch, wt, False)
    c_off = C.counters()
    log({"phase": "control_overload", "card": card, "batches": CTL_OVERLOAD_BATCHES,
         "queue_capacity": 8, "high": 4, "delivered_on": got_on, "max_depth_on": depth_on,
         "delivered_off": got_off, "max_depth_off": depth_off,
         "shed_batches": c_on["shed_batches"], "want_shed": want_shed,
         "throttle_events": c_on["throttle_events"], "throttle_s": c_on["throttle_seconds"]})
    if (depth_on > 5 or c_on["shed_batches"] != want_shed or want_shed <= 0
            or c_on["throttle_events"] <= 0 or got_on != CTL_OVERLOAD_BATCHES - want_shed):
        raise AssertionError(f"control_overload: depth {depth_on}, counters {c_on}")
    if depth_off < 8 or got_off != CTL_OVERLOAD_BATCHES or any(c_off.values()):
        raise AssertionError(f"control_overload off: depth {depth_off}, {got_off} delivered")

    C.reset()
    parts, cb = collect_sink()
    gov = C.ControlConfig(autotune=False, backpressure=True, high_watermark=0.5,
                          low_watermark=0.25)
    g, mp, m = graph_windows(torch, wt, GW_TOTAL, WIN_KEYS, WIN_LEN, WIN_SLIDE, GW_BATCH,
                             cb, control=gov)
    op = m.ops[0]
    inner, flushes = op.flush, []

    def flush(state):
        flushes.append(1)
        return inner(state)
    op.flush = flush
    try:
        launches, dt, _ = counted_run(torch, registry, lambda: g.start(threaded=True),
                                      g.wait_end)
    finally:
        del op.flush
    got = as_dict(np, parts)
    calls, _ = k4_launches(B, m._ordering.networks)
    applies = m._chain._push_count
    expect = dict.fromkeys(registry.KERNELS, 0)
    expect.update(lookup=applies, segment_fold=applies, ordering_merge=calls,
                  masked_window_reduce=applies + len(flushes))
    c = C.counters()
    log({"phase": "control_graph_windows", "card": card, "threaded": True,
         "batch": GW_BATCH, "tuples": GW_TOTAL, "windows": len(got), "run_s": dt,
         "launches": launches, "throttle_events": c["throttle_events"],
         "throttle_s": c["throttle_seconds"], "gauges": C.gauges()})
    if got != gw_rows:
        raise AssertionError("control_graph_windows: windows differ from the serial run's")
    if launches != expect:
        raise AssertionError(f"control_graph_windows: launches {launches}, expected {expect}")
    return launches


def control_supervised_checks(torch, np, wt, registry, card, q3_views):
    """q3 under supervised admission: a seeded fault plan replays to the
    clean run's rows and shed decisions; with ``remediation=True`` the
    barrier remediation fires and the faulted replay takes the same
    decisions; ``shards=2, reshard="auto"`` gives the unsharded rows
    (sorted). Returns the clean admission run's launches."""
    from windflow_tpu_torch import control as C
    from windflow_tpu_torch.nexmark import make_query
    from windflow_tpu_torch.observability import journal as J
    from windflow_tpu_torch.runtime import faults as F

    def rows(views):
        return [(v["key"], v["id"], np.stack([np.asarray(v["payload"][f])
                                              for f in sorted(v["payload"])], 1))
                for v in views if v is not None]

    def run(faults=None, remediation=None, **kw):
        views, path = [], os.path.join(CTL_DIR, "q3.jsonl")
        os.makedirs(CTL_DIR, exist_ok=True)
        src, ops = make_query("q3_enrich_join", NEX_BATCHES * NEX_BATCH)
        cfg = C.ControlConfig(autotune=False, backpressure=False, admission=True,
                              refill_per_batch=0.5 * NEX_BATCH, burst_tuples=2 * NEX_BATCH)
        sp = wt.SupervisedPipeline(src, ops, wt.Sink(views.append), batch_size=NEX_BATCH,
                                   checkpoint_every=CTL_Q3_EVERY, faults=faults,
                                   remediation=remediation, max_restarts=16,
                                   control=None if kw else cfg, **kw, **SUP_BACKOFF)
        j = J.EventJournal(path)
        J.set_active(j)
        C.reset()
        F.reset_counters()
        try:
            launches, dt, _ = counted_run(torch, registry, sp.start, sp.run)
        finally:
            J.set_active(None)
            j.close()
        recs = J.read_journal(path)
        sheds = sorted({r["pos"] for r in recs if r["event"] == "shed"})
        applies = sorted({(r["pos"], r["action"], r.get("rate")) for r in recs
                          if r["event"] == "remediation_apply"})
        reshards = [r for r in recs if r["event"] == "reshard"]
        rem = sp._remediation.state() if sp._remediation is not None else None
        return dict(rows=rows(views), sheds=sheds, applies=applies, rem=rem, sp=sp,
                    launches=launches, run_s=dt, reshards=reshards,
                    adm=sp._admission.state() if sp._admission is not None else None)

    def plan():
        return F.FaultPlan([F.FaultSpec("chain.step", at=[3, 7]),
                            F.FaultSpec("sink.consume", at=[2])], seed=7)
    clean, faulted = run(), run(plan())
    rclean, rfaulted = run(remediation=True), run(plan(), remediation=True)
    auto = run(shards=2, reshard="auto")
    same = flat_bytes(np, faulted["rows"]) == flat_bytes(np, clean["rows"])
    rsame = flat_bytes(np, rfaulted["rows"]) == flat_bytes(np, rclean["rows"])
    auto_same = (flat_bytes(np, sorted_rows(np, auto["rows"]))
                 == flat_bytes(np, sorted_rows(np, rows(q3_views))))
    log({"phase": "control_supervised_q3", "card": card, "batches": NEX_BATCHES,
         "batch": NEX_BATCH, "checkpoint_every": CTL_Q3_EVERY,
         "shed_positions": clean["sheds"], "restarts_faulted": faulted["sp"].restarts,
         "rows_equal_under_faults": same, "sheds_equal": faulted["sheds"] == clean["sheds"],
         "admission_state": clean["adm"], "remediation_applies": rclean["applies"],
         "remediation_state": rclean["rem"], "restarts_remediation": rfaulted["sp"].restarts,
         "remediation_rows_equal": rsame, "auto_rows_equal_unsharded": auto_same,
         "auto_reshards": len(auto["reshards"]),
         "run_s": {"clean": clean["run_s"], "faulted": faulted["run_s"],
                   "remediation": rclean["run_s"], "remediation_faulted": rfaulted["run_s"],
                   "auto": auto["run_s"]},
         "launches": clean["launches"], "auto_launches": auto["launches"]})
    if not (same and faulted["sheds"] == clean["sheds"] and clean["sheds"]
            and faulted["adm"] == clean["adm"] and faulted["sp"].restarts > 0):
        raise AssertionError("control_supervised_q3: the faulted run's rows or sheds differ")
    if not (rclean["applies"] and rsame and rfaulted["applies"] == rclean["applies"]
            and rfaulted["rem"] == rclean["rem"]):
        raise AssertionError(f"control_supervised_q3: remediation {rclean['applies']} "
                             f"vs {rfaulted['applies']}")
    if not auto_same:
        raise AssertionError("control_supervised_q3: reshard='auto' rows differ")
    pushed = clean["adm"]["admitted"]
    if clean["launches"] != {**dict.fromkeys(registry.KERNELS, 0), "join_probe": 2 * pushed}:
        raise AssertionError(f"control_supervised_q3: launches {clean['launches']}, "
                             f"{pushed} pushes")
    return clean["launches"]


# --------------------------------------------------------------------- serving

SERVE_DIR = os.path.join(ROOT, "build", "serving")
SERVE_SWAP_AT = 20        # the wire swap frame follows this many data frames
#: SocketSource replay ring: 4 chunks of a 2^20-record YSB frame (16 MiB
#: each) hold 64 MiB of host memory (the default of 256 would hold 4 GiB)
SERVE_REPLAY = 4
SERVE_RECV = 1 << 22      # bytes a recv() of the ingest threads
SERVE_TICK_S = 1.0        # reporter interval of the paging run
SERVE_WINDOW_MS = 700.0   # its profile window: longer than one send cycle
SERVE_STALL_S = 0.5       # the slow tenant's wire stall inside each frame
SERVE_STALLED = 14        # its stalled frames, then SERVE_CLEAN clean ones
SERVE_CLEAN = 6
#: its wire-to-sink p99 target (F26): between a clean frame's latency on the
#: card's host (p99 ticks of 92-262 ms: 16 MiB on the wire, framing, a quiet
#: frame ahead of it) and a stalled one's (at least SERVE_STALL_S); at 200 ms
#: a clean tick above it ended the run in warn now and then
SERVE_TARGET_MS = 400.0


def serve_source(np, eos_tenants=None):
    """A loopback ``SocketSource`` of YSB records on the card."""
    from windflow_tpu_torch.serving import SocketSource
    return SocketSource("tcp://127.0.0.1:0", np.dtype(YSB_RECORD), key_field="campaign",
                        ts_field="ts", replay=SERVE_REPLAY, recv_bytes=SERVE_RECV,
                        eos_tenants=eos_tenants)


def serve_timers(torch, src):
    """Wrap a SocketSource's framing, host-to-device copy and batch pickup
    with timers: per batch the wire ms (client send stamp to receipt), the
    queue ms (receipt to pickup by the drive loop: the wait, the framing and
    the copy), the framing ms (AoS -> SoA and padding) and the copy ms
    (pinning and the copy, waited for); the sink appends the graph each
    batch ran on under ``graph``."""
    t = {"wire_ms": [], "queue_ms": [], "frame_ms": [], "h2d_ms": [], "graph": []}
    chunks, host_batches, to_device = src.it_factory, src._host_batches, src._to_device
    got = {}

    def timed_chunks(from_batch=0):
        for rec in chunks(from_batch):
            got["t"] = time.perf_counter()      # the chunk left the socket's queue
            yield rec
    src.it_factory = timed_chunks

    def timed_host(bs, cursor=None):
        for hb in host_batches(bs, cursor):
            t["frame_ms"].append((time.perf_counter() - got["t"]) * 1e3)
            yield hb

    def timed_copy(hb):
        t0 = time.perf_counter()
        b = to_device(hb)
        torch.cuda.current_stream().synchronize()
        t["h2d_ms"].append((time.perf_counter() - t0) * 1e3)
        return b

    def batches(bs, cursor=None):
        for hb in timed_host(bs, cursor):
            b = timed_copy(hb)
            w = src.last_wire or {}
            now = time.time()
            if w.get("t_send") is not None:
                t["wire_ms"].append((w["t_recv"] - w["t_send"]) * 1e3)
            t["queue_ms"].append((now - w.get("t_recv", now)) * 1e3)
            yield b
    src.batches = batches
    return t


def serving_phase(torch, np, wt, ysb, registry, card, ty_ref, record_ms):
    """Phase 43 (see the module docstring): ServingRuntime over the WFS1
    socket on the card, served YSB then a monitored run that pages.
    ``ty_ref``: threaded_ysb's rows (``flat_bytes``); ``record_ms``:
    record_ysb's ms a batch (framing_workers 1, no prefetch). Returns the
    launches of both runs."""
    import shutil
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    total = THREADED_BATCHES * BATCH
    t0 = time.perf_counter()
    recs = ysb_records(np, ysb, total)
    log({"phase": "serving_records", "card": card, "pack_s": time.perf_counter() - t0,
         "frames": len(recs), "frame_mib": recs[0].nbytes / 2 ** 20,
         "replay_ring_mib": SERVE_REPLAY * recs[0].nbytes / 2 ** 20})
    launches = served_ysb(torch, np, wt, ysb, registry, card, recs, ty_ref, record_ms)
    paged = paged_serving(torch, np, wt, ysb, registry, card, recs)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    log({"phase": "serving", "card": card, "seconds": time.perf_counter() - t_phase})
    return {name: launches[name] + paged[name] for name in registry.KERNELS}


def served_ysb(torch, np, wt, ysb, registry, card, recs, ty_ref, record_ms):
    """Part (a): the packed YSB records (40 frames of 2^20) from a
    ``RecordClient`` to ``ServingRuntime(SocketSource, YSB ops, sink)``, two
    tenants alternating frames, a wire swap to a registered YSB chain after
    frame ``SERVE_SWAP_AT`` (warmed, state carried): rows byte for byte
    threaded_ysb's and the dense oracle, K1 and K2 once a frame plus the
    incoming chain's warm step, measured apart (building it launches
    nothing: its spec probes are abstract)."""
    from windflow_tpu_torch.observability import MonitoringConfig, journal
    from windflow_tpu_torch.serving import RecordClient, ServingRuntime
    geom = ysb.bench_geometry(BATCH)
    dt_rec = np.dtype(YSB_RECORD)
    # what building and warming one more YSB chain launches (the swap does
    # both): the build nothing, the warm step K1 and K2 once
    registry.reset_launches()
    extra = wt.CompiledChain(ysb.make_ops(**geom), wt.RecordSource(
        lambda: iter(()), dt_rec, key_field="campaign", ts_field="ts").payload_spec(),
        batch_capacity=BATCH)
    built = registry.launch_counts()
    registry.reset_launches()
    extra.warm(BATCH)
    torch.cuda.synchronize()
    warmed = registry.launch_counts()
    del extra
    if any(built.values()):
        raise AssertionError(f"serving: building a YSB chain launched {built}")
    if {k: v for k, v in warmed.items() if v} != {"histogram": 1, "lookup": 1}:
        raise AssertionError(f"serving: a YSB chain's warm step launched {warmed}")
    out = os.path.join(SERVE_DIR, "served")
    total = THREADED_BATCHES * BATCH
    parts, collect = collect_sink()
    src = serve_source(np)
    timers = serve_timers(torch, src)

    def cb(view):
        if view is not None:
            timers["graph"].append(rt.graph_label)
        collect(view)
    rt = ServingRuntime(src, ysb.make_ops(**geom), wt.Sink(cb), batch_size=BATCH,
                        serving={"tenants": [{"id": "a"}, {"id": "b"}],
                                 "replay": SERVE_REPLAY},
                        monitoring=MonitoringConfig(out_dir=out, interval_s=1.0))
    rt.register_graph("v2", ysb.make_ops(**geom))
    state = {}

    def prepare():
        rt.chain.warm(BATCH)
        src.start()

    def run():
        th = rt.run_background()
        client = RecordClient(src.endpoint)
        t0 = time.perf_counter()
        for i, rec in enumerate(recs):
            client.send(rec.tobytes(), tenant="ab"[i % 2])
            if i + 1 == SERVE_SWAP_AT:
                # the swap frame follows frame 20 once the drive loop has
                # taken frame 20: it cuts over before frame 21, whatever the
                # loop's pace
                t1 = time.perf_counter()
                while sum(r["offered"] for r in rt.registry.counters().values()) \
                        < SERVE_SWAP_AT:
                    if not th.is_alive():
                        raise AssertionError("serving: the drive thread ended early")
                    time.sleep(0.001)
                state["swap_wait_s"] = time.perf_counter() - t1
                client.send_swap("v2")
        state["send_s"] = time.perf_counter() - t0
        client.send_eos("a")
        client.close()
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("serving: the drive thread did not end")
        if rt.background_error is not None:
            raise rt.background_error
    launches, dt, peak = counted_run(torch, registry, prepare, run)
    recs_j = journal.read_journal(os.path.join(out, "events.jsonl"))
    swap = [r for r in recs_j if r["event"] == "graph_swap" and r.get("applied")]
    sec = rt.serving_section()
    expect = {k: THREADED_BATCHES * (k in ("histogram", "lookup")) + warmed[k]
              for k in registry.KERNELS}
    same = flat_bytes(np, parts) == ty_ref
    oracle = as_dict(np, parts) == ysb.dense_oracle(total)
    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    ms = dt / THREADED_BATCHES * 1e3
    log({"phase": "serving_ysb", "card": card, "frames": THREADED_BATCHES, "batch": BATCH,
         "run_s": dt, "send_s": state["send_s"], "swap_wait_s": state["swap_wait_s"],
         "ms_per_batch": ms,
         "tuples_per_s": total / dt, "over_record_ysb": ms / record_ms,
         "record_ysb_ms_per_batch": record_ms,
         "wire_ms_median": med(timers["wire_ms"]), "queue_ms_median": med(timers["queue_ms"]),
         "frame_ms_median": med(timers["frame_ms"]), "h2d_ms_median": med(timers["h2d_ms"]),
         "quiesce_ms": swap[0]["quiesce_ms"] if swap else None,
         "swap_first_batch": (timers["graph"].index("v2")
                              if "v2" in timers["graph"] else None),
         "launches": launches, "expect": expect, "build_launches": built,
         "peak_mib_above_start": peak / 2 ** 20, "tenants": sec.get("tenants"),
         "frames_decoded": sec.get("frames_decoded"),
         "rows_equal_threaded_ysb_bytes": same, "oracle": oracle})
    if not (same and oracle):
        raise AssertionError("serving_ysb: rows differ from threaded_ysb's or the oracle")
    if launches != expect:
        raise AssertionError(f"serving_ysb: launches {launches}, expected {expect}")
    if not (len(swap) == 1 and swap[0]["warmed"] and swap[0]["carried_state"]
            and rt.swaps_applied == 1 and rt.graph_label == "v2"
            and timers["graph"].index("v2") == SERVE_SWAP_AT):
        raise AssertionError(f"serving_ysb: the swap did not apply warmed and carried: "
                             f"{swap}")
    rows = sec["tenants"]
    if (rows["a"]["offered"], rows["b"]["offered"]) != (THREADED_BATCHES // 2,) * 2 or \
            rows["a"]["shed"] or rows["b"]["shed"]:
        raise AssertionError(f"serving_ysb: tenant rows {rows}")
    return launches


def paged_serving(torch, np, wt, ysb, registry, card, recs):
    """Part (b): YSB served to a quiet and a slow tenant under
    ``slo=[tenant_e2e_p99_ms of the slow tenant]``, ``profile=`` and
    ``remediation=`` (``tenant_rate``), with telemetry to a loopback
    ``FleetAggregator``. The slow tenant's frames stall on the wire
    (``SERVE_STALL_S`` between the two halves of each frame), then flow
    clean: its SLO pages and recovers, the bundle holds ``profile.json``
    (committed before the manifest) whose trace names K1's or K2's kernel,
    only its bucket tightens, the aggregator receives the host's frames,
    and ``scripts/wf_slo.py``, ``wf_profile.py`` and ``wf_fleet.py``
    exit 0 over the artifacts. K1 and K2 launch once an admitted frame."""
    from windflow_tpu_torch.observability import MonitoringConfig, fleet, profiling
    from windflow_tpu_torch.observability import slo as slo_mod
    from windflow_tpu_torch.serving import (RecordClient, ServingRuntime, connect,
                                            encode_record_frame)
    out = os.path.join(SERVE_DIR, "paged")
    fleet_dir = os.path.join(SERVE_DIR, "fleet")
    spec = {"name": "lat-slow", "signal": "tenant_e2e_p99_ms", "tenant": "slow",
            "target": SERVE_TARGET_MS, "objective": 0.5, "fast_window": 1,
            "slow_window": 3, "warn_burn": 1.0, "page_burn": 2.0}
    action = {"name": "slow-rate", "slo": "lat-slow", "actuator": "tenant_rate",
              "factor": 0.5}
    agg = fleet.FleetAggregator("tcp://127.0.0.1:0", fleet_dir, max_skew_s=0.5)
    agg.start()
    cfg = MonitoringConfig(out_dir=out, interval_s=SERVE_TICK_S, e2e_sample_every=1,
                           slo=[spec], telemetry=agg.endpoint,
                           profile=profiling.ProfileConfig(window_ms=SERVE_WINDOW_MS,
                                                           max_captures=1),
                           remediation=[action])
    # rate buckets that never shed (a refill of 2^40 tuples a batch), so the
    # remediation's halving shows on the slow tenant's rate alone
    big = float(1 << 40)
    parts, cb = collect_sink()
    # the stream ends when both tenants' connections have sent their EOS
    src = serve_source(np, eos_tenants=["quiet", "slow"])
    rt = ServingRuntime(src, ysb.make_ops(**ysb.bench_geometry(BATCH)), wt.Sink(cb),
                        batch_size=BATCH,
                        serving={"tenants": [{"id": "quiet", "refill_per_batch": big},
                                             {"id": "slow", "refill_per_batch": big}],
                                 "replay": SERVE_REPLAY}, monitoring=cfg)
    rates0 = {t: row["rate"] for t, row in rt.registry.counters().items()}
    n_slow = SERVE_STALLED + SERVE_CLEAN

    def prepare():
        rt.chain.warm(BATCH)
        src.start()

    def run():
        th = rt.run_background()
        quiet = RecordClient(src.endpoint)
        slow = connect(src.endpoint)
        try:
            for i in range(n_slow):
                quiet.send(recs[2 * i].tobytes(), tenant="quiet")
                frame = encode_record_frame(recs[2 * i + 1].tobytes(), tenant="slow",
                                            seq=i, t_send=time.time(), span=f"slow/{i}")
                if i < SERVE_STALLED:
                    # a wire stall: the frame's second half waits
                    half = len(frame) // 2
                    slow.sendall(frame[:half])
                    time.sleep(SERVE_STALL_S)
                    slow.sendall(frame[half:])
                else:
                    slow.sendall(frame)
                    time.sleep(SERVE_STALL_S)
            quiet.send_eos("quiet")
            slow.sendall(encode_record_frame(b"", tenant="slow", seq=n_slow, kind="eos"))
        finally:
            quiet.close()
            slow.close()
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("serving paged: the drive thread did not end")
        if rt.background_error is not None:
            raise rt.background_error
    launches, dt, _ = counted_run(torch, registry, prepare, run)
    time.sleep(1.5)           # the aggregator's last tick (max_skew_s) lands
    fleet_stats = agg.stats()
    agg.stop()
    sec = rt.serving_section()
    rows = sec["tenants"]
    admitted = sum(r["admitted"] for r in rows.values())
    expect = {k: admitted * (k in ("histogram", "lookup")) for k in registry.KERNELS}
    with open(os.path.join(out, "snapshots.jsonl")) as f:
        series = [json.loads(line) for line in f if line.strip()]
    states = [s_["slo"]["lat-slow"]["state"] for s_ in series if "slo" in s_]
    bundles, torn = slo_mod.list_incidents(out)
    prof, order_ok = None, False
    if bundles:
        man = bundles[0]
        prof = profiling.load_profile(man["path"])
        files = man.get("files", [])
        order_ok = ("profile.json" in files and not man["missing"] and
                    os.path.getmtime(os.path.join(man["path"], "profile.json"))
                    <= os.path.getmtime(os.path.join(man["path"], "manifest.json")))
    kernels = (prof or {}).get("kernels", [])
    hand = sorted(k for k in kernels if "wf_hist_tiles" in k or "wf_lookup_kernel" in k)
    rates = {t: row.get("rate") for t, row in rows.items()}
    with open(os.path.join(out, "snapshot.json")) as f:
        last = json.load(f)
    rem = last.get("remediation") or {}
    lat_rows = (last.get("serving") or {}).get("tenants") or {}
    scripts = {}
    specs = json.dumps([spec])
    for name, argv in (("wf_slo", ["scripts/wf_slo.py", "--monitoring-dir", out,
                                   "--specs", specs]),
                       ("wf_profile", ["scripts/wf_profile.py", "--monitoring-dir", out]),
                       ("wf_fleet", ["scripts/wf_fleet.py", "status", "--monitoring-dir",
                                     fleet_dir])):
        proc = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True,
                              text=True, timeout=120)
        scripts[name] = proc.returncode
        if proc.returncode:
            log(f"{name} rc={proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    tenant_ms = {t: {k: row.get(k) for k in ("e2e_p50_ms", "e2e_p99_ms", "e2e_samples")}
                 for t, row in lat_rows.items()}
    log({"phase": "serving_paged", "card": card, "run_s": dt, "launches": launches,
         "expect": expect, "slo_states": states, "bundles": len(bundles),
         "torn": len(torn), "profile_keys": sorted(prof or {}),
         "profile_skipped": (prof or {}).get("profile_skipped"),
         "profile_activities": (prof or {}).get("activities"),
         "trace_kernels": kernels[:16], "hand_kernels_in_trace": hand,
         "profile_before_manifest": order_ok, "rates_before": rates0, "rates_after": rates,
         "remediation": {k: rem.get(k) for k in ("applied", "skipped", "bound")},
         "fleet": fleet_stats, "scripts": scripts, "tenant_latency": tenant_ms})
    fails = []
    if launches != expect:
        fails.append(f"launches {launches}, expected {expect}")
    if "page" not in states or states[-1] != "ok":
        fails.append(f"the slow tenant's SLO states {states}: no page, or no recovery")
    if len(bundles) != 1 or torn or not order_ok:
        fails.append(f"bundles {len(bundles)}, torn {torn}, profile before manifest "
                     f"{order_ok}")
    if not hand:
        fails.append(f"the profile's trace names no hand kernel: {prof}")
    if not (rates["slow"] < rates0["slow"] and rates["quiet"] == rates0["quiet"]):
        fails.append(f"tenant_rate: rates {rates0} -> {rates}")
    if rows["quiet"]["shed"] or rows["slow"]["shed"]:
        fails.append(f"a tenant shed: {rows}")
    if not (fleet_stats["frames_received"] > 0 and fleet_stats["hosts_seen"] >= 1):
        fails.append(f"the aggregator received no frames: {fleet_stats}")
    if any(scripts.values()):
        fails.append(f"scripts exited {scripts}")
    if len(parts) == 0:
        fails.append("no rows")
    if fails:
        raise AssertionError("serving_paged: " + "; ".join(fails))
    return launches

def control_phase(torch, np, wt, ysb, registry, card, ysb_ref, gw_rows, q3_views):
    """Phase 41 (see the module docstring): the control plane and kernel
    selection on the card. Returns the launches of its main paths."""
    t0 = time.perf_counter()
    launches = {"ysb": control_ysb_runs(torch, np, wt, ysb, registry, card)}
    control_selection_checks(torch, np, wt, ysb, registry, card, ysb_ref)
    launches["graph_windows"] = control_governor_checks(torch, np, wt, registry, card,
                                                        gw_rows)
    launches["q3"] = control_supervised_checks(torch, np, wt, registry, card, q3_views)
    log({"phase": "control", "card": card, "seconds": time.perf_counter() - t0})
    return {name: sum(d[name] for d in launches.values()) for name in registry.KERNELS}


# --------------------------------------------------------------------- analysis

ANALYSIS_DIR = os.path.join(ROOT, "build", "analysis")


# ---------------------------------------------------------------- mesh phase

MESH_P = 4                 # the mesh phase's positions, all on cuda:0
MESH_2D_BATCH = 1 << 16    # the JAX tests' 2-D layouts at a card-sized batch
MESH_2D_BATCHES = 4
MESH_LANES = 1 << 20       # the collectives' lanes
MESH_PROCS = 2             # processes of the two-process run (gloo, sharing the card)
MESH_DRIVER = os.path.join(ROOT, "tests", "torch_multihost_driver.py")
MESH_DEVICE = "cuda:0"     # every position's device
MESH_NCCL = "nccl"         # the world-size-1 part's backend


def batch_parts(outs):
    """``(key, id, payload)`` host arrays of each output batch's live lanes."""
    from windflow_tpu_torch.batch import tree_leaves
    parts = []
    for o in outs:
        v = o.valid.cpu()
        parts.append((o.key.cpu()[v].numpy(), o.id.cpu()[v].numpy(),
                      tree_leaves(o.payload)[0].cpu()[v].numpy()))
    return parts


def mesh_layout(torch, sc):
    """A sharded chain's state layout: every split leaf's shards hold
    ``shape[0] / p`` rows and every replicated leaf is equal on every
    position. Returns the split leaves' shard rows."""
    from windflow_tpu_torch.batch import jax_leaves
    from windflow_tpu_torch.parallel import ShardedTensor
    split = []
    for st in sc.chain.states:
        for leaf in jax_leaves(st):
            if not isinstance(leaf, ShardedTensor):
                continue
            shards = leaf.addressable_shards
            ax = next((a for a in leaf.placement.spec if a is not None), None)
            if ax is None:
                if not all(torch.equal(s.data, shards[0].data) for s in shards):
                    raise AssertionError("mesh: a replicated leaf differs between positions")
                continue
            rows = sorted({s.data.shape[0] for s in shards})
            if rows != [leaf.shape[0] // sc.mesh.shape[ax]] or len(shards) != sc.mesh.size:
                raise AssertionError(f"mesh: a split leaf of {tuple(leaf.shape)} holds "
                                     f"{rows} rows a position")
            split.append(rows[0])
    return split


def mesh_states_equal(torch, sc, plain):
    """The sharded chain's gathered states equal the unsharded chain's, leaf
    for leaf, bit for bit."""
    from windflow_tpu_torch.batch import jax_leaves
    from windflow_tpu_torch.parallel import ShardedTensor
    for got, ref in zip(jax_leaves(sc.chain.states), jax_leaves(plain.states)):
        full = got.full() if isinstance(got, ShardedTensor) else got
        if not torch.equal(full, ref):
            return False
    return True


def mesh_ysb(torch, np, wt, ysb, registry, card):
    """Part a: YSB at full width (8 x 2^20, 100 campaigns) through
    ``ShardedChain`` over ``make_mesh(4, axis="key")`` on one card: the
    unsharded chain's rows on the card (sorted) and the dense oracle, each
    ``[K]`` leaf's shards 25 rows, the replicated leaves equal on every
    position, K1 and K2 launches a batch as found, eager ms a batch of both."""
    from windflow_tpu_torch.parallel import ShardedChain, make_mesh
    dev = torch.device(MESH_DEVICE)
    total = YSB_BATCHES * BATCH

    def build():
        src = ysb.make_source(total)
        return src, wt.CompiledChain(ysb.make_ops(**ysb.bench_geometry(BATCH)),
                                     src.payload_spec(), batch_capacity=BATCH)
    src, plain = build()
    batches = list(src.batches(BATCH))
    runs = {}
    for name in ("unsharded", "sharded"):
        _, chain = build()
        if name == "sharded":
            chain = ShardedChain(chain, make_mesh(MESH_P, axis="key", devices=[dev] * MESH_P),
                                 axis="key")
        torch.cuda.synchronize()
        registry.reset_launches()
        t0 = time.perf_counter()
        outs = [chain.push(b) for b in batches]
        outs += chain.flush()
        torch.cuda.synchronize()
        runs[name] = (time.perf_counter() - t0, registry.launch_counts(),
                      batch_parts(outs), chain)
    sc = runs["sharded"][3]
    launches = runs["sharded"][1]
    same = flat_bytes(np, sorted_rows(np, runs["sharded"][2])) == \
        flat_bytes(np, sorted_rows(np, runs["unsharded"][2]))
    oracle = as_dict(np, runs["sharded"][2]) == ysb.dense_oracle(total)
    split = mesh_layout(torch, sc)
    row = {"phase": "mesh", "part": "sharded_ysb", "positions": MESH_P, "axis": "key",
           "batches": YSB_BATCHES, "batch": BATCH, "rows_equal_unsharded": same,
           "dense_oracle": oracle, "split_leaf_rows": sorted(set(split)),
           "launches": launches,
           "k1_per_batch": launches["histogram"] / YSB_BATCHES,
           "k2_per_batch": launches["lookup"] / YSB_BATCHES,
           "unsharded_launches": runs["unsharded"][1],
           "eager_ms_per_batch": runs["sharded"][0] / YSB_BATCHES * 1e3,
           "unsharded_eager_ms_per_batch": runs["unsharded"][0] / YSB_BATCHES * 1e3,
           "card": card}
    log(row)
    if not (same and oracle):
        raise AssertionError("mesh: sharded YSB's rows differ from the unsharded chain's")
    if set(split) != {ysb.N_CAMPAIGNS // MESH_P}:
        raise AssertionError(f"mesh: sharded YSB's [K] shards hold {set(split)} rows")
    if launches["histogram"] < YSB_BATCHES or launches["lookup"] < YSB_BATCHES:
        raise AssertionError(f"mesh: sharded YSB did not run K1 and K2: {launches}")
    return launches


def mesh_2d(torch, np, wt, registry, card):
    """Part b: the JAX tests' 2-D layouts at batch 2^16 on one card:
    Key_FFAT (CB 20/20, 16 keys) over a 2 x 4 ``dp x key`` mesh and a keyed
    Win_Farm (CB 16/8, 8 keys) over a 4 x 2 ``key x win`` mesh, whose
    archive shards hold K/4 rows and whose window rows split over ``win``
    (K3 and K6): rows (sorted) and gathered states bit for bit the unsharded
    chain's after every push."""
    from windflow_tpu_torch.parallel import ShardedChain, make_mesh_2d
    dev = torch.device(MESH_DEVICE)
    C = MESH_2D_BATCH
    cases = {
        "key_ffat_dp_x_key": (16, (2, 4), ("dp", "key"), dict(axis="dp", key_axis="key"),
                              lambda K: wt.Key_FFAT(lambda t: t.v, torch.add,
                                                    spec=wt.WindowSpec(20, 20), num_keys=K)),
        "win_farm_key_x_win": (8, (4, 2), ("key", "win"),
                               dict(axis="key", win_axis="win", key_axis="key"),
                               lambda K: wt.Win_Farm(lambda wid, it: it.sum("v"),
                                                     wt.WindowSpec(16, 8), num_keys=K)),
    }
    total = {}
    for name, (K, shape, axes, kw, make) in cases.items():
        def chain():
            return wt.CompiledChain([make(K)], {"v": torch.zeros((), dtype=torch.float32)},
                                    batch_capacity=C)
        plain = chain()
        sc = ShardedChain(chain(), make_mesh_2d(shape, axes=axes, devices=[dev] * 8), **kw)
        got, want, states = [], [], True
        counts = dict.fromkeys(registry.KERNELS, 0)
        for s in range(0, MESH_2D_BATCHES * C, C):
            ids = np.arange(s, s + C, dtype=np.int32)
            b = wt.Batch.of({"v": (ids % 13).astype(np.float32)}, key=ids % K, id=ids, ts=ids,
                            device=dev)
            want.append(plain.push(b))
            registry.reset_launches()
            got.append(sc.push(b))
            torch.cuda.synchronize()
            for k, v in registry.launch_counts().items():
                counts[k] += v
            states = states and mesh_states_equal(torch, sc, plain)
        want += plain.flush()
        registry.reset_launches()
        got += sc.flush()
        for k, v in registry.launch_counts().items():
            counts[k] += v
        same = flat_bytes(np, sorted_rows(np, batch_parts(got))) == \
            flat_bytes(np, sorted_rows(np, batch_parts(want)))
        split = mesh_layout(torch, sc)
        row = {"phase": "mesh", "part": name, "mesh": dict(zip(axes, shape)), "batch": C,
               "batches": MESH_2D_BATCHES, "rows_equal_unsharded": same,
               "states_equal_unsharded": states, "split_leaf_rows": sorted(set(split)),
               "launches": {k: v for k, v in counts.items() if v}, "card": card}
        if name == "win_farm_key_x_win":
            row["window_rows"] = [b.window_rows for b in
                                  next(iter(sc._splits[0].blocks.values()))]
        log(row)
        if not (same and states):
            raise AssertionError(f"mesh {name}: rows or states differ from the unsharded chain")
        if set(split) != {K // 4}:
            raise AssertionError(f"mesh {name}: split leaves hold {set(split)} rows")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    if not (total["segment_fold"] and total["masked_window_reduce"]):
        raise AssertionError(f"mesh: the 2-D layouts did not run K3 and K6: {total}")
    return total


def mesh_collective_cases(torch, np):
    """The four collectives' inputs at ``MESH_LANES`` lanes (numpy, seeded)
    and functions ``(mesh, inputs on a device) -> outputs``."""
    from windflow_tpu_torch.parallel import collective as col
    rng = np.random.default_rng(41)
    L = MESH_LANES
    ints = rng.integers(-1000, 1000, L).astype(np.int32)
    floats = rng.normal(size=L).astype(np.float32)
    valid = rng.random(L) < 0.9
    keys = rng.integers(0, 1 << 20, L).astype(np.int32)
    skew = np.where(rng.random(L) < 0.7, 3, keys).astype(np.int32)
    cases = {
        "wmr_psum_int32": ((ints, valid), lambda m, d, v: col.wmr_map_reduce(
            lambda x, ok: torch.where(ok, x, 0).sum(dtype=torch.int32), torch.add, m,
            axis="part")(d, v)),
        "wmr_pmax_float32": ((floats, valid), lambda m, d, v: col.wmr_map_reduce(
            lambda x, ok: torch.where(ok, x, -torch.inf).max(), torch.maximum, m,
            axis="part")(d, v)),
        "wmr_generic_mean": ((floats, valid), lambda m, d, v: col.wmr_map_reduce(
            lambda x, ok: {"s": torch.where(ok, x, 0.0).sum(), "n": ok.sum(dtype=torch.int32)},
            lambda a, b: {"s": a["s"] + b["s"], "n": a["n"] + b["n"]}, m, axis="part")(d, v)),
        "ring_pane_windows": ((floats, np.ones(L, bool)), lambda m, d, v: col.ring_pane_windows(
            torch.add, 0.0, m, win_panes=8, slide_panes=4, axis="part")(d, v)),
        "keyed_all_to_all": ((keys, valid, floats), lambda m, k, v, x: col.keyed_all_to_all(
            m, axis="part", return_residue=True)(k, v, {"x": x, "k2": k * 3})),
        "keyed_all_to_all_lossless": ((skew, valid, floats), lambda m, k, v, x:
                                      col.keyed_all_to_all_lossless(
                                          m, axis="part", capacity=L // 16)(k, v, {"x": x})),
    }
    return cases


def mesh_flat(out):
    """Every tensor of a collective's output, gathered, in order."""
    from windflow_tpu_torch.batch import jax_leaves
    from windflow_tpu_torch.parallel import ShardedTensor
    return [x.full().cpu() if isinstance(x, ShardedTensor) else x
            for x in jax_leaves(list(out) if isinstance(out, tuple) else out)]


def mesh_collectives(torch, np, card):
    """Part c: the four collectives at 2^20 lanes over 4 positions on the
    card against the same functions over 4 CPU positions on the same inputs:
    integers and masks bit for bit, the float max and the ring's in-order
    window folds bit for bit, the generic mean's float sum within rtol 1e-5
    (the partial sums' order differs between the card's and the CPU's
    ``torch.sum``); eager ms of each on the card."""
    from windflow_tpu_torch.parallel import make_mesh
    dev = torch.device(MESH_DEVICE)
    card_mesh = make_mesh(MESH_P, axis="part", devices=[dev] * MESH_P)
    cpu_mesh = make_mesh(MESH_P, axis="part", devices=["cpu"] * MESH_P)
    for name, (inputs, fn) in mesh_collective_cases(torch, np).items():
        on_cpu = fn(cpu_mesh, *(torch.as_tensor(a) for a in inputs))
        args = [torch.as_tensor(a).to(dev) for a in inputs]
        on_card = fn(card_mesh, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(card_mesh, *args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        rounds = None
        if isinstance(on_card, tuple) and isinstance(on_card[-1], int):
            rounds = (on_card[-1], on_cpu[-1])
            on_card, on_cpu = on_card[:-1], on_cpu[:-1]
        a, b = mesh_flat(on_card), mesh_flat(on_cpu)
        exact = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        err = max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
                  for x, y in zip(a, b))
        ok = exact or (name == "wmr_generic_mean" and all(
            torch.allclose(x.double(), y.double(), rtol=1e-5, atol=0) for x, y in zip(a, b)))
        log({"phase": "mesh", "part": "collective", "case": name, "lanes": MESH_LANES,
             "positions": MESH_P, "bit_identical_to_cpu": exact, "max_abs_err": err,
             "tolerance": None if exact else "rtol 1e-5", "rounds": rounds, "ms": ms,
             "card": card})
        if not ok or (rounds and (rounds[0] != rounds[1] or rounds[0] < 2)):
            raise AssertionError(f"mesh collective {name}: the card differs from the CPU")


def mesh_processes_start():
    """Part d's two processes (``tests/torch_multihost_driver.py``, gloo,
    both on cuda:0), started in the background."""
    addr = f"127.0.0.1:{mesh_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "PYTHONPATH")}
    return [subprocess.Popen([sys.executable, MESH_DRIVER, addr, str(MESH_PROCS), str(i),
                              MESH_DEVICE, "gloo", "ysb"], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(MESH_PROCS)]


def mesh_processes_finish(torch, np, procs, card):
    """Part d: the two processes' results (each supervising half of a
    4-shard YSB stream with a shard-kill drill, then ``keyed_all_to_all``
    and its lossless variant across the process axis), the union of their
    rows held to this process's unsharded supervised run; then
    ``multihost.initialize()`` at world size 1 over NCCL and one exchange
    across the process axis, against the CPU."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_multihost_driver as drv
    from windflow_tpu_torch.parallel import collective as col
    from windflow_tpu_torch.parallel import make_mesh, multihost
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        if rc != 0 or "LOSSLESS-OK" not in out:
            log({"phase": "mesh", "part": "two_process", "rc": rc, "stdout": out[-2000:],
                 "stderr": err[-4000:]})
            raise AssertionError("mesh: a process of the two-process run failed")
    got = [o.split("SHARD-OK ")[1].split() for _, o, _ in outs]
    rows, _sp = drv.supervised_rows("ysb", torch.device(MESH_DEVICE))
    want_n, want_d = len(rows), drv.digest(rows)
    n = sum(int(g[0]) for g in got)
    d = sum(int(g[1]) for g in got) % (1 << 31)
    recv = [int(o.split("MULTIHOST-OK ")[1].split()[0]) for _, o, _ in outs]
    rounds = [int(o.split("rounds=")[1].split()[0]) for _, o, _ in outs]
    row = {"phase": "mesh", "part": "two_process", "processes": MESH_PROCS,
           "backend": "gloo", "ranges": [g[2] for g in got], "rows": n, "oracle_rows": want_n,
           "digest_equal": d == want_d, "received": recv, "lossless_rounds": rounds,
           "card": card}
    log(row)
    if n != want_n or d != want_d or sum(recv) != 64 * drv.LOCAL:
        raise AssertionError("mesh: the two processes' shards differ from the oracle")

    # one process over NCCL at world size 1: the exchange goes through
    # torch.distributed (the process axis), and equals the in-process one
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(mesh_free_port()),
           "WORLD_SIZE": "1", "RANK": "0"}
    os.environ.update(env)
    import torch.distributed as dist
    try:
        if not multihost.initialize() or dist.get_backend() != MESH_NCCL:
            raise AssertionError("mesh: initialize() did not start NCCL")
        mesh = multihost.make_dcn_ici_mesh(dcn_axis="key", ici_axes=("dp",),
                                           devices=[torch.device(MESH_DEVICE)] * 2)
        rng = np.random.default_rng(43)
        k = rng.integers(0, 100, MESH_LANES).astype(np.int32)
        v = rng.random(MESH_LANES) < 0.9
        x = rng.normal(size=MESH_LANES).astype(np.float32)
        ex = col.keyed_all_to_all(mesh, axis="key")
        dev = torch.device(MESH_DEVICE)
        a = mesh_flat(ex(*(torch.as_tensor(t).to(dev) for t in (k, v)),
                         {"x": torch.as_tensor(x).to(dev)}))
        ref = col.keyed_all_to_all(make_mesh(1, axis="key", devices=["cpu"]), axis="key")(
            torch.as_tensor(k), torch.as_tensor(v), {"x": torch.as_tensor(x)})
        b = mesh_flat(ref)
        same = len(a) == len(b) and all(torch.equal(p, q) for p, q in zip(a, b))
        log({"phase": "mesh", "part": "nccl_world_1", "backend": dist.get_backend(),
             "lanes": MESH_LANES, "bit_identical_to_cpu": same, "card": card})
        if not same:
            raise AssertionError("mesh: the NCCL exchange differs from the CPU's")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in env:
            os.environ.pop(key, None)


def mesh_free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(torch, np, wt, ysb, registry, card):
    """Phase ``mesh``: the two processes start first and run beside parts b
    (2-D layouts) and the NCCL part's wait; parts a (sharded YSB, timed) and
    c (collectives, timed) run after them. Returns the launches of the
    sharded paths (YSB; the 2-D layouts), each counted from zero."""
    procs = mesh_processes_start()
    try:
        l2d = mesh_2d(torch, np, wt, registry, card)
        mesh_processes_finish(torch, np, procs, card)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    lysb = mesh_ysb(torch, np, wt, ysb, registry, card)
    mesh_collectives(torch, np, card)
    return lysb, l2d


# ------------------------------------------------------------- examples phase

#: each example run's time limit (seconds): a card run takes about 20 s
EXAMPLE_TIMEOUT_S = 240


def example_run(name, device=None):
    """One run of ``python -m windflow_tpu_torch.examples.<name>`` (on the
    card, or with ``--device device``): its seconds, launch counts and the
    integers of its result lines. Raises unless it exits 0 with "OK"."""
    argv = [sys.executable, "-m", f"windflow_tpu_torch.examples.{name}"]
    if device is not None:
        argv += ["--device", device]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=EXAMPLE_TIMEOUT_S)
    dt = time.perf_counter() - t
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode or not lines or "OK" not in proc.stdout:
        log(f"example {name} ({device or 'cuda'}) rc={proc.returncode}:\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        raise RuntimeError(f"example {name} on {device or 'cuda'} failed "
                           f"(rc {proc.returncode})")
    launches = json.loads(lines[-2])["launches"]
    result = [ln for ln in lines if not ln.startswith("{")]
    return {"s": dt, "launches": launches, "result": result,
            "ints": [re.findall(r"-?\d+", ln) for ln in result]}


def examples_phase(registry, card):
    """Phase ``examples``: the port's six user-facing examples
    (``windflow_tpu_torch/examples/``), each a subprocess on the card (the
    kernels are built already: ``build/kernels/`` is keyed by source hash,
    so the processes load them) beside a run of it with ``--device cpu``
    on this machine's cores (so a card run's seconds include that
    neighbour). Every run passes its own oracle; the card's result numbers
    equal the CPU's; every kernel ``EXAMPLES`` names for an example
    launched on the card (Q1 in ``serving`` is a stateless Map and reaches
    none), and none on the CPU. Returns the card runs' launches, each
    counted from zero in its own process, summed."""
    from windflow_tpu_torch.examples import EXAMPLES
    total = {name: 0 for name in registry.KERNELS}
    rows = {}
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    for name, kernels in EXAMPLES.items():
        with ThreadPoolExecutor(2) as pool:
            runs = [pool.submit(example_run, name), pool.submit(example_run, name, "cpu")]
            on_card, on_cpu = (r.result() for r in runs)
        if on_card["ints"] != on_cpu["ints"]:
            raise RuntimeError(f"example {name}: the card's results {on_card['result']} "
                               f"differ from the CPU's {on_cpu['result']}")
        missed = [k for k in kernels if not on_card["launches"].get(k)]
        if missed or on_cpu["launches"]:
            raise RuntimeError(f"example {name}: kernels {missed} not launched on the card "
                               f"(launches {on_card['launches']}), or launches on the "
                               f"CPU {on_cpu['launches']}")
        for k, n in on_card["launches"].items():
            total[k] += n
        rows[name] = {"card_s": on_card["s"], "cpu_s": on_cpu["s"],
                      "launches": on_card["launches"], "expect": list(kernels),
                      "result": on_card["result"]}
        log({"phase": f"example_{name}", "card": card, **rows[name]})
    log({"phase": "examples", "card": card, "seconds": time.perf_counter() - t0,
         "card_s": sum(r["card_s"] for r in rows.values()),
         "cpu_s": sum(r["cpu_s"] for r in rows.values()), "launches": total})
    return total


# ------------------------------------------------------------- sweep phase

SWEEP_CHECK = (1 << 18, 500)  # the fixed rows whose states are held to the CPU port's
SWEEP_ADAPTIVE_KEYS = (500,)  # run_adaptive's keys, run twice (the second warm-starts)


def state_leaves(np, tree):
    """The arrays of a state tree (``convert.state_to_numpy``'s form) in
    order; None leaves are skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in state_leaves(np, tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in state_leaves(np, t)]
    return [np.asarray(tree)]


def states_same(np, got, want):
    """Byte equality of two state trees, NaN payloads compared as NaN."""
    g, w = state_leaves(np, got), state_leaves(np, want)
    if len(g) != len(w):
        return False
    for a, b in zip(g, w):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.kind == "f":
            na, nb = np.isnan(a), np.isnan(b)
            if not np.array_equal(na, nb):
                return False
            a, b = np.where(na, 0, a), np.where(nb, 0, b)
        if a.tobytes() != b.tobytes():
            return False
    return True


def launch_delta(registry, prev):
    """The launches since ``prev`` (a copy of the counts, updated in place)."""
    counts = registry.launch_counts()
    delta = {k: n - prev.get(k, 0) for k, n in counts.items() if n != prev.get(k, 0)}
    prev.clear()
    prev.update(counts)
    return delta


def sweep_phase(torch, np, registry, card):
    """Phase ``sweep``: ``benchmarks/sweep.py`` on the card at its defaults
    (36 fixed rows, 14 Nexmark rows) and ``run_adaptive`` over 500 keys
    twice with a tuning cache in a temporary directory (the second run
    warm-starts: one cache hit a row, no capacity switch, the same rungs),
    each row logged with its launches; then the four workloads' states after
    the timed steps of the 2^18-lane, 500-key rows against the CPU port's
    after the same steps, byte for byte (NaN as NaN). Returns the launches
    of the three runs."""
    import shutil
    import tempfile
    from windflow_tpu_torch import control
    from windflow_tpu_torch.benchmarks import sweep
    from windflow_tpu_torch.convert import state_to_numpy

    t0 = time.perf_counter()
    held, prev = {}, {}

    def on_row(row, ops, states):
        name, batch, keys, tps = row
        log({"phase": "sweep_row", "workload": name, "batch": batch, "keys": keys,
             "tuples_per_s": tps, "launches": launch_delta(registry, prev), "card": card})
        if (batch, keys) == SWEEP_CHECK and name in sweep.NAMES:
            held[name] = [state_to_numpy(op, s) for op, s in zip(ops, states)]

    registry.reset_launches()
    rows = sweep.run_sweep(device="cuda", on_row=on_row)
    nex = sweep.run_nexmark(device="cuda", on_row=on_row)
    tmp = tempfile.mkdtemp(prefix="wf_sweep_")
    cache = os.path.join(tmp, "tuning.json")
    adaptive = []
    for run in ("cold", "warm"):
        control.reset()
        got = sweep.run_adaptive(keyset=SWEEP_ADAPTIVE_KEYS, cache_path=cache, device="cuda")
        ctr = control.counters()
        log({"phase": "sweep_adaptive", "run": run, "rows": got, "card": card,
             "tuning_cache_hits": ctr.get("tuning_cache_hits", 0),
             "capacity_switches": ctr.get("capacity_switches", 0),
             "launches": launch_delta(registry, prev)})
        adaptive.append((got, ctr))
    launches = registry.launch_counts()
    (cold, _), (warm, ctr) = adaptive
    if (len(warm) != len(sweep.NAMES) or ctr.get("tuning_cache_hits") != len(warm)
            or ctr.get("capacity_switches", 0) != 0
            or [r[1] for r in warm] != [r[1] for r in cold]):
        raise AssertionError(f"sweep: the adaptive rerun did not warm-start at the cached "
                             f"rungs: {cold} then {warm}, counters {ctr}")
    if len(rows) != 36 or len(nex) != 14 or not all(r[3] > 0 for r in rows + nex + warm):
        raise AssertionError(f"sweep: {len(rows)} fixed and {len(nex)} Nexmark rows")
    out = os.path.join(tmp, "RESULTS.md")
    with open(out, "w") as f:
        f.write(sweep.render_markdown(rows + warm + nex, sweep.device_label("cuda")))
    with open(out) as f:
        table = [ln for ln in f if ln.startswith("| ")]
    shutil.rmtree(tmp, ignore_errors=True)
    missed = [k for k in SWEEP_KERNELS if not launches.get(k)]
    if missed:
        raise AssertionError(f"sweep: kernels {missed} never launched ({launches})")

    t1 = time.perf_counter()
    batch, keys = SWEEP_CHECK
    for name in sweep.NAMES:
        src, ops = sweep.workloads(batch, keys, 22 * batch, "cpu")[name]
        _, states = sweep.measure(ops, src, batch, 20, "cpu")
        want = [state_to_numpy(op, s) for op, s in zip(ops, states)]
        if not states_same(np, held[name], want):
            raise AssertionError(f"sweep {name} at {batch} lanes, {keys} keys: the card's "
                                 f"states differ from the CPU port's")
    log({"phase": "sweep", "card": card, "seconds": time.perf_counter() - t0,
         "check_s": time.perf_counter() - t1, "rows": len(rows), "nexmark_rows": len(nex),
         "adaptive_rows": len(warm), "table_rows": len(table) - 1,
         "checked": [f"{n}@{batch}x{keys}" for n in sweep.NAMES], "launches": launches})
    return launches


# ------------------------------------------------------------- chaos phase

#: chaos_sweep.py's modes, each at the JAX script's defaults with CHAOS_SEEDS
CHAOS_MODES = {"plain": [], "controller": ["--controller"], "dispatch": ["--dispatch", "4"],
               "shards": ["--shards", "4"], "remediate": ["--remediate"],
               "serve": ["--serve"]}
CHAOS_SEEDS = 2
#: the full-width run: the plain mode over 2^18 tuples. Its batch is the largest
#: the pipeline driver's TB Win_Seq(10, 10) takes without an explicit max_wins
#: (both packages refuse a [W, L] gather above 2^22 elements: 16384 lanes give
#: W = 1703, L = 32768)
CHAOS_FULL = ["--seeds", "1", "--batch", "4096", "--total", "262144"]
#: the kernels each path must launch (the K numbers of PERF.md's table)
SWEEP_KERNELS = ("lookup", "segment_fold", "ordering_merge", "join_probe",
                 "segment_fold_float")
CHAOS_KERNELS = ("lookup", "segment_fold", "ordering_merge", "masked_window_reduce")
PROFILE_WINDOW_MS = 300.0  # wf_profile --capture's window over the running chain


def chaos_output(fn, *a):
    """``fn(*a)`` with its standard output kept: (result, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a)
    return res, buf.getvalue()


def chaos_fired(text):
    """Faults fired a driver over a run's printed lines."""
    fired = {}
    for name, n in re.findall(r"^\[seed \d+\] (\w+): (\d+) faults injected", text, re.M):
        fired[name] = fired.get(name, 0) + int(n)
    for n in re.findall(r"^\[closed-loop\] threaded: (\d+) faults injected", text, re.M):
        fired["closed_loop"] = int(n)
    for n in re.findall(r"^\[seed \d+\] serve: .* (\d+) torn", text, re.M):
        fired["serve_torn"] = fired.get("serve_torn", 0) + int(n)
    return fired


def chaos_phase(torch, registry, card):
    """Phase ``chaos``: ``python -m windflow_tpu_torch.scripts.chaos_sweep``'s
    ``main`` in six modes at the JAX script's defaults with ``--seeds 2``
    (plain, --controller, --dispatch 4, --shards 4, --remediate, --serve),
    then the plain mode at full width (``CHAOS_FULL``), whose fault-free
    baselines must equal the CPU port's at the same flags; every run must
    exit 0 with no divergence. Each run's seconds, faults fired a driver and
    launches are logged. Then ``wf_profile --capture`` over a running chain
    (``profile_capture_check``). Returns the runs' launches, each counted
    from zero, summed."""
    import warnings
    from windflow_tpu_torch.scripts import chaos_sweep as C

    t0 = time.perf_counter()
    total = {name: 0 for name in registry.KERNELS}
    for mode, flags in CHAOS_MODES.items():
        argv = ["--seeds", str(CHAOS_SEEDS), *flags]
        t = time.perf_counter()
        registry.reset_launches()
        with warnings.catch_warnings():
            # F24: an operator-less chain (a graph's source pipe) captured an
            # empty CUDA graph under dispatch
            warnings.filterwarnings("error", message="The CUDA Graph is empty")
            rc, text = chaos_output(C.main, argv)
        launches = {k: n for k, n in registry.launch_counts().items() if n}
        if rc != 0 or "PASS" not in text:
            log(text[-6000:])
            raise RuntimeError(f"chaos_sweep {' '.join(argv)} exited {rc}")
        for k, n in launches.items():
            total[k] += n
        log({"phase": f"chaos_{mode}", "argv": argv, "card": card,
             "seconds": time.perf_counter() - t, "fired": chaos_fired(text),
             "launches": launches})

    t = time.perf_counter()
    args = C.parser().parse_args(CHAOS_FULL)
    dev = C.resolve_device("cuda")
    C.warm(args.batch, dev)
    registry.reset_launches()
    res, text = chaos_output(C.sweep, args, dev)
    launches = {k: n for k, n in registry.launch_counts().items() if n}
    card_s = time.perf_counter() - t
    if res["divergences"]:
        log(text[-6000:])
        raise RuntimeError(f"chaos_sweep {' '.join(CHAOS_FULL)}: "
                           f"{res['divergences']} divergent run(s)")
    for k, n in launches.items():
        total[k] += n
    t1 = time.perf_counter()
    for name in C.DRIVERS:
        cpu = C.RUNNERS[name](args.total, args.batch, device="cpu")
        if res["baselines"][name] != cpu:
            raise AssertionError(f"chaos full width: the card's {name} baseline "
                                 f"({len(res['baselines'][name])} rows) differs from the "
                                 f"CPU port's ({len(cpu)} rows)")
    log({"phase": "chaos_full_width", "argv": CHAOS_FULL, "card": card, "seconds": card_s,
         "cpu_baselines_s": time.perf_counter() - t1,
         "rows": {n: len(r) for n, r in res["baselines"].items()},
         "fired": {n: sum(f) for n, f in res["fired"].items()}, "launches": launches})
    missed = [k for k in CHAOS_KERNELS if not total.get(k)]
    if missed:
        raise AssertionError(f"chaos: kernels {missed} never launched ({total})")
    profile_capture_check(torch, card)
    log({"phase": "chaos", "card": card, "seconds": time.perf_counter() - t0,
         "launches": {k: n for k, n in total.items() if n}})
    return total


def profiler_on_main_thread(torch):
    """Open and close one short torch.profiler session with CUDA activity on
    this (the main) thread. Kineto initialises its CUPTI client on the
    thread of the first session and refuses a first session opened from
    another thread ("External init callback must run in same thread as
    registerClient"): that session then traces no CUDA kernel, or the
    process crashes later (F27). The serving phase's profile-on-page and
    ``profile_capture_check`` open theirs from worker threads."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones((1,), device="cuda").add_(1)
        torch.cuda.synchronize()


def profile_capture_check(torch, card):
    """``wf_profile --capture`` (its ``main``, in a thread of this process, so
    its torch.profiler session sees this process's kernels) over a running
    eager Key_FFAT chain at 2^18 lanes: it must exit 0 and its trace must
    hold at least one CUDA kernel event."""
    import shutil
    import tempfile
    import threading
    from windflow_tpu_torch.benchmarks import sweep
    from windflow_tpu_torch.observability.profiling import trace_kernels
    from windflow_tpu_torch.runtime.pipeline import CompiledChain
    from windflow_tpu_torch.scripts import wf_profile

    B = 1 << 18
    dev = sweep.resolve_device("cuda")
    src, ops = sweep.workloads(B, 500, B << 12, dev)["win_kf"]
    chain = CompiledChain(ops, src.payload_spec(), batch_capacity=B, device=dev,
                          event_time=False)
    states, cur = list(chain.states), torch.zeros((), dtype=torch.int32, device=dev)
    logdir = tempfile.mkdtemp(prefix="wf_profile_")
    box = {}
    argv = ["--capture", logdir, "--window-ms", str(PROFILE_WINDOW_MS), "--json"]

    def capture():
        box["rc"], box["out"] = chaos_output(wf_profile.main, argv)

    th = threading.Thread(target=capture)
    t = time.perf_counter()
    th.start()
    steps = 0
    while th.is_alive():
        b = src.make_batch(cur, B)
        for j, op in enumerate(chain.ops):
            states[j], b = op.apply(states[j], b)
        cur = cur + B
        steps += 1
        torch.cuda.synchronize()
    th.join()
    kernels = trace_kernels(os.path.join(logdir, "trace.json"))
    shutil.rmtree(logdir, ignore_errors=True)
    if box.get("rc") != 0 or not kernels:
        log(box.get("out", ""))
        raise RuntimeError(f"wf_profile --capture exited {box.get('rc')} with "
                           f"{len(kernels)} CUDA kernel(s) in its trace")
    summary = json.loads(box["out"])
    log({"phase": "wf_profile_capture", "card": card, "seconds": time.perf_counter() - t,
         "window_ms": summary["window_ms"], "activities": summary["activities"],
         "chain_steps": steps, "kernels": kernels[:16], "n_kernels": len(kernels)})


def analysis_phase(torch, np, wt, ysb, registry, card):
    """Phase 48 (see the module docstring): the static-analysis layer on the
    card. Building YSB, q3 and served YSB launches nothing; ``validate()`` of
    each (and of ``graph_windows`` for the threaded driver) launches no
    kernel, allocates no memory and captures no graph, and its report is
    clean; after YSB's K-step graph is captured, ``WF_KERNEL_IMPL=torch``
    gives a WF109 that names it; progcheck of the card's YSB lists K1 and
    K2 and fingerprints as the CPU build does; the perfgate proxy rows time
    the hand kernels (advisory)."""
    import gc
    import shutil
    from windflow_tpu_torch.analysis import perfgate, progcheck, validate
    from windflow_tpu_torch.nexmark import make_query
    from windflow_tpu_torch.observability import MonitoringConfig
    from windflow_tpu_torch.serving import ServingRuntime
    t_phase = time.perf_counter()
    gc.collect()                  # graphs of earlier phases, and their selections
    registry.reset_records()
    geom = ysb.bench_geometry(BATCH)
    k = DISPATCH_K["ysb"]

    def sink():
        return wt.Sink(lambda view: None)
    torch.cuda.synchronize()
    registry.reset_launches()
    ysb_p = wt.Pipeline(ysb.make_source(YSB_BATCHES * BATCH), ysb.make_ops(**geom), sink(),
                        batch_size=BATCH)
    q3_src, q3_ops = make_query("q3_enrich_join", NEX_BATCHES * NEX_BATCH)
    q3_p = wt.Pipeline(q3_src, q3_ops, sink(), batch_size=NEX_BATCH)
    served = ServingRuntime(serve_source(np), ysb.make_ops(**geom), sink(), batch_size=BATCH,
                            serving={"tenants": [{"id": "a"}], "replay": SERVE_REPLAY},
                            monitoring=MonitoringConfig(out_dir=ANALYSIS_DIR))
    g, _mp, _m = graph_windows(torch, wt, GW_TOTAL, WIN_KEYS, WIN_LEN, WIN_SLIDE, GW_BATCH,
                               lambda view: None)
    torch.cuda.synchronize()
    built = {name: n for name, n in registry.launch_counts().items() if n}
    log({"phase": "analysis_build", "card": card, "launches": built})
    if built:
        raise AssertionError(f"analysis: building YSB, q3 and served YSB launched {built}")

    def untouched(name, fn):
        """``fn()``'s result and ms, failing unless it left the card as it
        was: the same launches, allocated bytes and captured graphs (garbage
        collected first, so no earlier tensor is freed inside)."""
        gc.collect()
        torch.cuda.synchronize()
        before = (registry.launch_counts(), torch.cuda.memory_allocated(),
                  registry.REGISTRY.watched_graphs())
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        after = (registry.launch_counts(), torch.cuda.memory_allocated(),
                 registry.REGISTRY.watched_graphs())
        if after != before:
            raise AssertionError(f"analysis: {name} touched the card: {before} -> {after}")
        return out, ms

    for name, obj, kw in (("ysb", ysb_p, {}), ("q3", q3_p, {}),
                          ("graph_windows", g, {"threaded": True}),
                          ("served_ysb", served, {})):
        rep, ms = untouched(f"validate({name})", lambda: validate(obj, **kw))  # noqa: B023
        log({"phase": "analysis_validate", "card": card, "target": name, "ms": ms,
             "codes": sorted(set(rep.codes())), "report": str(rep)})
        if rep.diagnostics:
            raise AssertionError(f"analysis: validate({name}) is not clean:\n{rep}")

    # WF109: the K-step graph keeps the kernels it captured
    ysb_p.chain.warm_scan(k, BATCH)
    graph = ysb_p.chain.graphs[(0, k, BATCH)].name
    os.environ["WF_KERNEL_IMPL"] = "torch"
    try:
        rep, ms = untouched("validate(ysb, WF_KERNEL_IMPL=torch)",
                            lambda: validate(ysb_p, progcheck=False))
    finally:
        del os.environ["WF_KERNEL_IMPL"]
    wf109 = [d for d in rep.diagnostics if d.code == "WF109"]
    log({"phase": "analysis_wf109", "card": card, "graph": graph, "ms": ms,
         "where": sorted(d.where for d in wf109), "report": str(rep)})
    if not ({"kernel[histogram]", "kernel[lookup]"} <= {d.where for d in wf109}
            and all(graph in d.message for d in wf109)):
        raise AssertionError(f"analysis: WF109 does not name {graph}:\n{rep}")

    # progcheck: the card's YSB step lists its hand kernels and has the CPU's shape
    progs, trace_ms = untouched("progcheck(ysb)",
                                lambda: progcheck.chain_programs(ysb_p.chain, k=k))
    cpu_src = ysb.make_source(YSB_BATCHES * BATCH, device="cpu")
    cpu_chain = wt.CompiledChain(ysb.make_ops(device="cpu", **geom), cpu_src.payload_spec(),
                                 batch_capacity=BATCH, device="cpu")
    fp_card = progcheck.program_fingerprint(progs[0])
    fp_cpu = progcheck.step_fingerprint(cpu_chain, BATCH)
    findings = progcheck.analyze_programs(progs)
    log({"phase": "analysis_progcheck", "card": card, "trace_ms": trace_ms,
         "programs": [p.path for p in progs], "kernels": [list(p.kernels) for p in progs],
         "fingerprint_card": fp_card, "fingerprint_cpu": fp_cpu,
         "findings": [f.render() for f in findings]})
    if not {"histogram", "lookup"} <= set(progs[0].kernels) or fp_card != fp_cpu \
            or findings:
        raise AssertionError("analysis: the card's YSB progcheck disagrees")

    # perfgate's proxy rows on the card time the hand kernels (advisory)
    registry.reset_launches()
    t0 = time.perf_counter()
    rows = perfgate.proxy_microbench(reps=5, device="cuda")
    torch.cuda.synchronize()
    proxy_launches = {name: n for name, n in registry.launch_counts().items() if n}
    log({"phase": "analysis_perfgate_proxy", "card": card, "seconds": time.perf_counter() - t0,
         "rows": rows, "launches": proxy_launches, "advisory": True})
    missing = [name for name in ("histogram", "lookup", "segment_fold", "ordering_merge",
                                 "join_probe") if not proxy_launches.get(name)]
    if missing:
        raise AssertionError(f"analysis: the proxy rows launched no {missing}")
    del ysb_p, q3_p, served, g, progs
    shutil.rmtree(ANALYSIS_DIR, ignore_errors=True)
    log({"phase": "analysis", "card": card, "seconds": time.perf_counter() - t_phase})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of five steps of every loop, "
                         "captured and eager")
    ap.add_argument("--split-only", action="store_true",
                    help="build, run the split of K1's, K2's and K3's time and stop, "
                         "printing no result line (also on an older tree, see split_phase)")
    ap.add_argument("--helper-times", nargs="?", const="all", choices=("all", "lookup"),
                    help="build, time K2 (and, unless 'lookup', the helper kernels) on "
                         "their check inputs and stop, printing no result line (also on "
                         "an older tree, see helper_times)")
    ap.add_argument("--only", action="append",
                    choices=("lookup", "nexmark_loop", "path_b", "sweep", "chaos"),
                    help="build, run only the named phase (repeatable: K2's split and "
                         "checks, the Nexmark loops, path B, the sweep, the chaos sweep) "
                         "and stop, printing no result line (nexmark_loop and path_b "
                         "also on an older tree)")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.benchmarks import ysb
    from windflow_tpu_torch.ops import cuda, lookup, registry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0), "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    probe_job = None if args.helper_times else start_probe_build(cuda)
    try:
        built = cuda.build_all()
    finally:
        probes = probe_job and finish_probe_build(probe_job)
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "built": sorted(built), "flags": " ".join(cuda.NVCC_FLAGS)})
    for stem, rep in built.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas[{stem}]: {line.strip()}")

    profiler_on_main_thread(torch)
    if not hasattr(lookup, "table_lookup_many"):
        # an older tree (``--only``, ``--helper-times``): a K2 launch a table read
        Q5_APPLY["lookup"], PATH_B_APPLY["lookup"] = 14, 3
    if args.helper_times:
        helper_times(torch, np, ysb, card, lookup_only=args.helper_times == "lookup")
        return 0
    if args.only:
        if "lookup" in args.only:
            lookup_split(torch, ysb, probes, card)
            kernel_phase(torch, ysb, probes)
        if "nexmark_loop" in args.only:
            nexmark_loop_phase(torch, wt, card, args.profile)
        if "path_b" in args.only:
            path_b_phase(torch, np, wt, ysb, registry, card, args.profile)
        if "sweep" in args.only:
            sweep_phase(torch, np, registry, card)
        if "chaos" in args.only:
            chaos_phase(torch, registry, card)
        return 0
    split_phase(torch, ysb, probes)
    lookup_split(torch, ysb, probes, card)
    if args.split_only:
        return 0
    rows = kernel_phase(torch, ysb, probes)
    rows.update(partials_kernel_phase(torch, ysb))
    rows.update(nexmark_kernel_phase(torch))
    session_kernel_phase(torch)
    main_launches, ysb_parts = ysb_pipeline_phase(torch, np, wt, ysb, registry)
    ysb_ref = flat_bytes(np, ysb_parts)
    pg_launches = pipegraph_ysb_phase(torch, np, wt, ysb, registry, ysb_parts,
                                      main_launches)
    sy_launches = supervised_ysb_phase(torch, np, wt, ysb, registry, card, ysb_parts)
    shy_launches = sharded_ysb_phase(torch, np, wt, ysb, registry, card, ysb_parts)
    del ysb_parts
    ysb_loop_phase(torch, wt, ysb, card, args.profile)
    sum_launches = ysb_sum_phase(torch, np, wt, ysb, registry)
    ysb_loop_phase(torch, wt, ysb, card, args.profile, name="ysb_sum_loop",
                   make_ops=ysb.make_ops_sum, steps=SUM_LOOP_STEPS)
    bench_dispatch_phase(torch, wt, card)
    nex_launches, q3_views = nexmark_pipeline_phase(torch, np, wt, registry)
    sq_launches = supervised_q3_phase(torch, np, wt, registry, card, q3_views)
    shq_launches = sharded_q3_phase(torch, np, wt, registry, card, q3_views)
    nexmark_loop_phase(torch, wt, card, args.profile)
    ng_launches = nexmark_graph_phase(torch, np, wt, registry, card)
    q3_pipeline_phase(torch, np, wt, registry)
    q3_full_width_phase(torch, np, wt, registry, card, args.profile)
    ck_launches = checkpoint_phase(torch, np, wt, ysb, registry, card)
    rows["masked_window_reduce"] = window_reduce_kernel_phase(torch)
    a_launches = path_a_phase(torch, np, wt, registry, card, args.profile)
    b_launches = path_b_phase(torch, np, wt, ysb, registry, card, args.profile)
    windows_small_phase(wt, registry)
    ord_launches = ordering_phase(torch, np, wt, registry, card, args.profile)
    host_io_phase(torch, np, wt)
    gw_launches, gw_rows, gw_s, gw_parts = graph_windows_phase(torch, np, wt, registry)
    sg_launches = supervised_graph_phase(torch, np, wt, registry, card, gw_parts, gw_s)
    shg_launches = sharded_graph_phase(torch, np, wt, registry, card, gw_parts)
    del gw_parts
    fold_row = fold_checks(torch)
    kcb_launches = keyed_cb_phase(torch, np, wt, registry, card, args.profile)
    ks_launches = keyed_stateful_phase(torch, np, wt, registry, card, args.profile)
    keyed_small_phase(torch, np, wt, registry)
    ring_phase(card)
    handoff_phase(torch, wt)
    ty_launches, ty_rows = threaded_ysb_phase(torch, np, wt, ysb, registry, card,
                                              args.profile)
    ry_launches, ry_ms = record_ysb_phase(torch, np, wt, ysb, registry, card, ty_rows,
                                          ty_launches)
    f_launches = faults_phase(torch, np, wt, ysb, registry, card, ty_rows)
    ty_ref = flat_bytes(np, ty_rows)
    del ty_rows
    tgw_launches = threaded_graph_windows_phase(torch, np, wt, registry, card, gw_rows,
                                                gw_launches, gw_s)
    link_rate = link_read_phase(torch, probes, card)
    tq_launches, tq_chain = tiered_q3_phase(torch, np, wt, registry, card, args.profile)
    cold_row, scatter_row = cold_probe_phase(torch, np, registry, card, tq_chain, link_rate)
    del tq_chain
    tqs_launches = tiered_queries_phase(torch, np, wt, registry, card)
    tr_launches = tiered_recovery_phase(torch, np, wt, registry, card)
    trot_launches = tiered_rotating_phase(torch, np, wt, registry, card)
    tiered_inputs_phase(torch, np, wt, card)
    fetch_row = cold_fetch_phase(torch, np, card, link_rate)
    tq4_launches = tiered_q4_phase(torch, np, wt, registry, card)
    ctl_launches = control_phase(torch, np, wt, ysb, registry, card, ysb_ref, gw_rows,
                                 q3_views)
    del q3_views
    mon_launches = monitoring_phase(torch, np, wt, ysb, registry, card, ysb_ref,
                                    main_launches, gw_rows)
    srv_launches = serving_phase(torch, np, wt, ysb, registry, card, ty_ref, ry_ms)
    mesh_ysb_launches, mesh_2d_launches = mesh_phase(torch, np, wt, ysb, registry, card)
    ex_launches = examples_phase(registry, card)
    sw_launches = sweep_phase(torch, np, registry, card)
    ch_launches = chaos_phase(torch, registry, card)
    analysis_phase(torch, np, wt, ysb, registry, card)

    # each path's launches, counted from zero just before it and read just
    # after, summed over the paths
    paths = {"ysb": main_launches, "ysb_sum": sum_launches, "nexmark": nex_launches,
             "path_a": a_launches, "path_b": b_launches, "pipegraph_ysb": pg_launches,
             "ordering": ord_launches, "graph_windows": gw_launches,
             "keyed_cb": kcb_launches, "keyed_stateful": ks_launches,
             "threaded_ysb": ty_launches, "record_ysb": ry_launches,
             "threaded_graph_windows": tgw_launches, "nexmark_graph": ng_launches,
             "checkpoint": ck_launches, "faults": f_launches,
             "supervised_ysb": sy_launches, "supervised_q3": sq_launches,
             "supervised_graph": sg_launches, "tiered_q3": tq_launches,
             "tiered_queries": tqs_launches, "tiered_recovery": tr_launches,
             "tiered_rotating": trot_launches, "tiered_q4": tq4_launches,
             "sharded_ysb": shy_launches, "sharded_q3": shq_launches,
             "sharded_graph": shg_launches, "control": ctl_launches,
             "monitoring_ysb": mon_launches, "serving": srv_launches,
             "mesh_ysb": mesh_ysb_launches, "mesh_2d": mesh_2d_launches,
             "examples": ex_launches, "sweep": sw_launches, "chaos": ch_launches}
    path_launches = {name: sum(d[name] for d in paths.values())
                     for name in registry.KERNELS}
    log({"path_launches": paths})
    kernels = []
    for name, k in registry.tpu_kernels().items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": path_launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    helper = registry.KERNELS["segment_fold_float"]
    kernels.append({"name": helper.name, "route": "cuda", "source": helper.source,
                    "replaces": None, "launches": path_launches[helper.name],
                    "max_abs_err": fold_row["max_abs_err"], "ms": fold_row["ms"],
                    "plain_ms": fold_row["plain_ms"], "bound_ms": fold_row["bound_ms"],
                    "bound_by": fold_row["bound_by"], "library_ms": fold_row["library_ms"]})
    probe = registry.KERNELS["cold_probe"]
    kernels.append({"name": probe.name, "route": "cuda", "source": probe.source,
                    "replaces": None, "launches": path_launches[probe.name],
                    "max_abs_err": cold_row["max_abs_err"], "ms": cold_row["kernel_ms"],
                    "plain_ms": cold_row["plain_ms"], "bound_ms": cold_row["bound_ms"],
                    "bound_by": cold_row["bound_by"], "library_ms": None})
    for name, r in (("cold_fetch", fetch_row), ("cold_scatter", scatter_row)):
        k = registry.KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": None, "launches": path_launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``windflow_tpu_torch``) on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py              # the default run, one card
    python3 chip_smoke.py --profile    # adds torch.profiler breakdowns of
                                       # every loop's steps, captured and eager
    python3 chip_smoke.py --split-only # phases 1-3's split of K1's and K3's
                                       # time, then stops (no result line);
                                       # copied with PROBES_SRC into another
                                       # tree, it splits that tree's kernels

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
   ragged lengths, one lane and unaligned inputs; K4: one
   CTA, one cluster in one launch, several waves of clusters, beyond one
   cluster; K5: shared-memory and device-memory hash table, colliding and
   repeated keys, one row, one lane, ragged lane counts), bit-identical to
   the plain version (each K4 network also to a stable lexsort), with the
   kernel's time alone; K1 and K3 log each case's plan
   (``histogram_plan`` / ``segment_fold_plan``) and counters, and the phase
   fails unless every regime ran. Also the two repairs: K2 on
   a float table with -0.0 entries, and the fixed-order float fold (same
   bits on two card runs and on the CPU);
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
8. Nexmark q1, q2, q3, q6, q7 through ``Pipeline(...).run()`` at
   ``bench_nexmark``'s batch (2^14) for 16 batches, dispatch off and at
   K = 5: every sink row against the dense oracle, and the exact K4 and K5
   launches of each query;
9. the same five queries through the loop;
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
    self-check; K2 three times, K3 and K6 once per apply, K6 alone in the
    flush;
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
18. the ``{"kernels": [...]}`` summary (the six TPU kernels and the
    fixed-order float fold, launches summed over the paths, each counted
    from zero just before it), then the result line
    ``{"ok": true, "device": {...}}`` as the last line.

Phase 3 also holds K4 at the Ordering_Node's shapes (merges of [1, 8192]
and [1, 2^17], sorts of [1, 4096] and [1, 2^16]) and phase 11 holds K6 on
every dtype the JAX package sums (uint8 and uint16 into uint32 bit for bit,
float16 and bfloat16 within 1e-2, float64 within 1e-12).

It exits non-zero, printing no result, without CUDA or without the package.
"""

import argparse
import json
import os
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
              "path_b": 2}
BENCH_DISPATCH_BATCHES = 96     # bench.py::bench_dispatch: 96 batches of 2^18
BENCH_DISPATCH_BATCH = 1 << 18  # (BATCH // 4) at K = 8
BENCH_DISPATCH_K = 8
WMR_WIN_LEN = 1000        # path B: bench.py::bench_ysb_wmr's window (ticks)
WMR_MAP = 4               # and its map_parallelism
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores (data sheet),
                          # the rate used for int32 compares and selects
ROOT = os.path.dirname(os.path.abspath(__file__))
PROBES_SRC = os.path.join("windflow_tpu_torch", "benchmarks", "csrc", "split_probes.cu")


def log(obj):
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
    with torch.cuda.graph(g):
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
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    same, err = compare(torch, got, want)
    ok = same if tol is None else bool(torch.allclose(got, want, rtol=tol, atol=tol))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    row = {"kernel_check": name, "case": case, "shape": shape, **(extra or {}),
           "bit_identical": same, "max_abs_err": err, "tolerance": tol,
           "kernel_ms": graph_ms(torch, kernel) if time_kernel else None,
           "plain_ms": graph_ms(torch, plain) if timed else None,
           "library_ms": (None if library is None or not timed else
                          graph_ms(torch, library)),
           "kernel_eager_ms": time_ms(torch, kernel) if timed else None,
           "plain_eager_ms": time_ms(torch, plain) if timed else None,
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


def kernel_phase(torch, ysb):
    from windflow_tpu_torch.ops import lookup as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)
    C = BATCH
    rows = {}
    b, window = ysb_traffic(torch, ysb, 3 * BATCH)
    K = window.num_keys

    # K2 lookup
    def k2(case, idx, table):
        Kt = table.shape[0]
        safe = idx.clamp(0, Kt - 1)
        return check_kernel(
            torch, "lookup", case,
            lambda: L.lookup_cuda(table, idx), lambda: L.lookup_plain(table, idx),
            lambda: table.index_select(0, safe),
            C * 8 + Kt * 4, {"C": C, "K": Kt, "dtype": "int32"})
    campaigns = ysb.campaign_table(dev)
    Kc = campaigns.shape[0]
    src = ysb.make_source(4 * BATCH)
    rows["lookup"] = k2("ysb", src.make_batch(3 * BATCH, BATCH).payload["ad_id"],
                        campaigns)
    k2("out_of_range", torch.randint(-100, Kc + 100, (C,), device=dev, generator=gen,
                                     dtype=torch.int32), campaigns)

    def stray(keys, Sn):
        """``keys`` with one lane in 64 moved out of ``[0, Sn)``."""
        off = torch.randint(1, 101, (C,), device=dev, generator=gen, dtype=torch.int32)
        far = torch.where(torch.rand((C,), device=dev, generator=gen) < 0.5,
                          -off, Sn - 1 + off)
        return torch.where(torch.rand((C,), device=dev, generator=gen) < 1 / 64,
                           far, keys).contiguous()

    def ctrl_table(n, hi):
        return torch.randint(0, hi, (n,), device=dev, generator=gen, dtype=torch.int32)
    # the window paths' Win_Seq._insert reads: path A's per-key count over its
    # 512 keys (key = i % 512), path B's count and next_win over YSB's 100
    # campaigns (the window input's keys)
    a_keys = stray((torch.arange(C, device=dev) % WIN_KEYS).to(torch.int32), WIN_KEYS)
    b_keys = stray(b.key, K)
    k2("path_a_count", a_keys, ctrl_table(WIN_KEYS, 2 ** 31 - 1))
    k2("path_b_count", b_keys, ctrl_table(K, 2 ** 31 - 1))
    k2("path_b_next_win", b_keys, ctrl_table(K, 1 << 20))

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


def repair_checks(torch):
    """The two repairs: K2 on a float table with -0.0 entries (+0.0 back,
    as the JAX forms give it), and the fixed-order float fold (the same bits
    on two card runs and on the CPU)."""
    from windflow_tpu_torch.ops import lookup as L, segment as S

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261018)
    C = BATCH
    table = torch.randn((1000,), device=dev, generator=gen)
    table[::3] = -0.0
    table[1::7] = float("nan")
    idx = torch.randint(-10, 1010, (C,), device=dev, generator=gen, dtype=torch.int32)
    check_kernel(
        torch, "lookup", "float_negative_zero",
        lambda: L.lookup_cuda(table, idx), lambda: L.lookup_plain(table, idx),
        lambda: table.index_select(0, idx.clamp(0, 999)),
        C * 8 + 4000, {"C": C, "K": 1000, "dtype": "float32"})
    got = L.lookup_cuda(table, idx)
    if bool(torch.signbit(got[got == 0]).any()):
        raise AssertionError("K2 returned -0.0 from a float table of 1000 rows")

    Sn = 4096
    vals = torch.randn((C,), device=dev, generator=gen) * 1000
    seg = torch.randint(-5, Sn + 5, (C,), device=dev, generator=gen, dtype=torch.int32)
    valid = torch.rand((C,), device=dev, generator=gen) < 0.9
    first = S._index_add_fold(vals, seg, valid, Sn)
    second = S._index_add_fold(vals, seg, valid, Sn)
    cpu = S._index_add_fold(vals.cpu(), seg.cpu(), valid.cpu(), Sn)
    torch.cuda.synchronize()
    same = (torch.equal(_bits(torch, first), _bits(torch, second))
            and torch.equal(_bits(torch, first).cpu(), _bits(torch, cpu)))
    ok = valid & (seg >= 0) & (seg < Sn)
    safe = torch.where(ok, seg, Sn).long()
    masked = torch.where(ok, vals, 0.0)
    row = {"kernel_check": "segment_fold_float", "case": "determinism",
           "shape": {"C": C, "S": Sn, "dtype": "float32"},
           "bit_identical_card_card_cpu": bool(same),
           "max_abs_err": compare(torch, first.cpu(), cpu)[1],
           "ms": graph_ms(torch, lambda: S.segment_fold_float_cuda(vals, seg, valid, Sn)),
           "plain_ms": graph_ms(torch, lambda: torch.zeros(Sn + 1, device=dev).index_add_(
               0, torch.where(valid & (seg >= 0) & (seg < Sn), seg, Sn).long(),
               torch.where(valid & (seg >= 0) & (seg < Sn), vals, 0.0))[:Sn]),
           "library_ms": graph_ms(torch, lambda: torch.zeros(
               Sn + 1, device=dev).index_add_(0, safe, masked)),
           "bound_ms": (C * 9 + Sn * 4) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(row)
    if not same:
        raise AssertionError("the float fold's bits differ between runs or from the CPU")
    return row


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

    def k5(case, C, K, vals_dtype, keys=None, timed=True):
        if keys is None:
            keys = (torch.randperm(8 * K, device=dev, generator=gen)[:K]
                    - 4 * K).to(torch.int32)
            if K > 4:
                keys[-2:] = L.JOIN_KEY_SENTINEL    # unused slots: repeated sentinel
        hits = keys[torch.randint(0, K, (C,), device=dev, generator=gen)]
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
    return rows


NEX_ROWS = {
    "q1_currency": ("id", "auction", "euro"),
    "q2_selection": ("id", "auction", "price"),
    "q3_enrich_join": ("id", "auction", "category", "price"),
    "q7_distinct": ("id", "auction"),
}

#: exact launches per query in the Pipeline phase: K5 twice per StreamTableJoin
#: or Distinct apply (the upsert's slot probe and the probe), K4 once per TopN
#: apply; nothing else of the five kernels
NEX_LAUNCHES = {"q1_currency": {}, "q2_selection": {},
                "q3_enrich_join": {"join_probe": 2 * NEX_BATCHES},
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
    out = []
    for v in views:
        cols = [v["id"] if c == "id" else v["payload"][c] for c in NEX_ROWS[name]]
        out.extend(zip(*(np.asarray(c).tolist() for c in cols)))
    return sorted(out)


def nexmark_pipeline_phase(torch, np, wt, registry):
    """The five queries through Pipeline.run, dispatch off and at K = 5 (16
    batches: three replays and a tail of one, which is ``push``): every
    sink row against the dense oracle, exact K4 and K5 launches, and the
    two runs' rows byte for byte."""
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
            log({"phase": "nexmark_pipeline", "query": name, "dispatch": k,
                 "batches": NEX_BATCHES, "batch": NEX_BATCH, "rows": len(got),
                 "run_s": dt, "tuples_per_s": total / dt, "launches": counts,
                 "peak_mib": peak / 2 ** 20})
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
    return launches


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


def q3_oracle_np(np, start, n):
    """q3's expected lanes for events ``start .. start+n-1`` in numpy int32
    arithmetic (wrapping products, floored %): (emitted, auction, category,
    price)."""
    i = np.arange(start, start + n, dtype=np.int64).astype(np.int32)
    auction = (i * np.int32(2477)) % np.int32(Q3_AUCTIONS)
    category = (auction * np.int32(13)) % np.int32(7)
    price = (i * np.int32(7919)) % np.int32(9973) + np.int32(100)
    return i >= Q3_AUCTIONS, auction, category, price


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
    if on[1] != off[1]:
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
    if not parts:
        return {}
    k, w, c = (np.concatenate(x) for x in zip(*parts))
    return {(int(a), int(b)): int(v) for a, b, v in zip(k.tolist(), w.tolist(), c.tolist())}


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


def expect_launches(what, got, per, n):
    want = {k: per.get(k, 0) * n for k in got}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def path_a_oracle(np, batches):
    """``{(key, window): sum}`` of path A over ``batches`` batches and the
    flush: key k's arrival position p holds tuple i = p * 512 + k, value
    i % 97; window w covers positions [512 w, 512 w + 1024)."""
    n = batches * BATCH // WIN_KEYS
    p = np.arange(n, dtype=np.int64)
    vals = (p[None, :] * WIN_KEYS + np.arange(WIN_KEYS)[:, None]) % 97
    csum = np.concatenate([np.zeros((WIN_KEYS, 1), np.int64), np.cumsum(vals, 1)], 1)
    out = {}
    for w in range((n - 1) // WIN_SLIDE + 1):
        lo, hi = w * WIN_SLIDE, min(w * WIN_SLIDE + WIN_LEN, n)
        for k, v in enumerate((csum[:, hi] - csum[:, lo]).tolist()):
            out[(k, w)] = v
    return out


def path_a_source(wt, batches):
    return wt.DeviceSource(lambda i: {"v": (i % 97).float()}, total=batches * BATCH,
                           num_keys=WIN_KEYS)


def path_a_op(wt):
    return wt.Key_Farm(lambda wid, it: it.sum("v"), wt.WindowSpec(WIN_LEN, WIN_SLIDE),
                       num_keys=WIN_KEYS)


#: exact launches of one apply on each window path (the flush launches K6 once
#: per call and nothing else)
PATH_A_APPLY = {"lookup": 1, "segment_fold": 1, "masked_window_reduce": 1}
PATH_B_APPLY = {"lookup": 3, "segment_fold": 1, "masked_window_reduce": 1}


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
    registry.reset_launches()
    states, cur, out, ms = timed_steps(torch, step, states, cur, WIN_STEPS)
    launches = registry.launch_counts()
    row = {"phase": f"{name}_loop", "steps": WIN_STEPS, "batch": BATCH,
           "tuples_per_s": BATCH / ms * 1e3, "ms_per_step": ms,
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
    k_on = DISPATCH_K["path_a"]
    want = path_a_oracle(np, WIN_BATCHES)
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
        mp._compile(BATCH)            # the chain's build probes launch outside the count
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


def graph_windows(torch, wt, total, keys, win_len, slide, batch, cb, device=None):
    """split (id % 3) -> branches 0 and 1 (a Map each) merged partially in
    DETERMINISTIC mode -> CB Win_Seq sum -> Sink; branch 2 counted by a
    ReduceSink. Returns (graph, source pipe, merged pipe)."""
    kw = {} if device is None else {"device": device}
    g = wt.PipeGraph("graph_windows", mode=wt.Mode.DETERMINISTIC, batch_size=batch, **kw)
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
    Win_Seq apply (K6 once per flush call), K4's calls as the node made them."""
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
    m._compile(GW_BATCH)       # Win_Seq's build probe launches K6 outside the count
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
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of five steps of every loop, "
                         "captured and eager")
    ap.add_argument("--split-only", action="store_true",
                    help="build, run the split of K1's and K3's time and stop, printing "
                         "no result line (also on an older tree, see split_phase)")
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
    from windflow_tpu_torch.ops import cuda, registry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0), "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    probe_job = start_probe_build(cuda)
    try:
        built = cuda.build_all()
    finally:
        probes = finish_probe_build(probe_job)
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "built": sorted(built), "flags": " ".join(cuda.NVCC_FLAGS)})
    for stem, rep in built.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas[{stem}]: {line.strip()}")

    split_phase(torch, ysb, probes)
    if args.split_only:
        return 0
    rows = kernel_phase(torch, ysb)
    rows.update(partials_kernel_phase(torch, ysb))
    rows.update(nexmark_kernel_phase(torch))
    fold_row = repair_checks(torch)
    main_launches, ysb_parts = ysb_pipeline_phase(torch, np, wt, ysb, registry)
    pg_launches = pipegraph_ysb_phase(torch, np, wt, ysb, registry, ysb_parts,
                                      main_launches)
    del ysb_parts
    ysb_loop_phase(torch, wt, ysb, card, args.profile)
    sum_launches = ysb_sum_phase(torch, np, wt, ysb, registry)
    ysb_loop_phase(torch, wt, ysb, card, args.profile, name="ysb_sum_loop",
                   make_ops=ysb.make_ops_sum, steps=SUM_LOOP_STEPS)
    bench_dispatch_phase(torch, wt, card)
    nex_launches = nexmark_pipeline_phase(torch, np, wt, registry)
    nexmark_loop_phase(torch, wt, card, args.profile)
    q3_pipeline_phase(torch, np, wt, registry)
    q3_full_width_phase(torch, np, wt, registry, card, args.profile)
    rows["masked_window_reduce"] = window_reduce_kernel_phase(torch)
    a_launches = path_a_phase(torch, np, wt, registry, card, args.profile)
    b_launches = path_b_phase(torch, np, wt, ysb, registry, card, args.profile)
    windows_small_phase(wt, registry)
    ord_launches = ordering_phase(torch, np, wt, registry, card, args.profile)
    host_io_phase(torch, np, wt)
    gw_launches = graph_windows_phase(torch, np, wt, registry)

    # each path's launches, counted from zero just before it and read just
    # after, summed over the paths
    paths = {"ysb": main_launches, "ysb_sum": sum_launches, "nexmark": nex_launches,
             "path_a": a_launches, "path_b": b_launches, "pipegraph_ysb": pg_launches,
             "ordering": ord_launches, "graph_windows": gw_launches}
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
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``windflow_tpu_torch``) on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py              # the default run, one card
    python3 chip_smoke.py --profile    # adds torch.profiler breakdowns of the
                                       # YSB, q3 and q6 loop steps

Phases (each raises on a mismatch, so any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every CUDA kernel from ``windflow_tpu_torch/ops/csrc`` with nvcc
   for sm_90a (one nvcc per source, all started together), and its time;
3. each kernel (K1 histogram, K2 lookup, K3 segment_fold, K4 ordering_merge,
   K5 join_probe) at main-path shapes and on adversarial inputs:
   bit-identical to its plain PyTorch version, with the kernel's, the plain
   version's and one library call's device times (CUDA-graph replay; eager
   times beside them) and the bound (the larger of bytes moved / 3.35 TB/s
   and operations / 67 T/s). Also the two repairs: K2 on a float table with
   -0.0 entries, and the fixed-order float fold (same bits on two card runs
   and on the CPU);
4. YSB at full width through ``Pipeline(...).run()`` and a host ``Sink``:
   2^20-event batches with ``bench.py``'s geometry, every per-window count
   against a numpy dense oracle, and K1 and K2 launched once per batch;
5. YSB through the ``device_cursor_step`` loop: tuples/s and ms/step;
6. YSB-sum (Key_FFAT summing an int32 field) for a few batches: dense-oracle
   check and K3's launches;
7. Nexmark q1, q2, q3, q6, q7 through ``Pipeline(...).run()`` at
   ``bench_nexmark``'s batch (2^14) for 16 batches: every sink row against
   the dense oracle, and the exact K4 and K5 launches of each query;
8. the same five queries through the ``device_cursor_step`` loop: tuples/s
   and ms/step;
9. q3 at full width (2^20-event batches, 2048 auctions): tuples/s, and
   every emitted row against a numpy int32 oracle;
10. the ``{"kernels": [...]}`` summary, then the result line
    ``{"ok": true, "device": {...}}`` as the last line.

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
SUM_BATCHES = 3           # batches of the YSB-sum phase
NEX_BATCH = 1 << 14       # bench.py::bench_nexmark's batch
NEX_BATCHES = 16          # batches of the Nexmark Pipeline phase (262,144 events)
NEX_STEPS = 20            # timed steps of the Nexmark loops (after 2 warm-up)
Q3_AUCTIONS = 2048        # q3 at full width: auctions = table slots
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores (data sheet),
                          # the rate used for int32 compares and selects


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
                 library_graph=True, ops=0):
    """Kernel vs plain version (bit for bit) and their times. ``*_ms`` are
    device times from graph replay; ``*_eager_ms`` time eager calls. A library
    call that syncs with the host (``bincount`` sizes its output from the
    data) cannot be captured and is timed eagerly; ``library=None`` means no
    single PyTorch call computes the function. The bound is the larger of
    ``nbytes`` over the memory rate and ``ops`` over the operation rate."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    same, err = compare(torch, got, want)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    row = {"kernel_check": name, "case": case, "shape": shape,
           "bit_identical": same, "max_abs_err": err,
           "kernel_ms": graph_ms(torch, kernel), "plain_ms": graph_ms(torch, plain),
           "library_ms": (None if library is None else graph_ms(torch, library)
                          if library_graph else time_ms(torch, library)),
           "library_timing": "graph" if library_graph else "eager",
           "kernel_eager_ms": time_ms(torch, kernel),
           "plain_eager_ms": time_ms(torch, plain),
           "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(row)
    if not same:
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
    from windflow_tpu_torch.ops import histogram as H, lookup as L, segment as S

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)
    C = BATCH
    rows = {}
    b, window = ysb_traffic(torch, ysb, 3 * BATCH)
    K, P = window.num_keys, window.P
    pane = torch.div(b.ts, window.pane_len, rounding_mode="floor")

    # K1 histogram
    def k1(case, key, pane_, valid):
        ok = valid & (key >= 0) & (key < K)
        flat = torch.where(ok, key.long() * P + torch.remainder(pane_, P).long(), K * P)
        return check_kernel(
            torch, "histogram", case,
            lambda: H.histogram_cuda(key, pane_, valid, K, P),
            lambda: H.histogram_plain(key, pane_, valid, K, P),
            lambda: torch.bincount(flat, minlength=K * P + 1),
            C * 9 + K * P * 4, {"C": C, "K": K, "P": P}, library_graph=False)
    rows["histogram"] = k1("ysb", b.key, pane, b.valid)
    k1("adversarial",
       torch.randint(-10, K + 10, (C,), device=dev, generator=gen, dtype=torch.int32),
       torch.randint(-10 ** 6, 10 ** 6, (C,), device=dev, generator=gen,
                     dtype=torch.int32),
       torch.rand((C,), device=dev, generator=gen) < 0.7)

    # K2 lookup
    table = ysb.campaign_table(dev)
    Kt = table.shape[0]

    def k2(case, idx):
        safe = idx.clamp(0, Kt - 1)
        return check_kernel(
            torch, "lookup", case,
            lambda: L.lookup_cuda(table, idx), lambda: L.lookup_plain(table, idx),
            lambda: table.index_select(0, safe),
            C * 8 + Kt * 4, {"C": C, "K": Kt, "dtype": "int32"})
    src = ysb.make_source(4 * BATCH)
    rows["lookup"] = k2("ysb", src.make_batch(3 * BATCH, BATCH).payload["ad_id"])
    k2("out_of_range", torch.randint(-100, Kt + 100, (C,), device=dev, generator=gen,
                                     dtype=torch.int32))

    # K3 segment_fold
    def k3(case, values, seg, valid, Sn):
        ok = valid & (seg >= 0) & (seg < Sn)
        safe = torch.where(ok, seg, Sn)
        masked = torch.where(ok, values, 0)
        return check_kernel(
            torch, "segment_fold", case,
            lambda: S.segment_fold_cuda(values, seg, valid, Sn),
            lambda: S.segment_fold_plain(values, seg, valid, Sn),
            lambda: torch.zeros(Sn + 1, dtype=torch.int32, device=dev
                                ).index_add_(0, safe, masked),
            C * 9 + Sn * 4, {"C": C, "S": Sn, "dtype": str(values.dtype)})
    seg = torch.where(b.valid, b.key * P + torch.remainder(pane, P), K * P)
    rows["segment_fold"] = k3("ysb_sum", b.payload["ad_id"], seg, b.valid, K * P)
    for Sn in (K * P, 4096, 1024):
        vals = torch.randint(-2 ** 31, 2 ** 31, (C,), device=dev, generator=gen,
                             dtype=torch.int64).to(torch.int32)
        sg = torch.randint(-5, Sn + 5, (C,), device=dev, generator=gen,
                           dtype=torch.int32)
        k3(f"full_int32_S{Sn}", vals, sg, torch.rand((C,), device=dev, generator=gen) < 0.8,
           Sn)
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
           "ms": graph_ms(torch, lambda: S.segment_fold_float_cuda(vals, seg, valid, Sn)),
           "library_ms": graph_ms(torch, lambda: torch.zeros(
               Sn + 1, device=dev).index_add_(0, safe, masked)),
           "bound_ms": (C * 9 + Sn * 4) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(row)
    if not same:
        raise AssertionError("the float fold's bits differ between runs or from the CPU")


def nexmark_kernel_phase(torch):
    """K5 at the q3/q7 bench shape, at q3's full width and above the TPU
    envelope; K4 at TopN's bench shape and others, each sort also against a
    stable lexsort."""
    from windflow_tpu_torch.ops import bitonic as B, lookup as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261019)
    rows = {}

    def k5(case, C, K, vals_dtype):
        keys = (torch.randperm(8 * K, device=dev, generator=gen)[:K] - 4 * K).to(torch.int32)
        if K > 4:
            keys[-2:] = L.JOIN_KEY_SENTINEL        # unused slots: repeated sentinel
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
        return check_kernel(
            torch, "join_probe", case,
            lambda: L.join_probe_cuda(keys, vals, probe, valid),
            lambda: L.join_probe_plain(keys, vals, probe, valid),
            None, C * 10 + K * 8, {"C": C, "K": K, "dtype": str(vals_dtype)},
            ops=n_valid * K)
    rows["join_probe"] = k5("q3_full_width", 1 << 20, Q3_AUCTIONS, torch.int32)
    k5("q3_q7_bench", NEX_BATCH, 16, torch.int32)
    k5("above_tpu_envelope", 1 << 20, 5000, torch.int32)
    k5("float_nan_negative_zero", 1 << 20, Q3_AUCTIONS, torch.float32)
    k5("float_bench", NEX_BATCH, 16, torch.float32)

    def lexsort(p, s, c, i):
        perm = torch.argsort(i, dim=-1, stable=True)
        for k in (c, s, p):
            perm = torch.gather(perm, -1, torch.argsort(torch.gather(k, -1, perm),
                                                        dim=-1, stable=True))
        return tuple(torch.gather(x, -1, perm) for x in (p, s, c, i))

    def k4(case, R, n, sort, ties=False):
        hi = 4 if ties else 2 ** 31
        p = torch.randint(-hi, hi, (R, n), device=dev, generator=gen, dtype=torch.int64)
        s = torch.randint(-hi, hi, (R, n), device=dev, generator=gen, dtype=torch.int64)
        p, s = p.to(torch.int32), s.to(torch.int32)
        c = torch.zeros((R, n), dtype=torch.int32, device=dev)
        i = torch.arange(n, dtype=torch.int32, device=dev).expand(R, n).contiguous()
        if not sort:                              # bitonic input: up, then down
            p, s, c, i = lexsort(p, s, c, i)
            h = n // 2
            p, s, c, i = (torch.cat([x[:, :h], x[:, h:].flip(1)], 1).contiguous()
                          for x in (p, s, c, i))
        packed = (p.to(torch.int64) << 32) | (s.to(torch.int64) & 0xffffffff)
        m = n.bit_length() - 1
        stages = m * (m + 1) // 2 if sort else m
        row = check_kernel(
            torch, "ordering_merge", case,
            lambda: B.network_cuda(p, s, c, i, sort=sort),
            lambda: B.network_plain(p, s, c, i, sort=sort),
            lambda: torch.sort(packed, dim=-1, stable=True),
            R * n * 32, {"R": R, "n": n, "network": "sort" if sort else "merge",
                         "ties": ties},
            ops=R * (n // 2) * stages * 8)
        got = B.network_cuda(p, s, c, i, sort=sort)
        want = lexsort(p, s, c, i)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"ordering_merge [{case}]: differs from a stable lexsort")
        return row
    rows["ordering_merge"] = k4("topn_bench", 16, 1 << 15, True)
    k4("topn_bench_ties", 16, 1 << 15, True, ties=True)
    k4("smallest", 1, 2, True)
    k4("beyond_tpu_envelope", 4, 1 << 16, True)
    k4("merge_one_row", 1, 1 << 15, False)
    k4("merge_rows", 8, 4096, False)
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
    from windflow_tpu_torch.nexmark import PORTED, make_query, oracles

    total = NEX_BATCHES * NEX_BATCH
    launches = dict.fromkeys(registry.KERNELS, 0)
    for name in PORTED:
        src, ops = make_query(name, total)
        views = []
        pipe = wt.Pipeline(src, ops, wt.Sink(lambda v: views.append(v)),
                           batch_size=NEX_BATCH)
        registry.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = registry.launch_counts()
        for k, n in counts.items():
            launches[k] += n
        got = nexmark_rows(np, name, [v for v in views if v is not None])
        want = oracles.ORACLES[name](total)
        log({"phase": "nexmark_pipeline", "query": name, "batches": NEX_BATCHES,
             "batch": NEX_BATCH, "rows": len(got), "run_s": dt,
             "tuples_per_s": total / dt, "launches": counts})
        if got != want:
            bad = sorted(set(got) ^ set(want))[:5]
            raise AssertionError(f"{name}: sink rows differ from the dense oracle: {bad}")
        expect = {k: NEX_LAUNCHES[name].get(k, 0) for k in counts}
        if counts != expect:
            raise AssertionError(f"{name}: launches {counts}, expected {expect}")
    return launches


def nexmark_loop_phase(torch, wt, card, profile):
    from windflow_tpu_torch.benchmarks import device_cursor_step
    from windflow_tpu_torch.nexmark import PORTED, make_query

    warm = 2
    for name in PORTED:
        src, ops = make_query(name, (NEX_STEPS + warm + PROFILE_STEPS) * NEX_BATCH)
        chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=NEX_BATCH,
                                 event_time=False)
        step = device_cursor_step(chain, src, NEX_BATCH)
        states = tuple(chain.states)
        cur = torch.zeros((), dtype=torch.int32, device="cuda")
        for _ in range(warm):
            states, cur, _ = step(states, cur)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NEX_STEPS):
            states, cur, out = step(states, cur)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log({"phase": "nexmark_loop", "query": name, "steps": NEX_STEPS,
             "batch": NEX_BATCH, "tuples_per_s": NEX_STEPS * NEX_BATCH / dt,
             "ms_per_step": dt / NEX_STEPS * 1e3, "card": card})
        if int(cur) != (NEX_STEPS + warm) * NEX_BATCH:
            raise AssertionError(f"{name} loop: unexpected cursor {int(cur)}")
        if profile and name in ("q3_enrich_join", "q6_topn"):
            profile_steps(torch, f"nexmark_loop_{name}", step, states, cur,
                          dt / NEX_STEPS * 1e3)


def q3_oracle_np(np, start, n):
    """q3's expected lanes for events ``start .. start+n-1`` in numpy int32
    arithmetic (wrapping products, floored %): (emitted, auction, category,
    price)."""
    i = np.arange(start, start + n, dtype=np.int64).astype(np.int32)
    auction = (i * np.int32(2477)) % np.int32(Q3_AUCTIONS)
    category = (auction * np.int32(13)) % np.int32(7)
    price = (i * np.int32(7919)) % np.int32(9973) + np.int32(100)
    return i >= Q3_AUCTIONS, auction, category, price


def q3_full_width_phase(torch, np, wt, registry, card, profile):
    from windflow_tpu_torch.benchmarks import device_cursor_step
    from windflow_tpu_torch.nexmark import make_query

    warm = 2
    total = (NEX_STEPS + warm + PROFILE_STEPS) * BATCH
    src, ops = make_query("q3_enrich_join", total, n_auctions=Q3_AUCTIONS)
    chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=BATCH,
                             event_time=False)
    step = device_cursor_step(chain, src, BATCH, out_fn=lambda b: (
        b.valid, b.id, b.payload["auction"], b.payload["category"], b.payload["price"]))
    states = tuple(chain.states)
    cur = torch.zeros((), dtype=torch.int32, device="cuda")
    outs = []
    for _ in range(warm):
        states, cur, out = step(states, cur)
        outs.append(out)
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    for _ in range(NEX_STEPS):
        states, cur, out = step(states, cur)
        outs.append(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
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
    log({"phase": "q3_full_width", "steps": NEX_STEPS, "batch": BATCH,
         "auctions": Q3_AUCTIONS, "tuples_per_s": NEX_STEPS * BATCH / dt,
         "ms_per_step": dt / NEX_STEPS * 1e3, "rows_checked": rows,
         "table_used": int(st["used"].sum()), "dropped": int(st["dropped"]),
         "launches": launches, "card": card})
    if launches["join_probe"] != 2 * NEX_STEPS or int(st["dropped"]) != 0 \
            or int(st["used"].sum()) != Q3_AUCTIONS:
        raise AssertionError(f"q3 full width: launches {launches}, table "
                             f"{int(st['used'].sum())} used, {int(st['dropped'])} dropped")
    if profile:
        del outs
        profile_steps(torch, "q3_full_width", step, states, cur, dt / NEX_STEPS * 1e3)


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
    total = YSB_BATCHES * BATCH
    ops = ysb.make_ops(**ysb.bench_geometry(BATCH))
    parts, cb = collect_sink()
    pipe = wt.Pipeline(ysb.make_source(total), ops, wt.Sink(cb), batch_size=BATCH)
    registry.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = registry.launch_counts()
    got = as_dict(np, parts)
    want = ysb.dense_oracle(total)
    row = {"phase": "ysb_pipeline", "batches": YSB_BATCHES, "batch": BATCH,
           "P": ops[-1].P, "max_wins": ops[-1].max_wins,
           "count_lift": ops[-1].count_lift, "windows": len(got),
           "total": sum(got.values()), "oracle_total": ysb.oracle_totals(total),
           "run_s": dt, "tuples_per_s": total / dt, "launches": launches}
    log(row)
    if ops[-1].count_lift is not True:
        raise AssertionError("YSB's lift was not detected as a count lift")
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))[:5]
        raise AssertionError(f"YSB per-window counts differ from the dense oracle: {bad}")
    if launches["histogram"] != YSB_BATCHES or launches["lookup"] != YSB_BATCHES:
        raise AssertionError(f"expected K1 and K2 once per batch, got {launches}")
    return launches


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


def ysb_loop_phase(torch, wt, ysb, card, profile):
    from windflow_tpu_torch.benchmarks import device_cursor_step

    warm = 3
    src = ysb.make_source((LOOP_STEPS + warm + PROFILE_STEPS) * BATCH)
    ops = ysb.make_ops(**ysb.bench_geometry(BATCH))
    chain = wt.CompiledChain(ops, src.payload_spec(), batch_capacity=BATCH)
    step = device_cursor_step(chain, src, BATCH)
    states = tuple(chain.states)
    cur = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(warm):
        states, cur, _ = step(states, cur)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOP_STEPS):
        states, cur, out = step(states, cur)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    win = states[-1]
    row = {"phase": "ysb_loop", "steps": LOOP_STEPS, "batch": BATCH,
           "tuples_per_s": LOOP_STEPS * BATCH / dt, "ms_per_step": dt / LOOP_STEPS * 1e3,
           "dropped_old": int(win.dropped_old), "card": card}
    log(row)
    if int(win.dropped_old) != 0 or int(cur) != (LOOP_STEPS + warm) * BATCH:
        raise AssertionError("YSB loop: unexpected drops or cursor")
    if profile:
        profile_steps(torch, "ysb_loop", step, states, cur, row["ms_per_step"])


def ysb_sum_phase(torch, np, wt, ysb, registry):
    total = SUM_BATCHES * BATCH
    ops = ysb.make_ops_sum(**ysb.bench_geometry(BATCH))
    parts, cb = collect_sink()
    pipe = wt.Pipeline(ysb.make_source(total), ops, wt.Sink(cb), batch_size=BATCH)
    registry.reset_launches()
    pipe.run()
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    got = as_dict(np, parts)
    log({"phase": "ysb_sum", "batches": SUM_BATCHES, "windows": len(got),
         "count_lift": ops[-1].count_lift, "launches": launches})
    if got != ysb.dense_oracle(total, "sum"):
        raise AssertionError("YSB-sum per-window sums differ from the dense oracle")
    if launches["segment_fold"] != SUM_BATCHES:
        raise AssertionError(f"expected K3 once per batch, got {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of five steps of the YSB, "
                         "q3 (bench and full width) and q6 loops")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    built = cuda.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "built": sorted(built), "flags": " ".join(cuda.NVCC_FLAGS)})
    for stem, rep in built.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"ptxas[{stem}]: {line.strip()}")

    rows = kernel_phase(torch, ysb)
    rows.update(nexmark_kernel_phase(torch))
    repair_checks(torch)
    main_launches = ysb_pipeline_phase(torch, np, wt, ysb, registry)
    ysb_loop_phase(torch, wt, ysb, card, args.profile)
    sum_launches = ysb_sum_phase(torch, np, wt, ysb, registry)
    nex_launches = nexmark_pipeline_phase(torch, np, wt, registry)
    nexmark_loop_phase(torch, wt, card, args.profile)
    q3_full_width_phase(torch, np, wt, registry, card, args.profile)

    path_launches = {"histogram": main_launches["histogram"],
                     "lookup": main_launches["lookup"],
                     "segment_fold": sum_launches["segment_fold"],
                     "ordering_merge": nex_launches["ordering_merge"],
                     "join_probe": nex_launches["join_probe"]}
    kernels = []
    for name, k in registry.tpu_kernels().items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": path_launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

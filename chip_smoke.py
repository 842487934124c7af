#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``windflow_tpu_torch``) on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py              # the default run, one card
    python3 chip_smoke.py --profile    # adds a torch.profiler breakdown of a YSB step

Phases (each raises on a mismatch, so any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every CUDA kernel from ``windflow_tpu_torch/ops/csrc`` with nvcc
   for sm_90a, and its time;
3. each kernel (K1 histogram, K2 lookup, K3 segment_fold) at main-path shapes,
   on YSB traffic and on adversarial inputs: bit-identical to its plain PyTorch
   version, with the kernel's, the plain version's and one library call's
   device times (CUDA-graph replay; eager times beside them) and the
   memory-bound time (bytes moved / 3.35 TB/s);
4. YSB at full width through ``Pipeline(...).run()`` and a host ``Sink``:
   2^20-event batches with ``bench.py``'s geometry, every per-window count
   against a numpy dense oracle, and K1 and K2 launched once per batch;
5. YSB through the ``device_cursor_step`` loop: tuples/s and ms/step;
6. YSB-sum (Key_FFAT summing an int32 field) for a few batches: dense-oracle
   check and K3's launches;
7. the ``{"kernels": [...]}`` summary, then the result line
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
SUM_BATCHES = 3           # batches of the YSB-sum phase
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)


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


def check_kernel(torch, name, case, kernel, plain, library, nbytes, shape,
                 library_graph=True):
    """Kernel vs plain version (bit for bit) and their times. ``*_ms`` are
    device times from graph replay; ``*_eager_ms`` time eager calls. A library
    call that syncs with the host (``bincount`` sizes its output from the
    data) cannot be captured and is timed eagerly."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    same = got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    row = {"kernel_check": name, "case": case, "shape": shape,
           "bit_identical": bool(same), "max_abs_err": err,
           "kernel_ms": graph_ms(torch, kernel), "plain_ms": graph_ms(torch, plain),
           "library_ms": (graph_ms(torch, library) if library_graph
                          else time_ms(torch, library)),
           "library_timing": "graph" if library_graph else "eager",
           "kernel_eager_ms": time_ms(torch, kernel),
           "plain_eager_ms": time_ms(torch, plain),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
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


def ysb_loop_phase(torch, wt, ysb, card, profile):
    from windflow_tpu_torch.benchmarks import device_cursor_step

    warm = 3
    src = ysb.make_source((LOOP_STEPS + warm + 2) * BATCH)
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
        # device kernels of a few steps: busy time per step against the
        # unprofiled step time gives the card's idle share
        from torch.profiler import ProfilerActivity, profile as prof
        n = 5
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(n):
                states, cur, out = step(states, cur)
            torch.cuda.synchronize()
        kern = [e for e in p.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.device_time_total for e in kern) / n
        log({"phase": "ysb_loop_profile", "steps": n,
             "kernels_per_step": sum(e.count for e in kern) / n,
             "device_busy_ms_per_step": busy_us / 1e3,
             "idle_share": 1 - busy_us / 1e3 / row["ms_per_step"]})
        for e in sorted(kern, key=lambda e: -e.device_time_total)[:12]:
            log({"profile_kernel": e.key[:100], "per_step": e.count / n,
                 "device_us_per_step": e.device_time_total / n})


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
                    help="add a torch.profiler breakdown of five YSB loop steps")
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
    main_launches = ysb_pipeline_phase(torch, np, wt, ysb, registry)
    ysb_loop_phase(torch, wt, ysb, card, args.profile)
    sum_launches = ysb_sum_phase(torch, np, wt, ysb, registry)

    path_launches = {"histogram": main_launches["histogram"],
                     "lookup": main_launches["lookup"],
                     "segment_fold": sum_launches["segment_fold"]}
    kernels = []
    for name, k in registry.KERNELS.items():
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

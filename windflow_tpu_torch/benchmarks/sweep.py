"""Benchmark sweep harness: {batch capacity} x {num_keys} x {workload} on one
device, rendered as a markdown table (``RESULTS.md``).

Counterpart of ``windflow_tpu/benchmarks/sweep.py`` and, through it, of the
reference's committed sweep (``src/GPU_Tests/new_tests/run_tests.py:20-28``:
{batch 1k/5k/10k} x {1..14 sources} x {1..10k keys}, results recorded as
org-tables in ``results.org``). Workloads mirror the reference benchmark
programs:

- ``map_stateless``    — MapGPU stateless analogue (results.org:22-31)
- ``map_stateful``     — keyed per-key running state (results.org:8-18)
- ``filter``           — FilterGPU analogue (results.org:55-66)
- ``win_kf``           — keyed sliding CB windows (Key_FFAT)

plus one row per Nexmark query and the capacity autotuner's ``(adaptive)``
rows. Every step runs through :func:`~windflow_tpu_torch.benchmarks.device_cursor_step`,
which on the card captures the whole step as one CUDA graph at its first
call; that warm call runs before the clock starts, and the timed loop ends
with one ``torch.cuda.synchronize()`` and reads nothing back.

Run::

    python -m windflow_tpu_torch.benchmarks.sweep [--steps N] [--out RESULTS.md] [--device cpu]

(the defaults are sized for the card; the tests drive tiny shapes on the CPU).
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List, Tuple

import torch

from ..device import resolve_device

Row = Tuple[str, int, int, float]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(step: Callable, states, n_steps: int, device) -> Tuple[float, tuple]:
    """Seconds of ``n_steps`` steps after one warm step, and the states they
    leave. The cursor lives on the device and advances inside the step."""
    device = resolve_device(device)
    cur = torch.zeros((), dtype=torch.int32, device=device)
    states, cur, out = step(states, cur)        # warm: builds and captures
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        states, cur, out = step(states, cur)
    _sync(device)
    return time.perf_counter() - t0, states


def _throughput(step: Callable, states, n_steps: int, batch: int, device=None) -> float:
    """Tuples a second of ``n_steps`` steps of ``batch`` lanes."""
    seconds, _ = _timed(step, states, n_steps, device)
    return n_steps * batch / seconds


def _chain_step(ops, src, batch, device=None):
    """``(step, states)``: the bench step of ``ops`` over ``src`` at
    ``batch`` lanes and the chain's initial states."""
    from . import device_cursor_step
    from ..runtime.pipeline import CompiledChain

    chain = CompiledChain(ops, src.payload_spec(), batch_capacity=batch,
                          device=resolve_device(device), event_time=False)
    return device_cursor_step(chain, src, batch), tuple(chain.states)


def measure(ops, src, batch: int, steps: int, device=None) -> Tuple[float, tuple]:
    """One row's tuples a second and the states after its timed steps. The
    chain, its captured graph and the states it consumed are freed when this
    returns, before the caller builds the next row."""
    step, states = _chain_step(ops, src, batch, device)
    seconds, states = _timed(step, states, steps, device)
    return steps * batch / seconds, states


def workloads(batch: int, keys: int, total: int, device=None):
    """``name -> (source, ops)`` of the four reference workloads."""
    from ..operators.accumulator import Accumulator
    from ..operators.filter import Filter
    from ..operators.map import Map
    from ..operators.source import DeviceSource
    from ..operators.win_patterns import Key_FFAT
    from ..operators.window import WindowSpec

    dev = resolve_device(device)
    src = DeviceSource(lambda i: {"v": (i % 997).float()},
                       total=total, num_keys=keys, device=dev)
    return {
        "map_stateless": (src, [Map(lambda t: {"v": t.v * 2.0 + 1.0}, device=dev)]),
        "filter": (src, [Filter(lambda t: t.v > 100.0, device=dev)]),
        "map_stateful": (src, [Accumulator(lambda t: t.data["v"], init_value=0.0,
                                           num_keys=max(keys, 8), device=dev)]),
        "win_kf": (src, [Key_FFAT(lambda t: t.v, torch.add, spec=WindowSpec(1024, 512),
                                  num_keys=max(keys, 8), device=dev)]),
    }


NAMES = ("map_stateless", "map_stateful", "filter", "win_kf")


def run_sweep(batches=(1 << 16, 1 << 18, 1 << 20), keyset=(1, 500, 10_000),
              names=NAMES, steps: int = 20, device=None, on_row=None) -> List[Row]:
    """The fixed ladder: one row ``(workload, batch, keys, tuples/s)`` for
    each batch, key count and workload. ``on_row(row, ops, states)``, when
    given, sees each row, its operators and the states after its timed steps
    before they are freed."""
    dev = resolve_device(device)
    rows = []
    for batch in batches:
        for keys in keyset:
            for name in names:
                src, ops = workloads(batch, keys, (steps + 2) * batch, dev)[name]
                tps, states = measure(ops, src, batch, steps, dev)
                rows.append((name, batch, keys, tps))
                if on_row is not None:
                    on_row(rows[-1], ops, states)
                del src, ops, states
    return rows


def run_nexmark(batches=(1 << 12, 1 << 14), steps: int = 20, device=None,
                on_row=None) -> List[Row]:
    """One row for every Nexmark query: the scenario-diversity table beside
    the classic four workloads. The key column reports each query's own key
    domain (auctions and bidders are fixed by the generators, not swept).
    ``on_row`` as in :func:`run_sweep`."""
    from ..nexmark import QUERIES, make_query
    from ..nexmark import generators as g

    dev = resolve_device(device)
    keys_of = {"q5_session": g.N_BIDDERS}
    rows = []
    for batch in batches:
        for name in QUERIES:
            src, ops = make_query(name, total=(steps + 2) * batch, device=dev)
            tps, states = measure(ops, src, batch, steps, dev)
            rows.append((f"nexmark:{name}", batch, keys_of.get(name, g.N_AUCTIONS), tps))
            if on_row is not None:
                on_row(rows[-1], ops, states)
            del src, ops, states
    return rows


def run_adaptive(batches=(1 << 16, 1 << 18, 1 << 20), keyset=(1, 500, 10_000),
                 names=NAMES, steps: int = 20, cache_path=None,
                 device=None) -> List[Row]:
    """The autotuned counterpart of :func:`run_sweep`: for each workload the
    control plane's :class:`~windflow_tpu_torch.control.CapacityAutotuner`
    hill-climbs the same capacity ladder the fixed sweep enumerates,
    measuring each rung it visits as :func:`run_sweep` does, so an
    ``(adaptive)`` row (chosen capacity in the batch column, its rate in the
    rate column) compares directly with the fixed rows. ``cache_path``
    persists and consumes the tuning cache: a second call warm-starts at the
    cached rung and measures only that rung."""
    from ..control.autotune import (CapacityAutotuner, TuningCache, chain_signature,
                                    device_kind, payload_signature, tuning_key)

    dev = resolve_device(device)
    ladder = sorted(int(b) for b in batches)
    cache = TuningCache(cache_path) if cache_path else None
    rows = []
    for keys in keyset:
        for name in names:
            def rate(batch):
                src, ops = workloads(batch, keys, (steps + 2) * batch, dev)[name]
                step, states = _chain_step(ops, src, batch, dev)
                return _throughput(step, states, steps, batch, dev)
            key = None
            if cache is not None:
                # the signature of freshly built ops: the geometry it reads
                # is set at construction
                src0, ops0 = workloads(ladder[0], keys, 4 * ladder[0], dev)[name]
                key = tuning_key(chain_signature(ops0),
                                 payload_signature(src0.payload_spec()), device_kind(dev))
            tuner = CapacityAutotuner(ladder, start_capacity=ladder[0], cache=cache,
                                      cache_key=key, name=f"sweep:{name}:k{keys}")
            while True:
                tps = rate(tuner.capacity)
                if tuner.converged:
                    break           # warm start: one confirming measurement
                nxt = tuner.observe(tps)
                if tuner.converged and nxt is None:
                    break           # converged on the rung just measured
                # converged with a switch back to the best rung: measure the
                # winner once more; otherwise keep climbing
            rows.append((f"{name} (adaptive)", tuner.capacity, keys, tps))
    return rows


def device_label(device=None) -> str:
    """The device a table was measured on: ``nvidia-smi``'s name and power
    limit of the card, or the torch device's name off the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{torch.cuda.get_device_name(dev)} (power limit not read)"


def render_markdown(rows, device: str) -> str:
    lines = [
        "# RESULTS — swept throughput (tuples/s)",
        "",
        f"Device: {device}. Counterpart of the reference's committed sweep "
        "tables (`src/GPU_Tests/new_tests/results/results.org`). `(adaptive)` "
        "rows: the control plane's capacity autotuner hill-climbed the same "
        "ladder — batch column = chosen capacity.",
        "",
        "| workload | batch | keys | M tuples/s |",
        "|---|---|---|---|",
    ]
    for name, batch, keys, tps in rows:
        lines.append(f"| {name} | {batch} | {keys} | {tps / 1e6:.2f} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="RESULTS.md")
    ap.add_argument("--no-adaptive", action="store_true",
                    help="skip the autotuned rows (fixed-ladder sweep only)")
    ap.add_argument("--no-nexmark", action="store_true",
                    help="skip the Nexmark query rows")
    ap.add_argument("--tuning-cache", default=None,
                    help="tuning-cache path for the adaptive rows (a second "
                    "run warm-starts at the cached optimum)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; cpu runs every "
                         "kernel's plain PyTorch version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = run_sweep(steps=args.steps, device=dev)
    if not args.no_adaptive:
        rows += run_adaptive(steps=args.steps, cache_path=args.tuning_cache, device=dev)
    if not args.no_nexmark:
        rows += run_nexmark(steps=args.steps, device=dev)
    md = render_markdown(rows, device_label(dev))
    with open(args.out, "w") as f:
        f.write(md)
    print(md, file=sys.stderr)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()

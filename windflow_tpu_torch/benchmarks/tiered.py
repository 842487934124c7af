"""``bench.py``'s tiered-state row in the port.

:func:`bench_nexmark_tiered_100x` is ``bench.py::_bench_nexmark_tiered_100x``
(``bench.py:511-548``): Nexmark q3's stream-table join over a key space 100x
the batch (``keys = 100 * batch``) with a hot table of ``4 * batch`` slots
(``tiered=dict()``, the hot target one batch), ``keys`` definition events then
``max(4, min(steps, 12))`` batches of probes, driven through
``CompiledChain.push`` one batch at a time so the spill maintenance runs as
in production, each push timed to completion. It returns the JAX function's
fields. The JAX function caps the batch at 1024 (its resolve pass builds a
quadratic ``[R, K]`` compare); the port computes the same results without
it, so ``batch`` is taken as given.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..nexmark import make_query
from ..runtime.pipeline import CompiledChain


def bench_nexmark_tiered_100x(batch: int, steps: int, device=None,
                              on_out: Optional[Callable] = None) -> dict:
    """The row's fields: tuples/s over every push, mean and p99 seconds of a
    step (the first, which builds and loads the kernels, left out), the
    geometry, overflow drops, spills and readmissions (the device counters),
    and the cold tier's keys. ``on_out(batch, chain)`` gets each push's
    output and the chain after its time is taken."""
    b = int(batch)
    hot = 4 * b                     # clears the admission reserve (3b)
    keys = 100 * b                  # 100x the per-batch working set
    n_steps = max(4, min(int(steps), 12))
    total = keys + n_steps * b      # definition prefix + probe traffic
    src, ops = make_query("q3_enrich_join", total, n_auctions=keys, num_slots=hot,
                          tiered=dict(), device=device)
    chain = CompiledChain(ops, src.payload_spec(), batch_capacity=b, device=src.device)
    cuda = chain.device.type == "cuda"
    times = []
    for bt in src.batches(b):
        t0 = time.perf_counter()
        out = chain.push(bt)
        if cuda:
            torch.cuda.current_stream(chain.device).synchronize()
        times.append(time.perf_counter() - t0)
        if on_out is not None:
            on_out(out, chain)
    st = chain.states[0]
    timed = sorted(times[1:])
    p99 = timed[min(len(timed) - 1, int(0.99 * len(timed)))]
    n = len(times)
    spills, readmits = int(st["spills"]), int(st["readmits"])
    return {
        "tps": n * b / sum(times),
        "step_s": sum(timed) / max(1, len(timed)),
        "p99_step_s": p99,
        "batch": b, "keys": keys, "hot_capacity": hot, "batches": n,
        "overflow_drops": int(st["dropped"]),
        "state_spills": spills, "state_readmits": readmits,
        "spills_per_step": round(spills / n, 2),
        "readmits_per_step": round(readmits / n, 2),
        "cold_keys": ops[0]._tier.store.key_count(),
    }


__all__ = ["bench_nexmark_tiered_100x"]

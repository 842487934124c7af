"""Capacity autotuner: closed-loop micro-batch sizing over a rung ladder.

Counterpart of ``windflow_tpu/control/autotune.py``; the ladder, the
hill-climb, the key functions and the JSON bytes of the tuning cache are the
JAX package's, so a plan written by one package on the CPU is read by the
other.

- :func:`build_ladder`: a power-of-two ladder of capacities around the base
  (``base * 2^k``; down-rungs stop when the base stops dividing evenly, so
  rebatching stays an exact concat/slice with no re-padding).
- :class:`Rebatcher`: converts the source's base-capacity batches to the
  current rung at the ingest boundary: up-rungs concatenate 2^k base batches
  (``concat_batches``), down-rungs slice one base batch into 2^k pieces
  (``split_batch``). Lane content is unchanged, so results do not depend on
  the rung schedule. No padding, and no read of a device value.
- :class:`CapacityAutotuner`: hill-climbs tuples/s over the ladder. A rung
  switch selects a program made ready for that capacity before the run
  (``CompiledChain.warm``), so the hot path never builds one.
- :class:`TuningCache`: persists the winning rung to JSON keyed by (chain
  signature, payload spec, device kind), so later runs warm-start at the
  optimum instead of re-exploring. The device kind is ``gpu:<card name>``
  on a CUDA card and ``cpu:cpu`` on the CPU (:func:`device_kind`): a plan
  written on a TPU never matches, and the CPU keys equal the JAX package's.

The measured signal is tuples pushed per wall second at the chain boundary,
over ``decide_every``-batch windows with a ``settle_batches`` blackout after
each switch. Pushes are asynchronous on the card: the window's host time is
what the tuner reads, and nothing here waits for the card.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from functools import reduce
from typing import List, Optional

from ..batch import concat_batches, dtype_name, jax_leaves, split_batch
from ..observability import journal as _journal
from . import _state


def build_ladder(base: int, up: int = 2, down: int = 2,
                 min_capacity: int = 8, max_capacity: Optional[int] = None,
                 ) -> List[int]:
    """Power-of-two capacity rungs around ``base``, ascending, ``base``
    included. Down-rungs require exact divisibility (a base batch must slice
    into whole pieces) and stop at ``min_capacity``."""
    base = int(base)
    if base < 1:
        raise ValueError(f"ladder base must be >= 1, got {base}")
    rungs = [base]
    c = base
    for _ in range(max(0, int(down))):
        if c % 2 or c // 2 < min_capacity:
            break
        c //= 2
        rungs.append(c)
    c = base
    for _ in range(max(0, int(up))):
        c *= 2
        if max_capacity is not None and c > max_capacity:
            break
        rungs.append(c)
    return sorted(rungs)


class Rebatcher:
    """Base-capacity batches in, current-rung-capacity batches out.

    Rungs are exact multiples/divisors of the base capacity, so rebatching is
    a pure concat/slice — no padding, no compaction, no device sync. Switches
    take effect at base-batch boundaries; batches buffered toward a larger
    rung when the target shrinks are released at their own (base) capacity,
    which is always a ladder rung and therefore already made ready."""

    def __init__(self, base_capacity: int):
        self.base = int(base_capacity)
        self.target = self.base
        self._buf: List = []

    def set_target(self, capacity: int) -> None:
        if capacity >= self.base and capacity % self.base:
            raise ValueError(f"target {capacity} is not a multiple of the "
                             f"base capacity {self.base}")
        if capacity < self.base and self.base % capacity:
            raise ValueError(f"target {capacity} does not divide the base "
                             f"capacity {self.base}")
        self.target = int(capacity)

    def _release_buffer(self) -> List:
        out, self._buf = self._buf, []
        return out

    def feed(self, batch) -> List:
        """One base batch in; zero or more target-capacity batches out."""
        if batch.capacity != self.base:
            # sources emit a fixed capacity; anything else passes through
            # untouched (EOS flush cascades re-enter at odd capacities)
            return self._release_buffer() + [batch]
        if self.target == self.base:
            return self._release_buffer() + [batch]
        if self.target < self.base:
            return self._release_buffer() + split_batch(batch, self.target)
        self._buf.append(batch)
        if len(self._buf) * self.base >= self.target:
            merged = reduce(concat_batches, self._buf)
            self._buf = []
            return [merged]
        return []

    def drain(self) -> List:
        """EOS: release the partial accumulation at base capacity."""
        return self._release_buffer()


# --------------------------------------------------------------- tuning cache

def chain_signature(ops) -> str:
    """Structural signature of an operator chain — what the tuned capacity is
    conditioned on. Geometry-bearing attributes only (window spec, key space,
    fan-out, parallelism), not user lambdas: two runs of the same topology
    share a cache entry even though their closures hash differently."""
    sig = []
    for op in ops:
        row = {"type": type(op).__name__,
               "routing": op.getRoutingMode().name,
               "parallelism": op.getParallelism()}
        spec = getattr(op, "spec", None)
        if spec is not None and hasattr(spec, "win_len"):
            row["win"] = [int(spec.win_len), int(spec.slide),
                          getattr(getattr(spec, "wtype", None), "name", "")]
        for attr in ("num_keys", "max_fanout", "pane_len"):
            v = getattr(op, attr, None)
            if isinstance(v, int):
                row[attr] = v
        sig.append(row)
    return json.dumps(sig, sort_keys=True)


def payload_signature(spec) -> str:
    """The payload spec's leaves (``jax.tree.leaves`` order: dict keys
    sorted) as ``[[shape], dtype]`` rows, the JAX package's string."""
    return json.dumps([[list(getattr(l, "shape", ())),
                        dtype_name(getattr(l, "dtype", "?"))]
                       for l in jax_leaves(spec)])


def device_kind(device=None) -> str:
    """``platform:device_kind`` of ``device`` (None: the first CUDA card when
    there is one, else the CPU): ``gpu:<torch.cuda.get_device_name>`` on a
    card, ``cpu:cpu`` on the CPU."""
    import torch
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device if device is not None else "cpu")
    if dev.type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


def tuning_key(chain_sig: str, payload_sig: str, device: str) -> str:
    h = hashlib.sha1(f"{chain_sig}\n{payload_sig}\n{device}".encode())
    return h.hexdigest()[:16]


def kernel_tuning_key(kernel: str, spec_key: str, device: str) -> str:
    """Cache key for a per-backend KERNEL impl winner (``ops/registry.py``):
    the same keyed-by-(signature, spec, device) discipline as the capacity
    plans, with the kernel family name standing in for the chain signature —
    capacity entries and kernel entries share one cache file without
    colliding."""
    return tuning_key(f"kernel:{kernel}", spec_key, device)


def dispatch_tuning_key(chain_sig: str, payload_sig: str, device: str) -> str:
    """Cache key for the scan-dispatch K winner (``runtime/dispatch.py``):
    the capacity key's (chain, payload, device) coordinates under a
    ``dispatch:`` namespace, so K plans and capacity plans for the SAME chain
    live side by side in one cache file."""
    return tuning_key(f"dispatch:{chain_sig}", payload_sig, device)


class TuningCache:
    """JSON file of winning plans, read-merge-atomic-replace on ``put``; a
    corrupt/missing file reads empty. Two entry kinds share the store:

    - **capacity plans** (``tuning_key``): ``{"capacity": c, "tps": r,
      "ladder": [...], "name": ...}`` — the autotuner's converged rung.
    - **kernel impl winners** (``kernel_tuning_key``, written by
      ``ops/registry.py::persist_winner``): ``{"impl": "cuda", "kernel":
      "histogram", "spec": ..., "tps": ...}`` — the kernel registry
      warm-starts kernel selection from these, so a chain's first launch
      already uses the best known implementation for this device.

    Consumers ignore entry kinds they don't understand (``get`` returns the
    raw dict), so the schema extension is forward- and backward-compatible.
    """

    def __init__(self, path: str):
        self.path = path

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                obj = json.load(f)
            return obj if isinstance(obj, dict) else {}
        except (OSError, ValueError):
            return {}

    def get(self, key: str) -> Optional[dict]:
        return self._load().get(key)

    def put(self, key: str, entry: dict) -> None:
        store = self._load()
        store[key] = dict(entry, wall=time.time())
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(store, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


# ------------------------------------------------------------- the autotuner

class CapacityAutotuner:
    """Hill-climber over a capacity ladder.

    Protocol: the driver calls :meth:`on_batch` after every chain push; a
    non-None return is the new capacity to actuate (the driver points its
    :class:`Rebatcher` at it). Internally each rung is measured over
    ``decide_every`` batches (after a ``settle_batches`` blackout), then
    :meth:`observe` — the pure decision core, directly drivable by harnesses
    like ``benchmarks/sweep.py`` — records the rate and picks the next rung:
    climb up from the seed while each move beats the previous rung by
    ``improve_threshold``, then climb down from the seed the same way, then
    settle on the argmax, journal ``tuning_converged``, and persist the plan.

    A cache hit warm-starts *converged* at the cached rung — the second-run
    acceptance property: no re-exploration, first batch already optimal.
    """

    def __init__(self, ladder: List[int], *, start_capacity: Optional[int] = None,
                 decide_every: int = 8, settle_batches: int = 2,
                 improve_threshold: float = 0.05, clock=time.monotonic,
                 cache: Optional[TuningCache] = None,
                 cache_key: Optional[str] = None, name: str = "",
                 gauge: str = "chosen_capacity"):
        if not ladder:
            raise ValueError("empty capacity ladder")
        self.ladder = sorted(int(c) for c in ladder)
        self.decide_every = max(1, int(decide_every))
        self.settle_batches = max(0, int(settle_batches))
        self.improve_threshold = float(improve_threshold)
        self.clock = clock
        self.cache = cache
        self.cache_key = cache_key
        self.name = name
        #: control gauge this tuner publishes its chosen rung under — the
        #: capacity ladder's "chosen_capacity", or "dispatch_k" when the SAME
        #: hill-climber is pointed at a scan-dispatch K ladder
        self.gauge = gauge
        self.converged = False
        self.decisions = 0
        self._rates = {}                      # capacity -> tuples/s
        self._phase = "up"
        self._prev_rate: Optional[float] = None

        seed = start_capacity if start_capacity in self.ladder else self.ladder[0]
        if cache is not None and cache_key is not None:
            hit = cache.get(cache_key)
            if hit and int(hit.get("capacity", -1)) in self.ladder:
                seed = int(hit["capacity"])
                self.converged = True
                _state.bump("tuning_cache_hits")
                _journal.record("tuning_warm_start", tuner=name,
                                capacity=seed, key=cache_key)
        self.capacity = seed
        self._seed = seed
        _state.set_gauge(self.gauge, self.capacity)
        # measurement window
        self._settle = self.settle_batches
        self._win_batches = 0
        self._win_tuples = 0
        self._win_t0: Optional[float] = None
        # remediation re-climb request (control/remediation.py): SET from
        # the Reporter thread, CONSUMED by the driver loop at the next
        # on_batch boundary — the Event is the only cross-thread surface;
        # all tuner state stays single-writer[driver]
        self._reclimb = threading.Event()

    # -- decision core (pure w.r.t. time: rates come in from outside) -------

    def observe(self, rate: float) -> Optional[int]:
        """Record ``rate`` (tuples/s) for the current capacity and return the
        next capacity to try (None = stay / converged)."""
        if self.converged:
            return None
        self.decisions += 1
        _state.bump("tuning_decisions")
        self._rates[self.capacity] = float(rate)
        i = self.ladder.index(self.capacity)
        improved = (self._prev_rate is None
                    or rate > self._prev_rate * (1 + self.improve_threshold))
        if self._phase == "up":
            if (improved and i + 1 < len(self.ladder)
                    and self.ladder[i + 1] not in self._rates):
                self._prev_rate = rate
                return self._switch(self.ladder[i + 1])
            self._phase = "down"
            self._prev_rate = self._rates[self._seed]
            j = self.ladder.index(self._seed)
            if j - 1 >= 0 and self.ladder[j - 1] not in self._rates:
                return self._switch(self.ladder[j - 1])
            return self._finish()
        # phase == "down"
        if (improved and i - 1 >= 0
                and self.ladder[i - 1] not in self._rates):
            self._prev_rate = rate
            return self._switch(self.ladder[i - 1])
        return self._finish()

    def _switch(self, capacity: int) -> Optional[int]:
        if capacity == self.capacity:
            return None
        self.capacity = capacity
        _state.bump("capacity_switches")
        _state.set_gauge(self.gauge, capacity)
        _journal.record("capacity_switch", tuner=self.name, capacity=capacity)
        self._settle = self.settle_batches
        return capacity

    def _finish(self) -> Optional[int]:
        best = max(self._rates, key=self._rates.get)
        self.converged = True
        _journal.record("tuning_converged", tuner=self.name, capacity=best,
                        tps=round(self._rates[best], 1),
                        rates={str(k): round(v, 1)
                               for k, v in self._rates.items()})
        if self.cache is not None and self.cache_key is not None:
            self.cache.put(self.cache_key, {
                "capacity": int(best), "tps": self._rates[best],
                "ladder": self.ladder, "name": self.name})
        return self._switch(best)

    # -- remediation actuator surface ---------------------------------------

    def request_reclimb(self) -> None:
        """The ``autotune_reclimb`` remediation actuator: ask the driver loop
        to un-converge this tuner at its next batch boundary.  Thread-safe
        (an Event set); actuation itself happens on the driver thread via
        :meth:`reclimb`."""
        self._reclimb.set()

    def reclimb(self) -> bool:
        """Driver-thread: un-converge and re-explore the ladder from the
        current rung.  A tuner still exploring (including one inside a
        settle blackout after a switch) is a no-op — the climb in progress
        IS the re-climb; clobbering its window/blackout mid-measurement
        would poison the rate it is collecting."""
        if not self.converged:
            return False
        self.converged = False
        self._rates = {}
        self._phase = "up"
        self._prev_rate = None
        self._seed = self.capacity
        self._settle = self.settle_batches
        self._win_t0 = None
        _journal.record("tuning_reclimb", tuner=self.name,
                        capacity=self.capacity)
        return True

    # -- driver-loop surface ------------------------------------------------

    def on_batch(self, n_tuples: int) -> Optional[int]:
        """Account one pushed batch; returns a new capacity on a decision
        boundary that switched rungs, else None."""
        if self._reclimb.is_set():
            self._reclimb.clear()
            self.reclimb()
        if self.converged:
            return None
        if self._settle > 0:
            self._settle -= 1
            self._win_t0 = None               # blackout resets the window
            return None
        if self._win_t0 is None:
            # this batch opens the window (its push predates t0 — counting it
            # would inflate the first window's rate); measure the next N
            self._win_t0 = self.clock()
            self._win_batches = 0
            self._win_tuples = 0
            return None
        self._win_batches += 1
        self._win_tuples += int(n_tuples)
        if self._win_batches < self.decide_every:
            return None
        dt = max(self.clock() - self._win_t0, 1e-9)
        rate = self._win_tuples / dt
        self._win_t0 = None
        return self.observe(rate)

    def plan(self) -> dict:
        return {"capacity": self.capacity, "converged": self.converged,
                "rates": dict(self._rates), "ladder": self.ladder}

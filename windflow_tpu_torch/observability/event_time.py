"""Event-time observability: lateness histograms and delay advice.

Counterpart of ``windflow_tpu/observability/event_time.py``. A stateful
event-time operator built with event-time monitoring on (``event_time=True``
on its chain, or ``MonitoringConfig.event_time``) carries an ``int32[NB]``
histogram of observed lateness ``watermark - ts`` in its state; the snapshot
reads it back and names the smallest ``delay=`` that would have kept a
quantile of the recorded arrivals (:func:`recommend_delay`).

- The host half (``NB``, :func:`bucket_of`, :func:`bucket_upper`,
  :func:`lateness_quantile`, :func:`recommend_delay`, :func:`summarize`) is a
  copy of the JAX package's bucket math.
- The device half (:func:`lateness_init`, :func:`lateness_update`,
  :func:`read_hist`) is PyTorch on the state's device. The update is the JAX
  package's one masked ``[C, NB]`` threshold count and one-hot sum, in
  int32, so its counts are byte for byte the JAX ones. It is plain PyTorch
  (the JAX one is ``jnp``, not a Pallas kernel), so it launches no hand
  kernel of its own.

With monitoring off the histogram is absent from the state, and the
operators' steps launch what they launched before.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

#: lateness histogram buckets: bucket 0 = lateness 0; bucket b >= 1 =
#: lateness with bit length b (``[2**(b-1), 2**b - 1]`` ticks).  31 is the
#: widest bit length an int32 lateness can have, so 32 buckets are lossless.
NB = 32


def bucket_of(lateness: int) -> int:
    """Bucket index of one observed lateness value (host-side mirror of the
    device one-hot; tests pin the two agree)."""
    lat = max(0, int(lateness))
    return min(lat.bit_length(), NB - 1)


def bucket_upper(i: int) -> int:
    """Inclusive upper bound (ticks) of bucket ``i`` — the delay that covers
    every lateness the bucket can hold."""
    i = int(i)
    return 0 if i <= 0 else (1 << i) - 1


def lateness_quantile(counts: Sequence[int], q: float) -> int:
    """Upper bound (ticks) of the bucket containing quantile ``q`` (0 < q
    <= 1) of the recorded lateness samples; 0 when the histogram is empty."""
    total = sum(int(c) for c in counts)
    if total <= 0:
        return 0
    target = max(1, math.ceil(float(q) * total))
    acc = 0
    for i, c in enumerate(counts):
        acc += int(c)
        if acc >= target:
            return bucket_upper(i)
    return bucket_upper(len(counts) - 1)


def recommend_delay(counts: Sequence[int], q: float = 0.99) -> int:
    """THE delay advice: the smallest ``delay=`` (at bucket resolution —
    within 2x of the exact sample quantile) that covers quantile ``q`` of the
    observed lateness.  An operator run with ``delay >=`` this value would
    have accepted that fraction of its arrivals as on-time; ``q=1.0`` names
    the delay that drives ``tuples_dropped_old`` / overflow drops to zero
    for the recorded stream (the contract ``tests/test_event_time.py``
    pins end to end)."""
    return lateness_quantile(counts, q)


def summarize(counts: Sequence[int],
              q_recommend: float = 0.99) -> Dict[str, object]:
    """Snapshot-ready summary of one lateness histogram: raw bucket counts
    (so ``wf_state.py`` can re-quantile at any q), p50/p95/p99 upper bounds,
    max-bucket bound, and the default delay recommendation."""
    counts = [int(c) for c in counts]
    total = sum(counts)
    out: Dict[str, object] = {"counts": counts, "total": total}
    if total:
        out["p50"] = lateness_quantile(counts, 0.50)
        out["p95"] = lateness_quantile(counts, 0.95)
        out["p99"] = lateness_quantile(counts, 0.99)
        last = max(i for i, c in enumerate(counts) if c)
        out["max"] = bucket_upper(last)
        out["recommend_delay_p99"] = recommend_delay(counts, q_recommend)
    return out


# ------------------------------------------------------------- device side


def lateness_init(nb: int = NB, device=None) -> torch.Tensor:
    """A fresh ``int32[nb]`` histogram on ``device`` for an operator's state
    (only when event-time monitoring was on at chain build)."""
    return torch.zeros((int(nb),), dtype=torch.int32, device=device)


def lateness_update(hist: torch.Tensor, watermark, ts: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """``hist`` plus one batch's observed lateness: the bucket of lane i is
    the bit length of ``max(watermark - ts[i], 0)``, counted as the number
    of thresholds ``2**0 .. 2**(nb-2)`` it reaches (integer exact, so
    :func:`bucket_of` agrees); lanes outside ``mask`` count nowhere. One
    masked ``[C, nb]`` compare and a column sum, no scatter."""
    nb = hist.shape[0]
    dev = hist.device
    wm = torch.as_tensor(watermark, dtype=torch.int32, device=dev)
    lat = torch.clamp(wm - ts.to(torch.int32), min=0)
    ar = torch.arange(nb - 1, dtype=torch.int32, device=dev)
    th = torch.bitwise_left_shift(torch.ones((), dtype=torch.int32, device=dev), ar)
    b = (lat[:, None] >= th[None, :]).sum(dim=1, dtype=torch.int32)
    oh = (b[:, None] == torch.arange(nb, dtype=torch.int32, device=dev)[None, :]) \
        & mask[:, None]
    return hist + oh.sum(dim=0, dtype=torch.int32)


def read_hist(hist) -> Optional[List[int]]:
    """Host list of bucket counts (a snapshot-time read); None when the
    state carries no histogram."""
    if hist is None:
        return None
    return [int(v) for v in hist.detach().cpu().tolist()]

"""Control-plane configuration — the ``control=`` argument, resolved.

Counterpart of ``windflow_tpu/control/config.py`` (the same fields, defaults
and ``WF_CONTROL`` grammar).

Mirrors the ``monitoring=`` / ``faults=`` conventions of the other opt-in
subsystems: ``None`` consults the ``WF_CONTROL`` environment variable
(``''``/``'0'`` = off, ``'1'`` = defaults, inline JSON object or a path to a
JSON file = field overrides), ``False`` forces off, ``True`` = defaults, a
dict = field overrides, a :class:`ControlConfig` passes through. Off by
default: with control off every driver runs today's exact code path and no
controller state is created.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union


@dataclasses.dataclass
class ControlConfig:
    """Resolved control-plane settings for one driver run.

    Three independent sub-systems, each with its own enable flag:

    - **autotune** — the capacity ladder + hill-climbing batch autotuner
      (``control/autotune.py``); honored by the ``Pipeline`` driver (the
      compiled-chain execution core the ladder actuates).
    - **backpressure** — per-edge SPSC high/low watermark governor
      (``control/governor.py``); honored by ``ThreadedPipeline`` and
      ``PipeGraph._run_threaded``.
    - **admission** — token-bucket rate limiting + load shedding at the
      ingest boundary (``control/admission.py``); honored by every driver
      (the supervised drivers require the deterministic ``refill_per_batch``
      bucket — see ``runtime/supervisor.py``).
    """

    # -- capacity autotuner -------------------------------------------------
    autotune: bool = True
    #: rungs above/below the base capacity (each a x2 / /2 step; down-rungs
    #: stop early when the base capacity stops dividing evenly)
    ladder_up: int = 2
    ladder_down: int = 2
    #: measurement window: batches per hill-climb decision
    decide_every: int = 8
    #: batches ignored right after a rung switch (compile + pipeline refill)
    settle_batches: int = 2
    #: a move must beat the previous rung's rate by this fraction to continue
    improve_threshold: float = 0.05
    #: make every rung's program ready up front (a dry run that leaves the
    #: states untouched) so switches on the hot path never build one
    prewarm: bool = True
    #: JSON tuning-cache path; None = no persistence (cold start every run)
    cache_path: Optional[str] = None

    # -- backpressure governor ----------------------------------------------
    backpressure: bool = True
    #: watermarks as fractions of each edge's ring capacity
    high_watermark: float = 0.75
    low_watermark: float = 0.25
    throttle_poll_s: float = 0.001

    # -- admission control ---------------------------------------------------
    admission: bool = False
    #: token refill rate in tuples/second (wall-clock bucket); None with
    #: admission on = unlimited rate (no shedding, counting only)
    rate_tps: Optional[float] = None
    #: bucket capacity in tuples; None = 4x one base batch (resolved by the
    #: driver, which knows its batch capacity)
    burst_tuples: Optional[float] = None
    #: deterministic positional bucket: tokens refilled per OFFERED batch
    #: instead of per wall-clock second — the replay-stable form the
    #: supervised drivers require (shed decisions become a pure function of
    #: stream position, so checkpoint replay reproduces them exactly)
    refill_per_batch: Optional[float] = None
    #: "drop_newest" sheds the incoming batch when the bucket is empty;
    #: "drop_oldest_ts" holds up to ``hold_max`` batches and sheds the oldest
    #: (lowest-ts) held batch first — the Win_SeqFFAT OLD-straggler stance:
    #: prefer fresh data, drop stale
    shed_policy: str = "drop_newest"
    hold_max: int = 2

    def __post_init__(self):
        if self.shed_policy not in ("drop_newest", "drop_oldest_ts"):
            raise ValueError(
                f"unknown shed_policy {self.shed_policy!r} "
                f"(policies: drop_newest, drop_oldest_ts)")
        if not (0.0 <= self.low_watermark < self.high_watermark <= 1.0):
            raise ValueError(
                f"watermarks must satisfy 0 <= low < high <= 1, got "
                f"low={self.low_watermark} high={self.high_watermark}")

    @classmethod
    def resolve(cls, control: Union[None, bool, str, dict, "ControlConfig"],
                ) -> Optional["ControlConfig"]:
        """Normalize the user-facing ``control=`` argument; None when off."""
        if control is False:
            return None
        if isinstance(control, ControlConfig):
            return control
        if isinstance(control, dict):
            return cls(**control)
        if control is True:
            return cls()
        if isinstance(control, str):
            return cls._from_text(control)
        env = os.environ.get("WF_CONTROL", "")
        if env in ("", "0"):
            return None
        return cls._from_text(env)

    @classmethod
    def _from_text(cls, text: str) -> "ControlConfig":
        text = text.strip()
        if text in ("1", "true"):
            return cls()
        if text and text[0] == "{":
            return cls(**json.loads(text))
        with open(text) as f:                 # a path to a JSON config file
            return cls(**json.load(f))

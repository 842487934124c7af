"""Profile-on-page: a bounded device-profiler capture for incident bundles.

Counterpart of ``windflow_tpu/observability/profiling.py`` on
``torch.profiler``: a capture window of ``window_ms`` (CPU activity, and the
card's kernels through CUPTI when the run is on the card) that fires from
PAGE entry (``SLOEngine.profiler``) or opens programmatically
(:func:`profile_window`).

- **One session guard.** Every capture goes through ``stats.xprof_trace``'s
  one session latch: when it is held, the incident path records a
  ``profile_skipped`` reason into the bundle, and the programmatic path
  raises the guard's RuntimeError naming the holder.
- **Bounded and rate-limited.** A window runs on the Reporter tick thread,
  so it must stay below the reporter interval; :class:`ProfileOnPage`
  counts its attempts against ``max_captures``.
- **Committed before the manifest.** The capture lands under
  ``<bundle>/profile/`` (``trace.json``) and its summary (``profile.json``,
  the JAX package's keys plus ``activities`` and ``kernels``, the device
  kernels the trace names) joins the manifest's ``files`` list.
- **No silent success.** A run on the card whose profiler cannot record
  CUDA activity (no CUPTI) gets a ``profile_skipped`` reason, not a
  CPU-only capture.

Env toggles (off by default; ``''``/``'0'`` = off)::

    WF_PROFILE=1                 # profile-on-page inside incident bundles
    WF_PROFILE_WINDOW_MS=250     # capture window (must stay < reporter tick)
    WF_PROFILE_MAX_CAPTURES=2    # captures per run
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Union

#: capture window default — well under the Reporter's minimum interval
#: guardrail relative to the 1 s default tick, and long enough to cover
#: several serving batches on either backend
DEFAULT_WINDOW_MS = 250.0
#: captures per run (attempts, not successes: a backend that refuses must
#: not be retried on every subsequent page)
DEFAULT_MAX_CAPTURES = 2


@dataclasses.dataclass(frozen=True)
class ProfileConfig:
    """Resolved profile-on-page settings (``MonitoringConfig.profile``)."""

    window_ms: float = DEFAULT_WINDOW_MS
    max_captures: int = DEFAULT_MAX_CAPTURES

    def __post_init__(self):
        if float(self.window_ms) <= 0:
            raise ValueError(f"profile window_ms must be > 0, got "
                             f"{self.window_ms}")
        if int(self.max_captures) < 1:
            raise ValueError(f"profile max_captures must be >= 1, got "
                             f"{self.max_captures}")


def resolve_profile(profile: Union[None, bool, ProfileConfig],
                    ) -> Optional[ProfileConfig]:
    """Normalize the ``profile=`` argument (the ``TraceConfig.resolve``
    convention).  ``None`` consults ``WF_PROFILE`` (``''``/``'0'`` = off);
    ``False`` forces off; ``True`` = defaults; a config passes through.
    ``WF_PROFILE_WINDOW_MS`` / ``WF_PROFILE_MAX_CAPTURES`` override either
    way.  Returns None when profiling is off."""
    if profile is False:
        return None
    if isinstance(profile, ProfileConfig):
        cfg = profile
    elif profile is True:
        cfg = ProfileConfig()
    else:                                  # None: env-driven
        env = os.environ.get("WF_PROFILE", "")
        if env in ("", "0"):
            return None
        cfg = ProfileConfig()
    win = os.environ.get("WF_PROFILE_WINDOW_MS", "")
    if win:
        cfg = dataclasses.replace(cfg, window_ms=float(win))
    mx = os.environ.get("WF_PROFILE_MAX_CAPTURES", "")
    if mx:
        cfg = dataclasses.replace(cfg, max_captures=int(mx))
    return cfg


def profile_problems(cfg: Optional[ProfileConfig],
                     slo_on: bool,
                     interval_s: Optional[float]) -> List[str]:
    """The WF120 check surface (shared by ``MonitoringConfig`` construction
    and ``analysis/validate.py``): problems with a resolved profile config
    against the monitoring setup it rides.  Empty when ``cfg`` is None."""
    if cfg is None:
        return []
    probs: List[str] = []
    if not slo_on:
        probs.append(
            "profile-on-page is on but the SLO engine is off — captures "
            "trigger from PAGE entry only, so WF_PROFILE without WF_SLO "
            "(monitoring + at least one SLOSpec) can never fire")
    if interval_s is not None and float(cfg.window_ms) / 1e3 >= float(
            interval_s):
        probs.append(
            f"profile window {cfg.window_ms} ms >= reporter interval "
            f"{float(interval_s) * 1e3:g} ms — the capture runs ON the "
            f"Reporter tick thread, so a window that reaches the interval "
            f"stacks ticks; shrink WF_PROFILE_WINDOW_MS or stretch the "
            f"monitoring interval")
    try:
        from torch.profiler import supported_activities  # noqa: F401
    except Exception as e:  # noqa: BLE001 — any import failure: no profiler
        probs.append(
            f"profile-on-page is on but torch.profiler is not importable on "
            f"this box ({type(e).__name__}: {e}) — every capture would be "
            f"skipped; unset WF_PROFILE where the serving host has no "
            f"profiler")
    return probs


def profile_window(logdir: str,
                   window_ms: float = DEFAULT_WINDOW_MS) -> dict:
    """One bounded profiler capture: open the ONE ``stats.xprof_trace``
    session, hold it for ``window_ms`` of wall time while the device keeps
    executing whatever the drive loop has in flight, close it, and return
    a summary (``logdir``, ``window_ms``, the files written with sizes).

    Raises the guard's RuntimeError (naming the holder) when a session is
    already active — the programmatic caller decides; the incident path
    (:class:`ProfileOnPage`) converts it into a ``profile_skipped``
    record."""
    from ..stats import xprof_trace
    window_s = float(window_ms) / 1e3
    t0 = time.perf_counter()  # wf-lint: allow[wall-clock] timing-only: capture window bound
    with xprof_trace(logdir):
        # the window IS a sleep: the profiler samples the device/runtime
        # threads, the capture thread only bounds the session
        while True:
            left = window_s - (time.perf_counter() - t0)  # wf-lint: allow[wall-clock] timing-only: capture window bound
            if left <= 0:
                break
            time.sleep(min(left, 0.01))
    files = []
    for root, _dirs, names in os.walk(logdir):
        for nm in sorted(names):
            p = os.path.join(root, nm)
            try:
                files.append({"name": os.path.relpath(p, logdir),
                              "bytes": os.path.getsize(p)})
            except OSError:
                continue
    from ..stats import profiler_activities
    return {"logdir": logdir, "window_ms": float(window_ms),
            "files": sorted(files, key=lambda f: f["name"]),
            "activities": [a.name.lower() for a in profiler_activities()],
            "kernels": trace_kernels(os.path.join(logdir, "trace.json"))}


def trace_kernels(path: str, limit: int = 64) -> List[str]:
    """The distinct device-kernel names of a Chrome trace written by
    ``stats.xprof_trace`` (events of category ``kernel``), sorted; empty
    when the file is missing or holds none."""
    import json
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    except (OSError, ValueError, AttributeError):
        return []
    names = {str(e.get("name")) for e in events
             if isinstance(e, dict) and e.get("cat") == "kernel"}
    return sorted(names)[:int(limit)]


class ProfileOnPage:
    """The ``SLOEngine.profiler`` callable: ``fn(out_dir) -> dict`` run at
    incident-capture time, BEFORE the manifest commits.  Returns either a
    :func:`profile_window` summary or ``{"profile_skipped": reason}`` —
    never raises (forensics must not kill a Reporter tick), and never
    latches anything itself (a held ``xprof_trace`` session is a skip
    reason, not a second latch). It runs on the Reporter's tick thread, so
    the process's first CUDA profiler session must already be open
    (``Monitor.start`` opens it, ``stats.profiler_init``); without it the
    capture is skipped with the reason."""

    def __init__(self, config: Optional[ProfileConfig] = None):
        self.config = config or ProfileConfig()
        #: capture attempts so far — single-writer: the Reporter tick
        #: thread is the only caller (SLOEngine.observe -> capture)
        self.captures = 0                 # wf-lint: single-writer[reporter]

    @staticmethod
    def _unavailable() -> Optional[str]:
        """Why no capture can record this run's device work, or None. A
        process that has initialized CUDA runs on the card: its capture
        must record CUDA activity (CUPTI), or it is skipped."""
        try:
            import torch
            from ..stats import profiler_activities
            from torch.profiler import ProfilerActivity
            acts = profiler_activities()
        except Exception as e:  # noqa: BLE001 — no profiler: record why
            return f"torch.profiler unavailable ({type(e).__name__}: {e})"
        if torch.cuda.is_initialized() and ProfilerActivity.CUDA not in acts:
            return ("CUPTI unavailable: the run is on the card but "
                    "torch.profiler cannot record CUDA activity here")
        return None

    def __call__(self, out_dir: str) -> dict:
        if self.captures >= int(self.config.max_captures):
            return {"profile_skipped":
                    f"max captures reached "
                    f"({int(self.config.max_captures)} per run)"}
        self.captures += 1
        reason = self._unavailable()
        if reason is not None:
            return {"profile_skipped": reason}
        try:
            os.makedirs(out_dir, exist_ok=True)
            return profile_window(out_dir, self.config.window_ms)
        except RuntimeError as e:
            # the session guard (another capture holds the one profiler
            # session) or a backend that cannot profile — both are skip
            # reasons inside a bundle, never a failed tick
            return {"profile_skipped": f"{type(e).__name__}: {e}"}
        except OSError as e:
            return {"profile_skipped": f"OSError: {e}"}


def load_profile(bundle_dir: str) -> Optional[dict]:
    """``profile.json`` of one incident bundle (or None) — the
    ``wf_profile.py`` reader; stdlib only."""
    import json
    path = os.path.join(bundle_dir, "profile.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None

"""wf_profile — profile-on-page inspection and a bounded live capture.

Counterpart of the JAX package's ``scripts/wf_profile.py`` over the port's
own observability modules. Summarizes the profiler evidence a monitoring
run committed (``WF_PROFILE=1`` — ``observability/profiling.py``) and joins
it against the snapshot's device-time attribution:

- the **profile ledger**: every committed incident bundle under
  ``<dir>/incidents/`` with its ``profile.json`` — captured (file list and
  bytes), skipped (the recorded reason: session guard held, no profiler,
  max captures), or absent (a bundle from before profiling);
- the **device-time table**: the snapshot's per-stage ``health.device_time``
  rows (device ms, host dispatch ms, ``dispatch_ratio``), every stage at or
  past the dispatch-bound threshold flagged ``[FUSION CANDIDATE]``.

**Live capture**: ``--capture LOGDIR [--window-ms N]`` opens one bounded
``torch.profiler`` window (CPU activity, and the card's kernels through
CUPTI) through the one ``stats.xprof_trace`` session guard right now, over
whatever this process runs meanwhile; a held session exits 2 naming the
holder.

    WF_MONITORING=1 WF_SLO=1 WF_PROFILE=1 WF_SERVE=1 python my_service.py
    python -m windflow_tpu_torch.scripts.wf_profile --monitoring-dir wf_monitoring
    python -m windflow_tpu_torch.scripts.wf_profile --capture /tmp/prof --window-ms 250

Exit codes: 0 = summary rendered (or capture succeeded), 2 = missing or
unreadable inputs, capture impossible (no profiler, guard held) or usage
error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from windflow_tpu_torch.observability import device_health as dh
from windflow_tpu_torch.observability import profiling as prof_mod
from windflow_tpu_torch.observability import slo as slo_mod


# ------------------------------------------------------------ report pieces


def profile_rows(prof_mod, slo_mod, mon_dir):
    """One row per committed bundle: (bundle name, manifest, profile dict
    or None)."""
    bundles, torn = slo_mod.list_incidents(mon_dir)
    rows = []
    for man in bundles:
        rows.append((os.path.basename(man["path"]), man,
                     prof_mod.load_profile(man["path"])))
    return rows, torn


def ledger_section(rows, torn):
    lines = ["== profile ledger (committed incident bundles) =="]
    if not rows and not torn:
        lines.append("  (no incident bundles captured — enable with "
                     "WF_MONITORING=1 WF_SLO=1 WF_PROFILE=1)")
        return lines
    for name, man, prof in rows:
        head = f"  {name:<40} slo={man.get('slo')} tick={man.get('tick')}"
        if prof is None:
            lines.append(head + "  profile: ABSENT (bundle predates "
                                "WF_PROFILE or profile.json unreadable)")
        elif "profile_skipped" in prof:
            lines.append(head + f"  profile: SKIPPED ({prof['profile_skipped']})")
        else:
            files = prof.get("files", [])
            total = sum(int(f.get("bytes", 0)) for f in files)
            lines.append(head + f"  profile: captured "
                                f"window={prof.get('window_ms', 0):g} ms "
                                f"files={len(files)} bytes={total}")
            for f in files[:8]:
                lines.append(f"      {f.get('name')}  ({f.get('bytes')} B)")
            if len(files) > 8:
                lines.append(f"      ... {len(files) - 8} more file(s)")
    for name in torn:
        lines.append(f"  {name:<40} TORN (no committed manifest — crash "
                     f"mid-capture)")
    return lines


def device_time_section(dh, snap):
    """Per-stage device-time attribution out of the latest snapshot, with
    the dispatch-bound classifier's fusion candidates flagged inline."""
    lines = ["== device-time attribution (snapshot health.device_time) =="]
    health = snap.get("health") or {}
    dt = health.get("device_time") or {}
    if not dt:
        lines.append("  (no device-time rows — enable the health ledger "
                     "with WF_MONITORING_HEALTH=1 so captures have "
                     "per-stage rows to land on)")
        return lines
    thresh = float(getattr(dh, "DISPATCH_BOUND_RATIO", 0.5))
    lines.append(f"  {'stage':<28} {'device_ms':>10} {'dispatch_ms':>11} "
                 f"{'samples':>7} {'ratio':>6}")
    for label in sorted(dt):
        row = dt[label] or {}
        ratio = row.get("dispatch_ratio")
        flag = ""
        if isinstance(ratio, (int, float)) and ratio >= thresh:
            flag = "  [FUSION CANDIDATE]"
        lines.append(
            f"  {label:<28} {row.get('device_ms', 0):>10g} "
            f"{row.get('dispatch_ms', 0):>11g} {row.get('samples', 0):>7} "
            f"{(f'{ratio:g}' if isinstance(ratio, (int, float)) else '—'):>6}"
            f"{flag}")
    bound = health.get("dispatch_bound") or {}
    if bound:
        lines.append(f"  dispatch-bound (ratio >= {thresh:g} — host launch "
                     f"overhead rivals device work; fuse with K>1 "
                     f"dispatch): {', '.join(sorted(bound))}")
    return lines


def _capture(args) -> int:
    """One bounded live window through the one session guard; every failure
    is exit 2 with the reason."""
    try:
        from torch.profiler import supported_activities  # noqa: F401
    except Exception as e:  # noqa: BLE001 — any import failure: no profiler
        print(f"wf_profile: torch.profiler is not importable for a live capture: "
              f"{type(e).__name__}: {e}\n"
              f"(--capture opens a torch.profiler window; bundle summaries work "
              f"without one)", file=sys.stderr)
        return 2
    try:
        summary = prof_mod.profile_window(args.capture, window_ms=args.window_ms)
    except RuntimeError as e:
        print(f"wf_profile: capture refused: {e}\n"
              f"(the one stats.xprof_trace session guard is held, or "
              f"torch.profiler cannot start here — retry when the session "
              f"closes)", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"wf_profile: capture failed: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True))
    else:
        print(f"wf_profile: captured {summary['window_ms']:g} ms window "
              f"into {summary['logdir']!r} "
              f"({len(summary['files'])} file(s))")
        for f in summary["files"]:
            print(f"  {f['name']}  ({f['bytes']} B)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="wf_profile",
        description="windflow_tpu_torch profile-on-page CLI (incident-bundle "
                    "profile ledger + per-stage device-time attribution; "
                    "--capture opens one bounded live window)")
    ap.add_argument("--monitoring-dir", default="wf_monitoring",
                    help="monitoring output directory (incidents/ + snapshot.json)")
    ap.add_argument("--bundle", default=None, metavar="DIR",
                    help="summarize one incident bundle's profile.json "
                         "instead of the whole ledger")
    ap.add_argument("--capture", default=None, metavar="LOGDIR",
                    help="open one bounded torch.profiler window into LOGDIR "
                         "right now (exit 2 when the one session guard is held "
                         "or the profiler cannot start)")
    ap.add_argument("--window-ms", type=float, default=None,
                    help="capture window for --capture (default: "
                         "WF_PROFILE_WINDOW_MS, else the built-in default)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)

    if args.window_ms is None:
        env = os.environ.get("WF_PROFILE_WINDOW_MS", "")
        args.window_ms = float(env) if env else prof_mod.DEFAULT_WINDOW_MS
    if args.capture:
        return _capture(args)

    if args.bundle:
        prof = prof_mod.load_profile(args.bundle)
        if prof is None:
            print(f"wf_profile: no readable profile.json under "
                  f"{args.bundle!r}\n(a committed bundle carries either a "
                  f"capture summary or a profile_skipped reason once "
                  f"WF_PROFILE is on — this bundle has neither)",
                  file=sys.stderr)
            return 2
        print(json.dumps(prof, indent=1, sort_keys=True))
        return 0

    if not os.path.isdir(args.monitoring_dir):
        print(f"wf_profile: monitoring directory {args.monitoring_dir!r} "
              f"does not exist\n(run with WF_MONITORING=1 WF_SLO=1 "
              f"WF_PROFILE=1, or point --monitoring-dir / --bundle at "
              f"copied artifacts)", file=sys.stderr)
        return 2
    try:
        snap, _series = dh.load_snapshots(args.monitoring_dir)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"wf_profile: cannot load snapshots from "
              f"{args.monitoring_dir!r}: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    rows, torn = profile_rows(prof_mod, slo_mod, args.monitoring_dir)

    if args.json:
        print(json.dumps({
            "monitoring_dir": args.monitoring_dir,
            "bundles": [{"bundle": name, "slo": man.get("slo"),
                         "tick": man.get("tick"), "profile": prof}
                        for name, man, prof in rows],
            "torn": torn,
            "device_time": (snap.get("health") or {}).get("device_time"),
            "dispatch_bound": (snap.get("health") or {}).get("dispatch_bound"),
        }, indent=1, sort_keys=True, default=str))
        return 0

    captured = sum(1 for _n, _m, p in rows
                   if p is not None and "profile_skipped" not in p)
    print(f"wf_profile: {args.monitoring_dir!r} — {len(rows)} bundle(s), "
          f"{captured} with device captures")
    print()
    print("\n".join(ledger_section(rows, torn)))
    print()
    print("\n".join(device_time_section(dh, snap)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

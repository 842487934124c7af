"""What the examples share: the ``--device`` argument and the launch line."""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..ops import registry


def start(argv, doc: str) -> torch.device:
    """Parse ``--device`` (default ``cuda``, which raises without a card) and
    zero the kernels' launch counts; returns the device."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; cpu runs every "
                         "kernel's plain PyTorch version)")
    dev = resolve_device(ap.parse_args(argv).device)
    registry.reset_launches()
    return dev


def print_launches() -> None:
    """One JSON line: the launches of every kernel reached since :func:`start`."""
    counts = {k: n for k, n in registry.launch_counts().items() if n}
    print(json.dumps({"launches": counts}, sort_keys=True), flush=True)

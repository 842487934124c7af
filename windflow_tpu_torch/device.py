"""Device resolution: the card is the default, and its absence is an error.

Every entry point of the port (``Pipeline``, ``CompiledChain``, ``DeviceSource``
and the operators) takes ``device=``. ``None`` means ``"cuda"``; a CUDA device on
a machine without CUDA raises instead of carrying on silently on the CPU. Tests
and CPU runs pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None = ``"cuda"``) as a ``torch.device`` with its index, as
    a tensor on it reports it; raises when it names CUDA and no CUDA device is
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested (the default is 'cuda') but "
                f"torch.cuda.is_available() is False; pass device='cpu' to run "
                f"the port's plain PyTorch path on the CPU")
        if dev.index is None:           # "cuda" -> "cuda:N", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library under ``build/kernels/`` at the
repository root, at first use, and loaded with ``ctypes``. All sources build in
parallel (one ``nvcc`` process each, all started together). A library's file
name carries a hash of its source and flags, so an edited source rebuilds and a
built one is reused. Nothing here runs at import: the CPU tests import every
module of the port on a machine without ``nvcc``.

Safe under threads: one lock covers the build and the binding, and a build
writes to a temporary name of its own process and thread. The kernels' own
one-time setup on the device (shared-memory opt-ins, K4's cluster occupancy
query) is guarded inside ``csrc/`` (``std::call_once`` or a mutex).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path


CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_fns: dict = {}
_lock = threading.RLock()       # build_all, and function's build and bind


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels are built on the machine with "
                           "the card")
    return nvcc


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all at once. Returns
    ``{stem: {"seconds": s, "ptxas": text}}`` for the sources built now;
    raises with nvcc's output if any build fails."""
    with _lock:
        return _build_all()


def _build_all() -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True),
                          tmp, out)
    report, failed = {}, []
    for stem, (proc, tmp, out) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (nvcc rc {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
        report[stem] = {"seconds": time.perf_counter() - t0, "ptxas": text}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def function(stem: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<stem>.cu``, building first if
    needed; bound once and cached. Every entry point returns
    ``cudaGetLastError()`` as an int."""
    fn = _fns.get((stem, symbol))
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get((stem, symbol))
        if fn is None:
            lib = _libs.get(stem)
            if lib is None:
                target = _target(CSRC / f"{stem}.cu")
                if not target.exists():
                    _build_all()
                lib = _libs[stem] = ctypes.CDLL(str(target))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[(stem, symbol)] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())

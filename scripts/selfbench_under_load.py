#!/usr/bin/env python3
"""Run the port's ring selfbench test under load and count its failures.

Each round starts ``--workers`` concurrent pytest processes, each running
``tests/test_torch_native.py::test_queue_selfbench_moves_tokens`` once,
while ``--busy`` processes keep every core loaded with float32 matmuls on
all of PyTorch's intra-op threads (the load of the test run's other
workers). Prints one JSON line: the runs, the failures and the seconds.

    python3 scripts/selfbench_under_load.py --repo . --rounds 10 --workers 6 --busy 6

``--repo`` may name another checkout (e.g. a ``git archive`` of a parent
commit), so two trees can be compared under the same load.
"""

import argparse
import json
import os
import subprocess
import sys
import time

BUSY = ("import time, torch\n"
        "a = torch.randn(512, 512)\n"
        "while True:\n"
        "    a = (a @ a).clamp(-1, 1)\n")
TEST = "tests/test_torch_native.py::test_queue_selfbench_moves_tokens"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=".")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--busy", type=int, default=6)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    busy = [subprocess.Popen([sys.executable, "-c", BUSY]) for _ in range(args.busy)]
    runs = fails = 0
    t0 = time.perf_counter()
    try:
        for _ in range(args.rounds):
            procs = [subprocess.Popen([sys.executable, "-m", "pytest", "-q", "-p",
                                       "no:cacheprovider", "-p", "no:randomly", TEST],
                                      cwd=repo, env=env, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL)
                     for _ in range(args.workers)]
            for p in procs:
                runs += 1
                fails += p.wait() != 0
    finally:
        for p in busy:
            p.kill()
            p.wait()
    print(json.dumps({"repo": repo, "rounds": args.rounds, "workers": args.workers,
                      "busy": args.busy, "runs": runs, "failures": fails,
                      "seconds": round(time.perf_counter() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

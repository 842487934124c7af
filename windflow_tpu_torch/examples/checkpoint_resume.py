"""Checkpoint mid-stream, 'crash', restore into a NEW chain, and continue,
ending bit-identical to an uninterrupted run.

Every operator's state is a tree of tensors, so save/restore is an ``.npz``
of the chain's state (``runtime/checkpoint.py``, the JAX package's file
format). The same mechanism powers supervised exactly-once recovery
(SupervisedPipeline) and the rescale of a sharded chain across meshes.
Counterpart of ``examples/03_checkpoint_resume.py``.

    python -m windflow_tpu_torch.examples.checkpoint_resume [--device cpu]
"""

from __future__ import annotations

import os
import tempfile

import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.basic import win_type_t
from windflow_tpu_torch.examples._common import print_launches, start

TOTAL, BATCH, K = 4000, 256, 8


def make_chain(dev):
    src = wt.Source(lambda i: {"v": ((i * 13) % 23).float()}, total=TOTAL, num_keys=K,
                    device=dev)
    op = wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(64, 32, win_type_t.CB),
                     num_keys=K, device=dev)
    chain = wt.CompiledChain([op], src.payload_spec(), batch_capacity=BATCH, device=dev)
    return src, chain


def collect(out, batch):
    v = batch.valid
    out.extend(zip(batch.key[v].tolist(), batch.id[v].tolist(), batch.payload[v].tolist()))


def main(argv=None) -> None:
    dev = start(argv, __doc__)
    # ---- golden: uninterrupted run
    src, chain = make_chain(dev)
    golden = []
    for b in src.batches(BATCH):
        collect(golden, chain.push(b))
    for fb in chain.flush():
        collect(golden, fb)

    with tempfile.TemporaryDirectory(prefix="wf_example_ckpt_") as d:
        # ---- interrupted run: checkpoint at the half-way batch, then "crash"
        src, chain = make_chain(dev)
        part1, seen = [], 0
        ckpt = os.path.join(d, "chain.npz")
        for b in src.batches(BATCH):
            collect(part1, chain.push(b))
            seen += BATCH
            if seen >= TOTAL // 2:
                wt.save_chain(chain, ckpt, meta={"position": seen})
                break
        del chain                                  # the "crash"

        # ---- resume: fresh chain, restore state, fast-forward the source
        src2, chain2 = make_chain(dev)
        meta = wt.load_chain(chain2, ckpt)
    pos = meta["position"]
    part2 = []
    it = src2.batches(BATCH)
    for _ in range(pos // BATCH):          # replayable source: skip committed batches
        next(it)
    for b in it:
        collect(part2, chain2.push(b))
    for fb in chain2.flush():
        collect(part2, fb)

    assert sorted(part1 + part2) == sorted(golden), "resume diverged from golden run"
    print_launches()
    print(f"checkpoint/resume OK: {len(part1)}+{len(part2)} window results == "
          f"{len(golden)} golden")


if __name__ == "__main__":
    main()

"""Sharded execution: the same keyed-window chain placed over a 2-D mesh,
batch axis on ``dp`` (operator replication), key-state tables on ``key``
(Key_Farm whole-key ownership), and verified oracle-identical to the
unsharded run.

The mesh is 8 positions of the chain's one device (a position names a
device and positions may repeat it: ``parallel/mesh.py``); ``ShardedChain``
runs every position's block explicitly, as the JAX package's partitioned
step does over 8 devices. Counterpart of ``examples/04_multichip.py``.

    python -m windflow_tpu_torch.examples.multichip [--device cpu]
"""

from __future__ import annotations

import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.basic import win_type_t
from windflow_tpu_torch.examples._common import print_launches, start

TOTAL, BATCH, K = 8000, 512, 16
#: the mesh's positions, on the chain's device
POSITIONS = 8


def make_chain(dev):
    src = wt.Source(lambda i: {"v": ((i * 7) % 31).float()}, total=TOTAL, num_keys=K,
                    device=dev)
    op = wt.Key_FFAT(lambda t: t.v, torch.add, spec=wt.WindowSpec(50, 25, win_type_t.TB),
                     num_keys=K, device=dev)
    return src, wt.CompiledChain([op], src.payload_spec(), batch_capacity=BATCH, device=dev)


def rows(batch):
    v = batch.valid
    return zip(batch.key[v].tolist(), batch.id[v].tolist(), batch.payload[v].tolist())


def run(dev, sharded: bool):
    src, chain = make_chain(dev)
    if sharded:
        mesh = wt.make_mesh_2d((2, POSITIONS // 2), axes=("dp", "key"),
                               devices=[dev] * POSITIONS)
        chain = wt.ShardedChain(chain, mesh, axis="dp", key_axis="key")
    out = []
    for b in src.batches(BATCH):
        out.extend(rows(chain.push(b)))
    for fb in (chain.flush() or []):
        out.extend(rows(fb))
    return sorted(out)


def main(argv=None) -> None:
    dev = start(argv, __doc__)
    single = run(dev, sharded=False)
    multi = run(dev, sharded=True)
    assert single == multi and single, "sharded run diverged from the unsharded oracle"
    print_launches()
    print(f"multichip OK: {len(multi)} window results identical on the "
          f"{POSITIONS}-position mesh")


if __name__ == "__main__":
    main()

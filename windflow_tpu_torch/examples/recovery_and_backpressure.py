"""Fault recovery with an O(1) seekable source, and lossless routing under
deliberate overflow, end to end.

1. A SupervisedPipeline takes injected device faults mid-stream and recovers
   from the last aligned checkpoint. The source's ``it_factory`` declares a
   ``from_batch`` parameter, so a restart resumes AT the committed chunk
   index (the factory owns the cursor: here plain arithmetic, in production
   a file offset) instead of replaying the stream. Output must be
   exactly-once, bit-identical to a fault-free run.

2. A Standard_Emitter with a per-destination budget far below one skewed
   key's share must deliver EVERY tuple anyway: overflowing lanes are
   re-partitioned in further passes (the blocking bounded-queue
   backpressure of the reference's FF_BOUNDED_BUFFER: it blocks, it never
   drops).

Counterpart of ``examples/05_recovery_and_backpressure.py``.

    python -m windflow_tpu_torch.examples.recovery_and_backpressure [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.basic import routing_modes_t, win_type_t
from windflow_tpu_torch.batch import Batch
from windflow_tpu_torch.examples._common import print_launches, start
from windflow_tpu_torch.parallel.emitters import Standard_Emitter

TOTAL, BATCH, K = 2000, 100, 4


def factory(from_batch=0):
    """Chunk k is pure arithmetic on k, so seeking is O(1). The supervisor
    calls ``factory(from_batch=committed_chunk)`` on restart."""
    def gen():
        for s in range(from_batch * BATCH, TOTAL, BATCH):
            ids = np.arange(s, s + BATCH, dtype=np.int32)
            yield ({"v": ((ids * 7) % 31).astype(np.float32)}, ids % K, ids)
    return gen()


def build(dev, sink_cb, **kw):
    src = wt.GeneratorSource(factory, {"v": np.zeros((), np.float32)}, device=dev)
    op = wt.Win_Seq(lambda wid, it: it.sum("v"), wt.WindowSpec(25, 25, win_type_t.TB),
                    num_keys=K, device=dev)
    return wt.SupervisedPipeline(src, [op], wt.Sink(sink_cb, device=dev),
                                 batch_size=BATCH, device=dev, **kw)


def collect(results):
    def cb(view):
        if view is None:
            return
        results.extend(zip(view["key"].tolist(), view["id"].tolist(),
                           view["payload"].tolist()))
    return cb


def recovery(dev) -> None:
    golden = []
    build(dev, collect(golden)).run()

    got = []
    p = build(dev, collect(got), checkpoint_every=3, max_restarts=5)
    inner, fail_at = p.chain.push, {5, 11}
    calls = [0]

    def flaky(batch):
        calls[0] += 1
        if calls[0] in fail_at:
            raise RuntimeError(f"injected device fault at push #{calls[0]}")
        return inner(batch)

    p.chain.push = flaky
    p.run()
    assert p.restarts == 2, p.restarts
    assert sorted(got) == sorted(golden) and golden, "lost/duplicated results"
    print(f"recovery: {p.restarts} faults recovered, "
          f"{len(got)} window results exactly-once, O(1) resume")


def backpressure(dev) -> None:
    rng = np.random.default_rng(3)
    C = 256
    keys = np.where(rng.random(C) < 0.6, 0, rng.integers(0, 32, C)).astype(np.int32)
    valid = rng.random(C) < 0.9
    b = Batch(key=torch.as_tensor(keys, device=dev),
              id=torch.arange(C, dtype=torch.int32, device=dev),
              ts=torch.zeros(C, dtype=torch.int32, device=dev),
              payload={"v": torch.arange(C, dtype=torch.float32, device=dev)},
              valid=torch.as_tensor(valid, device=dev))
    em = Standard_Emitter(4, routing_modes_t.KEYBY, capacity_per_dest=8)
    outs = em.route(b)
    delivered = []
    for d, ob in enumerate(outs):
        ob = ob.to_host()
        v = ob["valid"]
        assert np.all(ob["key"][v] % 4 == d)
        delivered.extend(ob["payload"]["v"][v].tolist())
    want = [float(i) for i, ok in enumerate(valid) if ok]
    assert sorted(delivered) == sorted(want)
    print(f"backpressure: {len(want)} tuples through a budget of 8/dest in "
          f"{em.overflow_rounds + 1} passes, zero loss")


def main(argv=None) -> None:
    dev = start(argv, __doc__)
    recovery(dev)
    backpressure(dev)
    print_launches()
    print("OK")


if __name__ == "__main__":
    main()

"""The serving front door, end to end: Nexmark bid records arrive over a
REAL socket as WFS1 frames, are admitted under per-tenant budgets, flow
through the compiled Q1 currency-conversion query, and the graph is
hot-swapped mid-stream, all without dropping or reordering a single
committed tuple.

1. Socket ingest + zero-downtime swap: two tenants stream binary bid
   chunks through a ``SocketSource``; halfway in, a wire ``swap`` frame cuts
   the runtime over to a registered twin graph (same math, so the output
   must stay byte-identical to a plain in-process ``RecordSource`` oracle,
   REGARDLESS of which batch the cutover lands on). The swap is warmed
   before cutover and journaled as a ``graph_swap`` span.

2. Tenant isolation: a noisy tenant with a tight deterministic bucket is
   shed under ITS budget while the quiet tenant (same socket, same run) is
   never shed and every one of its bids reaches the sink.

Q1 is a stateless ``Map``: it reaches no hand-written kernel. Counterpart of
``examples/06_serving.py``.

    python -m windflow_tpu_torch.examples.serving [--device cpu]
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np

import windflow_tpu_torch as wt
from windflow_tpu_torch.examples._common import print_launches, start
from windflow_tpu_torch.nexmark.queries import EURO_DEN, EURO_NUM
from windflow_tpu_torch.serving import RecordClient, ServingRuntime, SocketSource

BATCH = 50
N_AUCTIONS = 8
#: the bid stream's wire schema: one fixed record dtype, keyed by auction
DT = np.dtype([("auction", np.int32), ("ts", np.int64), ("price", np.int32)])


def make_chunks(n_chunks, base_price):
    out = []
    for i in range(n_chunks):
        ids = np.arange(i * BATCH, (i + 1) * BATCH)
        rec = np.zeros(BATCH, dtype=DT)
        rec["auction"] = (ids * 2477) % N_AUCTIONS
        rec["ts"] = ids
        rec["price"] = base_price + (ids * 7919) % 9000 + 100
        out.append(rec)
    return out


def q1_ops(dev):
    """Nexmark Q1: per-bid dollar -> euro currency projection (the auction
    id rides the batch's key lane: RecordSource pulled it out of the
    payload as key_field)."""
    return [wt.Map(lambda t: {"euro": (t.price * EURO_NUM) // EURO_DEN},
                   name="nexmark_currency", device=dev)]


def collect(acc):
    def cb(view):
        if view is not None:
            acc.extend(zip(view["id"].tolist(), view["payload"]["euro"].tolist()))
    return cb


def serve(dev, tenants, chunks, tenant_of, *, swap_at=None, eos_tenant="a"):
    """Stand up a ServingRuntime on an ephemeral loopback port, stream the
    chunks through a RecordClient, return (results, runtime, mon_dir)."""
    mon_dir = tempfile.mkdtemp(prefix="wf_example_serve_")
    got = []
    src = SocketSource("tcp://127.0.0.1:0", DT, key_field="auction", ts_field="ts",
                       num_keys=N_AUCTIONS, replay=len(chunks) + 8, device=dev)
    rt = ServingRuntime(src, q1_ops(dev), wt.Sink(collect(got), device=dev),
                        batch_size=BATCH, serving={"tenants": tenants},
                        monitoring=mon_dir, device=dev)
    rt.register_graph("q1_v2", q1_ops(dev))   # the swap candidate (twin math)
    src.start()                               # .endpoint now has the real port
    thread = rt.run_background()
    client = RecordClient(src.endpoint)
    for i, chunk in enumerate(chunks):
        client.send(chunk.tobytes(), tenant=tenant_of[i])
        if swap_at is not None and i == swap_at:
            client.send_swap("q1_v2")         # hot-swap, from the wire
    client.send_eos(eos_tenant)
    client.close()
    thread.join(timeout=60.0)
    assert not thread.is_alive(), "serving drive did not reach EOS"
    if rt.background_error is not None:
        raise rt.background_error
    return got, rt, mon_dir


def hot_swap(dev) -> None:
    chunks = make_chunks(40, base_price=0)
    tenant_of = ["a" if i % 2 == 0 else "b" for i in range(len(chunks))]

    # oracle: the SAME bids through a plain in-process RecordSource pipeline
    oracle = []
    wt.Pipeline(wt.RecordSource(lambda: iter(chunks), DT, key_field="auction",
                                ts_field="ts", num_keys=N_AUCTIONS, device=dev),
                q1_ops(dev), wt.Sink(collect(oracle), device=dev), batch_size=BATCH,
                device=dev).run()

    got, rt, mon_dir = serve(dev, [{"id": "a"}, {"id": "b"}], chunks, tenant_of,
                             swap_at=len(chunks) // 2)
    assert rt.swaps_applied == 1 and rt.graph_label == "q1_v2", (
        rt.swaps_applied, rt.graph_label)
    assert sorted(got) == sorted(oracle) and oracle, \
        "serving output diverged from the RecordSource oracle across the swap"

    # query the service the way an operator would: the monitoring snapshot
    with open(os.path.join(mon_dir, "snapshot.json")) as f:
        sv = json.load(f)["serving"]
    assert sv["graph"] == "q1_v2" and sv["swaps_applied"] == 1
    shutil.rmtree(mon_dir, ignore_errors=True)
    print(f"hot-swap: {len(got)} Q1 results over tcp, swap to {sv['graph']!r} "
          f"mid-stream, byte-identical to the oracle")


def isolation(dev) -> None:
    # quiet bids carry prices >= 100_000 so their euro results are
    # recognizable in the shared sink; noisy gets a tight deterministic
    # bucket (burst = 1 batch, refill 10 tuples per offered batch) and MUST
    # shed, quiet never
    quiet_chunks = make_chunks(20, base_price=100_000)
    noisy_chunks = make_chunks(20, base_price=0)
    mixed, tenant_of = [], []
    for q, n in zip(quiet_chunks, noisy_chunks):
        mixed += [q, n]
        tenant_of += ["quiet", "noisy"]

    got, rt, mon_dir = serve(
        dev, [{"id": "quiet"},
              {"id": "noisy", "refill_per_batch": 10.0, "burst": float(BATCH)}],
        mixed, tenant_of, eos_tenant="quiet")
    rows = rt.serving_section()["tenants"]
    assert rows["noisy"]["shed"] > 0, rows
    assert rows["quiet"]["shed"] == 0 and rows["quiet"]["shed_tuples"] == 0, rows
    quiet_floor = (100_000 * EURO_NUM) // EURO_DEN
    quiet_out = [e for _, e in got if e >= quiet_floor]
    want = sum(len(c) for c in quiet_chunks)
    assert len(quiet_out) == want, (len(quiet_out), want)
    shutil.rmtree(mon_dir, ignore_errors=True)
    print(f"isolation: noisy shed {rows['noisy']['shed']} batches under its own "
          f"budget; quiet delivered {len(quiet_out)}/{want}, zero shed")


def main(argv=None) -> None:
    dev = start(argv, __doc__)
    hot_swap(dev)
    isolation(dev)
    print_launches()
    print("OK")


if __name__ == "__main__":
    main()

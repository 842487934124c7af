"""One process of the port's two-process run (``tests/test_torch_multihost.py``
on the CPU, ``chip_smoke.py``'s ``mesh`` phase on the card).

Run as ``python tests/torch_multihost_driver.py <host:port> <num_procs>
<proc_id> <device> <backend> <workload>`` from the repository root; it
imports neither JAX nor ``windflow_tpu``. ``device`` is where this process's
positions live (``cpu`` or ``cuda:0``; processes may share a card),
``backend`` the ``torch.distributed`` backend (``gloo``: NCCL refuses two
ranks on one card, so a shared card's exchanges pass through the host),
``workload`` the supervised stream of part 1 (``winseq``: the JAX driver's
Win_Seq over 240 tuples; ``ysb``: YSB at ``YSB_BATCH`` lanes a batch).

1. **Shard-local supervision across the process boundary.** This process
   supervises its slice (``multihost.process_shard_slice``) of a 4-shard
   ``SupervisedPipeline`` over the same logical stream as its peers, with a
   shard-kill drill on its first shard, and no collective. Prints
   ``SHARD-OK <rows> <digest> range=<lo>:<hi> restarts=<n>``; the parent
   holds the union of the processes' rows to the unsharded oracle.
2. **keyed_all_to_all over the process axis** of
   ``make_dcn_ici_mesh(dcn_axis="key", ici_axes=("dp",))``, two local
   positions a process, then the lossless variant under total key skew.
   Prints ``MULTIHOST-OK <rows received here>`` and ``LOSSLESS-OK
   <rows delivered> rounds=<n>``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import windflow_tpu_torch as wt  # noqa: E402
from windflow_tpu_torch.parallel import multihost  # noqa: E402
from windflow_tpu_torch.parallel.collective import (keyed_all_to_all,  # noqa: E402
                                                    keyed_all_to_all_lossless)
from windflow_tpu_torch.runtime.faults import FaultInjector, FaultPlan, FaultSpec  # noqa: E402

SH_SHARDS = 4
LOCAL = 2                  # positions a process
YSB_BATCH = 1 << 16
YSB_BATCHES = 6


def digest(rows) -> int:
    """An order-free digest of ``(key, id, value)`` rows (the JAX driver's)."""
    return sum((k + 1) * 1_000_003 + (i + 1) * 31 + int(v * 7) for k, i, v in rows) % (1 << 31)


def workload(name: str, device):
    """``(source, ops, batch, shard_key)`` of part 1's stream."""
    if name == "winseq":
        src = wt.Source(lambda i: {"v": (i % 13).float()}, total=240, num_keys=8,
                        device=device)
        ops = [wt.Win_Seq(lambda wid, it: it.sum("v"),
                          wt.WindowSpec(10, 10, wt.win_type_t.TB), num_keys=8, device=device)]
        return src, ops, 30, None
    from windflow_tpu_torch.benchmarks import ysb
    src = ysb.make_source(YSB_BATCHES * YSB_BATCH, device=device)
    ops = ysb.make_ops(device=device, **ysb.bench_geometry(YSB_BATCH))
    return src, ops, YSB_BATCH, lambda t: t.data["ad_id"] // ysb.ADS_PER_CAMPAIGN


def supervised_rows(name: str, device, shards=None, shard_range=None, faults=None):
    """The sink rows of part 1's stream, supervised (sharded when asked)."""
    got = []

    def cb(view):
        if view is None:
            return
        got.extend(zip(view["key"].tolist(), view["id"].tolist(),
                       np.asarray(view["payload"]).reshape(-1).tolist()))
    src, ops, batch, key = workload(name, device)
    kw = {} if shards is None else {"shards": shards, "shard_range": shard_range,
                                    "shard_key": key}
    sp = wt.SupervisedPipeline(src, ops, wt.Sink(cb, device=device), batch_size=batch,
                               checkpoint_every=2, max_restarts=4, backoff_base=0.0,
                               faults=faults, device=device, **kw)
    sp.run()
    return got, sp


def main(coordinator, num_procs, proc_id, device, backend, name):
    device = torch.device(device)
    assert multihost.initialize(coordinator, num_procs, proc_id, backend=backend), \
        "initialize() returned False for an explicit multi-process call"
    assert dist.get_world_size() == num_procs and dist.get_rank() == proc_id

    # ---- part 1: shard-local supervision across the process boundary -------
    lo, hi = multihost.process_shard_slice(SH_SHARDS)
    assert hi - lo == SH_SHARDS // num_procs, (lo, hi)
    kill = FaultInjector(FaultPlan(
        [FaultSpec("shard.kill", where={"shard": lo}, max_fires=1)], seed=11))
    got, sp = supervised_rows(name, device, SH_SHARDS, (lo, hi), kill)
    rep = sp.shard_report()
    assert rep[lo]["restarts"] == 1, rep
    assert all(r["restarts"] == 0 for k, r in rep.items() if k != lo), rep
    print(f"SHARD-OK {len(got)} {digest(got)} range={lo}:{hi} "
          f"restarts={rep[lo]['restarts']}", flush=True)

    # ---- part 2: keyed exchanges over the process axis ---------------------
    mesh = multihost.make_dcn_ici_mesh(dcn_axis="key", ici_axes=("dp",),
                                       devices=[device] * LOCAL)
    assert mesh.devices.shape == (num_procs, LOCAL), mesh.devices.shape
    assert mesh.axis_names == ("key", "dp")
    for row in range(num_procs):
        assert set(mesh.processes[row].tolist()) == {row}
    C = 64
    ar = torch.arange(C, dtype=torch.int32, device=device)
    keys, valid = ar * 7 % 13, torch.ones(C, dtype=torch.bool, device=device)
    rk, rv, rp, n_left = keyed_all_to_all(mesh, axis="key", capacity=C)(
        keys, valid, {"v": ar.float()})
    assert all(int(t.sum()) == 0 for t in n_left.pieces.values())
    n_local = 0
    for c in rk.pieces:
        kv, vv, pv = rk.piece(c).cpu(), rv.piece(c).cpu(), rp["v"].piece(c).cpu()
        assert torch.all(kv[vv] % num_procs == c[0]), (c, kv[vv])
        assert torch.all(pv[vv].long() * 7 % 13 == kv[vv]), c   # payload rode along
        n_local += int(vv.sum())
    wire = device if backend == "nccl" else "cpu"
    total = torch.tensor([n_local], dtype=torch.int64, device=wire)
    dist.all_reduce(total)
    assert int(total) == C * LOCAL, (int(total), C * LOCAL)   # every dp replica's rows
    print(f"MULTIHOST-OK {n_local}", flush=True)

    SMALL = 16
    keys = torch.full((SMALL,), 1, dtype=torch.int32, device=device)
    vals = torch.arange(SMALL, dtype=torch.float32, device=device)
    lk, lv, lp, rounds = keyed_all_to_all_lossless(mesh, axis="key", capacity=2)(
        keys, torch.ones(SMALL, dtype=torch.bool, device=device), {"v": vals})
    assert rounds > 1, f"skew did not overflow (rounds={rounds})"
    # logical global counts over the dp = 0 replica, summed across processes
    mine = [c for c in lk.pieces if c[1] == 0]
    stats = torch.tensor([sum(int(lv.piece(c).sum()) for c in mine),
                          sum(float(torch.where(lv.piece(c), lp["v"].piece(c), 0.0).sum())
                              for c in mine),
                          sum(int((lv.piece(c) & (lk.piece(c) != 1)).sum()) for c in mine)],
                         dtype=torch.float64, device=wire)
    dist.all_reduce(stats)
    n_delivered, v_sum, foreign = (float(x) for x in stats.cpu())
    assert n_delivered == SMALL and v_sum == sum(range(SMALL)) and foreign == 0, stats
    print(f"LOSSLESS-OK {int(n_delivered)} rounds={rounds}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], int(a[1]), int(a[2]), a[3], a[4], a[5])

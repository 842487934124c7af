"""The port's multi-process helpers (``parallel/multihost.py``) against the
JAX package's on the CPU.

The four single-process cases of ``tests/test_multihost.py`` (the DCN axis
collapsed to one process), each checked against the JAX function on the same
inputs, and one two-process ``gloo`` run that mirrors
``tests/test_multihost_2proc.py``: two child processes
(``tests/torch_multihost_driver.py``, which import neither JAX nor
``windflow_tpu``) supervise their halves of a 4-shard stream with a
shard-kill drill each, whose union the parent holds to the JAX package's
unsharded oracle, then exchange rows with ``keyed_all_to_all`` and its
lossless variant across the process boundary.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from windflow_tpu.parallel import multihost as jmh
from windflow_tpu.parallel.collective import keyed_all_to_all as jkeyed_all_to_all
from windflow_tpu_torch.parallel import multihost
from windflow_tpu_torch.parallel.collective import keyed_all_to_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(REPO, "tests", "torch_multihost_driver.py")
CPU8 = ["cpu"] * 8


def test_initialize_is_noop_single_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.initialize() is False
    assert jmh.initialize() is False
    assert not torch.distributed.is_initialized()
    assert multihost.process_shard_slice(4) == jmh.process_shard_slice(4) == (0, 4)


def test_dcn_ici_mesh_single_process_shapes_match_jax():
    for ici in (("key",), ("key", "win")):
        mesh = multihost.make_dcn_ici_mesh(dcn_axis="dp", ici_axes=ici, devices=CPU8)
        jmesh = jmh.make_dcn_ici_mesh(dcn_axis="dp", ici_axes=ici)
        assert mesh.axis_names == jmesh.axis_names == ("dp",) + ici
        assert mesh.shape == dict(jmesh.shape) and mesh.shape["dp"] == 1
        assert mesh.devices.size == 8 and mesh.process_axis is None
    for n, k in ((8, 1), (8, 2), (8, 3), (12, 2), (6, 2), (16, 3)):
        assert multihost._factor(n, k) == jmh._factor(n, k)


def test_collective_over_ici_axis_of_hybrid_mesh_matches_jax():
    mesh = multihost.make_dcn_ici_mesh(dcn_axis="dp", ici_axes=("key",), devices=CPU8)
    jmesh = jmh.make_dcn_ici_mesh(dcn_axis="dp", ici_axes=("key",))
    C = 64 * 8
    keys = np.arange(C, dtype=np.int32) % 23
    valid = np.ones(C, bool)
    pay = {"v": np.arange(C, dtype=np.float32)}
    rk, rv, rp, _ = keyed_all_to_all(mesh, axis="key")(
        torch.as_tensor(keys), torch.as_tensor(valid), {"v": torch.as_tensor(pay["v"])})
    sh = NamedSharding(jmesh, P("key"))
    args = jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), sh), (keys, valid, pay))
    jk, jv, jp, _ = jax.jit(jkeyed_all_to_all(jmesh, axis="key"))(*args)
    np.testing.assert_array_equal(rk.full().numpy(), np.asarray(jk))
    np.testing.assert_array_equal(rv.full().numpy(), np.asarray(jv))
    np.testing.assert_array_equal(rp["v"].full().numpy(), np.asarray(jp["v"]))
    rk, rv = rk.full().numpy(), rv.full().numpy()
    per = rk.shape[0] // 8
    for d in range(8):
        assert np.all(rk[d * per:(d + 1) * per][rv[d * per:(d + 1) * per]] % 8 == d)


def test_process_local_batch_range_single_process():
    assert multihost.process_local_batch_range(1000, 128) == \
        jmh.process_local_batch_range(1000, 128) == (0, 1000)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_oracle():
    """The JAX package's unsharded supervised run of the driver's part-1
    stream: (rows, digest)."""
    import windflow_tpu as wf
    from windflow_tpu.basic import win_type_t
    from windflow_tpu.operators.window import WindowSpec
    from windflow_tpu.runtime.supervisor import SupervisedPipeline
    got = []

    def cb(view):
        if view is None:
            return
        got.extend(zip(view["key"].tolist(), view["id"].tolist(),
                       np.asarray(view["payload"]).tolist()))
    SupervisedPipeline(
        wf.Source(lambda i: {"v": (i % 13).astype(jnp.float32)}, total=240, num_keys=8),
        [wf.Win_Seq(lambda wid, it: it.sum("v"), WindowSpec(10, 10, win_type_t.TB),
                    num_keys=8)],
        wf.Sink(cb), batch_size=30, checkpoint_every=2).run()
    digest = sum((k + 1) * 1_000_003 + (i + 1) * 31 + int(v * 7)
                 for k, i, v in got) % (1 << 31)
    return len(got), digest


def test_two_process_gloo_shard_supervision_and_collectives():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MASTER_ADDR")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, DRIVER, coordinator, "2", str(i), "cpu",
                               "gloo", "winseq"], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"driver failed (rc={rc}):\n{err[-3000:]}"
        assert "SHARD-OK" in out and "MULTIHOST-OK" in out and "LOSSLESS-OK" in out, out

    # part 1: the union of both processes' shard slices is the unsharded
    # oracle, each slice's kill drill recovered locally
    counts, digests, ranges = [], [], []
    for _rc, out, _err in outs:
        parts = out.split("SHARD-OK ")[1].split()
        counts.append(int(parts[0]))
        digests.append(int(parts[1]))
        ranges.append(parts[2])
        assert "restarts=1" in out, out
    assert sorted(ranges) == ["range=0:2", "range=2:4"], ranges
    n, digest = _jax_oracle()
    assert sum(counts) == n and sum(digests) % (1 << 31) == digest, (counts, digests)

    # part 2: 64 rows x 2 dp replicas received over the process axis; the
    # lossless exchange delivered all 16 rows (once each) in several rounds
    counts = [int(out.split("MULTIHOST-OK ")[1].split()[0]) for _, out, _ in outs]
    assert sum(counts) == 64 * 2, counts
    lcounts = [int(out.split("LOSSLESS-OK ")[1].split()[0]) for _, out, _ in outs]
    rounds = [int(out.split("rounds=")[1].split()[0]) for _, out, _ in outs]
    assert lcounts == [16, 16] and all(r > 1 for r in rounds), (lcounts, rounds)

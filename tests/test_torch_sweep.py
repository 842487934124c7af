"""The port's benchmark sweep (``windflow_tpu_torch/benchmarks/sweep.py``)
against the JAX package's (``windflow_tpu/benchmarks/sweep.py``), on the CPU.

Mirrors ``tests/test_sweep.py``, ``test_nexmark.py::test_sweep_run_nexmark_rows``
and ``test_control.py::test_sweep_adaptive_rows_and_warm_start``: each of the
four workloads' bench steps through both packages from the same generators,
states and step outputs byte for byte; the 8-row smoke and its markdown; one
Nexmark row a query under the JAX package's names and key columns; the
adaptive rows and their warm start; under a clock that advances one unit a
read in both modules, the same rung and byte-identical tuning-cache files;
the same table rows out of ``render_markdown``; and ``main`` on the CPU.
"""

import functools
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu import control as jcontrol
from windflow_tpu.benchmarks import sweep as jsweep
from windflow_tpu.nexmark import QUERIES as JQUERIES
from windflow_tpu.nexmark import generators as jgen
from windflow_tpu_torch import control as tcontrol
from windflow_tpu_torch.benchmarks import sweep as tsweep
from windflow_tpu_torch.convert import state_to_numpy
from windflow_tpu_torch.operators.win_seqffat import Win_SeqFFAT

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_control():
    jcontrol.reset()
    tcontrol.reset()
    yield
    jcontrol.reset()
    tcontrol.reset()


def _bytes_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


@pytest.mark.parametrize("keys", [1, 16])
@pytest.mark.parametrize("name", tsweep.NAMES)
def test_chain_step_matches_jax(name, keys):
    """Three bench steps of one workload through both packages: the states
    after each step and its output (the valid mask) byte for byte."""
    batch, steps = 256, 3
    total = (steps + 2) * batch
    jsrc, jops = jsweep.workloads(batch, keys, total)[name]
    tsrc, tops = tsweep.workloads(batch, keys, total, device=CPU)[name]
    jstep, jstates = jsweep._chain_step(jops, jsrc, batch)
    tstep, tstates = tsweep._chain_step(tops, tsrc, batch, device=CPU)
    jcur = jnp.asarray(0, jnp.int32)
    tcur = torch.zeros((), dtype=torch.int32)
    for s in range(steps):
        jstates, jcur, jout = jstep(jstates, jcur)
        tstates, tcur, tout = tstep(tstates, tcur)
        assert int(jcur) == int(tcur) == (s + 1) * batch
        _bytes_equal(tout.numpy(), jout, f"{name} step {s} output")
        for op, js, ts in zip(tops, jstates, tstates):
            got = state_to_numpy(op, ts)
            if got is None:
                assert js is None
                continue
            want = (jax.tree.map(np.asarray, js) if not isinstance(op, Win_SeqFFAT)
                    else {f: np.asarray(getattr(js, f)) for f in got})
            gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
            assert len(gl) == len(wl) > 0
            for i, (g, w) in enumerate(zip(gl, wl)):
                _bytes_equal(g, w, f"{name} step {s} state leaf {i}")


def test_sweep_smoke():
    rows = tsweep.run_sweep(batches=(256,), keyset=(1, 16), steps=3, device=CPU)
    assert len(rows) == 8
    assert [(n, b, k) for n, b, k, _ in rows] == [
        (n, 256, k) for k in (1, 16) for n in tsweep.NAMES]
    assert all(tps > 0 for *_, tps in rows)
    md = tsweep.render_markdown(rows, tsweep.device_label(CPU))
    assert md.count("\n| ") == 9 and "map_stateful" in md   # header + 8 rows
    assert "Device: cpu." in md


def test_sweep_run_nexmark_rows():
    """One row a query, under the JAX package's names and key columns."""
    rows = tsweep.run_nexmark(batches=(64,), steps=2, device=CPU)
    assert [(n, b, k) for n, b, k, _ in rows] == [
        (f"nexmark:{q}", 64, jgen.N_BIDDERS if q == "q5_session" else jgen.N_AUCTIONS)
        for q in JQUERIES]
    assert all(tps > 0 for *_, tps in rows)


def test_sweep_adaptive_rows_and_warm_start(tmp_path):
    cache = str(tmp_path / "tune.json")
    kw = dict(batches=(128, 256), keyset=(4,), names=("map_stateless",), steps=2,
              cache_path=cache, device=CPU)
    rows = tsweep.run_adaptive(**kw)
    assert len(rows) == 1
    name, cap, keys, tps = rows[0]
    assert name == "map_stateless (adaptive)" and cap in (128, 256) and keys == 4
    assert tps > 0
    tcontrol.reset()
    rows2 = tsweep.run_adaptive(**kw)
    assert rows2[0][1] == cap                # the cached rung, straight away
    assert tcontrol.counters()["tuning_cache_hits"] == 1
    assert tcontrol.counters()["capacity_switches"] == 0
    assert "(adaptive)" in tsweep.render_markdown(rows + rows2, "cpu")


def _counting_time():
    """A ``time`` module whose ``perf_counter`` advances one unit a read."""
    t = [0.0]

    def perf_counter():
        t[0] += 1.0
        return t[0]
    return types.SimpleNamespace(perf_counter=perf_counter)


def test_adaptive_same_rung_and_cache_file_as_jax(tmp_path, monkeypatch):
    """On the counting clock a row's rate is a function of its batch, so both
    packages climb the same ladder: the same rows, the same warm start, and
    byte-identical tuning-cache files (the wall time frozen)."""
    monkeypatch.setattr(jsweep, "time", _counting_time())
    monkeypatch.setattr(tsweep, "time", _counting_time())
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    kw = dict(batches=(64, 128, 256), keyset=(2, 8), names=("map_stateless", "filter"),
              steps=2)
    paths = {p: str(tmp_path / f"{p}.json") for p in ("jax", "port")}
    jrows = jsweep.run_adaptive(cache_path=paths["jax"], **kw)
    trows = tsweep.run_adaptive(cache_path=paths["port"], device=CPU, **kw)
    assert trows == jrows
    assert [r[1] for r in trows] == [256] * 4 and jcontrol.counters() == tcontrol.counters()
    with open(paths["jax"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()
    jcontrol.reset()
    tcontrol.reset()
    assert (tsweep.run_adaptive(cache_path=paths["port"], device=CPU, **kw)
            == jsweep.run_adaptive(cache_path=paths["jax"], **kw))
    assert tcontrol.counters()["tuning_cache_hits"] == 4 == jcontrol.counters()[
        "tuning_cache_hits"]


def test_render_markdown_rows_match_jax():
    rows = [("map_stateless", 1 << 20, 500, 1.234567e9), ("win_kf", 256, 1, 4321.0),
            ("nexmark:q5_session", 1 << 14, 8, 0.0),
            ("filter (adaptive)", 1 << 18, 10_000, 5.555e7)]
    table = lambda md: [ln for ln in md.splitlines() if ln.startswith("|")]  # noqa: E731
    assert table(tsweep.render_markdown(rows, "x")) == table(jsweep.render_markdown(rows, "x"))
    md = tsweep.render_markdown(rows, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert "Device: NVIDIA H100 80GB HBM3, 700.00 W." in md and "CUDA bars" not in md


def test_main_writes_the_table(tmp_path, monkeypatch, capsys):
    small = dict(batches=(64, 128), steps=1)
    monkeypatch.setattr(tsweep, "run_sweep",
                        functools.partial(tsweep.run_sweep, keyset=(1,), **small))
    monkeypatch.setattr(tsweep, "run_adaptive",
                        functools.partial(tsweep.run_adaptive, keyset=(1,),
                                          names=("filter",), **small))
    monkeypatch.setattr(tsweep, "run_nexmark",
                        functools.partial(tsweep.run_nexmark, batches=(64,)))
    out = tmp_path / "RESULTS.md"
    tsweep.main(["--device", "cpu", "--out", str(out), "--steps", "1"])
    md = out.read_text()
    assert md.count("\n| ") == 1 + 8 + 1 + len(JQUERIES)   # header + rows
    assert "| filter (adaptive) |" in md and "| nexmark:q3_enrich_join | 64 |" in md
    assert f"wrote {out}" in capsys.readouterr().err


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsweep.workloads(256, 1, 1024)
    with pytest.raises(RuntimeError, match="cuda"):
        tsweep.run_sweep(batches=(256,), keyset=(1,), steps=1)

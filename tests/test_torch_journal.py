"""The port's event journal (``windflow_tpu_torch/observability/journal.py``), on the CPU.

Mirrors the JAX package's journal cases (``tests/test_observability.py``,
``tests/test_tracing.py``): the record schema, spans with ``dur_s`` and the
``error`` override, the no-op module helpers, per-event and batched
flushing. Then every record site this port journals is driven once, in the
port and (where the JAX package has the same driver) in the JAX package,
and the records must be equal once their timing fields are dropped:
``fault_injected``, ``watchdog_timeout`` and ``backoff`` (``runtime/
faults.py``), ``checkpoint_invalid`` and ``checkpoint_fallback``
(``runtime/checkpoint.py``), ``watchdog_stale`` (``runtime/threaded.py``),
``eos`` (``Pipeline``), ``eos_flush`` (the serial PipeGraph driver),
``eos_propagate`` (the threaded one), ``ordering_close_channel`` and
``ordering_flush`` (the Ordering_Node).
"""

import os
import random

import jax.numpy as jnp
import pytest

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import Mode as JMode
from windflow_tpu.observability import journal as jjournal
from windflow_tpu.runtime import checkpoint as jck
from windflow_tpu.runtime import faults as jfaults
from windflow_tpu_torch.basic import Mode
from windflow_tpu_torch.observability import journal as tjournal
from windflow_tpu_torch.observability import EventJournal, read_journal
from windflow_tpu_torch.runtime import checkpoint as tck
from windflow_tpu_torch.runtime import faults as faults_mod

CPU = {"device": "cpu"}
#: timing fields of a record (``service_s``: a sampled launch's measured time)
TIMING = ("t", "wall", "dur_s", "stalled_s", "service_s")


@pytest.fixture(autouse=True)
def _clean():
    for m in (faults_mod, jfaults):
        m.set_active(None)
        m.reset_counters()
    for j in (tjournal, jjournal):
        j.set_active(None)
    yield
    for m in (faults_mod, jfaults):
        m.set_active(None)
    for j in (tjournal, jjournal):
        j.set_active(None)


def journaled(journal_mod, path, fn):
    """``fn()`` with a journal at ``path`` active; returns the records
    without their timing fields."""
    j = journal_mod.EventJournal(path)
    journal_mod.set_active(j)
    try:
        fn()
    finally:
        journal_mod.set_active(None)
        j.close()
    return [{k: v for k, v in r.items() if k not in TIMING}
            for r in read_journal(path)]


# -------------------------------------------------------- mirrored schema

def test_journal_schema_round_trip(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    j = EventJournal(path)
    j.event("custom", foo=1, bar="x")
    with j.span("work", item=3):
        j.event("inner")
    j.close()
    evs = read_journal(path)
    assert [e["event"] for e in evs] == ["custom", "work", "inner", "work"]
    for e in evs:
        assert isinstance(e["t"], float) and isinstance(e["wall"], float)
    ts = [e["t"] for e in evs]
    assert ts == sorted(ts)
    begin, end = evs[1], evs[3]
    assert begin["phase"] == "begin" and end["phase"] == "end"
    assert begin["span"] == end["span"] and end["dur_s"] >= 0
    assert begin["item"] == 3


def test_journal_span_records_error(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    j = EventJournal(path)
    with pytest.raises(ValueError):
        with j.span("boom"):
            raise ValueError("x")
    j.close()
    evs = read_journal(path)
    assert evs[-1]["phase"] == "end" and evs[-1]["error"] == "ValueError"


def test_journal_span_error_field_collision(tmp_path):
    """A span opened with an ``error`` field that then raises: the end record
    carries the in-span failure (a dict merge, no duplicate keyword)."""
    path = str(tmp_path / "ev.jsonl")
    j = EventJournal(path)
    with pytest.raises(RuntimeError):
        with j.span("restore", error="OrigError"):
            raise RuntimeError("boom")
    j.close()
    evs = read_journal(path)
    assert evs[0]["error"] == "OrigError"
    assert evs[1]["phase"] == "end" and evs[1]["error"] == "RuntimeError"


def test_module_level_journal_noop_when_inactive():
    assert tjournal.get_active() is None
    tjournal.record("nothing", x=1)
    with tjournal.span("nothing"):
        pass


def test_journal_buffered_mode_flushes_on_interval_and_close(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = EventJournal(path, flush_interval=10)
    for i in range(4):
        j.event("launch", push=i)
    assert os.path.getsize(path) == 0
    j.close()
    assert len(read_journal(path)) == 4
    path2 = str(tmp_path / "j2.jsonl")
    j2 = EventJournal(path2, flush_interval=3)
    for i in range(3):
        j2.event("launch", push=i)
    assert len(read_journal(path2)) == 3
    j2.close()


def test_journal_buffered_mode_flushes_errors_immediately(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = EventJournal(path, flush_interval=1000)
    j.event("launch", push=0)
    assert os.path.getsize(path) == 0
    j.event("restart_exhausted", error="Boom")
    assert len(read_journal(path)) == 2
    j.close()


def test_journal_default_stays_per_event(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = EventJournal(path)
    j.event("launch", push=0)
    assert len(read_journal(path)) == 1
    j.close()


def test_the_same_calls_journal_the_same_records(tmp_path):
    """Events, spans (with and without an error) and the module helpers give
    the JAX package's records, timing fields aside."""
    def calls(mod):
        def run():
            mod.record("a", x=1, s="t")
            with mod.span("b", y=[1, 2]):
                mod.record("c")
            try:
                with mod.span("d", error="Orig"):
                    raise KeyError("k")
            except KeyError:
                pass
        return run
    assert (journaled(tjournal, str(tmp_path / "t.jsonl"), calls(tjournal))
            == journaled(jjournal, str(tmp_path / "j.jsonl"), calls(jjournal)))


# ------------------------------------------------------------ record sites

def test_fault_sites_journal_as_jax(tmp_path):
    """fault_injected (a fire with its context), watchdog_timeout and backoff."""
    def run(fm):
        def body():
            inj = fm.FaultInjector(fm.FaultPlan([fm.FaultSpec("chain.step", at=[2])]))
            for i in range(3):
                try:
                    inj.fire("chain.step", pos=i, stage="seg0")
                except fm.InjectedFault:
                    pass
            with pytest.raises(fm.WatchdogTimeout) as ei:
                fm.call_with_timeout(lambda: 1, 0.02, stage="chain.step",
                                     pre=lambda: __import__("time").sleep(0.2))
            fm.join_abandoned_worker(ei.value, 1.0)
            fm.backoff_sleep(random.Random(1), 0.001, 0.001, 0.002, attempt=3)
        return body
    t = journaled(tjournal, str(tmp_path / "t.jsonl"), run(faults_mod))
    j = journaled(jjournal, str(tmp_path / "j.jsonl"), run(jfaults))
    assert [r["event"] for r in t] == ["fault_injected", "watchdog_timeout", "backoff"]
    assert t[0] == {"event": "fault_injected", "site": "chain.step", "occurrence": 2,
                    "kind": "error", "pos": 1, "stage": "seg0"}
    assert t == j                              # the same seeded backoff draw too


def _lineage_with_a_torn_head(ck, chain, path):
    ck.save_chain(chain, path, meta={"n": 1}, keep=3)
    ck.save_chain(chain, path, meta={"n": 2}, keep=3)
    man = ck._read_manifest(ck.manifest_path(path))
    newest = os.path.join(os.path.dirname(path), man["entries"][-1]["file"])
    with open(newest, "r+b") as f:
        f.truncate(64)                         # the newest entry torn


def test_checkpoint_fallback_journals_as_jax(tmp_path):
    """A torn newest lineage entry: checkpoint_invalid, then
    checkpoint_fallback naming the entry restored."""
    src = wt.Source(lambda i: {"v": i.float()}, total=64, **CPU)
    tchain = wt.CompiledChain([wt.Map(lambda t: {"v": t.v * 2}, **CPU)], src.payload_spec(),
                              batch_capacity=16, **CPU)
    jsrc = wf.Source(lambda i: {"v": i.astype(jnp.float32)}, total=64)
    jchain = wf.CompiledChain([wf.Map(lambda t: {"v": t.v * 2})], jsrc.payload_spec(),
                              batch_capacity=16)
    recs = {}
    for pkg, ck, chain, mod in (("port", tck, tchain, tjournal),
                                ("jax", jck, jchain, jjournal)):
        d = tmp_path / pkg
        d.mkdir()
        path = str(d / "c.npz")
        _lineage_with_a_torn_head(ck, chain, path)
        meta = {}
        recs[pkg] = journaled(mod, str(d / "ev.jsonl"),
                              lambda: meta.update(ck.load_chain(chain, path)))
        assert meta["n"] == 1
        for r in recs[pkg]:
            r.pop("path", None)                # the directory differs
    assert [r["event"] for r in recs["port"]] == ["checkpoint_invalid",
                                                  "checkpoint_fallback"]
    assert recs["port"] == recs["jax"]


def test_threaded_watchdog_stale_is_journaled(tmp_path):
    src = wt.Source(lambda i: {"v": i.float()}, total=96, **CPU)
    tp = wt.ThreadedPipeline(src, [[wt.Map(lambda t: {"v": t.v * 3}, **CPU)]],
                             wt.Sink(lambda v: None, **CPU), batch_size=16, pin=False,
                             heartbeat_timeout=0.05,
                             faults=faults_mod.FaultPlan([faults_mod.FaultSpec(
                                 "queue.stall", kind="stall", stall_s=0.4,
                                 where={"stage": "seg0", "pos": 2})]), **CPU)
    recs = journaled(tjournal, str(tmp_path / "t.jsonl"), tp.run)
    stale = [r for r in recs if r["event"] == "watchdog_stale"]
    assert {r["stage"] for r in stale} >= {"seg0"}
    assert all(r["timeout_s"] == 0.05 for r in stale)


def test_pipeline_eos_journals_as_jax(tmp_path):
    t = journaled(tjournal, str(tmp_path / "t.jsonl"), lambda: wt.Pipeline(
        wt.Source(lambda i: {"v": i.float()}, total=64, name="gen", **CPU),
        [wt.Map(lambda t: {"v": t.v + 1}, **CPU)], wt.Sink(lambda v: None, **CPU),
        batch_size=16, **CPU).run())
    j = journaled(jjournal, str(tmp_path / "j.jsonl"), lambda: wf.Pipeline(
        wf.Source(lambda i: {"v": i.astype(jnp.float32)}, total=64, name="gen"),
        [wf.Map(lambda t: {"v": t.v + 1})], wf.Sink(lambda v: None), batch_size=16).run())
    # the sampled launches (pushes 2 and 4 of 4, while a journal is active)
    # come before the EOS record
    assert t == [{"event": "launch", "op": "map", "from_op": 0, "push": 2},
                 {"event": "launch", "op": "map", "from_op": 0, "push": 4},
                 {"event": "eos", "pipeline": "gen"}]
    assert t == j


def _merge_graph(pkg, threaded=False):
    if pkg == "jax":
        g = wf.PipeGraph("m", batch_size=16, mode=JMode.DETERMINISTIC)
        a = g.add_source(wf.Source(lambda i: {"v": i.astype(jnp.float32)}, total=64,
                                   ts_fn=lambda i: 2 * i, name="a"))
        b = g.add_source(wf.Source(lambda i: {"v": i.astype(jnp.float32)}, total=48,
                                   ts_fn=lambda i: 2 * i + 1, name="b"))
        a.merge(b).add(wf.Map(lambda t: {"v": t.v + 1})).add_sink(wf.Sink(lambda v: None))
        return lambda: g.run(threaded=threaded) if threaded else g.run()
    g = wt.PipeGraph("m", batch_size=16, mode=Mode.DETERMINISTIC, **CPU)
    a = g.add_source(wt.Source(lambda i: {"v": i.float()}, total=64,
                               ts_fn=lambda i: 2 * i, name="a", **CPU))
    b = g.add_source(wt.Source(lambda i: {"v": i.float()}, total=48,
                               ts_fn=lambda i: 2 * i + 1, name="b", **CPU))
    a.merge(b).add(wt.Map(lambda t: {"v": t.v + 1}, **CPU)).add_sink(
        wt.Sink(lambda v: None, **CPU))
    return lambda: g.run(threaded=threaded)


def test_graph_eos_and_ordering_records_journal_as_jax(tmp_path):
    """The serial driver: ordering_close_channel as each source ends,
    eos_flush a pipe at EOS and the merge's ordering_flush, as the JAX
    package's serial driver records them."""
    t = journaled(tjournal, str(tmp_path / "t.jsonl"), _merge_graph("port"))
    j = journaled(jjournal, str(tmp_path / "j.jsonl"), _merge_graph("jax"))
    events = [r["event"] for r in t]
    assert events.count("ordering_close_channel") == 2
    assert events.count("eos_flush") == 3 and "ordering_flush" in events
    assert t == j


def test_threaded_graph_eos_propagate_is_journaled(tmp_path):
    t = journaled(tjournal, str(tmp_path / "t.jsonl"), _merge_graph("port", True))
    j = journaled(jjournal, str(tmp_path / "j.jsonl"), _merge_graph("jax", True))
    prop = sorted(r["pipe"] for r in t if r["event"] == "eos_propagate")
    assert prop == [0, 1, 2]
    # the threads interleave: compare the records as a multiset, without
    # the release counts (what a channel's close releases depends on the
    # interleave) and without the merged pipe's sampled launches (its
    # pushes are the releases' chunks): those follow the sampling schedule
    # over however many pushes it made
    merged = lambda r: r["event"] == "launch" and r["op"] == "map"  # noqa: E731
    drop = lambda rs: sorted(({k: v for k, v in r.items() if k != "released"}  # noqa: E731
                              for r in rs if not merged(r)), key=repr)
    assert drop(t) == drop(j)
    schedule = [2, 4, 8] + [16 * n for n in range(1, 64)]
    for recs in (t, j):
        pushes = [r["push"] for r in recs if merged(r)]
        assert pushes == schedule[:len(pushes)] and pushes

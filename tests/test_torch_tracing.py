"""Per-batch causal tracing in the port (``observability/tracing.py``) against
the JAX package, on the CPU.

Mirrors ``tests/test_tracing.py``: the ``TraceConfig`` forms and the
deterministic ids; the flight records of a traced run (trace ids,
positions, streams, stages and kinds; not the times, and as multisets where
stage threads interleave) equal to the JAX package's on every driver;
``to_chrome_trace`` and ``critical_path_report`` over them; every traced
batch of a threaded graph crossing every ring edge (``enq``/``deq``) to one
sink service span; and a supervised run with an injected fault, where
``abort_open("restore")`` closes the failed attempt's spans and the replay
re-mints the same ids.
"""

import json
import os

import pytest

from windflow_tpu.observability import tracing as jtr
from windflow_tpu.runtime.faults import FaultPlan as JFaultPlan
from windflow_tpu.runtime.faults import FaultSpec as JFaultSpec
from windflow_tpu_torch.observability import tracing as ttr
from windflow_tpu_torch.runtime.faults import FaultPlan, FaultSpec
from tests.test_torch_monitoring import ENV, monitored, report_lines


def test_trace_config_and_ids_equal_jax(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for arg in (None, False, True, "/x/trace"):
        a, b = jtr.TraceConfig.resolve(arg), ttr.TraceConfig.resolve(arg)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.out_dir, a.sample_every, a.ids) == (b.out_dir, b.sample_every, b.ids)
    monkeypatch.setenv("WF_TRACE", "/y")
    monkeypatch.setenv("WF_TRACE_SAMPLE", "3")
    assert ttr.TraceConfig.resolve(None).sample_every == \
        jtr.TraceConfig.resolve(None).sample_every == 3
    for bad in ({"ids": "wall"}, {"sample_every": 0}, {"ring_capacity": 0}):
        with pytest.raises(ValueError):
            ttr.TraceConfig(**bad)
    for run, stream, pos in (("r", 0, 0), ("ysb-pipeline", 2, 12345), ("x", 7, 2**32 + 5)):
        tid = ttr.mint_trace_id(run, stream, pos)
        assert tid == jtr.mint_trace_id(run, stream, pos)
        assert ttr.trace_pos(tid) == jtr.trace_pos(tid) == pos & 0xFFFFFFFF


def flight(d):
    recs, meta = ttr.load_flight(os.path.join(d, "trace"))
    return recs, meta


def shape(recs):
    """The records as (tid, stage, kind, pos, stream, k, aborted) multiset."""
    return sorted(((r["tid"], r["stage"], r["kind"], r.get("pos"), r.get("stream"),
                    r.get("k"), r.get("aborted")) for r in recs), key=repr)


@pytest.mark.parametrize("driver", ["plain", "dispatch", "threaded", "graph",
                                    "graph_threaded", "graph_supervised"])
def test_flight_records_equal_jax(driver, tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        monitored(pkg, "q5", driver, d, health=False)
        got[pkg] = flight(d)
    (trecs, tmeta), (jrecs, jmeta) = got["port"], got["jax"]
    assert shape(trecs) == shape(jrecs) and trecs
    if driver in ("plain", "dispatch", "graph", "graph_supervised"):
        # one thread: the same order too
        assert [(r["tid"], r["stage"], r["kind"]) for r in trecs] == \
            [(r["tid"], r["stage"], r["kind"]) for r in jrecs]
    assert {k: tmeta[k] for k in ("run_id", "name", "ids", "sample_every", "minted",
                                  "dropped")} == \
        {k: jmeta[k] for k in ("run_id", "name", "ids", "sample_every", "minted",
                               "dropped")}
    # the exporters, on the port's records, as on the JAX package's
    chrome = ttr.to_chrome_trace(trecs, meta=tmeta)
    json.loads(json.dumps(chrome))
    jchrome = jtr.to_chrome_trace(jrecs, meta=jmeta)
    assert sorted(e["ph"] for e in chrome["traceEvents"]) == \
        sorted(e["ph"] for e in jchrome["traceEvents"])
    assert report_lines(ttr.critical_path_report(trecs, meta=tmeta)) == \
        report_lines(jtr.critical_path_report(jrecs, meta=jmeta))


def test_threaded_graph_batches_cross_every_edge(tmp_path):
    """A traced threaded graph: every ingested id has an ``enq`` and a
    ``deq`` on every ring edge it crosses and one sink-side service span."""
    monitored("port", "ysb", "graph_threaded", str(tmp_path), health=False)
    recs, _ = flight(str(tmp_path))
    ids = {r["tid"] for r in recs if r["kind"] == "ingest"}
    assert ids
    for tid in ids:
        kinds = [(r["stage"], r["kind"]) for r in recs if r["tid"] == tid]
        assert ("src->0", "enq") in kinds and ("src->0", "deq") in kinds
        assert kinds.count(("pipe0", "begin")) == kinds.count(("pipe0", "end")) == 1


def test_supervised_fault_aborts_open_spans_and_replays_ids(tmp_path):
    """One injected step fault under ``SupervisedPipeline(trace=)``: the
    failed attempt's span ends ``aborted: restore``, every begin has its
    end, the replay re-mints the same ids, and the records equal the JAX
    package's (the JAX run takes the same plan)."""
    got = {}
    for pkg, plan in (("jax", JFaultPlan([JFaultSpec("chain.step", where={"pos": 4},
                                                    max_fires=1)])),
                      ("port", FaultPlan([FaultSpec("chain.step", where={"pos": 4},
                                                    max_fires=1)]))):
        d = str(tmp_path / pkg)
        rows, _ = monitored(pkg, "ysb", "supervised", d, health=False, faults=plan)
        got[pkg] = (rows, flight(d)[0])
    (trows, trecs), (jrows, jrecs) = got["port"], got["jax"]
    assert trows == jrows and trows
    assert shape(trecs) == shape(jrecs)
    aborted = [r for r in trecs if r.get("aborted") == "restore"]
    assert len(aborted) == 1 and aborted[0]["kind"] == "end"
    begins = sum(r["kind"] == "begin" for r in trecs)
    assert begins == sum(r["kind"] == "end" for r in trecs)
    minted = [r["tid"] for r in trecs if r["kind"] == "ingest"]
    assert len(minted) > len(set(minted))          # the replayed positions


def test_supervised_sequence_ids_refused(tmp_path):
    import windflow_tpu_torch as wt
    from tests.test_torch_monitoring import scenario
    src, ops = scenario("port", "q3")
    sp = wt.SupervisedPipeline(src, ops, None, batch_size=50, device="cpu",
                               trace=ttr.TraceConfig(out_dir=str(tmp_path), ids="sequence"))
    with pytest.raises(ValueError, match="ids='position'"):
        sp.run()

"""Topology export: the compiled PipeGraph/MultiPipe app-tree as dot + JSON.

Counterpart of ``windflow_tpu/observability/topology.py``, a copy over the
port's ``PipeGraph`` and ``Pipeline`` (the same attributes). The reference
dumps the PipeGraph as a graphviz diagram under ``GRAPHVIZ_WINDFLOW``
(``wf/pipegraph.hpp:226-237,1450-1518``); this is that dump, extended with
live telemetry when a
:class:`~.metrics.MetricsRegistry` snapshot is supplied: per-edge tuple rates
(producer output rate) and — under the threaded driver — SPSC queue depths
(the backpressure signal).

Two graph shapes are supported:

- ``PipeGraph`` (DAG of MultiPipes with split/merge edges + the Application
  Tree legality forest);
- ``Pipeline`` (the linear source → ops → sink slice), exported as a chain.
"""

from __future__ import annotations

from typing import Optional


def _op_info(op, rates: Optional[dict] = None,
             state_bytes: Optional[dict] = None) -> dict:
    info = {
        "name": op.getName(),
        "routing": op.getRoutingMode().name,
        "parallelism": op.getParallelism(),
        "chained": op._chained,
    }
    if rates and op.getName() in rates:
        r = rates[op.getName()]
        info["rate_in_tps"] = r.get("rate_in_tps")
        info["rate_out_tps"] = r.get("rate_out_tps")
    if state_bytes and op.getName() in state_bytes:
        # memory ledger (health monitoring): the operator's state
        # footprint, so the topology names WHERE device memory sits
        info["state_bytes"] = state_bytes[op.getName()]
    return info


def _rates_by_op(snapshot: Optional[dict]) -> dict:
    if not snapshot:
        return {}
    return {row["name"]: row for row in snapshot.get("operators", [])}


def _app_tree(graph, index) -> list:
    """Serialize the live Application-Tree forest (nodes with
    ``absorbed == False``; ``wf/pipegraph.hpp:64-75``)."""
    def ser(node):
        return {"pipe": index.get(id(node.mp)),
                "children": [ser(c) for c in node.children if not c.absorbed]}
    roots = [n for n in graph._nodes.values()
             if not n.absorbed and n.parent is None]
    return [ser(r) for r in roots]


# ---------------------------------------------------------------- PipeGraph

def graph_topology_json(graph, snapshot: Optional[dict] = None) -> dict:
    """JSON topology of a PipeGraph: per-pipe nodes (source/ops/sink), dataflow
    edges (source/split/merge/sink) annotated with live rates + queue depths,
    and the Application-Tree forest."""
    rates = _rates_by_op(snapshot)
    queues = (snapshot or {}).get("queues", {})
    # per-edge watermark skew (event-time monitoring): the registry computes
    # it over the SAME edge-label enumeration the threaded driver rings use
    skews = ((snapshot or {}).get("event_time") or {}).get("edge_skew_ts",
                                                           {})
    health = (snapshot or {}).get("health") or {}
    state_bytes = health.get("state_bytes") or {}
    pipes = graph._all_pipes()
    index = {id(p): i for i, p in enumerate(pipes)}
    nodes, edges = [], []
    for i, p in enumerate(pipes):
        nodes.append({
            "id": i,
            "source": p.source.getName() if p.source is not None else None,
            "sink": p.sink.getName() if p.sink is not None else None,
            "ops": [_op_info(o, rates, state_bytes) for o in p.ops],
            "compiled": p._chain is not None,
        })

    def edge(src, dst, kind, rate_op=None):
        e = {"from": src, "to": dst, "kind": kind}
        label = f"{src}->{dst}"
        if label in queues:
            e["queue_depth"] = queues[label]
        if label in skews:
            e["watermark_skew_ts"] = skews[label]
        if rate_op is not None and rate_op.getName() in rates:
            e["rate_tps"] = rates[rate_op.getName()].get("rate_out_tps")
        edges.append(e)

    for p in pipes:
        i = index[id(p)]
        last_op = p.ops[-1] if p.ops else None
        for b in p.split_branches:
            edge(i, index[id(b)], "split", last_op)
        for m in p._outputs_to:
            edge(i, index[id(m)], "merge", last_op)
    out = {
        "graph": graph.name,
        "mode": graph.mode.name,
        "batch_size": graph.batch_size,
        "nodes": nodes,
        "edges": edges,
        "app_tree": _app_tree(graph, index),
    }
    if snapshot:
        out["totals"] = snapshot.get("totals")
        out["e2e_latency_us"] = snapshot.get("e2e_latency_us")
        if snapshot.get("event_time"):
            out["event_time"] = snapshot["event_time"]
        if health:
            # the runtime-health summary rides the topology export too:
            # device headroom + the dispatch-bound stages (fusion
            # candidates), so one artifact answers "where is the memory
            # and which edges is the host loop throttling"
            out["health"] = {
                k: health[k] for k in ("devices", "headroom_risk",
                                       "dispatch_bound", "state_bytes")
                if health.get(k)}
    return out


def graph_topology_dot(graph, snapshot: Optional[dict] = None) -> str:
    """Graphviz dump of a PipeGraph (the reference's GRAPHVIZ_WINDFLOW
    diagram), with live per-edge rates / queue depths when a registry snapshot
    is supplied."""
    rates = _rates_by_op(snapshot)
    queues = (snapshot or {}).get("queues", {})
    skews = ((snapshot or {}).get("event_time") or {}).get("edge_skew_ts",
                                                           {})
    pipes = graph._all_pipes()
    index = {id(p): i for i, p in enumerate(pipes)}
    lines = [f'digraph "{graph.name}" {{', "  rankdir=LR;"]

    def op_label(o):
        tag = "" if o._chained else {
            "FORWARD": "", "NONE": "",
        }.get(o.getRoutingMode().name, f" ({o.getRoutingMode().name.lower()})")
        rate = ""
        if o.getName() in rates:
            tps = rates[o.getName()].get("rate_in_tps")
            if tps:
                rate = f"\\n{_fmt_tps(tps)}"
        return f"{o.getName()}{tag}{rate}"

    for i, p in enumerate(pipes):
        ops = " | ".join(op_label(o) for o in p.ops) or "(empty)"
        src = f"{p.source.getName()} -> " if p.source is not None else ""
        snk = f" -> {p.sink.getName()}" if p.sink is not None else ""
        lines.append(f'  mp{i} [shape=record, label="{src}{ops}{snk}"];')

    def edge_attrs(src, dst, kind):
        label = kind
        key = f"{src}->{dst}"
        if key in queues:
            label += f" depth={queues[key]}"
        if key in skews:
            label += f" skew={skews[key]}"
        return f'[label="{label}"]'

    for p in pipes:
        i = index[id(p)]
        for b in p.split_branches:
            j = index[id(b)]
            lines.append(f"  mp{i} -> mp{j} {edge_attrs(i, j, 'split')};")
        for m in p._outputs_to:
            j = index[id(m)]
            lines.append(f"  mp{i} -> mp{j} {edge_attrs(i, j, 'merge')};")
    lines.append("}")
    return "\n".join(lines)


# ----------------------------------------------------------------- Pipeline

def pipeline_topology_json(pipeline, snapshot: Optional[dict] = None) -> dict:
    """Linear Pipeline as a chain topology (source → ops → sink)."""
    rates = _rates_by_op(snapshot)
    state_bytes = ((snapshot or {}).get("health") or {}).get("state_bytes")
    stages = [{"name": pipeline.source.getName(), "kind": "source"}]
    stages += [dict(_op_info(o, rates, state_bytes), kind="operator")
               for o in pipeline.chain.ops]
    if pipeline.sink is not None:
        stages.append({"name": pipeline.sink.getName(), "kind": "sink"})
    out = {"pipeline": True, "batch_size": pipeline.batch_size,
           "stages": stages,
           "edges": [{"from": i, "to": i + 1, "kind": "chain"}
                     for i in range(len(stages) - 1)]}
    if snapshot:
        out["totals"] = snapshot.get("totals")
        out["e2e_latency_us"] = snapshot.get("e2e_latency_us")
        health = snapshot.get("health") or {}
        if health:
            out["health"] = {
                k: health[k] for k in ("devices", "headroom_risk",
                                       "dispatch_bound", "state_bytes")
                if health.get(k)}
    return out


def pipeline_topology_dot(pipeline, snapshot: Optional[dict] = None) -> str:
    rates = _rates_by_op(snapshot)
    names = [pipeline.source.getName()]
    names += [o.getName() for o in pipeline.chain.ops]
    if pipeline.sink is not None:
        names.append(pipeline.sink.getName())
    lines = ['digraph "pipeline" {', "  rankdir=LR;"]
    for i, n in enumerate(names):
        rate = ""
        if n in rates and rates[n].get("rate_in_tps"):
            rate = f"\\n{_fmt_tps(rates[n]['rate_in_tps'])}"
        lines.append(f'  s{i} [label="{n}{rate}"];')
    for i in range(len(names) - 1):
        lines.append(f"  s{i} -> s{i + 1};")
    lines.append("}")
    return "\n".join(lines)


# ----------------------------------------------------------------- dispatch

def topology_json(target, snapshot: Optional[dict] = None) -> dict:
    """Topology JSON for a PipeGraph or a Pipeline (duck-typed dispatch)."""
    if hasattr(target, "_all_pipes"):
        return graph_topology_json(target, snapshot)
    return pipeline_topology_json(target, snapshot)


def topology_dot(target, snapshot: Optional[dict] = None) -> str:
    """Topology graphviz dot for a PipeGraph or a Pipeline."""
    if hasattr(target, "_all_pipes"):
        return graph_topology_dot(target, snapshot)
    return pipeline_topology_dot(target, snapshot)


def _fmt_tps(tps: float) -> str:
    if tps >= 1e6:
        return f"{tps / 1e6:.1f}M t/s"
    if tps >= 1e3:
        return f"{tps / 1e3:.1f}k t/s"
    return f"{tps:.0f} t/s"

"""Per-batch causal tracing and the flight recorder.

Counterpart of ``windflow_tpu/observability/tracing.py``, a copy of its host
code (that module imports no JAX; the port imports nothing of the JAX
package): which batch hit the p99 and where its time went (queue wait,
service, restart) as it crossed operator chains, SPSC rings and restores.

- Deterministic trace ids minted at ingest from ``(run_id, stream,
  position)`` (:func:`mint_trace_id`): a supervised replay after a restore
  re-mints the same ids. The id rides on the port's ``Batch`` as host-side
  sidecar metadata (``batch.py::TRACE_META_ATTR``), never as a tensor, so the
  captured CUDA graphs and the kernels' inputs are untouched.
- The flight recorder: a bounded ring of stage records (ingest, ring enqueue
  and dequeue, service begin and end) a thread, so the hot path takes no
  lock; oldest records are overwritten when a segment wraps.
- Exporters: :func:`to_chrome_trace` (Chrome trace-event JSON, loadable in
  Perfetto) and :func:`critical_path_report`; ``scripts/wf_trace.py`` reads
  the port's ``flight.jsonl``/``meta.json`` as it reads the JAX package's.

Off by default: ``trace=`` on every driver, or ``WF_TRACE=1`` /
``WF_TRACE=/path`` and ``WF_TRACE_SAMPLE=N``. Off, a call site costs one
module attribute load and a ``None`` check. Service spans time the host: a
span closes when the push returned (the kernels are queued, not done) except
on a sampled push, which waits for the stream.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Union

from . import journal as _journal

#: host-side sidecar attribute carrying the trace id on a Batch (the name of
#: ``windflow_tpu_torch/batch.py::TRACE_META_ATTR`` and of the JAX package's)
TRACE_META_ATTR = "_wf_trace"

#: record kinds (flight-recorder rows and the flight.jsonl schema)
K_INGEST = "ingest"        # trace id minted at the source boundary
K_ENQ = "enq"              # batch pushed into an SPSC ring edge
K_DEQ = "deq"              # batch popped from an SPSC ring edge
K_BEGIN = "begin"          # stage service span opened
K_END = "end"              # stage service span closed (extra: aborted=reason)


@dataclasses.dataclass
class TraceConfig:
    """Resolved tracing settings for one driver run."""

    out_dir: str = "wf_trace"
    #: trace every Nth *offered* batch (positional — replay-deterministic);
    #: 1 = every batch
    sample_every: int = 1
    #: flight-recorder ring capacity, records per thread segment
    ring_capacity: int = 8192
    #: trace-id namespace; None = the driver's name. Make it explicit when
    #: comparing runs (same run_id + same positions => byte-identical ids).
    run_id: Optional[str] = None
    #: id minting mode: ``"position"`` derives ids from (run_id, stream,
    #: offered position) — replay-stable, REQUIRED under supervision;
    #: ``"sequence"`` uses a process-global counter (live-only: a replay
    #: after restore would mint fresh ids and orphan every exemplar).
    ids: str = "position"

    def __post_init__(self):
        if self.ids not in ("position", "sequence"):
            raise ValueError(f"unknown trace id mode {self.ids!r} "
                             f"(modes: position, sequence)")
        if int(self.sample_every) < 1:
            raise ValueError(f"trace sample_every must be >= 1, got "
                             f"{self.sample_every}")
        if int(self.ring_capacity) < 1:
            raise ValueError(f"trace ring_capacity must be >= 1, got "
                             f"{self.ring_capacity}")

    @classmethod
    def resolve(cls, trace: Union[None, bool, str, "TraceConfig"],
                ) -> Optional["TraceConfig"]:
        """Normalize the user-facing ``trace=`` argument (the
        ``MonitoringConfig.resolve`` convention).  ``None`` consults
        ``WF_TRACE`` (``''``/``'0'`` = off); ``False`` forces off; ``True``
        = defaults; a string is the output directory; a config passes
        through.  ``WF_TRACE_SAMPLE`` overrides ``sample_every`` either way.
        Returns None when tracing is off."""
        if trace is False:
            return None
        if isinstance(trace, TraceConfig):
            cfg = trace
        elif isinstance(trace, str):
            cfg = cls(out_dir=trace)
        elif trace is True:
            cfg = cls()
        else:                              # None: env-driven
            env = os.environ.get("WF_TRACE", "")
            if env in ("", "0"):
                return None
            cfg = cls() if env == "1" else cls(out_dir=env)
        sample = os.environ.get("WF_TRACE_SAMPLE", "")
        if sample:
            cfg = dataclasses.replace(cfg, sample_every=int(sample))
        return cfg


# ---------------------------------------------------------------- trace ids


def _fnv1a32(s: str) -> int:
    h = 2166136261
    for ch in s.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


def mint_trace_id(run_id: str, stream: int, pos: int) -> int:
    """THE deterministic id: a pure function of (run id, source stream,
    offered-batch position) — replay after a supervised restore re-offers the
    same positions and therefore re-mints the same ids.  Layout: a 31-bit
    namespace hash in the high word, the position in the low word (so tooling
    can decode the position back out with ``trace_pos``)."""
    h = _fnv1a32(f"{run_id}/{stream}") & 0x7FFFFFFF
    return (h << 32) | (pos & 0xFFFFFFFF)


def trace_pos(tid: int) -> int:
    """Offered-batch position encoded in a position-mode trace id."""
    return int(tid) & 0xFFFFFFFF


def tid_of(batch) -> Optional[int]:
    """Trace id riding on ``batch``, or None (untraced / tracing off)."""
    return getattr(batch, TRACE_META_ATTR, None)


def carry(src, dst) -> None:
    """Propagate the trace id across an operator hop (compiled pushes return
    NEW Batch objects; the sidecar attribute stays on the old one)."""
    tid = getattr(src, TRACE_META_ATTR, None)
    if tid is not None and dst is not None:
        object.__setattr__(dst, TRACE_META_ATTR, tid)


# ----------------------------------------------------------- flight recorder


# the no-lock hot path IS the design: every segment has exactly one writer
# (its owning thread — driver or a stage body); cross-thread readers
# (records/abort_open) either hold the registry lock and tolerate a ring
# slot landing late, or require the owner joined/dead first
class _Segment:  # wf-lint: single-writer[driver, stage]
    """One thread's pre-allocated slice of the flight recorder.  Single
    writer (the owning thread) — no lock; ``idx`` only grows, slot
    ``idx % capacity`` is overwritten on wrap."""

    __slots__ = ("buf", "idx", "capacity", "thread", "owner", "open_spans",
                 "minted")

    def __init__(self, capacity: int, owner: threading.Thread):
        self.buf: List[Optional[tuple]] = [None] * capacity
        self.idx = 0
        self.capacity = capacity
        self.owner = owner
        self.thread = owner.name
        #: ids minted by this segment's owner — per-thread so concurrent
        #: source loops never race a shared counter; Tracer.minted sums
        self.minted = 0
        #: spans begun but not yet ended on this thread (tid, stage) — lets
        #: a supervisor close them on the restore path so the export never
        #: contains orphan begin records after a recovery
        self.open_spans: List[tuple] = []

    def add(self, rec: tuple) -> None:
        self.buf[self.idx % self.capacity] = rec
        self.idx += 1

    def records(self) -> List[tuple]:
        if self.idx <= self.capacity:
            return [r for r in self.buf[:self.idx]]
        cut = self.idx % self.capacity
        return [r for r in self.buf[cut:] + self.buf[:cut] if r is not None]

    @property
    def dropped(self) -> int:
        return max(0, self.idx - self.capacity)


class _ServiceSpan:
    """Handle returned by :meth:`Tracer.service`; ``done()`` closes it."""

    __slots__ = ("_tracer", "_seg", "tid", "stage")

    def __init__(self, tracer: "Tracer", seg: _Segment, tid: int, stage: str):
        self._tracer = tracer
        self._seg = seg
        self.tid = tid
        self.stage = stage

    def done(self) -> None:
        try:
            self._seg.open_spans.remove((self.tid, self.stage))
        except ValueError:
            return                      # already closed by abort_open — a
            #                             second end would orphan-pair
        self._seg.add((time.perf_counter(), self.tid, self.stage,
                       K_END, None))


class Tracer:
    """Per-run tracing state: id minting + the flight recorder + dump.

    Lifecycle mirrors the event journal: ``start()`` installs the tracer as
    the process-global active tracer (runtime call sites reach it through
    the module-level helpers below, one None check when off), ``finish()``
    dumps ``flight.jsonl`` + ``meta.json`` into ``config.out_dir`` and
    deactivates.  ``finish`` is idempotent and runs in driver ``finally``
    blocks."""

    def __init__(self, config: TraceConfig, name: str = "run"):
        self.config = config
        self.name = name
        self.run_id = config.run_id or name
        self.sample_every = int(config.sample_every)
        self._segments: List[_Segment] = []
        self._seg_lock = threading.Lock()
        self._tls = threading.local()
        self._seq = 0                     # "sequence" id mode counter
        self._seq_lock = threading.Lock()
        self._finished = False
        #: clock sync captured at start: journal records carry
        #: ``time.monotonic()``, flight records ``time.perf_counter()`` —
        #: the exporters map between the two with this pair
        self.perf_t0 = time.perf_counter()
        self.mono_t0 = time.monotonic()
        self.wall_t0 = time.time()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Tracer":
        os.makedirs(self.config.out_dir, exist_ok=True)
        set_active(self)
        _journal.record("trace_start", run_id=self.run_id,
                        sample_every=self.sample_every, ids=self.config.ids)
        return self

    def finish(self) -> Optional[str]:
        """Dump the flight recorder; returns the flight.jsonl path (None on
        repeat calls)."""
        if self._finished:
            return None
        self._finished = True
        if get_active() is self:
            set_active(None)
        _journal.record("trace_end", run_id=self.run_id, minted=self.minted)
        recs = self.records()
        path = os.path.join(self.config.out_dir, "flight.jsonl")
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        with open(os.path.join(self.config.out_dir, "meta.json"), "w") as f:
            json.dump(self.meta(), f, indent=1)
        return path

    @property
    def minted(self) -> int:
        """Total ids minted, summed over the per-thread segments (each owner
        thread counts its own — no shared-counter race)."""
        with self._seg_lock:
            return sum(s.minted for s in self._segments)

    def meta(self) -> dict:
        with self._seg_lock:            # a stage thread may be registering
            segs = list(self._segments)  # its segment concurrently
        return {"run_id": self.run_id, "name": self.name,
                "ids": self.config.ids, "sample_every": self.sample_every,
                "ring_capacity": self.config.ring_capacity,
                "minted": self.minted,
                "dropped": sum(s.dropped for s in segs),
                "perf_t0": self.perf_t0, "mono_t0": self.mono_t0,
                "wall_t0": self.wall_t0}

    # -- recording ---------------------------------------------------------

    def _seg(self) -> _Segment:
        seg = getattr(self._tls, "seg", None)
        if seg is None:
            seg = _Segment(self.config.ring_capacity,
                           threading.current_thread())
            self._tls.seg = seg
            with self._seg_lock:
                self._segments.append(seg)
        return seg

    def ingest(self, batch, pos: int, stream: int = 0,
               extras: Optional[dict] = None) -> Optional[int]:
        """Source boundary: sample + mint + attach + record.  Returns the
        minted id (None when the batch fell outside the sample).

        ``extras`` rides the ingest record verbatim (flattened into the
        flight.jsonl row by :meth:`records`) — the serving runtime joins
        the wire coordinates here: ``tenant``/``seq`` plus ``wire_ms``
        (client send -> socket receipt) and ``queue_ms`` (receipt -> drive
        pickup), so the per-tenant trace report can attribute time spent
        BEFORE the batch existed on this host."""
        if pos % self.sample_every:
            return None
        if self.config.ids == "sequence":
            with self._seq_lock:
                n = self._seq
                self._seq += 1
            tid = mint_trace_id(self.run_id, stream, n)
        else:
            tid = mint_trace_id(self.run_id, stream, pos)
        object.__setattr__(batch, TRACE_META_ATTR, tid)
        seg = self._seg()
        seg.minted += 1
        extra = {"pos": int(pos), "stream": int(stream)}
        if extras:
            extra.update(extras)
        seg.add((time.perf_counter(), tid, "ingest", K_INGEST, extra))
        return tid

    def event(self, batch, stage: str, kind: str) -> None:
        """Ring-edge record (``stage`` is the edge label) for a traced batch;
        no-op for untraced ones."""
        tid = getattr(batch, TRACE_META_ATTR, None)
        if tid is None:
            return
        self._seg().add((time.perf_counter(), tid, stage, kind, None))

    def service(self, batch, stage: str,
                k: Optional[int] = None) -> Optional[_ServiceSpan]:
        """Open a service span for a traced batch; the caller invokes
        ``.done()`` after the stage's work.  None for untraced batches.

        ``k`` marks FUSED-GROUP membership (scan dispatch, ``WF_DISPATCH``
        with K>1): all K member spans cover the same one compiled launch, so
        the begin record carries ``k`` and the report's per-batch service
        attribution divides the span by it — without the marker a fused
        group would charge its whole service span to every member and the
        stage breakdown would overcount K-fold."""
        tid = getattr(batch, TRACE_META_ATTR, None)
        if tid is None:
            return None
        seg = self._seg()
        extra = {"k": int(k)} if k is not None and k > 1 else None
        seg.add((time.perf_counter(), tid, stage, K_BEGIN, extra))
        seg.open_spans.append((tid, stage))
        return _ServiceSpan(self, seg, tid, stage)

    def stall(self, stage: str) -> _ServiceSpan:
        """Batch-less span (governor throttle episodes): records on the
        given pseudo-stage with trace id 0."""
        seg = self._seg()
        seg.add((time.perf_counter(), 0, stage, K_BEGIN, None))
        seg.open_spans.append((0, stage))
        return _ServiceSpan(self, seg, 0, stage)

    def abort_open(self, reason: str) -> int:
        """Close every span left open by a failed attempt: spans on THIS
        thread (the supervised drivers' step usually runs on the driver
        thread) and spans on segments whose owning thread has exited (a
        ``step_timeout`` watchdog worker that died with the fault — the
        supervisors join abandoned workers before calling this, so a
        finished-or-dead worker's segment has no concurrent writer; a
        genuinely HUNG worker stays alive and keeps its spans, which the
        exporter then drops and counts as unmatched).  Each closed span gets
        an end record tagged with the abort reason — B/E stay matched, the
        aborted attempt stays visible in the trace.  Returns the number of
        spans closed."""
        cur = threading.current_thread()
        with self._seg_lock:
            segs = list(self._segments)
        now = time.perf_counter()
        n = 0
        for seg in segs:
            if not seg.open_spans:
                continue
            if seg.owner is not cur and seg.owner.is_alive():
                continue                    # live foreign writer: hands off
            for tid, stage in seg.open_spans:
                seg.add((now, tid, stage, K_END, {"aborted": reason}))
                n += 1
            seg.open_spans.clear()
        return n

    def snapshot_chrome(self, journal_events: Optional[list] = None) -> dict:
        """Chrome trace-event dump of the CURRENT ring contents, without
        finishing the tracer — the mid-run flight-recorder dump hook the
        SLO engine's incident capture rides (``observability/slo.py``).
        Safe from any thread: :meth:`records` reads each per-thread segment
        through its ring-window snapshot, and open spans simply have no end
        record yet (the exporter drops and counts unmatched begins)."""
        return to_chrome_trace(self.records(), journal_events=journal_events,
                               meta=self.meta())

    def records(self) -> List[dict]:
        """Every surviving record as dicts, globally sorted by timestamp."""
        with self._seg_lock:
            segs = list(self._segments)
        out = []
        for seg in segs:
            for (t, tid, stage, kind, extra) in seg.records():
                rec = {"t": t, "tid": tid, "stage": stage, "kind": kind,
                       "thread": seg.thread}
                if extra:
                    rec.update(extra)
                out.append(rec)
        out.sort(key=lambda r: r["t"])
        return out


# ------------------------------------------------- process-global active hook

#: the active tracer (set by a driver's run for its duration).  Runtime call
#: sites go through the module-level helpers so a disabled tracer costs one
#: attribute load + None check — the ``journal.record`` pattern.
_active: Optional[Tracer] = None


def set_active(tracer: Optional[Tracer]) -> None:
    global _active
    _active = tracer


def get_active() -> Optional[Tracer]:
    return _active


def ingest(batch, pos: int, stream: int = 0,
           extras: Optional[dict] = None) -> None:
    tr = _active
    if tr is not None:
        tr.ingest(batch, pos, stream, extras=extras)


def event(batch, stage: str, kind: str) -> None:
    tr = _active
    if tr is not None:
        tr.event(batch, stage, kind)


def service(batch, stage: str, k: Optional[int] = None
            ) -> Optional[_ServiceSpan]:
    tr = _active
    if tr is not None:
        return tr.service(batch, stage, k=k)
    return None


def stall(stage: str) -> Optional[_ServiceSpan]:
    tr = _active
    if tr is not None:
        return tr.stall(stage)
    return None


def abort_open(reason: str) -> None:
    tr = _active
    if tr is not None:
        tr.abort_open(reason)


# ------------------------------------------------------------------ loading


def load_flight(trace_dir: str):
    """(records, meta) from a Tracer dump directory."""
    with open(os.path.join(trace_dir, "meta.json")) as f:
        meta = json.load(f)
    records = []
    with open(os.path.join(trace_dir, "flight.jsonl")) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records, meta


def _mono_to_perf(meta: Optional[dict]):
    """Journal timestamps (``time.monotonic``) -> flight-recorder timeline
    (``time.perf_counter``) via the clock pair captured at Tracer.start."""
    if not meta or "mono_t0" not in meta or "perf_t0" not in meta:
        return None
    off = meta["perf_t0"] - meta["mono_t0"]
    return lambda t: t + off


# --------------------------------------------------- Chrome trace-event JSON


def to_chrome_trace(records: List[dict], journal_events: Optional[list] = None,
                    meta: Optional[dict] = None) -> dict:
    """Render flight-recorder records (+ optionally the event journal) as a
    Chrome trace-event JSON object (Perfetto / chrome://tracing loadable).

    Layout: pid 1 = the flight recorder, one tid (track) per stage — operator
    chains, the sink, and one track per SPSC ring edge whose slices are queue
    residency (enqueue -> dequeue), with flow arrows connecting producer to
    consumer; pid 2 = the runtime journal (checkpoint/restore/throttle spans,
    shed/dead-letter instants).  ``ts`` is microseconds from the earliest
    record; B/E events are emitted matched (unpaired begins are dropped and
    counted in the returned ``meta`` section)."""
    records = sorted(records, key=lambda r: r["t"])
    t0 = records[0]["t"] if records else 0.0
    mapper = _mono_to_perf(meta)
    jevents = sorted(journal_events or [], key=lambda e: e.get("t", 0.0))
    if jevents and mapper is not None:
        jt = [mapper(e["t"]) for e in jevents if "t" in e]
        if jt:
            t0 = min([t0] + jt) if records else min(jt)

    def us(t):
        return round((t - t0) * 1e6, 3)

    events: List[dict] = []
    tracks: Dict[str, int] = {}

    def track(stage: str) -> int:
        k = tracks.get(stage)
        if k is None:
            k = tracks[stage] = len(tracks) + 1
            events.append({"ph": "M", "pid": 1, "tid": k, "ts": 0,
                           "name": "thread_name",
                           "args": {"name": stage}})
        return k

    events.append({"ph": "M", "pid": 1, "tid": 0, "ts": 0,
                   "name": "process_name",
                   "args": {"name": "windflow flight recorder"}})

    open_begin: Dict[tuple, dict] = {}     # (tid, stage) -> begin record
    enq_at: Dict[tuple, dict] = {}         # (tid, edge) -> enqueue record
    dropped_begins = 0
    flow_seq = 0
    for r in records:
        tid, stage, kind = r["tid"], r["stage"], r["kind"]
        if kind == K_INGEST:
            events.append({"ph": "i", "pid": 1, "tid": track("ingest"),
                           "ts": us(r["t"]), "name": "ingest", "s": "t",
                           "args": {"trace_id": hex(tid),
                                    "pos": r.get("pos")}})
        elif kind == K_BEGIN:
            prev = open_begin.get((tid, stage))
            if prev is not None:
                dropped_begins += 1       # crashed attempt with no abort rec
            open_begin[(tid, stage)] = r
        elif kind == K_END:
            b = open_begin.pop((tid, stage), None)
            if b is None:
                continue                  # end without begin (ring wrapped)
            args: Dict[str, Any] = {"trace_id": hex(tid)}
            if b.get("k"):
                args["fused_k"] = b["k"]  # scan-dispatch group membership
            if r.get("aborted"):
                args["aborted"] = r["aborted"]
            tk = track(stage)
            events.append({"ph": "B", "pid": 1, "tid": tk, "ts": us(b["t"]),
                           "name": stage, "args": args})
            events.append({"ph": "E", "pid": 1, "tid": tk, "ts": us(r["t"]),
                           "name": stage})
        elif kind == K_ENQ:
            enq_at[(tid, stage)] = r
        elif kind == K_DEQ:
            e = enq_at.pop((tid, stage), None)
            if e is None:
                continue
            tk = track(f"ring {stage}")
            events.append({"ph": "X", "pid": 1, "tid": tk, "ts": us(e["t"]),
                           "dur": max(us(r["t"]) - us(e["t"]), 0.001),
                           "name": "queued",
                           "args": {"trace_id": hex(tid), "edge": stage}})
            flow_seq += 1
            fid = f"{tid:x}.{flow_seq}"
            events.append({"ph": "s", "pid": 1, "tid": tk, "ts": us(e["t"]),
                           "name": "ring", "cat": "ring", "id": fid})
            events.append({"ph": "f", "pid": 1, "tid": tk, "ts": us(r["t"]),
                           "name": "ring", "cat": "ring", "id": fid,
                           "bp": "e"})
    dropped_begins += len(open_begin)

    # runtime journal: spans as matched B/E per (event name, span seq),
    # point events as instants — on pid 2 so they sit under the flight tracks
    jtracks: Dict[str, int] = {}
    jopen: Dict[tuple, dict] = {}
    if jevents and mapper is not None:
        events.append({"ph": "M", "pid": 2, "tid": 0, "ts": 0,
                       "name": "process_name",
                       "args": {"name": "windflow runtime journal"}})

        def jtrack(name: str) -> int:
            k = jtracks.get(name)
            if k is None:
                k = jtracks[name] = len(jtracks) + 1
                events.append({"ph": "M", "pid": 2, "tid": k, "ts": 0,
                               "name": "thread_name", "args": {"name": name}})
            return k

        for e in jevents:
            if "t" not in e or "event" not in e:
                continue
            ts = us(mapper(e["t"]))
            name = e["event"]
            args = {k: v for k, v in e.items()
                    if k not in ("t", "wall", "event", "phase", "span")}
            if e.get("phase") == "begin":
                jopen[(name, e.get("span"))] = e
            elif e.get("phase") == "end":
                b = jopen.pop((name, e.get("span")), None)
                if b is None:
                    continue
                tk = jtrack(name)
                events.append({"ph": "B", "pid": 2, "tid": tk,
                               "ts": us(mapper(b["t"])), "name": name,
                               "args": args})
                events.append({"ph": "E", "pid": 2, "tid": tk, "ts": ts,
                               "name": name})
            else:
                events.append({"ph": "i", "pid": 2, "tid": jtrack(name),
                               "ts": ts, "name": name, "s": "t",
                               "args": args})

    events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "M" else 1))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"run_id": (meta or {}).get("run_id"),
                          "dropped_begins": dropped_begins,
                          "flight_records": len(records)}}


# ------------------------------------------------------- critical-path report


def _batch_lifecycles(records: List[dict]) -> Dict[int, dict]:
    """Fold records into per-trace-id lifecycles: ingest time, end time,
    per-stage service durations, per-edge queue waits, aborted-span count.

    Fused-dispatch apportionment: a span whose begin record carries ``k``
    (scan dispatch, K>1) covers ONE compiled launch shared by K group
    members, so each member is charged ``span / k`` — the per-batch drill-
    down stays honest under ``WF_DISPATCH`` instead of charging the whole
    group service span to every member."""
    out: Dict[int, dict] = {}

    def life(tid):
        lc = out.get(tid)
        if lc is None:
            lc = out[tid] = {"tid": tid, "pos": None, "stream": None,
                             "t_ingest": None, "t_end": None,
                             "service": {}, "queue": {}, "aborts": 0,
                             "attempts": {}, "fused": 0,
                             # wire-to-sink coordinates (serving ingest
                             # extras; None for non-serving drivers)
                             "tenant": None, "seq": None,
                             "wire_ms": None, "queue_ms": None}
        return lc

    open_begin: Dict[tuple, tuple] = {}    # (tid, stage) -> (t, k or None)
    enq_at: Dict[tuple, float] = {}
    for r in sorted(records, key=lambda x: x["t"]):
        tid, stage, kind, t = r["tid"], r["stage"], r["kind"], r["t"]
        if tid == 0:
            continue                      # batch-less stall spans
        lc = life(tid)
        lc["t_end"] = t if lc["t_end"] is None else max(lc["t_end"], t)
        if kind == K_INGEST:
            if lc["t_ingest"] is None:    # replay re-ingests: keep the first
                lc["t_ingest"] = t
                lc["pos"] = r.get("pos")
                lc["stream"] = r.get("stream")
                lc["tenant"] = r.get("tenant")
                lc["seq"] = r.get("seq")
                lc["wire_ms"] = r.get("wire_ms")
                lc["queue_ms"] = r.get("queue_ms")
        elif kind == K_BEGIN:
            open_begin[(tid, stage)] = (t, r.get("k"))
            lc["attempts"][stage] = lc["attempts"].get(stage, 0) + 1
        elif kind == K_END:
            b = open_begin.pop((tid, stage), None)
            if b is not None:
                t0, k = b
                dur = t - t0
                if k and int(k) > 1:
                    dur /= int(k)         # fused group: this batch's share
                    lc["fused"] += 1
                lc["service"][stage] = lc["service"].get(stage, 0.0) + dur
            if r.get("aborted"):
                lc["aborts"] += 1
        elif kind == K_ENQ:
            enq_at[(tid, stage)] = t
        elif kind == K_DEQ:
            e = enq_at.pop((tid, stage), None)
            if e is not None:
                lc["queue"][stage] = lc["queue"].get(stage, 0.0) + (t - e)
    return out


def _journal_intervals(jevents: list, name: str, mapper) -> List[tuple]:
    """(t_begin, t_end, fields) for every completed journal span ``name``,
    mapped onto the flight-recorder timeline."""
    if mapper is None:
        return []
    out, jopen = [], {}
    for e in sorted(jevents, key=lambda x: x.get("t", 0.0)):
        if e.get("event") != name or "t" not in e:
            continue
        if e.get("phase") == "begin":
            jopen[e.get("span")] = e
        elif e.get("phase") == "end":
            b = jopen.pop(e.get("span"), None)
            if b is not None:
                out.append((mapper(b["t"]), mapper(e["t"]), e))
    return out


def _throttle_intervals(jevents: list, mapper) -> List[tuple]:
    """throttle/throttle_end are point-event pairs (not spans): pair them
    sequentially per edge."""
    if mapper is None:
        return []
    out, started = [], {}
    for e in sorted(jevents, key=lambda x: x.get("t", 0.0)):
        ev = e.get("event")
        if ev == "throttle" and "t" in e:
            started[e.get("edge")] = e
        elif ev == "throttle_end" and "t" in e:
            b = started.pop(e.get("edge"), None)
            if b is not None:
                out.append((mapper(b["t"]), mapper(e["t"]), e))
    return out


def _overlap(a0: float, a1: float, iv: List[tuple]) -> float:
    tot = 0.0
    for (b0, b1, _f) in iv:
        tot += max(0.0, min(a1, b1) - max(a0, b0))
    return tot


def critical_path_report(records: List[dict],
                         journal_events: Optional[list] = None,
                         snapshot: Optional[dict] = None,
                         meta: Optional[dict] = None, top: int = 5) -> str:
    """Human-readable critical-path breakdown: per-stage service vs queue
    wait vs governor throttle vs shed/restart attribution (correlated from
    the event journal), plus a drill-down of the slowest traced batches and
    the latency exemplars from the metrics snapshot."""
    jevents = journal_events or []
    mapper = _mono_to_perf(meta)
    lives = _batch_lifecycles(records)
    restores = _journal_intervals(jevents, "restore", mapper)
    throttles = _throttle_intervals(jevents, mapper)
    # shed events journal (stream, per-root offered pos) — the coordinates
    # trace ids are minted from; events from single-stream drivers omit the
    # stream and match on position alone
    shed_keys = {(e.get("stream"), e.get("pos")) for e in jevents
                 if e.get("event") == "shed"}
    shed_pos = {p for _s, p in shed_keys}
    dead_pos = {e.get("at_batch") for e in jevents
                if e.get("event") == "dead_letter"}
    # event-time drop forensics (event_time monitoring): each record carries
    # the trace coordinates of the sampled batch whose readback surfaced it
    late_drops = [e for e in jevents if e.get("event") == "lateness_drop"]

    def _is_shed(lc) -> bool:
        return ((lc["stream"], lc["pos"]) in shed_keys
                or (None, lc["pos"]) in shed_keys)

    lines: List[str] = []
    rid = (meta or {}).get("run_id", "?")
    lines.append(f"== windflow trace report: run {rid!r} "
                 f"({len(lives)} traced batches, {len(records)} records) ==")

    # -- aggregate per-stage critical path --------------------------------
    svc_tot: Dict[str, float] = {}
    q_tot: Dict[str, float] = {}
    for lc in lives.values():
        for s, d in lc["service"].items():
            svc_tot[s] = svc_tot.get(s, 0.0) + d
        for s, d in lc["queue"].items():
            q_tot[s] = q_tot.get(s, 0.0) + d
    lines.append("")
    lines.append("stage breakdown (summed over traced batches):")
    for s, d in sorted(svc_tot.items(), key=lambda kv: -kv[1]):
        lines.append(f"  service      {s:<24} {d * 1e3:10.3f} ms")
    for s, d in sorted(q_tot.items(), key=lambda kv: -kv[1]):
        lines.append(f"  queue-wait   {s:<24} {d * 1e3:10.3f} ms")
    thr_s = sum(b1 - b0 for b0, b1, _ in throttles)
    if throttles:
        lines.append(f"  governor-throttle {len(throttles)} episodes "
                     f"{thr_s * 1e3:10.3f} ms")
    res_s = sum(b1 - b0 for b0, b1, _ in restores)
    if restores:
        lines.append(f"  restart/restore   {len(restores)} restores "
                     f"{res_s * 1e3:10.3f} ms")
    if shed_pos:
        lines.append(f"  shed              {len(shed_pos)} batches "
                     f"(admission) at pos "
                     f"{sorted(p for p in shed_pos if p is not None)}")
    if dead_pos:
        lines.append(f"  dead-letter       {len(dead_pos)} batches at pos "
                     f"{sorted(p for p in dead_pos if p is not None)}")
    if late_drops:
        lines.append("")
        lines.append("event-time drops (lateness_drop journal; joined to "
                     "traced batches by the sampled readback's coordinates):")
        for e in late_drops:
            where = ""
            if e.get("pos") is not None:
                tid = e.get("tid")
                traced = tid is not None and int(tid) in lives
                where = (f"  at/before pos={e['pos']}"
                         f" (batch {int(tid):#x}"
                         f"{', traced' if traced else ''})"
                         if tid is not None else f"  at/before pos={e['pos']}")
            lines.append(f"  {e.get('op', '?'):<24} {e.get('kind', '?'):<16} "
                         f"+{e.get('n', 0)} (total {e.get('total', '?')})"
                         f"{where}")

    # -- per-tenant wire-to-sink attribution (serving) --------------------
    by_tenant: Dict[str, list] = {}
    for lc in lives.values():
        if lc.get("tenant") is not None:
            by_tenant.setdefault(str(lc["tenant"]), []).append(lc)
    if by_tenant:
        lines.append("")
        lines.append("per-tenant wire-to-sink attribution (serving ingest; "
                     "wire = client send -> socket receipt, queue = receipt "
                     "-> drive pickup + ring waits, service = stage spans):")

        def _segments(lc) -> dict:
            wire = (lc.get("wire_ms") or 0.0) / 1e3
            qsrc = (lc.get("queue_ms") or 0.0) / 1e3
            svc = sum(lc["service"].values())
            qring = sum(lc["queue"].values())
            t0, t1 = lc["t_ingest"], lc["t_end"]
            host = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
            return {"wire": wire, "queue": qsrc + qring, "service": svc,
                    "e2e": wire + qsrc + host}

        for tenant, lcs in sorted(by_tenant.items()):
            segs = [_segments(lc) for lc in lcs]
            shed_n = sum(1 for lc in lcs if _is_shed(lc))
            head = f"  tenant {tenant!r}: {len(lcs)} traced requests"
            if shed_n:
                head += f"  ({shed_n} shed at admission)"
            lines.append(head)
            worst_seg, worst_max = "", -1.0
            for name in ("wire", "queue", "service", "e2e"):
                vals = [s[name] for s in segs]
                avg, mx = sum(vals) / len(vals), max(vals)
                lines.append(f"    {name:<8} avg={avg * 1e3:10.3f} ms  "
                             f"max={mx * 1e3:10.3f} ms")
                if name != "e2e" and mx > worst_max:
                    worst_seg, worst_max = name, mx
            slowest = max(zip(segs, lcs), key=lambda p: p[0]["e2e"])
            lines.append(f"    slowest segment: {worst_seg}  "
                         f"(worst request: batch {slowest[1]['tid']:#x} "
                         f"seq={slowest[1].get('seq')} "
                         f"e2e={slowest[0]['e2e'] * 1e3:.3f} ms)")

    # -- dispatch-bound classifier (health monitoring) --------------------
    health = (snapshot or {}).get("health") or {}
    dt = health.get("device_time") or {}
    if dt:
        lines.append("")
        lines.append("device-time attribution (health ledger; sampled "
                     "host-dispatch vs device ms per stage):")
        bound = health.get("dispatch_bound") or {}
        for stage, row in sorted(dt.items(),
                                 key=lambda kv: -(kv[1].get("dispatch_ratio")
                                                  or 0.0)):
            ratio = row.get("dispatch_ratio")
            flag = "  [DISPATCH-BOUND -> fusion candidate]" \
                if stage in bound else ""
            lines.append(
                f"  {stage:<24} device={row.get('device_ms', 0):10.3f} ms  "
                f"dispatch={row.get('dispatch_ms', 0):10.3f} ms  "
                f"ratio={ratio if ratio is not None else '—'}{flag}")
        comp = health.get("compile") or {}
        if comp:
            lines.append(
                f"  compile ledger: {comp.get('compiles', 0)} compiles "
                f"({comp.get('retraces', 0)} shape retraces, "
                f"{comp.get('retraces_unexpected', 0)} UNEXPECTED), "
                f"{comp.get('compile_s_total', 0)} s total")

    # -- per-batch phase attribution --------------------------------------
    def phases(lc) -> dict:
        t0, t1 = lc["t_ingest"], lc["t_end"]
        if t0 is None or t1 is None:
            return {"total": 0.0, "service": 0.0, "queue": 0.0,
                    "throttle": 0.0, "restart": 0.0, "other": 0.0}
        total = t1 - t0
        svc = sum(lc["service"].values())
        q = sum(lc["queue"].values())
        thr = _overlap(t0, t1, throttles)
        res = _overlap(t0, t1, restores)
        return {"total": total, "service": svc, "queue": q, "throttle": thr,
                "restart": res,
                "other": max(total - svc - q - thr - res, 0.0)}

    def flags(lc) -> str:
        f = []
        if lc.get("fused"):
            # service figures are the batch's 1/k share of fused launches
            f.append("FUSED")
        if _is_shed(lc):
            f.append("SHED")
        if lc["pos"] in dead_pos:
            f.append("DEAD-LETTER")
        if lc["aborts"] or _overlap(lc["t_ingest"] or 0.0,
                                    lc["t_end"] or 0.0, restores) > 0.0:
            f.append("RESTART-AFFECTED")
        return ",".join(f)

    def render(lc, prefix="  ") -> List[str]:
        ph = phases(lc)
        head = (f"{prefix}batch {lc['tid']:#x} pos={lc['pos']} "
                f"total={ph['total'] * 1e3:.3f} ms"
                + (f"  [{flags(lc)}]" if flags(lc) else ""))
        parts = (f"{prefix}  service={ph['service'] * 1e3:.3f} ms  "
                 f"queue-wait={ph['queue'] * 1e3:.3f} ms  "
                 f"throttle={ph['throttle'] * 1e3:.3f} ms  "
                 f"restart={ph['restart'] * 1e3:.3f} ms  "
                 f"other={ph['other'] * 1e3:.3f} ms")
        out = [head, parts]
        for s, n in sorted(lc["attempts"].items()):
            if n > 1:
                out.append(f"{prefix}  {s}: {n} attempts "
                           f"({lc['aborts']} aborted spans)")
        return out

    slow = sorted(lives.values(), key=lambda lc: -phases(lc)["total"])[:top]
    lines.append("")
    lines.append(f"slowest {len(slow)} traced batches:")
    for lc in slow:
        lines.extend(render(lc))

    # -- exemplars vs snapshot --------------------------------------------
    if snapshot:
        e2e = snapshot.get("e2e_latency_us") or {}
        ex = e2e.get("p99_exemplar")
        lines.append("")
        if ex is not None:
            lines.append(f"p99 exemplar (snapshot e2e histogram, "
                         f"p99={e2e.get('p99')} us): batch {int(ex):#x}")
            lc = lives.get(int(ex))
            if lc is not None:
                lines.extend(render(lc, prefix="    "))
            else:
                lines.append("    (exemplar batch outside the flight "
                             "recorder's retained window)")
        else:
            lines.append("no e2e p99 exemplar in snapshot (tracing and "
                         "monitoring must run together for exemplars)")
    return "\n".join(lines)

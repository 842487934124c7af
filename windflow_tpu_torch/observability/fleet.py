"""Fleet telemetry: live streaming aggregation and fleet-level SLOs.

Counterpart of ``windflow_tpu/observability/fleet.py``, a copy of it (that
module imports no JAX, but the port imports nothing of the JAX package):

- :class:`TelemetryAgent` rides each host's Reporter tick: the snapshot and
  the journal delta since the last tick go as one length-framed JSON frame
  to an aggregator over TCP or a Unix socket, from a sender thread behind a
  bounded drop-oldest outbox (a slow or dead aggregator costs frames,
  counted in ``frames_dropped``, never Reporter cadence).
- :class:`FleetAggregator` (``scripts/wf_fleet.py serve``) accepts any
  number of host streams, folds them with
  ``device_health.merge_snapshots``, evaluates fleet-level SLOs over the
  merged view (:class:`FleetSLOEngine`) and writes ``snapshot.json``,
  ``snapshots.jsonl``, ``events.jsonl`` and ``metrics.prom`` in the
  Reporter's schema.

Wire framing: ``b"WFT1 " + 8 hex digits (payload length) + b"\\n" + payload
+ b"\\n"``, the payload one UTF-8 JSON object; a reader that lands
mid-stream resyncs at the next magic and counts ``frames_torn``. The frames
are the JAX package's byte for byte, so either package's aggregator reads
either package's hosts. Stdlib only.
"""


from __future__ import annotations

import collections
import json
import os
import socket
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from . import device_health as _device_health
from . import journal as _journal
from . import slo as _slo

# --------------------------------------------------------------- wire format

#: frame magic — the resync point for readers that land mid-stream
MAGIC = b"WFT1 "
_LEN_DIGITS = 8
_HEADER_LEN = len(MAGIC) + _LEN_DIGITS + 1
#: hard per-frame cap: a corrupt length field must not make the decoder
#: buffer gigabytes waiting for a frame that never completes
MAX_FRAME_BYTES = 64 << 20
#: per-tick cap on the journal delta an agent ships (a journal burst —
#: restart storm, chatty tracing — degrades to a gap, never a huge frame)
_MAX_JOURNAL_DELTA = 1 << 20


def encode_frame(obj: dict) -> bytes:
    """One length-framed JSON frame (see the module docstring's grammar)."""
    payload = json.dumps(obj, default=str).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"frame payload {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    return MAGIC + b"%0*x" % (_LEN_DIGITS, len(payload)) + b"\n" \
        + payload + b"\n"


class FrameDecoder:
    """Incremental frame parser, torn-input tolerant.

    ``feed(data)`` returns the complete frames decoded so far; bytes that do
    not parse (mid-stream join, torn send, corrupt length, bad JSON) are
    skipped to the next ``MAGIC`` and counted in ``frames_torn`` — the
    stream self-heals at the next intact frame."""

    def __init__(self):
        self._buf = bytearray()
        self.frames_decoded = 0
        self.frames_torn = 0

    def feed(self, data: bytes) -> List[dict]:
        self._buf += data
        out: List[dict] = []
        while True:
            i = self._buf.find(MAGIC)
            if i < 0:
                # no magic in the buffer: keep only a possible magic PREFIX
                # at the tail, drop the rest as torn noise
                keep = len(MAGIC) - 1
                if len(self._buf) > keep:
                    del self._buf[:len(self._buf) - keep]
                    self.frames_torn += 1
                return out
            if i > 0:
                del self._buf[:i]          # resync: skip torn bytes
                self.frames_torn += 1
            if len(self._buf) < _HEADER_LEN:
                return out                 # header still in flight
            hexlen = self._buf[len(MAGIC):len(MAGIC) + _LEN_DIGITS]
            try:
                n = int(bytes(hexlen), 16)
            except ValueError:
                n = -1
            if (n < 0 or n > MAX_FRAME_BYTES
                    or self._buf[_HEADER_LEN - 1:_HEADER_LEN] != b"\n"):
                del self._buf[:len(MAGIC)]  # corrupt header: resync past it
                self.frames_torn += 1
                continue
            if len(self._buf) < _HEADER_LEN + n + 1:
                return out                 # payload still in flight
            payload = bytes(self._buf[_HEADER_LEN:_HEADER_LEN + n])
            trailer = self._buf[_HEADER_LEN + n:_HEADER_LEN + n + 1]
            if trailer != b"\n":
                del self._buf[:len(MAGIC)]  # length lied: resync
                self.frames_torn += 1
                continue
            del self._buf[:_HEADER_LEN + n + 1]
            try:
                obj = json.loads(payload)
            except ValueError:
                self.frames_torn += 1
                continue
            self.frames_decoded += 1
            out.append(obj)


def parse_endpoint(endpoint: str) -> Tuple[str, ...]:
    """Parse a telemetry endpoint string into ``("tcp", host, port)`` or
    ``("unix", path)``.

    Accepted forms: ``tcp://HOST:PORT``, bare ``HOST:PORT``, and
    ``unix://PATH`` / ``unix:PATH``.  Raises ``ValueError`` on anything
    else — the validator reports an unparseable configured endpoint as
    WF117 before the run."""
    s = str(endpoint or "").strip()
    if not s:
        raise ValueError("empty telemetry endpoint (expected tcp://HOST:PORT"
                         ", HOST:PORT, or unix://PATH)")
    if s.startswith("unix://"):
        path = s[len("unix://"):]
    elif s.startswith("unix:"):
        path = s[len("unix:"):]
    else:
        path = None
    if path is not None:
        if not path:
            raise ValueError(f"unix endpoint {endpoint!r} has an empty path")
        return ("unix", path)
    if s.startswith("tcp://"):
        s = s[len("tcp://"):]
    host, sep, port_s = s.rpartition(":")
    if not sep or not host:
        raise ValueError(f"unparseable telemetry endpoint {endpoint!r} "
                         f"(expected tcp://HOST:PORT, HOST:PORT, or "
                         f"unix://PATH)")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"telemetry endpoint {endpoint!r}: port {port_s!r} "
                         f"is not an integer") from None
    if not 0 <= port <= 65535:
        raise ValueError(f"telemetry endpoint {endpoint!r}: port {port} "
                         f"out of range")
    return ("tcp", host.strip("[]"), port)


def _connect(parsed: Tuple[str, ...], timeout: float) -> socket.socket:
    if parsed[0] == "unix":
        sk = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sk.settimeout(timeout)
        sk.connect(parsed[1])
    else:
        sk = socket.create_connection((parsed[1], parsed[2]),
                                      timeout=timeout)
    sk.settimeout(timeout)
    return sk


def _atomic_write(path: str, data: str) -> None:
    """tmp + flush + fsync + rename — readers never observe a torn file
    (the reporter.py/slo.py discipline, duplicated so this module stays
    loadable by file path without the package)."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass


# ------------------------------------------------------------ host-side agent

class TelemetryAgent:
    """Host side of the telemetry plane: a bounded non-blocking bridge from
    the Reporter tick to the aggregator socket.

    ``offer(snap)`` is called by the Reporter thread right after it wrote
    the tick's artifacts; it assembles one frame (snapshot + journal delta +
    incident-bundle references) and appends it to a ``deque(maxlen=outbox)``
    — a full outbox silently evicts the OLDEST frame (counted in
    ``frames_dropped``), so the Reporter's cadence is independent of the
    aggregator's health by construction.  A daemon sender thread drains the
    outbox, reconnecting with capped backoff; connect/loss transitions are
    journaled (``telemetry_connect`` / ``telemetry_lost``).

    Constructor raises ``ValueError`` on a missing/unparseable endpoint or
    an ``outbox < 1`` — loudly at Monitor construction, the SLO-engine
    convention; ``validate()`` reports the same problems as WF117 before
    the run."""

    def __init__(self, endpoint: str, host: str,
                 out_dir: Optional[str] = None, outbox: int = 64,
                 journal_path: Optional[str] = None,
                 journal: Optional[_journal.EventJournal] = None,
                 connect_timeout_s: float = 2.0,
                 reconnect_max_s: float = 2.0):
        self.parsed = parse_endpoint(endpoint)   # ValueError -> WF117
        if int(outbox) < 1:
            raise ValueError(f"telemetry_outbox/WF_TELEMETRY_OUTBOX must be "
                             f">= 1, got {outbox} (the validator reports "
                             f"this as WF117 before the run)")
        self.endpoint = str(endpoint)
        self.host = str(host)
        self.out_dir = out_dir
        self.connect_timeout_s = float(connect_timeout_s)
        self.reconnect_max_s = float(reconnect_max_s)
        self._journal_path = journal_path
        self._journal_off = 0                 # reporter-thread only
        self._journal = journal
        self._seq = 0                         # reporter-thread only
        self._lock = threading.Lock()
        self._outbox: Deque[dict] = collections.deque(maxlen=int(outbox))
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None  # wf-lint: single-writer[driver, telemetry]
        # counters below are guarded by _lock (written on both the reporter
        # and the sender thread, read by stats())
        self._frames_sent = 0
        self._frames_dropped = 0
        self._connects = 0
        self._connected = False
        self._thread: Optional[threading.Thread] = None

    # -- reporter-thread side ---------------------------------------------

    def offer(self, snap: dict) -> None:
        """Enqueue one tick's frame.  NEVER blocks: the only synchronized
        work is a deque append under an uncontended lock."""
        frame = {"kind": "snap", "host": self.host, "seq": self._seq + 1,
                 "mon_dir": self.out_dir, "snap": snap,
                 "journal": self._read_journal_delta(),
                 "incidents": self._incident_refs()}
        self._seq += 1
        with self._lock:
            if len(self._outbox) == self._outbox.maxlen:
                self._frames_dropped += 1     # deque drops the oldest
            self._outbox.append(frame)
        self._wake.set()

    def _read_journal_delta(self) -> List[dict]:
        """New COMPLETE journal lines since the last tick (file-offset
        tailing; a torn in-flight append waits for the next tick — the
        loader convention).  Bounded per tick so a journal burst degrades
        to a gap, never a huge frame."""
        path = self._journal_path
        if not path:
            return []
        try:
            size = os.path.getsize(path)
            if size < self._journal_off:      # rotation/restart: start over
                self._journal_off = 0
            with open(path, "rb") as f:
                f.seek(self._journal_off)
                data = f.read(_MAX_JOURNAL_DELTA)
        except OSError:
            return []
        end = data.rfind(b"\n")
        if end < 0:
            return []
        self._journal_off += end + 1
        out = []
        for line in data[:end + 1].splitlines():
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
        return out

    def _incident_refs(self) -> Optional[List[str]]:
        """This host's committed incident-bundle paths — shipped with every
        frame so the aggregator can reference them from a fleet incident's
        ``correlation.json`` without filesystem access to the host."""
        if not self.out_dir:
            return None
        d = os.path.join(self.out_dir, "incidents")
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return None
        return [os.path.join(d, n) for n in names]

    # -- sender-thread side ------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(  # wf-lint: thread-role[telemetry]
            target=self._run, name=f"wf-telemetry-{self.host}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        backoff = 0.05
        while True:
            frame = self._pop()
            if frame is None:
                if self._stop.is_set():
                    return
                self._wake.wait(0.2)
                self._wake.clear()
                continue
            if not self._ensure_connected():
                self._requeue(frame)
                if self._stop.is_set():
                    return                # dead aggregator at close: give up
                self._stop.wait(backoff)
                backoff = min(self.reconnect_max_s, backoff * 2)
                continue
            backoff = 0.05
            try:
                self._sock.sendall(encode_frame(frame))
                with self._lock:
                    self._frames_sent += 1
            except (OSError, ValueError):
                self._drop_socket()
                self._requeue(frame)

    def _pop(self) -> Optional[dict]:
        with self._lock:
            return self._outbox.popleft() if self._outbox else None

    def _requeue(self, frame: dict) -> None:
        with self._lock:
            if len(self._outbox) == self._outbox.maxlen:
                self._frames_dropped += 1   # outbox refilled meanwhile
            else:
                self._outbox.appendleft(frame)

    def _ensure_connected(self) -> bool:
        if self._sock is not None:
            return True
        try:
            self._sock = _connect(self.parsed, self.connect_timeout_s)
        except OSError:
            return False
        with self._lock:
            self._connects += 1
            self._connected = True
        if self._journal is not None:
            self._journal.event("telemetry_connect", host=self.host,
                                endpoint=self.endpoint)
        return True

    def _drop_socket(self) -> None:
        sk, self._sock = self._sock, None
        if sk is not None:
            try:
                sk.close()
            except OSError:
                pass
        with self._lock:
            was = self._connected
            self._connected = False
        if was and self._journal is not None:
            self._journal.event("telemetry_lost", host=self.host,
                                endpoint=self.endpoint)

    def stats(self) -> dict:
        """The ``telemetry`` snapshot section / ``windflow_telemetry_*``
        gauges (names.py::TELEMETRY_GAUGES lockstep — keep in sync)."""
        with self._lock:
            return {"frames_sent": self._frames_sent,
                    "frames_dropped": self._frames_dropped,
                    "reconnects": max(0, self._connects - 1),
                    "outbox_depth": len(self._outbox),
                    "connected": 1 if self._connected else 0}

    def close(self, flush_s: float = 1.0) -> None:
        """Stop the sender, draining the outbox for at most ``flush_s``
        (best-effort: a dead aggregator must not delay run teardown)."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=max(0.0, float(flush_s)))
        self._drop_socket()


# ----------------------------------------------------------- fleet SLO engine

class FleetSLOEngine(_slo.SLOEngine):
    """The SLO engine's burn-rate math evaluated over the MERGED fleet snapshot.

    Burn math, state machine, rate limiting, and bundle commit discipline
    are inherited unchanged; the only addition is ``correlation.json`` in
    every fleet incident bundle — which hosts paged in the same window,
    with their own monitoring dirs and committed bundle paths, so a fleet
    page fans out to the per-host forensics in one hop."""

    def __init__(self, specs, out_dir, host_forensics:
                 Callable[[], List[dict]], **kw):
        super().__init__(specs, out_dir, **kw)
        self._host_forensics = host_forensics

    def _extra_bundle_files(self, st, snap: dict) -> dict:
        # the merged HOST fold (worst_host/pages_by_host), not the fleet
        # engine's own rows — by capture time snap["slo"] holds the latter
        row = (self._incoming_slo or snap.get("slo")
               or {}).get(st.spec.name) or {}
        pages_by_host = row.get("pages_by_host") or {}
        hosts = []
        for h in self._host_forensics():
            hrow = (h.get("slo") or {}).get(st.spec.name) or {}
            burn = hrow.get("burn_fast")
            hosts.append({
                "host": h.get("host"),
                "mon_dir": h.get("mon_dir"),
                "state": hrow.get("state"),
                "burn_fast": burn,
                "pages": hrow.get("pages", 0),
                "bundles": h.get("incidents") or [],
                # correlated = this host is burning on the same SLO in the
                # current window — the fleet page's cause.  Its own STICKY
                # page state lags by up to a frame (the snapshot carrying
                # the transition arrives after the one whose burn caused
                # it), so a host already at page-rate burn or in WARN
                # counts too; healthy hosts sit at state "ok"/burn 0.
                "correlated": bool(
                    hrow.get("state") in (_slo.STATE_PAGE, _slo.STATE_WARN)
                    or pages_by_host.get(h.get("host"))
                    or (burn is not None
                        and burn >= float(st.spec.page_burn))),
            })
        return {"correlation.json": {
            "fleet_slo": st.spec.name, "signal": st.spec.signal,
            "tick": self._tick, "worst_host": row.get("worst_host"),
            "pages_by_host": pages_by_host, "hosts": hosts,
        }}


# --------------------------------------------------------------- aggregator

#: the ``fleet`` snapshot section / ``windflow_fleet_*`` gauges
#: (names.py::FLEET_GAUGES lockstep — keep in sync)
_FLEET_HELP = {
    "hosts_connected": "hosts with a live telemetry stream right now",
    "hosts_seen": "distinct host tags seen since the aggregator started",
    "frames_received": "telemetry frames decoded across all hosts",
    "frames_torn": "wire bytes lost to torn/corrupt frames (resync'd)",
    "ticks": "fleet merge ticks emitted",
}


class FleetAggregator:
    """Accepts host telemetry streams and maintains the rolling fleet view.

    One fleet tick = one ``merge_snapshots`` fold over every host's latest
    snapshot, SLO-judged and written to ``out_dir`` in the Reporter's exact
    artifact schema.  A tick is emitted as soon as every CONNECTED host has
    delivered a fresh snapshot since the last tick (round-complete — the
    fleet tick rate follows the slowest live host), or after
    ``max_skew_s`` with at least one fresh snapshot (straggler timeout, so
    one wedged host cannot freeze the fleet view).  Host journal deltas are
    re-emitted host-tagged into the fleet ``events.jsonl``.

    Join/leave/restart tolerant: hosts are keyed by the tag their frames
    carry; a reconnecting host resumes its slot, and a departed host's last
    snapshot stays in the merged view (its absence is visible via
    ``fleet.hosts_connected`` vs ``merged_from``)."""

    def __init__(self, listen: str, out_dir: str, specs=None,
                 max_skew_s: float = 1.0, cooldown_s: float = 60.0,
                 max_incidents: int = 8, snapshot_keep: Optional[int] = None):
        self.parsed = parse_endpoint(listen)
        self.out_dir = out_dir
        self.max_skew_s = float(max_skew_s)
        self.snapshot_keep = (None if snapshot_keep is None
                              else max(1, int(snapshot_keep)))
        os.makedirs(out_dir, exist_ok=True)
        events_path = os.path.join(out_dir, "events.jsonl")
        self._journal = _journal.EventJournal(events_path)
        self.engine: Optional[FleetSLOEngine] = None
        specs = _slo.resolve_specs(specs) if specs is not None else None
        if specs:
            self.engine = FleetSLOEngine(
                specs, out_dir, self._host_forensics_locked,
                cooldown_s=cooldown_s, max_incidents=max_incidents,
                journal_path=events_path)
            # fleet transitions go to the fleet journal, never the
            # process-global active journal (this process may also be a host)
            self.engine.journal_sink = self._journal
        self._lock = threading.Lock()
        #: per-host state: {tag: {snap, seq, mon_dir, incidents, connected,
        #: fresh, last_rx}} — guarded by _lock
        self._hosts: Dict[str, dict] = {}  # wf-lint: guarded-by[_lock]
        self._frames_received = 0
        self._frames_torn = 0
        self._ticks = 0
        self._jsonl_lines = 0
        self._first_fresh_t: Optional[float] = None
        self._started = time.monotonic()  # wf-lint: allow[wall-clock] timing-only: uptime display
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self.address: Optional[Tuple[str, ...]] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.parsed[0] == "unix":
            path = self.parsed[1]
            try:
                os.unlink(path)              # stale socket from a dead serve
            except OSError:
                pass
            sk = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sk.bind(path)
            self.address = ("unix", path)
        else:
            sk = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sk.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sk.bind((self.parsed[1], self.parsed[2]))
            self.address = ("tcp",) + sk.getsockname()[:2]
        sk.listen(64)
        # accept wakes every 0.2 s to see stop(): closing a listener does
        # not wake a thread blocked in accept()
        sk.settimeout(0.2)
        self._listener = sk
        for target, name in ((self._accept_loop, "wf-fleet-accept"),
                             (self._ticker, "wf-fleet-ticker")):
            t = threading.Thread(  # wf-lint: thread-role[telemetry]
                target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    @property
    def endpoint(self) -> str:
        """The BOUND endpoint as a client string (resolves port 0)."""
        a = self.address or self.parsed
        return f"unix://{a[1]}" if a[0] == "unix" else f"tcp://{a[1]}:{a[2]}"

    def stats(self) -> dict:
        """The fleet counters (the ``_FLEET_HELP`` /
        ``names.FLEET_GAUGES`` set) — the same numbers every fleet
        snapshot carries under ``snap["fleet"]``."""
        with self._lock:
            return {
                "hosts_connected": sum(1 for h in self._hosts.values()
                                       if h["connected"]),
                "hosts_seen": len(self._hosts),
                "frames_received": self._frames_received,
                "frames_torn": self._frames_torn,
                "ticks": self._ticks,
            }

    def stop(self) -> None:
        self._stop.set()
        lst, self._listener = self._listener, None
        if lst is not None:
            try:
                lst.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)
        with self._lock:
            if any(h["fresh"] for h in self._hosts.values()):
                self._emit_locked()          # final partial round
        if self.parsed[0] == "unix":
            try:
                os.unlink(self.parsed[1])
            except OSError:
                pass
        self._journal.close()

    # -- socket side -------------------------------------------------------

    def _accept_loop(self) -> None:
        lst = self._listener
        while not self._stop.is_set():
            try:
                conn, _addr = lst.accept()
            except socket.timeout:
                continue
            except OSError:
                return                       # listener closed by stop()
            t = threading.Thread(  # wf-lint: thread-role[telemetry]
                target=self._reader, args=(conn,),
                name="wf-fleet-reader", daemon=True)
            t.start()
            self._threads.append(t)

    def _reader(self, conn: socket.socket) -> None:
        dec = FrameDecoder()
        tag: Optional[str] = None
        conn.settimeout(0.5)
        try:
            while not self._stop.is_set():
                try:
                    data = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break                    # peer EOF
                for frame in dec.feed(data):
                    tag = self._on_frame(frame, tag)
                if dec.frames_torn:
                    with self._lock:
                        self._frames_torn += dec.frames_torn
                    dec.frames_torn = 0
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if tag is not None:
                with self._lock:
                    h = self._hosts.get(tag)
                    if h is not None:
                        h["connected"] = False
                self._journal.event("fleet_host_leave", host=tag)

    def _on_frame(self, frame: dict, tag: Optional[str]) -> Optional[str]:
        host = frame.get("host")
        if not isinstance(host, str) or frame.get("kind") != "snap":
            with self._lock:
                self._frames_torn += 1       # structurally valid JSON,
            return tag                       # semantically not a frame
        joined = False
        with self._lock:
            h = self._hosts.get(host)
            if h is None:
                h = self._hosts[host] = {"snap": None, "seq": -1,
                                         "mon_dir": None, "incidents": [],
                                         "connected": False, "fresh": False,
                                         "last_rx": 0.0}
                joined = True
            h["connected"] = True
            h["last_rx"] = time.monotonic()  # wf-lint: allow[wall-clock] timing-only: staleness display
            seq = frame.get("seq")
            if isinstance(seq, int):
                h["seq"] = seq               # informational (restart shows
            if frame.get("snap") is not None:  # as a seq reset in the logs)
                h["snap"] = frame["snap"]
                h["fresh"] = True
                if self._first_fresh_t is None:
                    self._first_fresh_t = time.monotonic()  # wf-lint: allow[wall-clock] timing-only: skew-gate cadence
            h["mon_dir"] = frame.get("mon_dir") or h["mon_dir"]
            if frame.get("incidents"):
                h["incidents"] = frame["incidents"]
            self._frames_received += 1
            round_complete = all(st["fresh"] for st in self._hosts.values()
                                 if st["connected"])
        if joined:
            self._journal.event("fleet_host_join", host=host,
                                mon_dir=frame.get("mon_dir"))
        for rec in frame.get("journal") or []:
            if not isinstance(rec, dict):
                continue
            fields = {k: v for k, v in rec.items()
                      if k not in ("event", "name", "t", "wall", "host")}
            self._journal.event(str(rec.get("event", "?")), host=host,
                                src_wall=rec.get("wall"), **fields)
        if round_complete:
            with self._lock:
                if any(st["fresh"] for st in self._hosts.values()):
                    self._emit_locked()
        return host

    def _ticker(self) -> None:
        """Straggler timeout: a round that stays incomplete for
        ``max_skew_s`` is emitted with whatever is fresh — one wedged or
        departed host cannot freeze the fleet view."""
        poll = max(0.05, self.max_skew_s / 4.0)
        while not self._stop.wait(poll):
            with self._lock:
                t0 = self._first_fresh_t
                if (t0 is not None
                        and time.monotonic() - t0 >= self.max_skew_s):  # wf-lint: allow[wall-clock] timing-only: emit cadence
                    self._emit_locked()

    # -- fleet tick --------------------------------------------------------

    def _host_forensics_locked(self) -> List[dict]:
        """Per-host correlation context for FleetSLOEngine — called from
        ``engine.observe`` INSIDE ``_emit_locked``, so ``_lock`` is already
        held."""
        out = []
        # _lock held by caller (see docstring)
        for tag in sorted(self._hosts):      # wf-lint: allow[unguarded]
            h = self._hosts[tag]             # wf-lint: allow[unguarded]
            out.append({"host": tag, "mon_dir": h["mon_dir"],
                        "incidents": h["incidents"],
                        "slo": (h["snap"] or {}).get("slo")})
        return out

    def _emit_locked(self) -> None:
        # _locked suffix = caller (the tick emitters) already holds _lock
        tags = [t for t in sorted(self._hosts)       # wf-lint: allow[unguarded]
                if self._hosts[t]["snap"] is not None]  # wf-lint: allow[unguarded]
        if not tags:
            return
        snaps = [self._hosts[t]["snap"] for t in tags]  # wf-lint: allow[unguarded]
        merged = _device_health.merge_snapshots(snaps, hosts=tags)
        # enrich the merge's provenance rows with the streaming-plane
        # facts only the aggregator knows (where each host's own
        # artifacts/bundles live, whether its socket is still up)
        for row in merged.get("hosts", []):
            h = self._hosts.get(row.get("host"))  # wf-lint: allow[unguarded]
            if h is not None:
                row["mon_dir"] = h["mon_dir"]
                row["connected"] = bool(h["connected"])
        merged["wall_time"] = time.time()  # wf-lint: allow[wall-clock] timing-only: report stamp
        merged["uptime_s"] = round(time.monotonic() - self._started, 3)  # wf-lint: allow[wall-clock] timing-only: uptime display
        self._ticks += 1
        merged["fleet"] = {
            "hosts_connected": sum(1 for h in self._hosts.values()  # wf-lint: allow[unguarded]
                                   if h["connected"]),
            "hosts_seen": len(self._hosts),  # wf-lint: allow[unguarded]
            "frames_received": self._frames_received,
            "frames_torn": self._frames_torn,
            "ticks": self._ticks,
        }
        if self.engine is not None:
            try:
                self.engine.observe(merged)
            except Exception as e:  # noqa: BLE001 — a judging bug must not
                merged["slo_error"] = str(e)   # kill the aggregation plane
        for h in self._hosts.values():       # wf-lint: allow[unguarded]
            h["fresh"] = False
        self._first_fresh_t = None
        self._write_artifacts(merged)

    def _write_artifacts(self, merged: dict) -> None:
        data = json.dumps(merged, default=str)
        _atomic_write(os.path.join(self.out_dir, "snapshot.json"), data)
        series = os.path.join(self.out_dir, "snapshots.jsonl")
        with open(series, "a") as f:
            f.write(data + "\n")
        self._jsonl_lines += 1
        keep = self.snapshot_keep
        if keep is not None and self._jsonl_lines >= 2 * keep:
            try:                             # amortized trim, atomic rewrite
                with open(series) as f:
                    lines = f.readlines()[-keep:]
                _atomic_write(series, "".join(lines))
                self._jsonl_lines = len(lines)
            except OSError:
                pass
        _atomic_write(os.path.join(self.out_dir, "metrics.prom"),
                      render_prometheus(merged))


# ------------------------------------------------------ prometheus rendering

def render_prometheus(snap: dict) -> str:
    """Text exposition for a MERGED fleet snapshot — the subset of the
    Reporter's families that survive the fold (fleet/slo gauges, queue
    depths, the merged e2e percentiles); per-operator histograms need the
    live LogHistograms and stay a host-Reporter concern."""
    esc = lambda s: str(s).replace("\\", r"\\").replace('"', r'\"')  # noqa: E731
    g = snap.get("graph", "?")
    lines: List[str] = []
    fleet = snap.get("fleet") or {}
    for name in sorted(_FLEET_HELP):
        if name in fleet:
            lines.append(f"# HELP windflow_fleet_{name} {_FLEET_HELP[name]}")
            lines.append(f"# TYPE windflow_fleet_{name} gauge")
            lines.append(f'windflow_fleet_{name}{{graph="{esc(g)}"}} '
                         f'{fleet[name]}')
    sec = snap.get("slo") or {}
    typed = set()

    def head(name):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE windflow_slo_{name} gauge")

    for slo_name, row in sorted(sec.items()):
        lab = f'graph="{esc(g)}",slo="{esc(slo_name)}"'
        for name in ("burn_fast", "burn_slow", "signal", "target", "pages"):
            v = row.get(name)
            if v is not None:
                head(name)
                lines.append(f'windflow_slo_{name}{{{lab}}} {v}')
        if row.get("code") is not None:
            head("state")
            lines.append(f'windflow_slo_state{{{lab}}} {row["code"]}')
    queues = snap.get("queues") or {}
    if queues:
        lines.append("# TYPE windflow_queue_depth gauge")
        for edge, depth in queues.items():
            lines.append(f'windflow_queue_depth{{graph="{esc(g)}",'
                         f'edge="{esc(edge)}"}} {depth}')
    e2e = snap.get("e2e_latency_us") or {}
    for pct in ("p50", "p95", "p99"):
        if e2e.get(pct) is not None:
            lines.append(f"# TYPE windflow_e2e_latency_{pct}_us gauge")
            lines.append(f'windflow_e2e_latency_{pct}_us'
                         f'{{graph="{esc(g)}"}} {e2e[pct]}')
    return "\n".join(lines) + "\n"

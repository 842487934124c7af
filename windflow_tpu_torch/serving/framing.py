"""Serving wire format — length-framed binary record frames.

Counterpart of ``windflow_tpu/serving/framing.py``, a copy: the two
packages' frames are byte-identical, so either package's client drives
either package's server.

The ingest counterpart of the fleet telemetry plane's WFT1 frames
(``observability/fleet.py``): same magic + hex-length + resync discipline,
but the payload carries **binary records** (rows of one fixed numpy
structured dtype — the ``RecordSource`` AoS framing), not JSON snapshots.

Frame grammar (all ASCII except the record bytes)::

    b"WFS1 " <8 hex digits: payload length> b"\\n" <payload> b"\\n"
    payload := <meta JSON line terminated by b"\\n"> <raw record bytes>

The meta line names the frame's **tenant** (the multi-tenant label every
downstream plane keys on), a per-tenant monotonically increasing **seq**
(the dedup coordinate — a reconnecting client may re-send its unacked tail
and the receiver drops already-seen seqs, so peer kills degrade to replay,
never duplication), a **kind** (``data`` / ``eos`` / ``swap``) and the
record byte count (cross-checked against the frame — a length that lies is
a torn frame, resync'd like any other).

A reader that lands mid-stream (or receives torn/garbage bytes from a
killed peer) skips to the next ``WFS1 `` magic and counts the gap in
``frames_torn`` — the stream self-heals at the next intact frame, the
``FrameDecoder.feed`` contract.

Stdlib only, as the JAX package's copy that ``scripts/wf_serve.py`` loads
by file path.
"""

from __future__ import annotations

import json
import socket
import time
from typing import Dict, List, Optional, Tuple

#: frame magic — the resync point for readers that land mid-stream
MAGIC = b"WFS1 "
_LEN_DIGITS = 8
_HEADER_LEN = len(MAGIC) + _LEN_DIGITS + 1
#: hard per-frame cap: a corrupt length field must not make the decoder
#: buffer gigabytes waiting for a frame that never completes
MAX_FRAME_BYTES = 64 << 20

#: frame kinds: "data" carries records, "eos" closes one tenant's stream,
#: "swap" requests a named-graph hot swap (``ServingRuntime.swap_graph``
#: driven over the wire — scripts/wf_serve.py swap)
KIND_DATA = "data"
KIND_EOS = "eos"
KIND_SWAP = "swap"
FRAME_KINDS = (KIND_DATA, KIND_EOS, KIND_SWAP)

#: the tenant label used when a client does not declare one — every
#: counter/SLO surface keys on SOME tenant, never on a missing label
DEFAULT_TENANT = "default"


def encode_record_frame(records: bytes = b"", *, tenant: str = DEFAULT_TENANT,
                        seq: int = 0, kind: str = KIND_DATA,
                        graph: Optional[str] = None,
                        t_send: Optional[float] = None,
                        span: Optional[str] = None) -> bytes:
    """One length-framed record frame (see the module docstring's grammar).
    ``graph`` names the swap target on ``kind="swap"`` frames.  ``t_send``
    (sender wall time) and ``span`` (a client-chosen span id) are OPTIONAL
    meta keys — the wire-to-sink tracing stamp; decoders that predate them
    pass unknown meta keys through untouched (the forward-compat pin in
    ``tests/test_serving.py``), so stamped frames need no flag day."""
    if kind not in FRAME_KINDS:
        raise ValueError(f"unknown frame kind {kind!r} "
                         f"(kinds: {', '.join(FRAME_KINDS)})")
    meta = {"tenant": str(tenant), "seq": int(seq), "kind": kind,
            "nbytes": len(records)}
    if graph is not None:
        meta["graph"] = str(graph)
    if t_send is not None:
        meta["t_send"] = round(float(t_send), 6)
    if span is not None:
        meta["span"] = str(span)
    head = json.dumps(meta, sort_keys=True).encode("utf-8") + b"\n"
    payload = head + bytes(records)
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"frame payload {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    return MAGIC + b"%0*x" % (_LEN_DIGITS, len(payload)) + b"\n" \
        + payload + b"\n"


class RecordFrameDecoder:
    """Incremental binary-frame parser, torn-input tolerant.

    ``feed(data)`` returns the complete ``(meta, record_bytes)`` pairs
    decoded so far; bytes that do not parse (mid-stream join, torn send,
    corrupt length, bad meta, a record count that disagrees with the frame
    length) are skipped to the next ``MAGIC`` and counted in
    ``frames_torn`` — the WFT1 resync discipline over a binary payload."""

    def __init__(self):
        self._buf = bytearray()
        self.frames_decoded = 0
        self.frames_torn = 0

    def feed(self, data: bytes) -> List[Tuple[dict, bytes]]:
        self._buf += data
        out: List[Tuple[dict, bytes]] = []
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
            nl = payload.find(b"\n")
            meta = None
            if nl >= 0:
                try:
                    meta = json.loads(payload[:nl])
                except ValueError:
                    meta = None
            if not isinstance(meta, dict) or meta.get("kind") not in FRAME_KINDS:
                self.frames_torn += 1
                continue
            # meta is attacker-supplied JSON: a null/non-numeric nbytes or
            # seq is a torn frame, never an exception out of feed() — one
            # malformed frame must not kill the client connection loop
            try:
                nbytes = int(meta.get("nbytes", -1))
                meta["seq"] = int(meta.get("seq", 0))
            except (ValueError, TypeError):
                self.frames_torn += 1
                continue
            if nbytes != len(payload) - nl - 1:
                self.frames_torn += 1
                continue
            meta.setdefault("tenant", DEFAULT_TENANT)
            self.frames_decoded += 1
            out.append((meta, payload[nl + 1:]))


def parse_endpoint(endpoint: str) -> Tuple[str, ...]:
    """``("tcp", host, port)`` / ``("unix", path)`` from a serving endpoint
    string — the exact telemetry-endpoint grammar (``tcp://HOST:PORT``,
    bare ``HOST:PORT``, ``unix://PATH`` / ``unix:PATH``); duplicated here
    (not imported) so this module stays loadable by file path alone."""
    s = str(endpoint or "").strip()
    if not s:
        raise ValueError("empty serving endpoint (expected tcp://HOST:PORT, "
                         "HOST:PORT, or unix://PATH)")
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
        raise ValueError(f"unparseable serving endpoint {endpoint!r} "
                         f"(expected tcp://HOST:PORT, HOST:PORT, or "
                         f"unix://PATH)")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"serving endpoint {endpoint!r}: port {port_s!r} "
                         f"is not an integer") from None
    if not 0 <= port <= 65535:
        raise ValueError(f"serving endpoint {endpoint!r}: port {port} "
                         f"out of range")
    return ("tcp", host.strip("[]"), port)


def connect(endpoint: str, timeout: float = 5.0) -> socket.socket:
    """Client-side connect to a serving endpoint (tests, examples, the
    ``wf_serve swap`` control path)."""
    parsed = parse_endpoint(endpoint)
    if parsed[0] == "unix":
        sk = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sk.settimeout(timeout)
        sk.connect(parsed[1])
    else:
        sk = socket.create_connection((parsed[1], parsed[2]),
                                      timeout=timeout)
    sk.settimeout(timeout)
    return sk


class RecordClient:
    """Minimal framing client: per-tenant monotone seqs, reconnect-aware.

    Each ``send`` frames one chunk of raw record bytes under a tenant label
    with the tenant's next seq.  After a peer kill, ``reconnect()`` opens a
    fresh socket and the caller may re-send its unacked tail — overlapping
    seqs are deduped server-side, so replay is idempotent (the peer-kill
    contract)."""

    def __init__(self, endpoint: str, timeout: float = 5.0,
                 stamp: bool = True):
        self.endpoint = endpoint
        self.timeout = timeout
        #: wire-to-sink tracing stamp: when on (default), every data frame's
        #: meta carries ``t_send`` (sender wall time) + a deterministic
        #: client ``span`` id (``tenant/seq``) — old servers ignore both
        #: (unknown-meta-key forward compat), so the stamp has no flag day.
        #: ``stamp=False`` reproduces pre-stamp clients exactly (the
        #: backward-compat regression path).
        self.stamp = bool(stamp)
        self._seq: Dict[str, int] = {}
        self._sock: Optional[socket.socket] = None

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            self._sock = connect(self.endpoint, self.timeout)
        return self._sock

    def send(self, records: bytes, *, tenant: str = DEFAULT_TENANT,
             seq: Optional[int] = None) -> int:
        """Frame + send one record chunk; returns the seq used.  An explicit
        ``seq`` re-sends that coordinate (the reconnect-overlap path)."""
        if seq is None:
            seq = self._seq.get(tenant, -1) + 1
        self._seq[tenant] = max(self._seq.get(tenant, -1), seq)
        kw = {}
        if self.stamp:
            kw = {"t_send": time.time(),  # wf-lint: allow[wall-clock] cross-process wire timing needs wall time
                  "span": f"{tenant}/{seq}"}
        self._ensure().sendall(
            encode_record_frame(records, tenant=tenant, seq=seq, **kw))
        return seq

    def send_eos(self, tenant: str = DEFAULT_TENANT) -> None:
        seq = self._seq.get(tenant, -1) + 1
        self._seq[tenant] = seq
        self._ensure().sendall(
            encode_record_frame(b"", tenant=tenant, seq=seq, kind=KIND_EOS))

    def send_swap(self, graph: str) -> None:
        """Request a hot swap to the named registered graph (control frame —
        rides outside every tenant's data seq space)."""
        self._ensure().sendall(
            encode_record_frame(b"", tenant="", seq=0, kind=KIND_SWAP,
                                graph=graph))

    def send_garbage(self, data: bytes) -> None:
        """Inject raw non-frame bytes (chaos/selftest: the decoder must
        resync and count them torn, never desync the following frames)."""
        self._ensure().sendall(data)

    def kill(self) -> None:
        """Abrupt peer kill: close without EOS (chaos_sweep --serve)."""
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def reconnect(self) -> None:
        self.kill()
        self._ensure()

    def close(self) -> None:
        self.kill()

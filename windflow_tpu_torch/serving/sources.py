"""Network ingest sources — the serving front door.

Counterpart of ``windflow_tpu/serving/sources.py`` over the port's
``RecordSource``: the same wire, dedup, replay ring and resume; the batches
land on the source's ``device`` (None = ``"cuda"``).

Both sources here are thin :class:`~windflow_tpu_torch.operators.source.
RecordSource` subclasses: they only provide an ``it_factory`` that yields
numpy structured-array chunks, so EVERY downstream contract — the native
AoS->SoA transpose (``native/csrc/ingest.cpp``), ``SourceBase._frame``'s
zero-pad + progressive-id framing, ``cursor()`` checkpoints, trace-id
minting — runs unchanged.  Their factories declare ``from_batch``, so the
supervisor's ``_open_seek`` resumes them in O(1): :class:`SocketSource`
re-drives the committed-cursor gap from its bounded replay ring,
:class:`FileTailSource` seeks the file offset.

- :class:`SocketSource` — TCP/Unix listener decoding ``WFS1`` record
  frames (``serving/framing.py``: magic + resync + per-tenant seq dedup).
  One frame = one chunk = one batch, so tenant attribution is exact at
  batch granularity (``last_tenant``).  Torn bytes from a killed peer
  resync; a reconnecting client re-sending overlap is deduped by seq —
  peer kills degrade to replay, never loss or duplication.
- :class:`FileTailSource` — append-follow over a fixed-record binary file
  with rotation detection (inode change / truncation reopens at zero) and
  a marker-file EOS (``<path>.eos``).

The drive loop that consumes these sources is one thread (the Pipeline/
ServingRuntime discipline); ``last_tenant`` attribution relies on it, so
serving sources are driven un-prefetched.
"""

from __future__ import annotations

import collections
import os
import queue
import socket
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..operators.source import RecordSource
from . import framing


class SocketSource(RecordSource):
    """Length-framed record ingest over TCP or a Unix socket.

    ``endpoint`` follows the telemetry grammar (``tcp://HOST:PORT``, bare
    ``HOST:PORT``, ``unix://PATH``; port 0 binds ephemeral — read the
    resolved address back from :attr:`endpoint` after :meth:`start`).
    ``replay`` bounds the in-memory chunk ring that re-drives the
    committed-cursor gap on a supervised restart — size it to cover at
    least one checkpoint interval of chunks, or resume refuses loudly.
    ``eos_tenants`` lists the tenant ids whose ``eos`` control frames end
    the stream (default: the first ``eos`` frame from anyone ends it)."""

    def __init__(self, endpoint: str, record_dtype, *,
                 key_field: Optional[str] = None,
                 ts_field: Optional[str] = None,
                 num_keys: Optional[int] = None,
                 name: str = "socket_source", parallelism: int = 1,
                 framing_workers: int = 1, replay: int = 256,
                 eos_tenants: Optional[Sequence[str]] = None,
                 recv_bytes: int = 1 << 16, device=None):
        super().__init__(self._chunks_from_ring, record_dtype,
                         key_field=key_field, ts_field=ts_field,
                         num_keys=num_keys, name=name,
                         parallelism=parallelism,
                         framing_workers=framing_workers, device=device)
        self._parsed = framing.parse_endpoint(endpoint)
        self.endpoint = endpoint
        self.replay = max(1, int(replay))
        self.recv_bytes = int(recv_bytes)
        self._eos_needed = set(eos_tenants) if eos_tenants else None
        self._lock = threading.Lock()
        #: decoded chunks awaiting the drive loop; the ring keeps the last
        #: ``replay`` of them for gap re-drive after a supervised restart
        self._queue: "queue.Queue" = queue.Queue()
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.replay)                  # wf-lint: guarded-by[_lock]
        self._next_chunk = 0                     # wf-lint: guarded-by[_lock]
        self._last_seq: Dict[str, int] = {}      # wf-lint: guarded-by[_lock]
        self._eos_seen: set = set()              # wf-lint: guarded-by[_lock]
        self._eos = threading.Event()
        self._stop = threading.Event()
        self._swaps: "collections.deque" = collections.deque()  # wf-lint: guarded-by[_lock]
        # mutated by start()/close() on the drive thread only; the accept
        # loop reads it once and a close() under its feet surfaces as a
        # clean OSError exit
        self._server: Optional[socket.socket] = None  # wf-lint: single-writer[driver]
        self._threads = []                       # wf-lint: guarded-by[_lock]
        #: wire-level counters (snapshot ``serving`` section); updated by
        #: every client thread, so increments happen under ``_lock``
        self.frames_decoded = 0                  # wf-lint: guarded-by[_lock]
        self.frames_torn = 0                     # wf-lint: guarded-by[_lock]
        self.frames_dup = 0                      # wf-lint: guarded-by[_lock]
        self.clients_seen = 0                    # wf-lint: single-writer[ingest]
        #: tenant of the chunk most recently handed to the drive loop —
        #: valid only under the single-threaded, un-prefetched drive
        #: contract (module docstring)
        self.last_tenant = framing.DEFAULT_TENANT
        #: wire timing of the most recently yielded chunk (same contract):
        #: ``{"seq", "t_send", "t_recv", "span"}`` — ``t_send``/``span``
        #: are None for frames from pre-stamp clients (meta keys absent),
        #: ``t_recv`` is this host's receipt wall time.  The drive loop
        #: turns the pair into wire/queue segment attribution for the
        #: per-tenant trace report.
        self.last_wire: Optional[dict] = None
        #: chunk idx -> wire timing, popped as chunks are yielded; bounded
        #: so a stalled drive loop can't grow it without bound
        self._wire: Dict[int, dict] = {}         # wf-lint: guarded-by[_lock]

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "SocketSource":
        """Bind + listen + spawn the acceptor; idempotent."""
        if self._server is not None:
            return self
        if self._parsed[0] == "unix":
            sk = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                os.unlink(self._parsed[1])
            except OSError:
                pass
            sk.bind(self._parsed[1])
        else:
            sk = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sk.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sk.bind((self._parsed[1], self._parsed[2]))
            host, port = sk.getsockname()[:2]
            self.endpoint = f"tcp://{host}:{port}"
        sk.listen(16)
        sk.settimeout(0.2)
        self._server = sk
        t = threading.Thread(  # wf-lint: thread-role[ingest]
            target=self._accept_loop, daemon=True,
            name=f"wf-serve-accept[{self.name}]")
        t.start()
        with self._lock:
            self._threads.append(t)
        return self

    def close(self) -> None:
        self._stop.set()
        self._eos.set()
        if self._server is not None:
            try:
                self._server.close()
            finally:
                self._server = None
            if self._parsed[0] == "unix":
                try:
                    os.unlink(self._parsed[1])
                except OSError:
                    pass
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=2.0)
        super().close()

    # -- network side ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return                          # server socket closed
            self.clients_seen += 1
            t = threading.Thread(  # wf-lint: thread-role[ingest]
                target=self._client_loop, args=(conn,), daemon=True,
                name=f"wf-serve-client[{self.name}]")
            t.start()
            with self._lock:
                self._threads.append(t)

    def _client_loop(self, conn: socket.socket) -> None:
        dec = framing.RecordFrameDecoder()
        conn.settimeout(0.2)
        try:
            while not self._stop.is_set():
                try:
                    data = conn.recv(self.recv_bytes)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:                    # peer closed (or was killed)
                    break
                for meta, blob in dec.feed(data):
                    self._on_frame(meta, blob)
                # decoder counters are cumulative; publish deltas and reset
                # (under _lock — concurrent clients read-modify-write the
                # same shared counters)
                with self._lock:
                    self.frames_decoded += dec.frames_decoded
                    self.frames_torn += dec.frames_torn
                dec.frames_decoded = 0
                dec.frames_torn = 0
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _on_frame(self, meta: dict, blob: bytes) -> None:
        kind = meta.get("kind")
        tenant = str(meta.get("tenant") or framing.DEFAULT_TENANT)
        if kind == framing.KIND_SWAP:
            with self._lock:
                self._swaps.append(str(meta.get("graph") or ""))
            return
        seq = int(meta.get("seq", 0))
        with self._lock:
            last = self._last_seq.get(tenant)
            if last is not None and seq <= last:
                self.frames_dup += 1            # reconnect overlap: dedup
                return
            self._last_seq[tenant] = seq
            if kind == framing.KIND_EOS:
                self._eos_seen.add(tenant)
                done = (self._eos_needed is None
                        or self._eos_needed <= self._eos_seen)
                if done:
                    self._eos.set()
                return
            if len(blob) % self.dtype.itemsize:
                self.frames_torn += 1           # ragged record payload
                return
            rec = np.frombuffer(blob, dtype=self.dtype).copy()
            idx = self._next_chunk
            self._next_chunk += 1
            # wire receipt stamp: t_send/span ride the frame meta when the
            # client stamped them (framing.RecordClient); both are
            # attacker-supplied, so coercion failure degrades to "no stamp"
            # — never an exception out of the ingest thread
            t_send = meta.get("t_send")
            if t_send is not None:
                try:
                    t_send = float(t_send)
                except (TypeError, ValueError):
                    t_send = None
            span = meta.get("span")
            self._wire[idx] = {
                "seq": seq, "t_send": t_send,
                "t_recv": time.time(),  # wf-lint: allow[wall-clock] cross-process wire timing needs wall time
                "span": None if span is None else str(span)}
            while len(self._wire) > 4 * self.replay:
                self._wire.pop(next(iter(self._wire)))
            self._ring.append((idx, tenant, rec))
            # the put MUST stay inside the lock: with concurrent clients,
            # enqueueing outside would let a later idx land first and the
            # in-order consumer (_chunks_from_ring) would silently drop the
            # overtaken chunk; in-lock it also cannot land after an EOS
            # whose empty-queue check already passed
            self._queue.put((idx, tenant, rec))

    def pop_swap_request(self) -> Optional[str]:
        """Next pending wire swap request (ServingRuntime polls at batch
        boundaries), or None."""
        with self._lock:
            try:
                return self._swaps.popleft()
            except IndexError:
                return None

    # -- the RecordSource chunk factory --------------------------------

    def _chunks_from_ring(self, from_batch: int = 0):
        """The seekable ``it_factory``: chunks ``[from_batch, ...)`` in
        chunk-index order — ring replay first (the committed-cursor gap),
        then the live queue.  Declaring ``from_batch`` opts into
        ``SourceBase._open_seek``'s O(1) resume."""
        self.start()
        with self._lock:
            ring = list(self._ring)
            next_live = self._next_chunk
        if from_batch:
            ring_start = ring[0][0] if ring else next_live
            if from_batch < ring_start:
                raise RuntimeError(
                    f"{self.name}: resume at chunk {from_batch} but the "
                    f"replay ring starts at {ring_start} — size replay= "
                    f"(now {self.replay}) to cover at least one checkpoint "
                    f"interval of chunks")
        pos = from_batch
        for idx, tenant, rec in ring:
            if idx < pos:
                continue
            # replayed chunks were already dequeued by the pre-restart
            # incarnation; re-drive them from the ring in idx order
            self.last_tenant = tenant
            with self._lock:
                self.last_wire = self._wire.pop(idx, None)
            pos = idx + 1
            yield rec
        while True:
            # drain anything the live queue holds below pos (chunks the
            # ring already replayed) without blocking
            try:
                idx, tenant, rec = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._eos.is_set() and self._queue.empty():
                    return
                continue
            if idx < pos:
                continue
            self.last_tenant = tenant
            with self._lock:
                self.last_wire = self._wire.pop(idx, None)
            pos = idx + 1
            yield rec


class FileTailSource(RecordSource):
    """Append-follow ingest over a binary file of fixed-size records.

    Chunks of up to ``batch_records`` rows are read as the file grows
    (``poll_s`` cadence); a rotation (inode change or truncation) reopens
    at offset zero and the chunk index simply keeps counting.  EOS: create
    ``<path>.eos`` (or pass ``eos_marker=``) once the writer is done — the
    source drains to the final size and ends.  ``it_factory(from_batch=k)``
    seeks straight to ``k * batch_records`` rows: O(1) supervised resume
    against the CURRENT file incarnation (a cursor from before a rotation
    re-reads the rotated-in file — rotation resets content, not ids)."""

    def __init__(self, path: str, record_dtype, *,
                 batch_records: int = 64,
                 key_field: Optional[str] = None,
                 ts_field: Optional[str] = None,
                 num_keys: Optional[int] = None,
                 name: str = "file_tail_source", parallelism: int = 1,
                 framing_workers: int = 1, poll_s: float = 0.02,
                 eos_marker: Optional[str] = None, device=None):
        super().__init__(self._chunks_from_file, record_dtype,
                         key_field=key_field, ts_field=ts_field,
                         num_keys=num_keys, name=name,
                         parallelism=parallelism,
                         framing_workers=framing_workers, device=device)
        self.path = path
        self.batch_records = max(1, int(batch_records))
        self.poll_s = float(poll_s)
        self.eos_marker = eos_marker if eos_marker is not None \
            else path + ".eos"
        self.rotations = 0

    def _chunks_from_file(self, from_batch: int = 0):
        row = self.dtype.itemsize
        chunk_bytes = row * self.batch_records
        f = open(self.path, "rb")
        try:
            ino = os.fstat(f.fileno()).st_ino
            f.seek(from_batch * chunk_bytes)
            pending = b""
            while True:
                try:
                    st = os.stat(self.path)
                except FileNotFoundError:
                    st = None
                if st is not None and (st.st_ino != ino
                                       or st.st_size < f.tell()):
                    # rotation: a new inode, or the file shrank under us —
                    # reopen at zero; ids keep counting (the chunk index is
                    # stream position, not file position)
                    f.close()
                    f = open(self.path, "rb")
                    ino = os.fstat(f.fileno()).st_ino
                    pending = b""
                    self.rotations += 1
                data = f.read(chunk_bytes - len(pending))
                if data:
                    pending += data
                n_rows = len(pending) // row
                if n_rows and (n_rows >= self.batch_records or not data):
                    blob = pending[:n_rows * row]
                    pending = pending[n_rows * row:]
                    yield np.frombuffer(blob, dtype=self.dtype).copy()
                    continue
                if not data:
                    if os.path.exists(self.eos_marker):
                        if pending and len(pending) % row == 0:
                            yield np.frombuffer(pending,
                                                dtype=self.dtype).copy()
                        return
                    time.sleep(self.poll_s)
        finally:
            f.close()

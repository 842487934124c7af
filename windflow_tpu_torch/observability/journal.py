"""Structured event journal — JSONL spans with monotonic timestamps.

The port's own copy of ``windflow_tpu/observability/journal.py`` (that module
imports no JAX, but the port imports nothing of the JAX package); keep the
two equal: ``tests/test_torch_journal.py`` holds the records of both against
each other.

The runtime's discrete events (checkpoint commits, restores/restarts,
ordering-buffer flushes, EOS propagation, sampled compiled-program launches;
the sharded supervisors' ``shard_restore`` records and ``reshard`` spans,
and ``shard`` fields on their ``restart_exhausted`` and ``dead_letter``
records) are appended as one JSON object per line, so a round's artifacts carry the
*sequence* of what happened, not just end-state counters. Every record has:

- ``t``: ``time.monotonic()`` at emission — totally ordered within a process;
- ``wall``: ``time.time()`` for cross-process correlation;
- ``event``: the event name;
- spans additionally: ``phase`` (``begin``/``end``), ``span`` (a per-journal
  sequence number pairing begin with end), and on ``end`` a ``dur_s``.

Call sites go through the module-level active journal (:func:`record` /
:func:`span`), which is a no-op costing one attribute load + None check when
monitoring is off — safe in per-batch paths.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional


class EventJournal:
    """Append-only JSONL journal. Thread-safe.

    Flushing: the default (``flush_interval=None``) flushes per event —
    events are checkpoint/EOS-granular, not per-tuple, and a crash must not
    lose the records describing it, so supervised runs keep this mode.
    Tracing-heavy runs (sampled launches, per-batch spans) can opt into
    batched flushing with ``flush_interval=N``: the stream is flushed every N
    events instead of paying a write syscall per record; error-carrying
    records and ``close()`` always flush immediately, so the failure tail is
    never buffered away."""

    def __init__(self, path: str, flush_interval: Optional[int] = None):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.flush_interval = (None if not flush_interval
                               else max(1, int(flush_interval)))
        # line buffering when per-event; block buffering when batched
        self._f = open(path, "a",
                       buffering=(1 if self.flush_interval is None else -1))
        self._lock = threading.Lock()
        self._span_seq = 0
        self._since_flush = 0
        self.events_written = 0

    def event(self, name: str, **fields) -> None:
        rec = {"t": time.monotonic(), "wall": time.time(), "event": name}
        rec.update(fields)
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self.events_written += 1
            if self.flush_interval is not None:
                self._since_flush += 1
                if (self._since_flush >= self.flush_interval
                        or "error" in rec):
                    self._f.flush()
                    self._since_flush = 0

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """``begin``/``end`` record pair around a block; ``end`` carries the
        measured ``dur_s`` (and ``error`` if the block raised)."""
        with self._lock:
            self._span_seq += 1
            sid = self._span_seq
        t0 = time.monotonic()
        self.event(name, phase="begin", span=sid, **fields)
        try:
            yield sid
        except BaseException as e:
            # the in-span failure overrides any caller-supplied 'error' field
            # (e.g. a restore span opened with the error being recovered FROM)
            # — a dict merge, never a duplicate-kwarg TypeError that would
            # mask the real exception
            self.event(name, phase="end", span=sid,
                       dur_s=round(time.monotonic() - t0, 6),
                       **{**fields, "error": type(e).__name__})
            raise
        self.event(name, phase="end", span=sid,
                   dur_s=round(time.monotonic() - t0, 6), **fields)

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


#: process-global active journal (set with :func:`set_active`; a ``Monitor``
#: sets its own for the run). Runtime call sites use the
#: module-level helpers below so a disabled journal costs one None check.
_active: Optional[EventJournal] = None


def set_active(journal: Optional[EventJournal]) -> None:
    global _active
    _active = journal


def get_active() -> Optional[EventJournal]:
    return _active


def record(name: str, **fields) -> None:
    """Emit one event to the active journal; no-op when none is active."""
    j = _active
    if j is not None:
        j.event(name, **fields)


def span(name: str, **fields):
    """Span context manager on the active journal; no-op context when none."""
    j = _active
    if j is not None:
        return j.span(name, **fields)
    return contextlib.nullcontext()


def read_journal(path: str):
    """Parse a journal file back into a list of dicts (tests/tooling)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out

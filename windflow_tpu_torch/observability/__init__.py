"""Observability of the port: the name registries its operators check against
(``names.py``) and the event journal (``journal.py``, JSONL records and spans
of checkpoints, restores, faults, backoffs and EOS). The JAX package's
metrics, reporters, tracing and event-time monitoring are not ported yet
(ROADMAP Queue 1 item 16)."""

from . import journal, names
from .journal import EventJournal, read_journal, set_active as set_journal

__all__ = ["EventJournal", "journal", "names", "read_journal", "set_journal"]

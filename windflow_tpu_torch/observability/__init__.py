"""Observability names of the port (the registries its operators check
against). The JAX package's metrics, reporters and event-time monitoring are
not ported yet (ROADMAP Queue 1 item 16)."""

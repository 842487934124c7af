"""Serving front-end — network ingest, multi-tenant isolation, hot swap.

Counterpart of ``windflow_tpu/serving/``: the same frames, tenants,
configuration, sources and runtime, over the port's drivers.

The layer that turns a compiled chain into a long-running service
(the source paper's live Source/Sink model with the host
as a thin ingest shim):

- ``framing.py`` — the ``WFS1`` binary record wire format (magic + resync
  + per-tenant seq dedup); stdlib-only, path-loadable (``wf_serve.py``).
- ``sources.py`` — :class:`SocketSource` / :class:`FileTailSource`, thin
  ``RecordSource`` factories riding the native SoA ingest path with O(1)
  supervised resume.
- ``tenants.py`` — :class:`TenantSpec` registry over per-tenant admission
  controllers; stdlib-only resolution/validation half, path-loadable.
- ``config.py`` — :class:`ServingConfig` (``WF_SERVE`` /
  ``WF_SERVE_ENDPOINT`` / ``WF_TENANTS``) + the shared WF119 check.
- ``runtime.py`` — :class:`ServingRuntime`: the Pipeline drive loop plus
  per-tenant admission, zero-downtime :meth:`~ServingRuntime.swap_graph`,
  and the ``serving`` snapshot section.
"""

from .config import DEFAULT_ENDPOINT, ServingConfig, serving_problems
from .framing import (DEFAULT_TENANT, FRAME_KINDS, KIND_DATA, KIND_EOS,
                      KIND_SWAP, MAGIC, RecordClient, RecordFrameDecoder,
                      connect, encode_record_frame, parse_endpoint)
from .runtime import ServingRuntime
from .sources import FileTailSource, SocketSource
from .tenants import (SHED_POLICIES, TenantRegistry, TenantSpec,
                      build_registry, registry_problems, resolve_tenants,
                      tenant_problems)

__all__ = [
    "DEFAULT_ENDPOINT", "DEFAULT_TENANT", "FRAME_KINDS", "KIND_DATA",
    "KIND_EOS", "KIND_SWAP", "MAGIC", "RecordClient", "RecordFrameDecoder",
    "SHED_POLICIES", "ServingConfig", "ServingRuntime", "SocketSource",
    "FileTailSource", "TenantRegistry", "TenantSpec", "build_registry",
    "connect", "encode_record_frame", "parse_endpoint", "registry_problems",
    "resolve_tenants", "serving_problems", "tenant_problems",
]

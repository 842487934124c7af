"""Serving configuration — the ``serving=`` / ``WF_SERVE`` resolution.

Counterpart of ``windflow_tpu/serving/config.py``, a copy.

One declarative object for the whole serving plane: where the front door
listens (``endpoint``), who may walk through it (``tenants`` — the
``tenants.py`` spec grammar), how deep the socket's chunk replay ring is
(``replay`` — the supervised-resume gap buffer), and whether an incoming
hot-swap chain is warmed before cutover (``swap_warm`` — compiling inside
the swap quiesce stalls live traffic, so ``False`` is a WF119 error).

Resolution follows the ``MonitoringConfig`` env convention exactly:
``serving=None`` consults ``WF_SERVE`` (``''``/``'0'`` off, ``'1'``
defaults, inline JSON / JSON file path / bare endpoint string otherwise);
``WF_SERVE_ENDPOINT`` supplies the endpoint when the config did not name
one, ``WF_TENANTS`` supplies the tenant set the same way.  All three are
read when the config resolves — at :class:`ServingRuntime` construction
or ``run()``, and by the WF119 validator with the run's exact arguments.

:func:`serving_problems` is THE shared legality check (the
``slo.spec_problems`` discipline): the :class:`ServingRuntime` constructor
raises on it, ``analysis/validate.py`` reports it as WF119 pre-run, and
``wf_lint --explain WF119`` tells its story.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

from . import framing
from .tenants import registry_problems, resolve_tenants

DEFAULT_ENDPOINT = "tcp://127.0.0.1:0"


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Resolved serving settings for one :class:`ServingRuntime`."""

    #: where the socket front door listens (``framing.parse_endpoint``
    #: grammar; port 0 = ephemeral).  None = ``WF_SERVE_ENDPOINT`` or the
    #: loopback default — explicit config always wins over env.
    endpoint: Optional[str] = None
    #: the tenant set (``tenants.resolve_tenants`` grammar: spec list,
    #: inline JSON, file path).  None = consult ``WF_TENANTS``; resolving
    #: empty/off means single-tenant mode (everything under ``default``,
    #: never shed).
    tenants: object = None
    #: warm the incoming chain's programs BEFORE cutover (the autotuner's
    #: pre-compiled-ladder switch trick) — ``False`` compiles inside the
    #: swap quiesce, stalling live traffic: legal at runtime, WF119 pre-run
    swap_warm: bool = True
    #: SocketSource chunk replay-ring depth — must cover at least one
    #: supervised checkpoint interval of chunks for gap re-drive
    replay: int = 256

    def resolved_endpoint(self) -> str:
        if self.endpoint is not None:
            return self.endpoint
        return os.environ.get("WF_SERVE_ENDPOINT", "") or DEFAULT_ENDPOINT

    def resolved_tenants(self):
        """The tenant argument after its ``WF_TENANTS`` deferral (still the
        raw grammar — ``tenants.resolve_tenants`` turns it into specs)."""
        if self.tenants is not None:
            return self.tenants
        return os.environ.get("WF_TENANTS", "") or None

    @classmethod
    def resolve(cls, serving) -> Optional["ServingConfig"]:
        """Normalize the user-facing ``serving=`` argument.

        ``None`` consults ``WF_SERVE`` (``''``/``'0'`` off); ``False``
        forces off; ``True`` = defaults; a dict/config passes through; a
        string is inline JSON (``{...}``), a JSON file path (endswith
        ``.json``), or a bare endpoint.  Returns None when serving is
        off."""
        if serving is False:
            return None
        if isinstance(serving, ServingConfig):
            return serving
        if isinstance(serving, dict):
            return cls(**serving)
        if serving is None:
            serving = os.environ.get("WF_SERVE", "")
            if serving in ("", "0"):
                return None
        if serving is True or serving == "1":
            return cls()
        if isinstance(serving, str):
            s = serving.strip()
            if s in ("", "0"):
                return None
            if s == "1":
                return cls()
            if s.startswith("{"):
                return cls(**json.loads(s))
            if s.endswith(".json"):
                with open(s) as f:
                    return cls(**json.load(f))
            return cls(endpoint=s)
        raise ValueError(f"serving= accepts None/bool/str/dict/"
                         f"ServingConfig, got {type(serving).__name__}")


def serving_problems(cfg: Optional[ServingConfig], *, monitoring=None,
                     supervised: bool = False,
                     slo_specs=None) -> List[str]:
    """Every reason this serving setup cannot be honored — THE WF119 check.

    ``monitoring`` is the run's monitoring argument resolved exactly as the
    driver will resolve it; ``slo_specs`` the resolved SLO spec list (for
    the tenant-label cross-check); ``supervised`` rejects wall-clock tenant
    buckets (replay cannot re-derive clock-driven shed decisions)."""
    if cfg is None:
        return []
    out = []
    try:
        framing.parse_endpoint(cfg.resolved_endpoint())
    except ValueError as e:
        out.append(str(e))
    specs = None
    try:
        specs = resolve_tenants(cfg.resolved_tenants())
    except (ValueError, OSError) as e:
        out.append(f"tenants: {e}")
    if specs:
        out += registry_problems(specs, supervised=supervised)
    if int(cfg.replay) < 1:
        out.append(f"replay must be >= 1, got {cfg.replay}")
    if not cfg.swap_warm:
        out.append("swap_warm=false cuts over to an UN-WARMED chain — the "
                   "incoming programs compile inside the swap quiesce, "
                   "stalling live traffic; warm the incoming rungs before "
                   "cutover (the autotuner's pre-compiled-ladder switch "
                   "discipline)")
    from ..observability import MonitoringConfig
    try:
        mon = MonitoringConfig.resolve(monitoring)
    except (ValueError, TypeError):
        mon = None      # a broken monitoring config is WF11x's finding
    if mon is None:
        out.append("serving is on while monitoring resolves off — the "
                   "serving plane's tenant counters, SLO isolation, and "
                   "graph_swap spans all live in the monitoring snapshot/"
                   "journal (set monitoring=/WF_MONITORING)")
    ids = {s.id for s in (specs or [])}
    for spec in slo_specs or []:
        tenant = getattr(spec, "tenant", None)
        if tenant is not None and tenant not in ids:
            out.append(f"slo[{spec.name}]: tenant {tenant!r} is not a "
                       f"declared tenant id ({', '.join(sorted(ids)) or 'none'}"
                       f") — a label nobody emits idles the SLO at OK "
                       f"forever")
    return out

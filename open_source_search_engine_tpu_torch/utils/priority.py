"""Request priority tiers — the vocabulary the admission plane speaks.

A copy of ``open_source_search_engine_tpu/utils/priority.py``; the port imports
nothing of that package.

Reference: the engine survived open-internet load by treating traffic
classes differently — AutoBan rate-limited abusive sources, the
niceness bit (``UdpProtocol.h``) made spider work yield to queries, and
``maxQueryTime`` bounded what one query could cost. This module is the
shared, layering-safe half of that story: tier names, the
``X-OSSE-Priority`` header that carries a request's tier through
scatter legs, and the contextvar binding the transport reads when it
stamps outbound RPCs. The gate that *enforces* tiers lives in
``serve/admission.py``; ``parallel/`` and ``query/`` only ever need
this module, so the dependency arrow keeps pointing downward.

Tiers, highest priority first:

* ``interactive`` — a human waiting on a SERP; never queues behind the
  other tiers.
* ``suggest`` — typeahead/completion traffic: latency-sensitive but
  individually cheap and abandonable.
* ``crawlbot`` — bulk/background clients (spiders, batch exports); the
  first tier shed under overload, mapped to niceness 1 on the node
  planes so it also yields inside each host.
"""

from __future__ import annotations

import contextlib
import contextvars

#: highest priority first — wake/shed order is exactly this tuple
TIERS: tuple[str, ...] = ("interactive", "suggest", "crawlbot")

#: scatter legs carry the front door's verdict on this header (like
#: X-OSSE-Deadline carries the budget and X-OSSE-Trace the span)
PRIORITY_HEADER = "X-OSSE-Priority"

#: the tenant (collection owner) a request bills against — the
#: admission plane's weighted-fair ledger key, carried across wire
#: legs exactly like the tier so a scatter leg sheds against the same
#: quota its coordinator would
TENANT_HEADER = "X-OSSE-Tenant"

#: tier -> the niceness bit the node planes honor (crawlbot work yields
#: to interactive inside each node, not only at the front door)
_TIER_NICENESS = {"interactive": 0, "suggest": 0, "crawlbot": 1}

_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "osse-priority-tier", default=None)

_tenant_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "osse-priority-tenant", default=None)


class QueueFull(RuntimeError):
    """A bounded admission/dispatch queue refused an enqueue — the
    overload signal the serve edge turns into shed-stale-or-503
    (distinct from a timeout: no work was started at all)."""


def current_tier() -> str | None:
    """The tier bound to this context, or None outside a request."""
    return _ctx.get()


@contextlib.contextmanager
def bind_tier(tier: str | None):
    """Bind ``tier`` for the duration: every outbound RPC inside stamps
    it on :data:`PRIORITY_HEADER` so shard nodes honor the front door's
    classification."""
    tok = _ctx.set(tier)
    try:
        yield
    finally:
        _ctx.reset(tok)


def tier_from_header(value: str | None) -> str | None:
    """Parse an ``X-OSSE-Priority`` header; unknown/absent -> None
    (the receiver falls back to its own classification)."""
    v = (value or "").strip().lower()
    return v if v in TIERS else None


def current_tenant() -> str | None:
    """The tenant bound to this context, or None outside a request."""
    return _tenant_ctx.get()


@contextlib.contextmanager
def bind_tenant(tenant: str | None):
    """Bind the billing tenant for the duration; outbound RPCs stamp
    it on :data:`TENANT_HEADER` (the quota analog of tier)."""
    tok = _tenant_ctx.set(tenant)
    try:
        yield
    finally:
        _tenant_ctx.reset(tok)


def tenant_from_header(value: str | None) -> str | None:
    """Parse an ``X-OSSE-Tenant`` header; absent/oversized -> None.
    Tenant names are free-form collection names, so only length is
    policed (a hostile header must not mint unbounded counter keys)."""
    v = (value or "").strip()
    return v[:64] if v else None


def classify(query: dict, niceness: int = 0,
             header_tier: str | None = None) -> str:
    """Front-door classification. Precedence: an explicit ``tier=``
    request param, then the propagated header (a scatter leg keeps its
    coordinator's verdict), then the niceness bit (background callers
    already self-identify), else interactive — misclassifying *up* is
    safer than starving a human."""
    explicit = tier_from_header(str(query.get("tier", "")))
    if explicit is not None:
        return explicit
    if header_tier in TIERS:
        return header_tier
    if niceness > 0:
        return "crawlbot"
    return "interactive"


def tier_niceness(tier: str | None) -> int:
    """The niceness bit a tier rides on the node planes."""
    return _TIER_NICENESS.get(tier or "", 0)

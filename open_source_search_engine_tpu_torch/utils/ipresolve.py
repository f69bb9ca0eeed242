"""First-IP resolution, the crawl plane's DNS seam.

Port of ``open_source_search_engine_tpu/utils/ipresolve.py``. The spider
keys everything by a URL host's first IP (its first A record): spiderdb
records (``Spider.h:99-108``), shard ownership and per-IP politeness.
Here the OS resolver (or :mod:`.dnsresolver` when ``OSSE_DNS_SERVERS``
names servers) does the lookup, and this module adds a TTL cache,
in-flight dedup (concurrent lookups of one host make one), an injectable
resolver (:data:`resolver_override`) and a deterministic pseudo-IP for a
host that does not resolve, so sharding and politeness stay stable
offline.
"""

from __future__ import annotations

import os
import socket
import time

from . import ghash, threads
from .lockcheck import make_event, make_lock
from .log import get_logger

log = get_logger("ipresolve")

#: the resolution cache's TTL (the reference's DNS cache default)
TTL_S = 3600.0

_cache: dict[str, tuple[str, float]] = {}
_inflight: dict = {}
_lock = make_lock("ipresolve")

#: a callable host -> ip string that replaces the lookup (tests, offline)
resolver_override = None

_wire = None


def _wire_resolver():
    """The wire-protocol DnsResolver when ``OSSE_DNS_SERVERS`` names DNS
    servers; None means the OS resolver."""
    global _wire
    if _wire is None:
        from .dnsresolver import DnsResolver
        servers = [s for s in
                   os.environ.get("OSSE_DNS_SERVERS", "").split(",") if s]
        _wire = DnsResolver(servers) if servers else False
    return _wire or None


def _pseudo_ip(host: str) -> str:
    """The fallback for a host that does not resolve: a pseudo-IP in the
    reserved 0.x.x.x range from the host's hash, the same on every node,
    never equal to a routable first IP."""
    h = ghash.hash64(host)
    return f"0.{(h >> 16) & 0xFF}.{(h >> 8) & 0xFF}.{h & 0xFF}"


def first_ip(host: str, timeout: float = 5.0) -> str:
    """The host's first A record, TTL-cached, lookups deduped."""
    now = time.monotonic()
    with _lock:
        hit = _cache.get(host)
        if hit is not None and hit[1] > now:
            return hit[0]
        ev = _inflight.get(host)
        if ev is None:
            ev = _inflight[host] = make_event("ipresolve.flight")
            owner = True
        else:
            owner = False
    if not owner:
        # wait past the owner's own bound: the owner always caches a value
        # (real or pseudo) and sets the event, so the waiter reads what
        # the owner cached unless this wait itself expires
        ev.wait(timeout + 1.0)
        with _lock:
            hit = _cache.get(host)
        return hit[0] if hit is not None else _pseudo_ip(host)
    try:
        if resolver_override is not None:
            ip = resolver_override(host)
        elif (wire := _wire_resolver()) is not None:
            ip = wire.resolve(host, budget_s=timeout) or _pseudo_ip(host)
        else:
            # getaddrinfo takes no timeout and can hang for minutes on a
            # broken resolver path: a daemon thread bounds it
            box: list[str] = []

            def _lookup() -> None:
                try:
                    box.append(socket.getaddrinfo(
                        host, None, family=socket.AF_INET,
                        type=socket.SOCK_STREAM)[0][4][0])
                except Exception as exc:  # noqa: BLE001 — NXDOMAIN etc.
                    log.debug("getaddrinfo(%s) failed: %s", host, exc)
            t = threads.spawn(f"dns-{host[:24]}", _lookup)
            t.join(timeout)
            ip = box[0] if box else _pseudo_ip(host)
    except Exception:  # noqa: BLE001 — an unresolvable host
        ip = _pseudo_ip(host)
    finally:
        with _lock:
            if len(_cache) > 65536:
                _cache.clear()
            _cache[host] = (ip, now + TTL_S)
            _inflight.pop(host, None)
        ev.set()
    return ip


def clear_cache() -> None:
    global _wire
    with _lock:
        _cache.clear()
        _inflight.clear()
        _wire = None  # OSSE_DNS_SERVERS is read again at the next lookup

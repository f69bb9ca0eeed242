"""DNS resolver: a wire-protocol client with per-record TTLs.

Port of ``open_source_search_engine_tpu/utils/dnsresolver.py`` (reference
``Dns.cpp``, ``Dns.h:131``): the crawler runs its own resolver because
``getaddrinfo`` gives it no TTLs, no timeout budget and one blocking slot
per lookup. Stdlib UDP sockets only:

* A queries against the configured servers (``OSSE_DNS_SERVERS`` or the
  constructor's list), a per-try timeout and a budget per lookup;
* answers parsed with compressed names, CNAME chains (bounded depth) and
  referrals; ``iterative=True`` follows referrals (NS + glue) from the
  given servers as roots, the root -> TLD -> authority walk;
* every A record cached under its own TTL (clamped), negative answers
  under a short one, on the cache plane;
* concurrent lookups of one host collapse into one query.

``ipresolve.first_ip`` uses this resolver when servers are configured and
the OS resolver otherwise.
"""

from __future__ import annotations

import os
import secrets
import socket
import struct
import time

from .lockcheck import make_event, make_lock
from .log import get_logger

log = get_logger("dns")

#: per-try socket timeout and the whole lookup's budget
TRY_TIMEOUT_S = 1.5
TOTAL_BUDGET_S = 5.0
#: TTL clamps: never cached longer than a day nor shorter than 10 s
TTL_MIN_S, TTL_MAX_S = 10.0, 86400.0
NEGATIVE_TTL_S = 60.0
MAX_CNAME_DEPTH = 8
MAX_REFERRAL_DEPTH = 8

QTYPE_A = 1
QTYPE_NS = 2
QTYPE_CNAME = 5


def build_query(name: str, qid: int, qtype: int = QTYPE_A,
                recurse: bool = True) -> bytes:
    """One DNS question packet (RFC 1035 §4)."""
    flags = 0x0100 if recurse else 0x0000  # the RD bit
    out = struct.pack(">HHHHHH", qid, flags, 1, 0, 0, 0)
    for label in name.strip(".").split("."):
        lb = label.encode("idna") if not label.isascii() \
            else label.encode()
        out += bytes([len(lb)]) + lb
    out += b"\x00" + struct.pack(">HH", qtype, 1)
    return out


def _read_name(pkt: bytes, off: int) -> tuple[str, int]:
    """Decode a (possibly compressed) name: (name, next offset)."""
    labels: list[str] = []
    jumps = 0
    next_off = None
    while True:
        if off >= len(pkt):
            raise ValueError("truncated name")
        ln = pkt[off]
        if ln & 0xC0 == 0xC0:  # a compression pointer
            if off + 1 >= len(pkt):
                raise ValueError("truncated pointer")
            ptr = ((ln & 0x3F) << 8) | pkt[off + 1]
            if next_off is None:
                next_off = off + 2
            off = ptr
            jumps += 1
            if jumps > 32:
                raise ValueError("pointer loop")
            continue
        if ln == 0:
            off += 1
            break
        labels.append(pkt[off + 1: off + 1 + ln].decode("ascii", "replace"))
        off += 1 + ln
    return ".".join(labels).lower(), (next_off if next_off is not None
                                      else off)


def parse_response(pkt: bytes) -> dict:
    """{id, rcode, answers: [(name, type, ttl, data)], authority,
    additional}: data is an IP string for A, a name for NS and CNAME, the
    raw bytes otherwise."""
    if len(pkt) < 12:
        raise ValueError("short packet")
    qid, flags, qd, an, ns, ar = struct.unpack(">HHHHHH", pkt[:12])
    off = 12
    for _ in range(qd):  # skip the questions
        _, off = _read_name(pkt, off)
        off += 4
    out = {"id": qid, "rcode": flags & 0xF, "answers": [],
           "authority": [], "additional": []}
    for section, count in (("answers", an), ("authority", ns),
                           ("additional", ar)):
        for _ in range(count):
            name, off = _read_name(pkt, off)
            if off + 10 > len(pkt):
                raise ValueError("truncated rr")
            rtype, _rclass, ttl, rdlen = struct.unpack(
                ">HHIH", pkt[off: off + 10])
            off += 10
            rdata = pkt[off: off + rdlen]
            if rtype == QTYPE_A and rdlen == 4:
                data = socket.inet_ntoa(rdata)
            elif rtype in (QTYPE_NS, QTYPE_CNAME):
                data, _ = _read_name(pkt, off)
            else:
                data = rdata
            off += rdlen
            out[section].append((name, rtype, int(ttl), data))
    return out


class DnsResolver:
    """A-record resolver over the configured servers. The default mode
    sets RD and lets a recursive upstream walk; ``iterative=True`` starts
    at the servers as roots and follows referrals."""

    def __init__(self, servers: list[str] | None = None,
                 iterative: bool = False, port: int = 53):
        env = os.environ.get("OSSE_DNS_SERVERS", "")
        self.servers = list(servers or [s for s in env.split(",") if s])
        self.iterative = iterative
        self.port = port
        # host -> ip on the cache plane (the Msg13 DNS cache); a negative
        # answer is cached as None, hence lookup()'s (hit, value)
        from ..cache import g_cacheplane
        self._cache = g_cacheplane.register(
            "dns", ttl_s=TTL_MAX_S, max_entries=200_000,
            desc="A-record answers incl. negatives (Msg13 DNS cache)")
        self._inflight: dict = {}
        self._lock = make_lock("dns.inflight")
        self._rr = 0  # the server round-robin cursor

    # -- cache ----------------------------------------------------------

    def _cache_get(self, host: str) -> tuple[bool, str | None]:
        return self._cache.lookup(host)

    def _cache_put(self, host: str, ip: str | None, ttl: float) -> None:
        ttl = min(max(ttl, TTL_MIN_S), TTL_MAX_S) if ip is not None \
            else NEGATIVE_TTL_S
        self._cache.put(host, ip, ttl_s=ttl)

    # -- wire -----------------------------------------------------------

    def _ask(self, server: str, name: str, deadline: float,
             recurse: bool) -> dict | None:
        qid = secrets.randbelow(1 << 16)
        pkt = build_query(name, qid, recurse=recurse)
        timeout = min(TRY_TIMEOUT_S, max(deadline - time.monotonic(), 0.05))
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.settimeout(timeout)
                host, _, prt = server.partition(":")
                s.sendto(pkt, (host, int(prt) if prt else self.port))
                while True:
                    data, _ = s.recvfrom(4096)
                    resp = parse_response(data)
                    if resp["id"] == qid:  # ignore spoofed or stale ids
                        return resp
        except Exception:  # noqa: BLE001 — timeout, net error, parse
            return None

    # -- resolution -----------------------------------------------------

    def resolve(self, host: str,
                budget_s: float | None = None) -> str | None:
        """The first A record of host, or None. Bounded by ``budget_s``
        (default TOTAL_BUDGET_S) of wall time, shared across CNAME hops
        and glueless-referral sub-lookups."""
        budget = budget_s if budget_s is not None else TOTAL_BUDGET_S
        host = host.strip(".").lower()
        hit, ip = self._cache_get(host)
        if hit:
            return ip
        with self._lock:
            ev = self._inflight.get(host)
            if ev is None:
                ev = self._inflight[host] = make_event("dns.flight")
                owner = True
            else:
                owner = False
        if not owner:
            ev.wait(budget + 1.0)
            hit, ip = self._cache_get(host)
            return ip
        try:
            ip, ttl = self._resolve_uncached(host,
                                             time.monotonic() + budget)
            self._cache_put(host, ip, ttl)
            return ip
        finally:
            with self._lock:
                self._inflight.pop(host, None)
            ev.set()

    def _resolve_uncached(self, host: str,
                          deadline: float) -> tuple[str | None, float]:
        name = host
        servers = list(self.servers)
        if not servers:
            return None, 0.0
        for _ in range(MAX_CNAME_DEPTH):
            resp = self._walk(name, servers, deadline)
            if resp is None:
                return None, 0.0
            a = [(n, t, ttl, d) for n, t, ttl, d in resp["answers"]
                 if t == QTYPE_A and n == name]
            if a:
                return a[0][3], float(a[0][2])
            cn = [(ttl, d) for n, t, ttl, d in resp["answers"]
                  if t == QTYPE_CNAME and n == name]
            if cn:
                name = cn[0][1]
                # the target's A records may ride the same response
                a2 = [(ttl, d) for n, t, ttl, d in resp["answers"]
                      if t == QTYPE_A and n == name]
                if a2:
                    return a2[0][1], float(a2[0][0])
                continue
            return None, 0.0
        return None, 0.0

    def _walk(self, name: str, servers: list[str],
              deadline: float) -> dict | None:
        """One query in recursive mode; the referral-following descent in
        iterative mode."""
        if not self.iterative:
            for i in range(len(servers)):
                if time.monotonic() >= deadline:
                    return None
                server = servers[(self._rr + i) % len(servers)]
                resp = self._ask(server, name, deadline, recurse=True)
                if resp is not None and resp["rcode"] in (0, 3):
                    self._rr = (self._rr + i + 1) % len(servers)
                    return resp
            return None
        cur = list(servers)
        for _ in range(MAX_REFERRAL_DEPTH):
            resp = None
            for server in cur:
                if time.monotonic() >= deadline:
                    return None
                resp = self._ask(server, name, deadline, recurse=False)
                if resp is not None and resp["rcode"] in (0, 3):
                    break
            if resp is None:
                return None
            if resp["answers"] or resp["rcode"] == 3:
                return resp
            # a referral: NS in authority, glue A in additional
            ns_names = [d for _, t, _, d in resp["authority"]
                        if t == QTYPE_NS]
            glue = [d for n, t, _, d in resp["additional"]
                    if t == QTYPE_A and n in ns_names]
            if not glue:
                # glueless: resolve one NS name under the SAME deadline
                # (a fresh budget per level would let a hostile zone
                # stall the crawler N x 5 s)
                nxt = None
                for nsn in ns_names[:2]:
                    nxt = self._resolve_uncached(nsn, deadline)[0] \
                        if time.monotonic() < deadline else None
                    if nxt:
                        break
                if not nxt:
                    return None
                glue = [nxt]
            cur = glue
        return None

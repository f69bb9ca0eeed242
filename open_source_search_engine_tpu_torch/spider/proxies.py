"""SpiderProxy: a pool of crawl proxies with ban detection.

Port of ``open_source_search_engine_tpu/spider/proxies.py`` (reference
``SpiderProxy.h:27``, ``SpiderProxy.cpp``): a proxy per target first IP,
so load spreads and a site sees a stable exit; outstanding downloads
counted per proxy; ban pages detected (``isProxyBanPage``,
``SpiderProxy.cpp:1048``), and a banned (proxy, IP) pair cooled down
while other IPs keep using the proxy. The pool lives beside the fetcher:
each node owns the pool for the IPs it crawls.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

from ..utils.lockcheck import make_lock
from ..utils.log import get_logger

log = get_logger("proxy")

#: how long a banned (proxy, ip) pair sits out
BAN_COOLDOWN_S = 600.0

#: ban-page markers (captcha and access-denied boilerplate); 403 and 429
#: count on their own
_BAN_RE = re.compile(
    r"captcha|access denied|forbidden|unusual traffic|"
    r"blocked|are you a robot", re.IGNORECASE)
_BAN_SCAN_BYTES = 4096


def looks_banned(status: int, content: str) -> bool:
    """Does this response read as a proxy or crawler ban page?"""
    if status in (403, 429):
        return True
    if status == 200 and content and \
            _BAN_RE.search(content[:_BAN_SCAN_BYTES]) and \
            len(content) < 8192:
        # a short page shouting captcha or denied is a ban interstitial;
        # a long real document may contain the words
        return True
    return False


@dataclass
class _ProxyState:
    addr: str                 # "host:port"
    outstanding: int = 0      # downloads in flight through it
    #: target ip -> ban expiry (monotonic)
    banned_until: dict = field(default_factory=dict)


class ProxyPool:
    """Per-target-IP proxy assignment and ban rotation."""

    def __init__(self, proxies: list[str] | None = None):
        self._lock = make_lock("spider.proxies")
        self._proxies = [_ProxyState(p) for p in (proxies or []) if p]

    @classmethod
    def from_conf(cls, conf) -> "ProxyPool":
        raw = getattr(conf, "spider_proxies", "") or ""
        return cls([p.strip() for p in raw.split(",") if p.strip()])

    def __bool__(self) -> bool:
        return bool(self._proxies)

    def pick(self, target_ip: str) -> str | None:
        """The proxy for this target IP: sticky by the IP's hash, skipping
        banned pairs, the least loaded candidate when the sticky one is
        markedly busier. None when every proxy is banned for the IP."""
        with self._lock:
            if not self._proxies:
                return None
            now = time.monotonic()
            n = len(self._proxies)
            start = hash(target_ip) % n
            order = [self._proxies[(start + i) % n] for i in range(n)]
            live = [p for p in order
                    if p.banned_until.get(target_ip, 0.0) <= now]
            if not live:
                return None  # every proxy banned for this ip: direct
            best = min(live, key=lambda p: p.outstanding)
            chosen = live[0] if live[0].outstanding \
                <= best.outstanding + 4 else best
            chosen.outstanding += 1
            return chosen.addr

    def release(self, addr: str) -> None:
        with self._lock:
            for p in self._proxies:
                if p.addr == addr and p.outstanding > 0:
                    p.outstanding -= 1
                    return

    def report(self, addr: str, target_ip: str, status: int,
               content: str = "") -> bool:
        """Feed a response back; True when it read as a ban (the pair is
        cooled down and the caller retries through the next proxy)."""
        banned = looks_banned(status, content)
        if banned:
            with self._lock:
                for p in self._proxies:
                    if p.addr == addr:
                        p.banned_until[target_ip] = \
                            time.monotonic() + BAN_COOLDOWN_S
                        log.info("proxy %s banned for ip %s (status %d)",
                                 addr, target_ip, status)
                        break
        return banned

    def status(self) -> list[dict]:
        """The admin view (the reference's proxy table page)."""
        now = time.monotonic()
        with self._lock:
            return [{
                "addr": p.addr,
                "outstanding": p.outstanding,
                "banned_ips": sum(1 for t in p.banned_until.values()
                                  if t > now),
            } for p in self._proxies]

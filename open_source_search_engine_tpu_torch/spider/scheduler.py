"""Spider scheduler: the URL frontier with filters, priorities and
politeness.

Port of ``open_source_search_engine_tpu/spider/scheduler.py`` (reference
``Spider.{h,cpp}``): SpiderRequests keyed by (firstIP, urlhash), a
per-IP politeness wait feeding doledb, the per-priority ready queue that
``SpiderLoop::spiderDoledUrls`` (``Spider.cpp:6758``) drains, and the
collection's URL filter rows (pattern -> priority, max hops, allow,
delay). A prior reply suppresses a duplicate.

One scheduler object holds the seen set (the replies), the per-IP ready
times and in-flight locks, and a priority heap (doledb).
:class:`~.spiderdb.DurableSpiderScheduler` keeps the same state in an
Rdb.
"""

from __future__ import annotations

import heapq
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..utils import ghash
from ..utils.url import normalize


@dataclass
class UrlFilterRule:
    """One URL filter row (the reference's per-collection table)."""

    pattern: str                  # a substring, or regex:..., of the URL
    priority: int = 0             # higher doles sooner
    max_hops: int | None = None   # overrides the crawl depth
    allow: bool = True            # False: never spider
    delay_s: float = 0.25         # per-IP politeness for matching URLs
    _re: re.Pattern | None = None

    def matches(self, url: str) -> bool:
        if self.pattern == "*":
            return True
        if self.pattern.startswith("regex:"):
            if self._re is None:
                self._re = re.compile(self.pattern[6:])
            return bool(self._re.search(url))
        return self.pattern in url


DEFAULT_FILTERS = [UrlFilterRule("*", priority=0)]


@dataclass(order=True)
class _Doled:
    sort_key: tuple
    url: str = field(compare=False)
    hopcount: int = field(compare=False)
    priority: int = field(compare=False)
    first_ip: str = field(compare=False, default="")


@dataclass
class SpiderRequest:
    url: str
    hopcount: int = 0
    priority: int = 0
    added: float = 0.0
    first_ip: str = ""


class SpiderScheduler:
    """Frontier, politeness and dedup (spiderdb, doledb, waiting tree)."""

    def __init__(self, filters: list[UrlFilterRule] | None = None,
                 max_hops: int = 3, same_host_only: bool = False,
                 banned=None, resolver=None):
        self.filters = filters or list(DEFAULT_FILTERS)
        self.max_hops = max_hops
        self.same_host_only = same_host_only
        #: an optional url -> bool hook, normally Tagdb.is_banned: a
        #: banned site never enters the frontier
        self.banned = banned
        #: host -> first IP (injectable for tests and offline crawls)
        self.resolver = resolver
        self.seen: set[int] = set()          # urlhash (spider replies)
        self.heap: list[_Doled] = []         # doledb
        #: per-IP politeness and in-flight locks: two hosts behind one IP
        #: share a window, and an IP with a fetch in flight never doles
        #: again until ``release`` (the doledb-lock role, lock-free
        #: because one scheduler owns each IP)
        self.ip_ready_at: dict[str, float] = {}
        self.ip_delay: dict[str, float] = {}
        self.ip_inflight: set[str] = set()
        self.roots: set[str] = set()         # seed hosts (same_host_only)
        self.n_added = 0
        self.n_doled = 0

    def _ip_of(self, host: str) -> str:
        from ..utils import ipresolve
        if self.resolver is not None:
            return self.resolver(host)
        return ipresolve.first_ip(host)

    # --- adds (spiderdb writes) ---

    def add_url(self, url: str, hopcount: int = 0,
                _ip: str | None = None) -> bool:
        """Queue a URL if the filters allow it and it was not seen.
        ``_ip`` skips resolution when the caller knows the first IP (a
        durable reload replays the stored IPs)."""
        try:
            u = normalize(url)
        except Exception:  # noqa: BLE001 — junk URLs abound
            return False
        if u.scheme not in ("http", "https"):
            return False
        h = ghash.hash64(u.full)
        if h in self.seen:
            return False
        rule = self._rule_for(u.full)
        if rule is None or not rule.allow:
            return False
        if self.banned is not None and self.banned(u.full):
            return False
        cap = rule.max_hops if rule.max_hops is not None else self.max_hops
        if hopcount > cap:
            return False
        if self.same_host_only and self.roots and u.host not in self.roots:
            return False
        if hopcount == 0:
            self.roots.add(u.host)
        self.seen.add(h)
        ip = _ip if _ip is not None else self._ip_of(u.host)
        self.last_added_ip = ip
        self.ip_delay.setdefault(ip, rule.delay_s)
        # the lowest sort key pops first: (-priority, hopcount, arrival)
        self.n_added += 1
        heapq.heappush(self.heap, _Doled(
            sort_key=(-rule.priority, hopcount, self.n_added),
            url=u.full, hopcount=hopcount, priority=rule.priority,
            first_ip=ip))
        return True

    def _rule_for(self, url: str) -> UrlFilterRule | None:
        for r in self.filters:
            if r.matches(url):
                return r
        return None

    # --- doling (doledb reads) ---

    def next_batch(self, n: int, now: float | None = None
                   ) -> list[SpiderRequest]:
        """Pop up to n URLs whose first IPs are past their politeness
        window and not in flight: one URL per IP per batch, and an IP is
        never fetched concurrently, even across hosts."""
        now = time.monotonic() if now is None else now
        out: list[SpiderRequest] = []
        requeue: list[_Doled] = []
        batch_ips: set[str] = set()
        while self.heap and len(out) < n:
            d = heapq.heappop(self.heap)
            ip = d.first_ip or self._ip_of(normalize(d.url).host)
            if (ip in self.ip_inflight or ip in batch_ips
                    or self.ip_ready_at.get(ip, 0.0) > now):
                requeue.append(d)
                continue
            batch_ips.add(ip)
            self.ip_inflight.add(ip)
            self.n_doled += 1
            out.append(SpiderRequest(url=d.url, hopcount=d.hopcount,
                                     priority=d.priority, added=now,
                                     first_ip=ip))
        for d in requeue:
            heapq.heappush(self.heap, d)
        return out

    def release(self, url: str, now: float | None = None,
                first_ip: str | None = None) -> None:
        """A fetch attempt finished (any outcome): release the IP's
        in-flight lock and start its politeness window from completion.

        ``first_ip`` should be the IP the request was doled under: a
        fresh resolution after a TTL lapse could name another IP and
        leave the first one locked for good."""
        now = time.monotonic() if now is None else now
        ip = first_ip
        if not ip:
            try:
                ip = self._ip_of(normalize(url).host)
            except Exception:  # noqa: BLE001 — an unparsable URL
                return
        self.ip_inflight.discard(ip)
        self.ip_ready_at[ip] = now + self.ip_delay.get(ip, 0.25)

    def __len__(self) -> int:
        return len(self.heap)

    @property
    def exhausted(self) -> bool:
        return not self.heap

    # --- persistence ---

    def save_to(self, path: str | Path) -> None:
        """Persist the frontier and the seen set, so a restart resumes
        the crawl."""
        Path(path).write_text(json.dumps({
            "seen": list(self.seen),
            "heap": [[list(d.sort_key), d.url, d.hopcount, d.priority]
                     for d in self.heap],
            "roots": sorted(self.roots),
            "n_added": self.n_added,
            "n_doled": self.n_doled,
        }))

    def load_from(self, path: str | Path) -> bool:
        p = Path(path)
        if not p.exists():
            return False
        state = json.loads(p.read_text())
        self.seen = set(state["seen"])
        self.heap = [_Doled(sort_key=tuple(k), url=u, hopcount=h,
                            priority=pr)
                     for k, u, h, pr in state["heap"]]
        heapq.heapify(self.heap)
        self.roots = set(state["roots"])
        self.n_added = state["n_added"]
        self.n_doled = state["n_doled"]
        return True

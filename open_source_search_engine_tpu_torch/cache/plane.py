"""Unified cache plane — named generation-keyed caches behind one registry.

A copy of ``open_source_search_engine_tpu/cache/plane.py``; the port imports
nothing of that package.

Reference: ``RdbCache.cpp`` is the ONE cache class behind every hot
lookup in the original engine — termlists (``Msg0``'s disk-page cache),
title recs (``Msg22``), DNS and robots.txt (``Msg13``), and the query
result cache (``Msg17``/``Msg40Cache``). One implementation meant one
accounting story (``Mem.cpp`` labels), one invalidation trick and one
admin page. Our reproduction had grown four ad-hoc caches instead; this
module is the consolidation:

* :class:`GenCache` — keyed TTL entries stamped with a **generation**
  (any equality-comparable value, usually the owning Rdb's ``version``
  or a tuple of shard versions). A write bumps the owner's version, so
  every dependent entry goes stale in O(1) with zero scanning — the
  termlist-cache trick from the reference, generalized.
* **Single-flight** (:meth:`GenCache.get_or_compute`) — N concurrent
  identical misses share ONE compute; followers block on the leader's
  result instead of stampeding the device (dogpile suppression).
* **Stale-while-revalidate** — within ``swr_s`` past expiry a hot key
  serves the stale value immediately and refreshes in the background
  (generation mismatches are NEVER served stale: staleness bounded by
  TTL is acceptable, staleness across a write is not).
* **Membudget charging** — every cache reports its byte estimate as a
  ``cache``-label gauge in :data:`~..utils.membudget.g_membudget`, and
  the plane registers a pressure handler: under memory pressure caches
  shed (biggest first) BEFORE real work (the query packer, a merge) is
  refused. A cache is the definition of droppable memory.
* **Observability** — per-cache hit/miss/evict/inflight counters and
  gauges in :data:`~..utils.stats.g_stats` (``cache.<name>.*``), fills
  timed under ``trace.timed_span`` so cache fills show up in query
  waterfalls, and ``/admin/cache`` lists every registered cache with a
  flush button.

The registry (:class:`CachePlane`, singleton :data:`g_cacheplane`)
holds caches weakly: a cache dies with its owner (a DeviceIndex swap, a
server) and drops off the admin page and the membudget gauges without
ceremony. Departure from the reference: ``GenCache.__del__`` queues its
gauge drop (``MemBudget.set_gauge_later``) instead of taking the
membudget lock, so a finalizer run by the cyclic collector never waits.

``OSSE_CACHE=0`` disables the whole plane (every lookup misses, every
put is dropped): the plane's A/B switch.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Hashable

import numpy as np

from ..utils import threads, trace as trace_mod
from ..utils.lockcheck import make_event, make_lock
from ..utils.log import get_logger
from ..utils.membudget import g_membudget
from ..utils.stats import g_stats

log = get_logger("cache")

#: membudget label every cache charges under (one row on /admin/mem)
MEM_LABEL = "cache"

#: sentinel: "no generation supplied on this call — use the cache's
#: gen_fn (or None)"; distinct from gen=None, a legal generation value
_UNSET = object()


def _estimate_cost(value: Any, _depth: int = 0) -> int:
    """Rough byte cost of a cached value (strings/arrays dominate every
    real payload here; exactness doesn't matter, ordering under
    pressure does). Bounded recursion so adversarial nesting can't make
    a put() O(deep)."""
    if value is None or isinstance(value, (bool, int, float)):
        return 16
    if isinstance(value, (str, bytes, bytearray)):
        return len(value) + 48
    if isinstance(value, np.ndarray):
        return int(value.nbytes) + 96
    if _depth >= 4:
        return 64
    if isinstance(value, dict):
        return 64 + sum(_estimate_cost(k, _depth + 1)
                        + _estimate_cost(v, _depth + 1)
                        for k, v in value.items())
    if isinstance(value, (list, tuple, set, frozenset)):
        return 56 + sum(_estimate_cost(v, _depth + 1) for v in value)
    # dataclass-ish object (a ResidentPlan, a SearchResults): charge
    # its array/str attributes
    d = getattr(value, "__dict__", None)
    if isinstance(d, dict) and d:
        return 64 + sum(_estimate_cost(v, _depth + 1)
                        for v in d.values())
    return 128


class _Flight:
    """One in-flight compute (the single-flight unit): the leader fills
    ``value``/``err`` and sets the event; followers wait on it. The
    flight remembers the generation its leader started under — a caller
    whose generation differs must NOT join: the leader's result is
    pre-write from that caller's point of view."""

    __slots__ = ("event", "value", "err", "gen")

    def __init__(self, gen: Any = None):
        self.event = make_event("cache.flight")
        self.value: Any = None
        self.err: BaseException | None = None
        self.gen = gen


class GenCache:
    """One named cache on the plane: TTL + generation entries, byte
    accounting, single-flight, optional stale-while-revalidate.

    Entries are ``key -> (expiry, gen, cost, value)``. A lookup hits
    only when the entry is unexpired AND its generation equals the
    current one (per-call ``gen=``, else the cache's ``gen_fn()``, else
    None). Generations are compared by ``==`` so ints, tuples of shard
    versions, or vectors all work.
    """

    def __init__(self, name: str, ttl_s: float = 60.0,
                 max_entries: int = 4096,
                 gen_fn: Callable[[], Any] | None = None,
                 cost_fn: Callable[[Any], int] | None = None,
                 desc: str = ""):
        self.name = name
        self.ttl_s = float(ttl_s)
        self.max_entries = int(max_entries)
        self.gen_fn = gen_fn
        self.cost_fn = cost_fn or _estimate_cost
        self.desc = desc
        #: per-cache kill switch (the bench's A/B lever): False makes
        #: every lookup miss and every put a no-op
        self.enabled = True
        self._d: dict[Hashable, tuple[float, Any, int, Any]] = {}
        self._bytes = 0
        self._lock = make_lock("cache.gencache")
        self._inflight: dict[Hashable, _Flight] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_served = 0

    # --- generation -------------------------------------------------------

    def _gen(self, gen: Any) -> Any:
        if gen is not _UNSET:
            return gen
        return self.gen_fn() if self.gen_fn is not None else None

    def current_gen(self) -> Any:
        """The generation new entries would be stamped with right now
        (admin-page display; None when the cache is ungenerated)."""
        return self._gen(_UNSET)

    # --- accounting -------------------------------------------------------

    def _charge_locked(self) -> None:
        g_membudget.set_gauge(MEM_LABEL, self.name, self._bytes)
        g_stats.gauge(f"cache.{self.name}.entries", len(self._d))
        g_stats.gauge(f"cache.{self.name}.bytes", self._bytes)

    def _evict_locked(self, now: float, gen: Any) -> None:
        """Room-making sweep (the ttlcache satellite's rule, shared):
        dead-generation and already-expired entries go first — they are
        free wins — and only then the stalest half by expiry."""
        dead = [k for k, (exp, g, _, _) in self._d.items()
                if exp < now or g != gen]
        for k in dead:
            exp, g, cost, _ = self._d.pop(k)
            self._bytes -= cost
        evicted = len(dead)
        if len(self._d) >= self.max_entries:
            for k in sorted(self._d, key=lambda k: self._d[k][0])[
                    : max(self.max_entries // 2, 1)]:
                self._bytes -= self._d.pop(k)[2]
                evicted += 1
        if evicted:
            self.evictions += evicted
            g_stats.count(f"cache.{self.name}.evict", evicted)

    # --- core ops ---------------------------------------------------------

    def lookup(self, key: Hashable, gen: Any = _UNSET
               ) -> tuple[bool, Any]:
        """``(hit, value)`` — a miss is ``(False, None)``. Values may
        legitimately BE None (negative DNS answers), hence the flag."""
        if not self.enabled:
            return False, None
        g = self._gen(gen)
        now = time.monotonic()
        with self._lock:
            e = self._d.get(key)
            if e is not None and e[0] >= now and e[1] == g:
                self.hits += 1
                g_stats.count(f"cache.{self.name}.hit")
                return True, e[3]
            self.misses += 1
            g_stats.count(f"cache.{self.name}.miss")
            return False, None

    def get(self, key: Hashable, gen: Any = _UNSET,
            default: Any = None) -> Any:
        hit, v = self.lookup(key, gen=gen)
        return v if hit else default

    def lookup_stale(self, key: Hashable, gen: Any = _UNSET
                     ) -> tuple[bool, Any]:
        """``(hit, value)`` ignoring TTL expiry — but never crossing a
        generation move (a write still invalidates; only time is
        softened). The deadline plane uses this: a just-expired answer
        served as degraded beats refusing an over-budget query."""
        if not self.enabled:
            return False, None
        g = self._gen(gen)
        with self._lock:
            e = self._d.get(key)
            if e is not None and e[1] == g:
                self.stale_served += 1
                g_stats.count(f"cache.{self.name}.stale")
                return True, e[3]
            return False, None

    def put(self, key: Hashable, value: Any, ttl_s: float | None = None,
            gen: Any = _UNSET, cost: int | None = None) -> None:
        if not self.enabled:
            return
        g = self._gen(gen)
        c = int(cost if cost is not None else self.cost_fn(value))
        now = time.monotonic()
        with self._lock:
            old = self._d.get(key)
            if old is not None:
                self._bytes -= old[2]
            elif len(self._d) >= self.max_entries:
                self._evict_locked(now, g)
            self._d[key] = (now + (self.ttl_s if ttl_s is None
                                   else float(ttl_s)), g, c, value)
            self._bytes += c
            self._charge_locked()

    def invalidate(self, key: Hashable) -> None:
        with self._lock:
            e = self._d.pop(key, None)
            if e is not None:
                self._bytes -= e[2]
                self._charge_locked()

    def flush(self) -> int:
        """Drop everything; returns the bytes freed (pressure-handler
        accounting)."""
        with self._lock:
            freed = self._bytes
            self._d.clear()
            self._bytes = 0
            self._charge_locked()
        return freed

    # --- single-flight + stale-while-revalidate ---------------------------

    def get_or_compute(self, key: Hashable, compute: Callable[[], Any],
                       ttl_s: float | None = None, gen: Any = _UNSET,
                       swr_s: float = 0.0) -> tuple[Any, str]:
        """The full-service read: ``(value, status)`` where status is
        ``"hit"`` (fresh), ``"stale"`` (expired-but-within-swr, same
        generation — served immediately, refresh fired in background),
        ``"join"`` (waited on another caller's identical in-flight
        compute), or ``"miss"`` (this caller computed).

        Single-flight: concurrent identical misses elect one leader;
        the rest block on its result. A leader failure propagates to
        every waiter of that flight (retrying N times in lockstep is
        the stampede this exists to prevent). A caller only joins a
        flight whose leader started under the SAME generation — if a
        write moved the generation since the leader began, the leader's
        result is pre-write and the caller computes its own. Stale
        serves never cross a generation move — a write invalidates
        instantly; only TTL expiry is softened. The generation is
        captured once at entry and stamps the stored entry, so a write
        landing during the compute yields a dead entry (a later miss),
        never a pre-write value passing as fresh.
        """
        if not self.enabled:
            return compute(), "miss"
        g = self._gen(gen)
        now = time.monotonic()
        with self._lock:
            e = self._d.get(key)
            if e is not None and e[1] == g:
                if e[0] >= now:
                    self.hits += 1
                    g_stats.count(f"cache.{self.name}.hit")
                    return e[3], "hit"
                if now <= e[0] + swr_s:
                    # hot key just past TTL: serve stale, refresh once
                    self.hits += 1
                    self.stale_served += 1
                    g_stats.count(f"cache.{self.name}.hit")
                    g_stats.count(f"cache.{self.name}.stale")
                    self._spawn_refresh_locked(key, compute, ttl_s, g)
                    return e[3], "stale"
            self.misses += 1
            g_stats.count(f"cache.{self.name}.miss")
            fl = self._inflight.get(key)
            if fl is not None and fl.gen == g:
                leader = False
            else:
                # no flight, or the in-flight leader started under a
                # different generation (a write landed since it began):
                # its value is pre-write for us, so compute our own
                # rather than join; only register in the flight map
                # when the slot is actually free
                registered = fl is None
                fl = _Flight(g)
                if registered:
                    self._inflight[key] = fl
                leader = True
            g_stats.gauge(f"cache.{self.name}.inflight",
                          len(self._inflight))
        if not leader:
            g_stats.count(f"cache.{self.name}.join")
            fl.event.wait()
            if fl.err is not None:
                raise fl.err
            return fl.value, "join"
        try:
            with trace_mod.timed_span(f"cache.{self.name}.fill"):
                value = compute()
            fl.value = value
            # stamp with the generation captured at ENTRY, not re-read
            # now: a write landing during the compute must leave this
            # entry dead (a miss), never stale-served-fresh
            self.put(key, value, ttl_s=ttl_s, gen=g)
        except BaseException as exc:
            fl.err = exc
            raise
        finally:
            # value/err are published BEFORE the event: a follower must
            # never wake to an unfilled flight
            with self._lock:
                if self._inflight.get(key) is fl:
                    del self._inflight[key]
                g_stats.gauge(f"cache.{self.name}.inflight",
                              len(self._inflight))
            fl.event.set()
        return value, "miss"

    def _spawn_refresh_locked(self, key, compute, ttl_s, g) -> None:
        """Background SWR refresh, deduped through the in-flight map
        (caller holds the lock). ``g`` is the resolved generation the
        stale serve happened under — the refreshed entry is stamped
        with it, so a write landing mid-refresh leaves a dead entry
        rather than a stale one passing as fresh."""
        if key in self._inflight:
            return  # a refresh (or a concurrent miss) already runs
        fl = self._inflight[key] = _Flight(g)

        def _refresh():
            try:
                with trace_mod.timed_span(f"cache.{self.name}.refresh"):
                    value = compute()
                fl.value = value
                self.put(key, value, ttl_s=ttl_s, gen=g)
            except BaseException as exc:  # noqa: BLE001 — background
                fl.err = exc
                log.warning("swr refresh of %s[%r] failed: %s",
                            self.name, key, exc)
            finally:
                with self._lock:
                    if self._inflight.get(key) is fl:
                        del self._inflight[key]
                fl.event.set()

        threads.spawn(f"swr-{self.name}", _refresh)

    # --- introspection ----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            gen = None
            try:
                gen = self.current_gen()
            except Exception as exc:  # noqa: BLE001 — owner half-dead
                g_stats.count(f"cache.{self.name}.gen_error")
                log.debug("gen_fn of %s failed: %s", self.name, exc)
            return {
                "entries": len(self._d),
                "bytes": self._bytes,
                "max_entries": self.max_entries,
                "ttl_s": self.ttl_s,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "evictions": self.evictions,
                "stale_served": self.stale_served,
                "inflight": len(self._inflight),
                "generation": repr(gen),
                "enabled": self.enabled,
                "desc": self.desc,
            }

    def __del__(self):  # noqa: D105 — drop the membudget gauge with us
        # the cyclic collector may run this inside a locked membudget
        # section of the same thread (the reference's self-deadlock):
        # queue the drop, taking no lock; the next locked call applies it
        g_membudget.set_gauge_later(MEM_LABEL, self.name, 0)


class CachePlane:
    """Registry of every live :class:`GenCache` (weakly held) plus the
    one membudget pressure hook for all of them."""

    def __init__(self):
        import weakref
        self._lock = make_lock("cache.plane")
        self._caches: "weakref.WeakValueDictionary[str, GenCache]" = \
            weakref.WeakValueDictionary()
        #: plane-wide kill switch, seeded from OSSE_CACHE (0 = off)
        self.enabled = os.environ.get("OSSE_CACHE", "1") != "0"
        g_membudget.add_pressure_handler(self._on_pressure)

    def register(self, name: str, ttl_s: float = 60.0,
                 max_entries: int = 4096,
                 gen_fn: Callable[[], Any] | None = None,
                 cost_fn: Callable[[Any], int] | None = None,
                 desc: str = "") -> GenCache:
        """Create + register a cache. A live-name collision uniquifies
        (``name#2``): a background DeviceIndex rebuild registers its
        plan cache while the old index still serves."""
        with self._lock:
            final = name
            n = 2
            while final in self._caches:
                final = f"{name}#{n}"
                n += 1
            c = GenCache(final, ttl_s=ttl_s, max_entries=max_entries,
                         gen_fn=gen_fn, cost_fn=cost_fn, desc=desc)
            c.enabled = self.enabled
            self._caches[final] = c
            return c

    def flush(self, name: str | None = None) -> int:
        """Flush one cache (or all); returns bytes freed."""
        with self._lock:
            caches = [self._caches[name]] if name in self._caches \
                else (list(self._caches.values()) if name is None
                      else [])
        return sum(c.flush() for c in caches)

    def snapshot(self) -> dict:
        """name → stats for every live cache (the /admin/cache body)."""
        with self._lock:
            caches = sorted(self._caches.items())
        return {nm: c.stats() for nm, c in caches}

    def _on_pressure(self, need: int) -> int:
        """Membudget relief hook: shed caches biggest-first until the
        shortfall is covered (or everything cached is gone). Caches are
        by definition droppable — they MUST empty before real work (a
        pack pass, a merge) gets refused."""
        with self._lock:
            caches = sorted(self._caches.values(),
                            key=lambda c: -c._bytes)
        freed = 0
        for c in caches:
            if freed >= need:
                break
            b = c.flush()
            if b:
                freed += b
                g_stats.count("cache.pressure_flush")
                log.info("memory pressure: flushed cache %s (%d KB)",
                         c.name, b >> 10)
        return freed


#: process-wide registry (the g_cacheDB... there is no reference
#: singleton name — RdbCache instances were globals; ours meet here)
g_cacheplane = CachePlane()

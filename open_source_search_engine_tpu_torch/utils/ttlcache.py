"""General TTL record cache (the ``RdbCache`` role) for new consumers.

Port of ``open_source_search_engine_tpu/utils/ttlcache.py``: keyed TTL
entries, bounded size with stalest-half eviction (dead-generation and
expired entries go first), thread-safe, and a version tag so a whole
generation is invalidated in O(1)."""

from __future__ import annotations

import time
from typing import Any, Hashable

from .lockcheck import make_lock


class TtlCache:
    def __init__(self, ttl_s: float = 3600.0, max_entries: int = 4096):
        self.ttl_s = ttl_s
        self.max_entries = max_entries
        self._d: dict[Hashable, tuple[float, int, Any]] = {}
        self._lock = make_lock("ttlcache")
        self._version = 0
        self.hits = 0
        self.misses = 0

    def bump_version(self) -> None:
        """Invalidate every current entry in O(1) (a new generation)."""
        with self._lock:
            self._version += 1

    def get(self, key: Hashable):
        now = time.monotonic()
        with self._lock:
            hit = self._d.get(key)
            if hit is None or hit[0] < now or hit[1] != self._version:
                self.misses += 1
                return None
            self.hits += 1
            return hit[2]

    def put(self, key: Hashable, value: Any,
            ttl_s: float | None = None) -> None:
        now = time.monotonic()
        with self._lock:
            if len(self._d) >= self.max_entries:
                dead = [k for k, (exp, ver, _) in self._d.items()
                        if exp < now or ver != self._version]
                for k in dead:
                    del self._d[k]
                if len(self._d) >= self.max_entries:
                    for k in sorted(self._d, key=lambda k: self._d[k][0])[
                            : self.max_entries // 2]:
                        del self._d[k]
            self._d[key] = (now + (ttl_s if ttl_s is not None
                                   else self.ttl_s),
                            self._version, value)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def stats(self) -> dict:
        now = time.monotonic()
        with self._lock:
            # "live" counts only what a get() could still return
            live = sum(1 for exp, ver, _ in self._d.values()
                       if exp >= now and ver == self._version)
            return {"entries": len(self._d), "live": live,
                    "hits": self.hits, "misses": self.misses,
                    "version": self._version}

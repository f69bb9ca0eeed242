"""Metrics — counters, mergeable latency histograms and gauges.

A copy of ``open_source_search_engine_tpu/utils/stats.py`` (the port
imports nothing of that package), with the per-second sample ring the
server's statsdb sampler fills and ``/admin/graph`` draws.

Reference: ``Stats.cpp/h`` (in-RAM per-message latency stats drawn on
PagePerf, ``Stats.h:38`` ``addStat_r``) + ``Statsdb`` (an actual Rdb of
per-second multi-metric samples graphed on PageStatsdb, ``Statsdb.h:24``).

One registry: named counters, named latency recorders and gauges. All
host-side and lock-cheap; the device never sees this.

The latency recorder is an HDR-style **log-linear histogram**: log2
major buckets (one per power of two, down to sub-millisecond) each split
into ``_SUB`` linear sub-buckets, so relative error is bounded by
``1/_SUB`` everywhere instead of a full power of two. Two recorders for
the same metric on different hosts merge by bucket-wise addition —
fleet percentiles come from the merged distribution, never from
averaging per-node percentiles (Dean & Barroso, *The Tail at Scale*).
Each recorder also keeps a bounded set of **exemplars**: occasionally a
sampled trace id is pinned to the bucket its latency landed in, so an
aggregate tail cell can link back to one concrete trace (Dapper).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

# Log-linear bucket geometry. Major bucket = binary exponent of the
# value in ms, clamped to [_E_MIN, _E_MAX]; each major bucket splits
# into _SUB linear sub-buckets. _E_MIN = -10 resolves to ~1µs —
# sub-millisecond cache hits land in real buckets instead of a 1ms
# floor — and _E_MAX = 22 tops out past an hour, same ceiling as the
# old log2 table.
_SUB = 16
_E_MIN = -10
_E_MAX = 22
_N_MAJOR = _E_MAX - _E_MIN + 1
_NBUCKETS = _N_MAJOR * _SUB
_MAX_EXEMPLARS = 8


def _bucket_index(ms: float) -> int:
    if ms <= 0.0:
        return 0
    m, e = math.frexp(ms)          # ms = m * 2**e, m in [0.5, 1)
    if e < _E_MIN:
        return 0
    if e > _E_MAX:
        return _NBUCKETS - 1
    sub = int((m - 0.5) * 2.0 * _SUB)
    if sub >= _SUB:                # m == 1-epsilon rounding guard
        sub = _SUB - 1
    return (e - _E_MIN) * _SUB + sub


def _bucket_bounds(idx: int) -> tuple[float, float]:
    """[lo, hi) value range of bucket ``idx`` in ms."""
    major, sub = divmod(idx, _SUB)
    e = major + _E_MIN
    width = 2.0 ** e               # major bucket spans [2**(e-1), 2**e)
    lo = width * (0.5 + sub / (2.0 * _SUB))
    hi = width * (0.5 + (sub + 1) / (2.0 * _SUB))
    return lo, hi


class LatencyStat:
    """One metric's mergeable log-linear histogram + summary moments."""

    __slots__ = ("count", "total_ms", "min_ms", "max_ms", "buckets",
                 "exemplars")

    def __init__(self):
        self.count: int = 0
        self.total_ms: float = 0.0
        self.min_ms: float = float("inf")
        self.max_ms: float = 0.0
        #: sparse histogram: bucket index -> sample count
        self.buckets: dict[int, int] = {}
        #: bucket index -> (trace_id, ms) — bounded, newest-wins
        self.exemplars: dict[int, tuple[str, float]] = {}

    def add(self, ms: float, exemplar: str | None = None) -> None:
        self.count += 1
        self.total_ms += ms
        if ms < self.min_ms:
            self.min_ms = ms
        if ms > self.max_ms:
            self.max_ms = ms
        idx = _bucket_index(ms)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        if exemplar is not None:
            if idx not in self.exemplars and \
                    len(self.exemplars) >= _MAX_EXEMPLARS:
                # full: keep the exemplar for the slowest buckets (the
                # tail is what /admin/perf links from)
                low = min(self.exemplars)
                if idx > low:
                    del self.exemplars[low]
                    self.exemplars[idx] = (exemplar, ms)
            else:
                self.exemplars[idx] = (exemplar, ms)

    def merge(self, other: "LatencyStat") -> "LatencyStat":
        """Bucket-wise merge of another recorder into this one."""
        self.count += other.count
        self.total_ms += other.total_ms
        if other.min_ms < self.min_ms:
            self.min_ms = other.min_ms
        if other.max_ms > self.max_ms:
            self.max_ms = other.max_ms
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        for idx, ex in other.exemplars.items():
            self.exemplars.setdefault(idx, ex)
        return self

    def quantile(self, q: float) -> float:
        """Quantile from the histogram, linearly interpolated within
        the crossing bucket and clamped to the observed [min, max]."""
        if not self.count:
            return 0.0
        want = q * self.count
        seen = 0
        for idx in sorted(self.buckets):
            n = self.buckets[idx]
            if seen + n >= want:
                lo, hi = _bucket_bounds(idx)
                frac = (want - seen) / n
                v = lo + frac * (hi - lo)
                return min(max(v, self.min_ms), self.max_ms)
            seen += n
        return self.max_ms

    def count_over(self, ms: float) -> int:
        """Samples above ``ms``, interpolating within the crossing
        bucket — the numerator of a latency SLO (`p99 < 500ms` means
        "fraction over 500ms must stay under 1%")."""
        thr = _bucket_index(ms)
        total = 0
        for idx, n in self.buckets.items():
            if idx > thr:
                total += n
            elif idx == thr:
                lo, hi = _bucket_bounds(idx)
                frac = (hi - ms) / (hi - lo) if hi > lo else 0.0
                total += int(round(n * max(0.0, min(1.0, frac))))
        return total

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "avg_ms": self.total_ms / self.count if self.count else 0.0,
            "min_ms": 0.0 if self.count == 0 else self.min_ms,
            "max_ms": self.max_ms,
            "p50_ms": self.quantile(0.50),
            "p99_ms": self.quantile(0.99),
        }

    def to_wire(self) -> dict:
        """Compact JSON-safe form: sparse buckets + moments + exemplars.
        This is what ``/rpc/stats`` ships and ``merge`` reconstitutes —
        raw buckets, not percentiles, so the coordinator can merge."""
        return {
            "count": self.count,
            "total_ms": self.total_ms,
            "min_ms": self.min_ms if self.count else 0.0,
            "max_ms": self.max_ms,
            "buckets": sorted(self.buckets.items()),
            "exemplars": [[idx, tid, ms] for idx, (tid, ms)
                          in sorted(self.exemplars.items())],
        }

    @classmethod
    def from_wire(cls, wire: dict) -> "LatencyStat":
        st = cls()
        st.count = int(wire.get("count", 0))
        st.total_ms = float(wire.get("total_ms", 0.0))
        st.min_ms = float(wire.get("min_ms", 0.0)) if st.count \
            else float("inf")
        st.max_ms = float(wire.get("max_ms", 0.0))
        st.buckets = {int(i): int(n)
                      for i, n in wire.get("buckets", [])}
        st.exemplars = {int(i): (str(tid), float(ms))
                        for i, tid, ms in wire.get("exemplars", [])}
        return st


class Stats:
    """Process-wide metrics registry (``g_stats`` equivalent)."""

    def __init__(self, timeseries_window: int = 600):
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {}
        self.latencies: dict[str, LatencyStat] = {}
        #: last-written point-in-time values (per-host RTT, pool sizes —
        #: the PagePerf gauge row; counters monotonically grow, gauges
        #: overwrite)
        self.gauges: dict[str, float] = {}
        #: per-second samples: (epoch_s, {metric: value}) ring
        self.timeseries: deque = deque(maxlen=timeseries_window)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def record_ms(self, name: str, ms: float,
                  exemplar: str | None = None) -> None:
        with self._lock:
            self.latencies.setdefault(name, LatencyStat()).add(
                ms, exemplar=exemplar)

    def sample(self, **metrics: float) -> None:
        """Append a Statsdb-style timestamped sample row."""
        with self._lock:
            self.timeseries.append((time.time(), dict(metrics)))

    def reset(self) -> None:
        """Zero counters + latency histograms (bench/test isolation).

        Gauges survive: they are point-in-time state written once (pool
        sizes, RTT seeds) that other planes keep reading — use
        ``reset_gauges()`` when a test really needs a blank slate."""
        with self._lock:
            self.counters.clear()
            self.latencies.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "latencies": {k: v.to_dict()
                              for k, v in self.latencies.items()},
                "gauges": dict(self.gauges),
            }

    def wire(self) -> dict:
        """Mergeable snapshot: raw histogram buckets instead of derived
        percentiles — the ``/rpc/stats`` payload a coordinator scrape
        merges into fleet distributions."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "latencies": {k: v.to_wire()
                              for k, v in self.latencies.items()},
                "gauges": dict(self.gauges),
                "timeseries": [(t, dict(m))
                               for t, m in list(self.timeseries)[-60:]],
            }

    def prefixed(self, prefix: str) -> dict:
        """Snapshot filtered to one subsystem's namespace — the admin
        pages' per-plane view (``/admin/cache`` wants ``cache.*`` only)."""
        with self._lock:
            return {
                "counters": {k: v for k, v in self.counters.items()
                             if k.startswith(prefix)},
                "latencies": {k: v.to_dict()
                              for k, v in self.latencies.items()
                              if k.startswith(prefix)},
                "gauges": {k: v for k, v in self.gauges.items()
                           if k.startswith(prefix)},
            }

    def series(self, last_s: float = 600.0) -> list:
        cutoff = time.time() - last_s
        with self._lock:
            return [(t, m) for t, m in self.timeseries if t >= cutoff]


def merge_wire(parts: list[dict]) -> dict:
    """Merge per-host ``Stats.wire()`` payloads into one fleet view:
    counters sum, histograms merge bucket-wise, gauges keep the last
    writer (point-in-time state has no meaningful sum)."""
    counters: dict[str, int] = {}
    lats: dict[str, LatencyStat] = {}
    gauges: dict[str, float] = {}
    for part in parts:
        for k, v in part.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, w in part.get("latencies", {}).items():
            st = LatencyStat.from_wire(w)
            if k in lats:
                lats[k].merge(st)
            else:
                lats[k] = st
        gauges.update(part.get("gauges", {}))
    return {"counters": counters, "latencies": lats, "gauges": gauges}


#: process-wide singleton (reference ``g_stats``)
g_stats = Stats()

"""SLO tracker — declared objectives, rolling error budgets, burn rate.

A copy of ``open_source_search_engine_tpu/utils/slo.py`` (latency
objectives, the degrade signal the admission gate reads); the port
imports nothing of that package. The server's SLO tick evaluates every
10 s, as the reference's statsdb sampler does.

The reference never had this; it is the piece PagePerf/Statsdb stop
short of: turning the measurement substrate into *enforceable*
objectives. An objective declares what "good" means (``query p99 <
500ms``, ``availability 99.9%``) over a rolling window; the tracker
consumes the merged cluster stream (cumulative histogram/counter
reads), differences successive reads into (ts, Δgood, Δbad) deltas,
and derives:

- ``burn_rate``  — observed bad fraction / allowed bad fraction. 1.0
  means the error budget is being spent exactly as fast as it accrues;
  above 1 the objective is burning down.
- ``budget_remaining`` — share of the window's error budget left,
  clamped to [0, 1].

Both export as ``slo.<name>.burn_rate`` / ``slo.<name>.budget_remaining``
gauges, and any objective with burn > 1 raises the process-wide degrade
signal (``g_slo.degraded()``) the cache/membudget planes can observe to
shed optional work before the tail melts.

Evaluation is pull-based: the serve loop (or a test, with an injected
``now``) calls ``evaluate()`` with the latest counters + latency
recorders — local ``g_stats`` on a single host, the scraped-and-merged
fleet view on a coordinator.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

from .stats import LatencyStat, Stats, g_stats


@dataclass
class SloObjective:
    """One declared objective over a rolling window.

    ``kind="latency"``: of the samples in ``metric``'s histogram, the
    fraction above ``threshold_ms`` must stay under ``1 - target``.
    ``kind="availability"``: of ``good_counter + bad_counter`` events,
    the bad fraction must stay under ``1 - target``.
    """
    name: str
    kind: str                      # "latency" | "availability"
    target: float                  # e.g. 0.99 (p99) or 0.999 (99.9%)
    window_s: float = 300.0
    metric: str = ""               # latency: histogram name
    threshold_ms: float = 0.0      # latency: the "< 500ms" bound
    good_counter: str = ""         # availability: success counter
    bad_counter: str = ""          # availability: failure counter
    # cumulative reads at the last evaluate (for delta computation)
    _last: tuple[int, int] | None = field(default=None, repr=False)
    # rolling (ts, d_good, d_bad) deltas inside the window
    _deltas: deque = field(default_factory=deque, repr=False)

    def _cumulative(self, counters: dict,
                    latencies: dict) -> tuple[int, int]:
        """(total, bad) cumulative reads from the current stream."""
        if self.kind == "latency":
            lat = latencies.get(self.metric)
            if lat is None:
                return 0, 0
            if not isinstance(lat, LatencyStat):
                lat = LatencyStat.from_wire(lat)
            return lat.count, lat.count_over(self.threshold_ms)
        good = int(counters.get(self.good_counter, 0))
        bad = int(counters.get(self.bad_counter, 0))
        return good + bad, bad

    def observe(self, counters: dict, latencies: dict,
                now: float) -> dict:
        total, bad = self._cumulative(counters, latencies)
        if self._last is None:
            d_total, d_bad = total, bad
        else:
            # counters reset (bench isolation) read as negative deltas;
            # treat a rewind as a fresh stream
            d_total = total - self._last[0]
            d_bad = bad - self._last[1]
            if d_total < 0 or d_bad < 0:
                d_total, d_bad = total, bad
        self._last = (total, bad)
        if d_total > 0 or d_bad > 0:
            self._deltas.append((now, d_total, d_bad))
        cutoff = now - self.window_s
        while self._deltas and self._deltas[0][0] < cutoff:
            self._deltas.popleft()

        w_total = sum(d[1] for d in self._deltas)
        w_bad = sum(d[2] for d in self._deltas)
        allowed_frac = max(1e-9, 1.0 - self.target)
        if w_total <= 0:
            burn, budget = 0.0, 1.0
        else:
            bad_frac = w_bad / w_total
            burn = bad_frac / allowed_frac
            budget = max(0.0, 1.0 - w_bad / (allowed_frac * w_total))
        return {
            "name": self.name, "kind": self.kind,
            "target": self.target, "window_s": self.window_s,
            "window_total": w_total, "window_bad": w_bad,
            "burn_rate": burn, "budget_remaining": budget,
            "burning": burn > 1.0,
        }


class SloTracker:
    """Registry of objectives + the process-wide degrade signal."""

    def __init__(self, registry: Stats | None = None):
        self._lock = threading.Lock()
        self.objectives: dict[str, SloObjective] = {}
        self.registry = registry if registry is not None else g_stats
        self._burning: set[str] = set()
        #: the last evaluation per objective (the /admin/perf rows)
        self._status: dict[str, dict] = {}

    def declare(self, obj: SloObjective) -> SloObjective:
        with self._lock:
            self.objectives[obj.name] = obj
        return obj

    def declare_latency(self, name: str, metric: str,
                        threshold_ms: float, target: float,
                        window_s: float = 300.0) -> SloObjective:
        """``declare_latency("query_p99", "cluster.query", 500, 0.99)``
        reads as: query p99 < 500ms."""
        return self.declare(SloObjective(
            name=name, kind="latency", target=target,
            window_s=window_s, metric=metric,
            threshold_ms=threshold_ms))

    def evaluate(self, counters: dict | None = None,
                 latencies: dict | None = None,
                 now: float | None = None) -> dict[str, dict]:
        """Run every objective against the given stream (defaults to
        the local registry) and export the gauges. ``now`` is
        injectable so tests can march the window forward without
        sleeping."""
        if counters is None or latencies is None:
            with self.registry._lock:
                counters = dict(self.registry.counters)
                latencies = dict(self.registry.latencies)
        if now is None:
            import time
            now = time.time()
        out: dict[str, dict] = {}
        with self._lock:
            objs = list(self.objectives.values())
        for obj in objs:
            st = obj.observe(counters, latencies, now)
            out[obj.name] = st
            self.registry.gauge(f"slo.{obj.name}.burn_rate",
                                st["burn_rate"])
            self.registry.gauge(f"slo.{obj.name}.budget_remaining",
                                st["budget_remaining"])
        with self._lock:
            self._burning = {n for n, st in out.items()
                             if st["burning"]}
            self._status.update(out)
        self.registry.gauge("slo.degraded", float(len(self._burning)))
        return out

    def status(self) -> dict[str, dict]:
        """The last evaluation per objective."""
        with self._lock:
            return dict(self._status)

    def degraded(self, name: str | None = None) -> bool:
        """The degrade signal: is any objective (or ``name``
        specifically) burning its budget faster than it accrues? Cheap
        enough for cache/membudget planes to poll on their hot paths."""
        with self._lock:
            if name is not None:
                return name in self._burning
            return bool(self._burning)


#: process-wide singleton, parallel to ``g_stats``/``g_tracer``
g_slo = SloTracker()

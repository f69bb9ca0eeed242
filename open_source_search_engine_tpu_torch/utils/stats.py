"""Metrics: named counters and gauges (reference ``Stats.cpp/h``).

A reduced copy of ``open_source_search_engine_tpu/utils/stats.py``: the
counters and gauges the serving planes bump, under the reference's names
(``resident.issue``, ``tenancy.coldstart``, ``build.device_base``, ...).
The latency histograms and the time-series ring wait for the telemetry
plane. All host-side; the device never sees this.
"""

from __future__ import annotations

import threading


class Stats:
    """Process-wide metrics registry (``g_stats``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {}
        #: last-written point-in-time values (counters grow, gauges
        #: overwrite)
        self.gauges: dict[str, float] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def reset(self) -> None:
        """Zero the counters (test isolation); gauges survive."""
        with self._lock:
            self.counters.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges)}


#: process-wide singleton (reference ``g_stats``)
g_stats = Stats()

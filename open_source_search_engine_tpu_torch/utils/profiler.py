"""Sampling profiler — where is the process spending its time?

Port of ``open_source_search_engine_tpu/utils/profiler.py`` (the port
imports nothing of that package). Reference: ``Profiler.cpp/h`` — a
SIGPROF-style sampler (``startRealTimeProfiler`` ``Profiler.cpp:1586``
arms ``setitimer``; ``getStackFrame`` ``Profiler.cpp:1446`` walks the
stack into a buffer rendered by the profiler admin page) plus the
quickpoll-miss tracker naming functions that hog the event loop.

Here: a sampler THREAD walks every Python thread's current frame stack
via ``sys._current_frames()`` at a fixed rate and aggregates
(function, file:line) self/cumulative hit counts — the same product as
the reference's IP-buffer histogram, without signals (signal-based
sampling can't interrupt C extensions portably; a thread sees exactly
the frames the GIL publishes). Rendered by ``/admin/profiler``.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter

from . import threads
from .log import get_logger

log = get_logger("profiler")


class SamplingProfiler:
    """Start/stop stack sampler with per-function hit aggregation."""

    def __init__(self, interval_s: float = 0.01):
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples = 0
        #: sampler-loop exceptions survived (visible in report())
        self.sample_errors = 0
        #: (func, file, line of def) → self-time hits (top of stack)
        self.self_hits: Counter = Counter()
        #: same key → cumulative hits (anywhere on stack)
        self.cum_hits: Counter = Counter()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _sample_once(self) -> None:
        me = threading.get_ident()
        for tid, frame in list(sys._current_frames().items()):
            if tid == me:
                continue
            self.samples += 1
            seen = set()
            top = True
            while frame is not None:
                code = frame.f_code
                key = (code.co_name, code.co_filename, code.co_firstlineno)
                if top:
                    self.self_hits[key] += 1
                    top = False
                if key not in seen:  # recursion: one cum hit per sample
                    self.cum_hits[key] += 1
                    seen.add(key)
                frame = frame.f_back

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self._sample_once()
                except Exception as exc:  # noqa: BLE001 — keep sampling
                    self.sample_errors += 1
                    log.debug("profiler sample failed: %s", exc)

        self._thread = threads.spawn("profiler", loop)
        log.info("sampling profiler started (%.0f Hz)",
                 1.0 / self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(1.0)
            self._thread = None

    def reset(self) -> None:
        self.samples = 0
        self.sample_errors = 0
        self.self_hits.clear()
        self.cum_hits.clear()

    def report(self, top: int = 30) -> dict:
        """The profiler page payload: top functions by self and by
        cumulative samples (fractions of total)."""
        total = max(self.samples, 1)

        def rows(counter):
            return [{
                "func": k[0],
                "where": f"{k[1]}:{k[2]}",
                "hits": n,
                "frac": round(n / total, 4),
            } for k, n in counter.most_common(top)]
        return {"samples": self.samples, "running": self.running,
                "interval_ms": self.interval_s * 1000,
                "top_self": rows(self.self_hits),
                "top_cumulative": rows(self.cum_hits)}


#: process-wide instance (the reference's g_profiler)
g_profiler = SamplingProfiler()

"""Chaos plane — seedable fault injection (reference ``utils/chaos.py``).

A reduced copy: the one injection point the resident loop calls,
``resident.loop`` (stall an issue or a collect, or drop a collect), and
the flag every seam checks first. Off is a true no-op: a hot path pays
one attribute read (``g_chaos.enabled``). A decision is a pure function
of (seed, point, per-point call index) through sha256, so a seed replays
the same fault schedule whatever the threads do. Every fired fault
counts under ``chaos.<point>.<kind>``.

The transport, cluster, rdb, membudget and fleet points wait for the
planes they fault.
"""

from __future__ import annotations

import hashlib
import threading
import time

from .stats import g_stats


class ChaosError(RuntimeError):
    """An injected fault, handled by the same recovery paths as a real
    one."""


class ChaosPlane:
    """Singleton (:data:`g_chaos`), inert until armed."""

    #: the one injection point carried, and the fault kinds it fires
    POINT = "resident.loop"
    KINDS = ("stall", "drop_collect")

    def __init__(self):
        self.enabled = False
        self.seed: int | None = None
        self.rate = 0.0
        self.delay_s = 0.05
        self._lock = threading.Lock()
        self._calls = 0

    def enable(self, seed: int, rate: float = 0.1,
               delay_s: float = 0.05) -> None:
        """Arm the point; a re-arm replays the schedule from the top."""
        with self._lock:
            self.seed, self.rate, self.delay_s = int(seed), float(rate), \
                float(delay_s)
            self._calls = 0
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self.seed = None
            self.rate = 0.0

    def decide(self) -> str | None:
        """None (no fault) or a fault kind of ``resident.loop``."""
        with self._lock:
            if not self.enabled or self.rate <= 0.0:
                return None
            n = self._calls
            self._calls += 1
            seed, rate = self.seed, self.rate
        h = hashlib.sha256(f"{seed}:{self.POINT}:{n}".encode()).digest()
        if int.from_bytes(h[:8], "big") / 2.0 ** 64 >= rate:
            return None
        kind = self.KINDS[int.from_bytes(h[8:12], "big") % len(self.KINDS)]
        g_stats.count(f"chaos.{self.POINT}.{kind}")
        return kind

    def resident_fault(self, where: str) -> None:
        """Stall an issue or a collect, or drop a collect (raises; the
        loop fails that wave's tickets)."""
        kind = self.decide()
        if kind is None:
            return
        if kind == "stall":
            time.sleep(self.delay_s)
            return
        if where == "collect":
            raise ChaosError("chaos: collect dropped")


#: process-wide plane: importing costs nothing, arming is explicit
g_chaos = ChaosPlane()

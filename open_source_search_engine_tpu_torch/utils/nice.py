"""Niceness gate — the UdpProtocol.h niceness bit for the HTTP planes.

A copy of ``open_source_search_engine_tpu/utils/nice.py``; the port imports
nothing of that package.

Background (niceness-1) requests wait — bounded — while interactive
(niceness-0) requests are in flight; interactive work never waits.
Shared by the public search server and the cluster node RPC server so
spider writes and heal pulls yield to queries on BOTH planes.
"""

from __future__ import annotations

import threading
import time


class NicenessGate:
    def __init__(self, max_wait_s: float = 2.0):
        self.max_wait_s = max_wait_s
        self._cv = threading.Condition()
        self._n0 = 0

    @property
    def interactive_inflight(self) -> int:
        return self._n0

    def enter(self, niceness: int) -> None:
        """Call before handling a request. Interactive requests are
        counted; background ones block (up to ``max_wait_s`` — bounded
        so background work cannot starve forever) while any
        interactive request is in flight."""
        if niceness <= 0:
            with self._cv:
                self._n0 += 1
            return
        deadline = time.monotonic() + self.max_wait_s
        with self._cv:
            while self._n0 > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)

    def exit(self, niceness: int) -> None:
        if niceness <= 0:
            with self._cv:
                self._n0 -= 1
                if self._n0 <= 0:
                    self._cv.notify_all()

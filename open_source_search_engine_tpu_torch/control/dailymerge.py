"""DailyMerge — scheduled quiet-hours full merges.

Port of ``open_source_search_engine_tpu/control/dailymerge.py``
(reference ``DailyMerge.h:11``): once a day, inside a configured quiet
window, every Rdb gets a full (forced) merge, so daytime serving reads
one run per Rdb instead of a deepening stack. The ``merge_quiet_hours``
parm ("HH-HH", e.g. "2-5"; empty = disabled) carries the window.
"""

from __future__ import annotations

import threading
from datetime import datetime

from ..utils import threads
from ..utils.log import get_logger

log = get_logger("dailymerge")


def parse_window(spec: str) -> tuple[int, int] | None:
    """"2-5" → (2, 5); None when disabled or malformed. A wrapped window
    ("22-4") spans midnight."""
    try:
        lo, hi = spec.strip().split("-")
        lo, hi = int(lo), int(hi)
        if 0 <= lo <= 23 and 0 <= hi <= 23:
            return lo, hi
    except (ValueError, AttributeError):
        pass
    return None


def in_window(hour: int, window: tuple[int, int]) -> bool:
    lo, hi = window
    if lo <= hi:
        return lo <= hour < hi
    return hour >= lo or hour < hi  # spans midnight


class DailyMerge:
    """One merge sweep per day inside the quiet window."""

    def __init__(self, colls, conf, check_interval_s: float = 60.0):
        """``colls``: an iterable (or a callable returning one) of objects
        with ``rdbs()``; ``conf`` supplies ``merge_quiet_hours``."""
        self._colls = colls
        self._conf = conf
        self._interval = check_interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_merge_day: str | None = None
        self.merges = 0

    def _targets(self):
        c = self._colls
        return c() if callable(c) else c

    def tick(self, now: datetime | None = None) -> bool:
        """One scheduler check; True when a sweep ran."""
        window = parse_window(
            getattr(self._conf, "merge_quiet_hours", "") or "")
        if window is None:
            return False
        now = now or datetime.now()
        day = now.strftime("%Y-%m-%d")
        if self.last_merge_day == day or not in_window(now.hour, window):
            return False
        n = 0
        for coll in self._targets():
            for name, rdb in coll.rdbs().items():
                try:
                    before = len(rdb.runs)
                    rdb.attempt_merge(force=True)
                    if len(rdb.runs) < before:
                        n += 1
                except Exception:  # noqa: BLE001 — keep sweeping
                    log.exception("daily merge failed for %s", name)
        self.last_merge_day = day
        self.merges += 1
        log.info("daily merge sweep done (%d rdbs merged)", n)
        return True

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self._interval):
                self.tick()
        self._thread = threads.spawn("dailymerge", loop)

    def stop(self) -> None:
        self._stop.set()

"""Process supervisor — autosave, orderly shutdown, save on a signal.

Port of ``open_source_search_engine_tpu/control/process.py:24-92``
(reference ``Process.cpp``: the autosave clock ``:1299-1331`` →
``saveRdbTrees`` ``:1444-1449``, the save and shutdown on request, the
save on a fatal signal ``:1595-1612``). Every registered savable's
in-memory state is checkpointed, so a clean restart is lossless; the
Rdbs' journals cover what was written since the last checkpoint.
"""

from __future__ import annotations

import signal
import threading

from ..utils import threads
from ..utils.log import get_logger

log = get_logger("process")


class Process:
    """Owns savable components; runs the autosave clock; handles signals."""

    def __init__(self, autosave_minutes: float = 5.0):
        self._savables: list = []       # objects with .save()
        self._closers: list = []        # extra shutdown callbacks
        self.autosave_minutes = autosave_minutes
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.saves = 0

    @property
    def stopping(self) -> bool:
        """True once shutdown (or a signal) was requested."""
        return self._stop.is_set()

    def register(self, savable) -> None:
        """Register anything with a ``save()`` (a CollectionDb, a
        Collection)."""
        self._savables.append(savable)

    def on_shutdown(self, fn) -> None:
        self._closers.append(fn)

    def save_all(self) -> None:
        """Save every registered savable (the ``gb save`` admin op); a
        failure is logged and the others are still saved."""
        for s in self._savables:
            try:
                s.save()
            except Exception:  # noqa: BLE001 — save what we can
                log.exception("save failed for %r", s)
        self.saves += 1

    def start_autosave(self) -> None:
        """Save every ``autosave_minutes`` until shutdown."""
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.autosave_minutes * 60.0):
                log.info("autosave")
                self.save_all()

        self._thread = threads.spawn("autosave", loop)

    def shutdown(self) -> None:
        """Stop the clock, save, then run the shutdown callbacks."""
        self._stop.set()
        self.save_all()
        for fn in self._closers:
            try:
                fn()
            except Exception:  # noqa: BLE001 — run the others
                log.exception("shutdown callback failed")
        log.info("shutdown complete (%d saves)", self.saves)

    def install_signal_handlers(self) -> None:
        """SIGTERM and SIGINT request a shutdown: the handler only sets
        the flag, and the main loop (which polls ``stopping``) saves and
        stops outside the signal frame."""
        def handler(signum, frame):
            log.info("signal %d: saving and exiting", signum)
            self._stop.set()

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

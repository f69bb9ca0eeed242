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


def make_rpc_probe(conf, transport=None, timeout_s: float = 1.5):
    """A :class:`Heartbeat` probe that pings real node processes:
    ``probe(shard) -> bool`` hits ``/rpc/ping`` on each of the shard's
    twins over the pooled transport and reports the shard alive when any
    twin answers (the cross-process PingServer, for a fleet spawned by
    ``parallel.fleet.FleetManager`` from the same hosts.conf map)."""
    def probe(shard: int) -> bool:
        # imported at call time: control/ does not pull the transport
        # stack in at import
        from ..parallel import transport as transport_mod

        t = transport or transport_mod.g_transport
        return any(t.probe(addr, timeout=timeout_s) is not None
                   for addr in conf.addresses[shard])

    return probe


class Heartbeat:
    """Shard liveness prober (PingServer: ``sendPingsToAll``
    ``PingServer.h:61``, and the dead marking Multicast fails over on).

    The probe is pluggable: a fleet hands ``probe(shard_id) -> bool`` a
    real RPC ping (:func:`make_rpc_probe` over a hosts.conf map); tests
    flip it to simulate failures. Dead shards are skipped by the query
    path (degraded serving) until they pass a probe again."""

    def __init__(self, hostmap, probe=None, interval_s: float = 2.0):
        self.hostmap = hostmap
        self.probe = probe or (lambda shard: True)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def check_once(self) -> None:
        for s in range(self.hostmap.n_shards):
            try:
                alive = bool(self.probe(s))
            except Exception:  # noqa: BLE001 — a failed probe = dead
                alive = False
            if alive:
                self.hostmap.mark_alive(s)
            else:
                if self.hostmap.alive[s].any():
                    log.warning("shard %d marked dead", s)
                self.hostmap.mark_dead(s)

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                self.check_once()

        self._thread = threads.spawn("heartbeat", loop)

    def stop(self) -> None:
        self._stop.set()

"""Chaos plane — seedable fault injection (reference ``utils/chaos.py``).

The injection points this package's planes call, and the faults each
fires:

==================  =====================================================
injection point     faults
==================  =====================================================
transport.request   drop / delay / refuse / blackhole a scatter leg
cluster.node        slowwalk / wedge / kill a shard node mid-query
rdb.read            flip a byte of an on-disk posting run, so the CRC
                    verify or scrub must trip
membudget.reserve   force a pressure pass, so caches shed before work
                    is refused
resident.loop       stall an issue or a collect / drop a collect
fleet               a real signal to a spawned node process: kill
                    (SIGKILL) / wedge (SIGSTOP)
==================  =====================================================

Arming: ``OSSE_CHAOS=<seed>`` (``OSSE_CHAOS_RATE`` the rate) through
:func:`maybe_enable`, or ``g_chaos.enable(seed)``. Off is a true no-op: a
hot path pays one attribute read (``g_chaos.enabled``). A decision is a
pure function of (seed, point, per-point call index) through sha256, so
a seed replays the same fault schedule whatever the threads do. Every
fired fault counts under ``chaos.<point>.<kind>``.
"""

from __future__ import annotations

import hashlib
import os
import time

from .lockcheck import make_lock
from .log import get_logger
from .stats import g_stats

log = get_logger("chaos")


class ChaosError(RuntimeError):
    """An injected fault, handled by the same recovery paths as a real
    one."""


#: point name → the fault kinds it can fire (rates start at 0 until
#: enable() arms them)
DEFAULT_POINTS: dict[str, tuple[str, ...]] = {
    "transport.request": ("drop", "delay", "refuse", "blackhole"),
    "cluster.node": ("slowwalk", "wedge", "kill"),
    "rdb.read": ("flipbyte",),
    "membudget.reserve": ("pressure",),
    "resident.loop": ("stall", "drop_collect"),
    "fleet": ("kill", "wedge"),
}


class _Point:
    __slots__ = ("name", "kinds", "rate", "match", "delay_s", "calls",
                 "fired")

    def __init__(self, name: str, kinds: tuple[str, ...]):
        self.name = name
        self.kinds = kinds
        self.rate = 0.0
        #: substring filter on the decide() key ("" matches everything)
        self.match = ""
        self.delay_s = 0.05
        self.calls = 0
        self.fired: dict[str, int] = {}


class ChaosPlane:
    """Singleton (:data:`g_chaos`), inert until armed."""

    def __init__(self):
        self.enabled = False
        self.seed: int | None = None
        self._lock = make_lock("chaos.plane")
        self._points: dict[str, _Point] = {}
        self._fresh_points()

    def _fresh_points(self) -> None:
        self._points = {n: _Point(n, k) for n, k in DEFAULT_POINTS.items()}

    # --- arming -----------------------------------------------------------

    def enable(self, seed: int, rate: float = 0.1,
               delay_s: float | None = None) -> None:
        """Arm every point at ``rate`` (``delay_s``, when given, is every
        point's sleep); a re-arm resets the per-point call counters, so
        the schedule replays from the top."""
        with self._lock:
            self.seed = int(seed)
            self._fresh_points()
            for p in self._points.values():
                p.rate = float(rate)
                if delay_s is not None:
                    p.delay_s = float(delay_s)
            self.enabled = True
        g_stats.gauge("chaos.enabled", 1)
        log.info("chaos plane armed (seed=%d rate=%.3f)", seed, rate)

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self.seed = None
            self._fresh_points()
        g_stats.gauge("chaos.enabled", 0)

    def configure(self, point: str, rate: float | None = None,
                  kinds: tuple[str, ...] | None = None,
                  match: str | None = None,
                  delay_s: float | None = None) -> None:
        """Aim one point: its rate, the kinds it may fire, a substring the
        decide() key must contain (one twin's ``host:port``, say), and
        the sleep of its delay-like kinds."""
        with self._lock:
            p = self._points[point]
            if rate is not None:
                p.rate = float(rate)
            if kinds is not None:
                p.kinds = tuple(kinds)
            if match is not None:
                p.match = match
            if delay_s is not None:
                p.delay_s = float(delay_s)

    def fired(self, point: str | None = None) -> dict:
        """Per-kind fire counts (one point, or all points nested)."""
        with self._lock:
            if point is not None:
                return dict(self._points[point].fired)
            return {n: dict(p.fired) for n, p in self._points.items()}

    # --- the decision function --------------------------------------------

    def decide(self, point: str, key: str = "") -> str | None:
        """None (no fault) or a fault kind, pure in (seed, point, call
        index)."""
        p = self._points.get(point)
        if p is None or p.rate <= 0.0:
            return None
        with self._lock:
            n = p.calls
            p.calls += 1
        if p.match and p.match not in key:
            return None
        h = hashlib.sha256(f"{self.seed}:{point}:{n}".encode()).digest()
        if int.from_bytes(h[:8], "big") / 2.0 ** 64 >= p.rate:
            return None
        kind = p.kinds[int.from_bytes(h[8:12], "big") % len(p.kinds)]
        with self._lock:
            p.fired[kind] = p.fired.get(kind, 0) + 1
        g_stats.count(f"chaos.{point}.{kind}")
        return kind

    # --- the seams (each called only behind an `enabled` check) -----------

    def leg_fault(self, addr: str, path: str, timeout: float) -> None:
        """transport.request: raise (drop, refuse, blackhole) or sleep
        (delay) as the wire would. A refusal raises a real
        ConnectionRefusedError, so the transport's fast-fail path runs."""
        kind = self.decide("transport.request", key=f"{addr}{path}")
        if kind is None:
            return
        p = self._points["transport.request"]
        if kind == "delay":
            time.sleep(p.delay_s)
            return
        if kind == "refuse":
            raise ConnectionRefusedError(f"chaos: refused {addr}{path}")
        if kind == "blackhole":
            # silence, then failure, held to a slice of the leg timeout
            time.sleep(min(float(timeout), p.delay_s * 10.0))
        raise ChaosError(f"chaos: {kind} {addr}{path}")

    def node_fault(self, node) -> None:
        """cluster.node: slow-walk (a short sleep), wedge (a long one) or
        kill (stop the server from a side thread; the in-flight reply is
        held past the hedge delay and then fails)."""
        kind = self.decide("cluster.node", key=str(getattr(node, "port", "")))
        if kind is None:
            return
        p = self._points["cluster.node"]
        if kind == "slowwalk":
            time.sleep(p.delay_s)
            return
        if kind == "wedge":
            time.sleep(p.delay_s * 20.0)
            return
        from . import threads
        threads.spawn("chaos-kill", node.stop)
        time.sleep(p.delay_s * 10.0)
        raise ChaosError("chaos: node killed mid-query")

    def rdb_fault(self, rdb) -> None:
        """rdb.read: corrupt one on-disk run, so the CRC planes (load
        verify, scrub) must trip before those bytes are trusted again."""
        if self.decide("rdb.read",
                       key=getattr(rdb, "name", "")) == "flipbyte":
            self.corrupt_one_run(rdb)

    def corrupt_one_run(self, rdb) -> str | None:
        """Flip one byte of one loaded run on disk (a deterministic pick
        from the seed). Returns the path touched, or None when the rdb
        has no on-disk run. Noticing is the scrub and verify planes'
        job, not this one's."""
        runs = [r for r in getattr(rdb, "runs", [])
                if getattr(r, "path", None) is not None]
        if not runs:
            return None
        h = hashlib.sha256(
            f"{self.seed}:flip:{len(runs)}".encode()).digest()
        run = runs[int.from_bytes(h[:4], "big") % len(runs)]
        fname = "data.npy" if run.data is not None else "keys.npy"
        target = run.path / fname
        size = os.path.getsize(target)
        if size < 256:
            return None
        # past the .npy header: flip mid-payload
        off = 192 + int.from_bytes(h[4:8], "big") % (size - 256)
        with open(target, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
        g_stats.count("chaos.rdb.corrupted")
        log.info("chaos: flipped byte %d of %s", off, target)
        return str(target)

    def fleet_fault(self, pid: int, key: str = "") -> str | None:
        """fleet: a real signal to a spawned node process — ``kill`` is
        SIGKILL (no save; the next life recovers every acknowledged write
        from its journal), ``wedge`` is SIGSTOP (sockets stay open and no
        reply comes, so the transport's hedge has to eat the requests).
        Returns the kind fired, or None."""
        import signal

        kind = self.decide("fleet", key=key or str(pid))
        if kind is None:
            return None
        sig = signal.SIGKILL if kind == "kill" else signal.SIGSTOP
        try:
            os.kill(int(pid), sig)
            log.info("chaos: fleet %s pid=%d", kind, pid)
        except ProcessLookupError:
            log.warning("chaos: fleet %s pid=%d already gone", kind, pid)
        return kind

    def fleet_resume(self, pid: int) -> None:
        """SIGCONT a wedged node."""
        import signal

        try:
            os.kill(int(pid), signal.SIGCONT)
        except ProcessLookupError:
            pass

    def resident_fault(self, where: str) -> None:
        """resident.loop: stall an issue or a collect, or drop a collect
        (raises; the loop fails that wave's tickets)."""
        kind = self.decide("resident.loop", key=where)
        if kind is None:
            return
        if kind == "stall":
            time.sleep(self._points["resident.loop"].delay_s)
            return
        if where == "collect":
            raise ChaosError("chaos: collect dropped")


#: process-wide plane: importing costs nothing, arming is explicit
g_chaos = ChaosPlane()


def maybe_enable() -> bool:
    """Arm from ``OSSE_CHAOS=<seed>`` if set (at a process's start, never
    on a hot path); True when armed. ``OSSE_CHAOS_RATE`` overrides the
    ambient rate: the fleet hands its children rate 0, so their seams are
    armed and replayable but only the faults the parent aims fire."""
    v = os.environ.get("OSSE_CHAOS", "")
    if not v:
        return False
    try:
        seed = int(v)
    except ValueError:
        log.warning("OSSE_CHAOS=%r is not an integer seed; ignored", v)
        return False
    try:
        rate = float(os.environ.get("OSSE_CHAOS_RATE", "0.1"))
    except ValueError:
        rate = 0.1
    g_chaos.enable(seed, rate=rate)
    return True

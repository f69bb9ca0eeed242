"""Runtime lock-order / lock-discipline auditor (``OSSE_LOCKCHECK=1``).

Port of ``open_source_search_engine_tpu/utils/lockcheck.py`` (the port
imports nothing of that package). Inside an active
``schedcheck.explore`` the factories hand the calling thread
cooperatively scheduled primitives under the same names
(``utils/schedcheck.py``).

The static half of the analysis plane (``tools/osselint.py``) catches
rule-shaped bugs lexically; this module catches the ones only execution
reveals, in the spirit of ThreadSanitizer/RacerD's lock-set analysis:

* **Held-lock sets** — every :class:`TrackedLock` acquire/release
  maintains a per-thread stack of held locks.
* **Acquisition-order graph** — acquiring B while holding A records the
  edge A→B; a new edge that closes a path back to its source is a
  **potential deadlock** (two threads interleaving the two orders can
  each block on the other), reported once per edge with the acquiring
  stack, counted as ``lockcheck.cycle`` in ``g_stats``.
* **Hold-time histograms** — every release records the hold duration as
  ``lock.<name>.held_ms`` in the stats plane, so ``/admin/stats`` shows
  which mutex is the contention ceiling.
* **Blocking-call probes** — with the auditor on, ``time.sleep`` and
  socket connect/send/recv are wrapped; performing one while holding a
  tracked lock is recorded (``lockcheck.blocking_under_lock``) with the
  offending lock names and call site. This is the runtime twin of the
  static ``blocking-under-lock`` rule (which only sees *lexical*
  nesting).

Everything is opt-in: with ``OSSE_LOCKCHECK`` unset, :func:`make_lock`
and :func:`make_rlock` return plain ``threading`` primitives and this
module costs one import. The serving planes create their locks,
conditions and events through these factories under the reference's
roster names. Locks are identified by NAME, not instance —
every ``GenCache._lock`` is one node ``cache.gencache`` — because the
ordering convention is per lock *role*; same-name edges (two instances
of one role) are ignored rather than reported as self-deadlocks.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any

from . import schedcheck as _schedcheck
from .log import get_logger
from .stats import g_stats

log = get_logger("lockcheck")

#: process-wide opt-in, read once at import (the tracked locks are
#: constructed at module/instance init; flipping mid-run cannot retrofit
#: them)
ENABLED = os.environ.get("OSSE_LOCKCHECK") == "1"


def enabled() -> bool:
    return ENABLED


def _stack_tail(skip: int = 3, limit: int = 5) -> str:
    """Compact ``file:line`` chain of the acquiring frames (diagnostic
    payload on edges/events; only built when the auditor is on)."""
    frames = traceback.extract_stack()[:-skip][-limit:]
    return " < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                      for f in reversed(frames))


class LockCheckRegistry:
    """One audit domain: held sets, the order graph, recorded events.

    The process singleton is :data:`g_lockcheck`; tests construct their
    own so assertions never see another test's edges.
    """

    def __init__(self):
        self._tl = threading.local()
        # the registry's own mutex is deliberately a PLAIN lock:
        # auditing the auditor would recurse
        self._mu = threading.Lock()
        #: src name -> {dst name, ...}: "src was held when dst was taken"
        self.edges: dict[str, set[str]] = {}
        #: (src, dst) -> "thread | stack" of the first observation
        self.edge_info: dict[tuple[str, str], str] = {}
        #: cycle paths ([name, ..., name]) — potential deadlocks
        self.cycles: list[list[str]] = []
        #: per cycle, "src->dst" → "thread | stack" for EVERY edge on
        #: the loop (both acquisition orders of a 2-cycle), so a
        #: schedcheck failure timeline cross-references by lock name
        self.cycle_stacks: list[dict[str, str]] = []
        #: blocking-call-under-lock events
        self.blocking: list[dict] = []

    # --- per-thread held set ---------------------------------------------

    def _held_list(self) -> list:
        h = getattr(self._tl, "held", None)
        if h is None:
            h = self._tl.held = []
        return h

    def held(self) -> list[str]:
        """Names of locks the CURRENT thread holds, outermost first."""
        return [name for name, _t0 in self._held_list()]

    # --- graph ------------------------------------------------------------

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """DFS src→dst over the order graph (caller holds ``_mu``)."""
        stack, seen = [(src, [src])], {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self.edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note_acquire(self, name: str) -> None:
        held = self._held_list()
        new_edges = [(h, name) for h, _ in held
                     if h != name and name not in
                     self.edges.get(h, ())]
        if new_edges:
            info = f"{threading.current_thread().name} | {_stack_tail()}"
            with self._mu:
                for src, dst in new_edges:
                    if dst in self.edges.setdefault(src, set()):
                        continue
                    # adding src→dst closes a potential-deadlock loop
                    # iff dst already reaches src
                    back = self._find_path(dst, src)
                    self.edges[src].add(dst)
                    self.edge_info[(src, dst)] = info
                    if back is not None:
                        cycle = back + [dst]
                        self.cycles.append(cycle)
                        pairs = list(zip(cycle, cycle[1:]))
                        self.cycle_stacks.append(
                            {f"{a}->{b}": self.edge_info.get((a, b), "?")
                             for a, b in pairs})
                        g_stats.count("lockcheck.cycle")
                        log.error(
                            "lock-order cycle (potential deadlock): "
                            "%s — new edge %s→%s at %s",
                            " → ".join(cycle), src, dst, info)
        held.append((name, time.perf_counter()))

    def note_release(self, name: str) -> None:
        held = self._held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _, t0 = held.pop(i)
                g_stats.record_ms(f"lock.{name}.held_ms",
                                  1000.0 * (time.perf_counter() - t0))
                return

    def note_blocking(self, what: str) -> None:
        """A blocking call ran on this thread; if it holds tracked
        locks, that's a latency bug (every other thread wanting those
        locks waits out the sleep/IO)."""
        held = self.held()
        if not held:
            return
        g_stats.count("lockcheck.blocking_under_lock")
        ev = {"call": what, "held": held, "where": _stack_tail(skip=4)}
        with self._mu:
            if len(self.blocking) < 256:
                self.blocking.append(ev)
        log.warning("blocking %s while holding %s at %s", what,
                    "+".join(held), ev["where"])

    # --- reporting --------------------------------------------------------

    def report(self) -> dict:
        with self._mu:
            return {
                "edges": {s: sorted(d) for s, d in
                          sorted(self.edges.items())},
                "edge_info": {f"{s}->{d}": v for (s, d), v in
                              self.edge_info.items()},
                "cycles": [list(c) for c in self.cycles],
                "cycle_stacks": [dict(s) for s in self.cycle_stacks],
                "blocking": list(self.blocking),
            }

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.edge_info.clear()
            self.cycles.clear()
            self.cycle_stacks.clear()
            self.blocking.clear()


#: process-wide audit domain
g_lockcheck = LockCheckRegistry()


class TrackedLock:
    """``threading.Lock`` wrapper feeding a :class:`LockCheckRegistry`.

    Supports the full lock protocol (``acquire``/``release``/context
    manager) so it drops in anywhere a plain mutex lives, including as
    the lock behind a ``threading.Condition``.
    """

    _inner_factory = staticmethod(threading.Lock)

    def __init__(self, name: str,
                 registry: LockCheckRegistry | None = None):
        self.name = name
        self.registry = registry or g_lockcheck
        self._inner = self._inner_factory()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        # try-then-block so contention is observable: a failed fast
        # acquire counts ``lock.<name>.contended`` before parking —
        # with held_ms it answers "which mutex is the ceiling AND who
        # queues on it"
        got = self._inner.acquire(False)
        if not got:
            g_stats.count(f"lock.{self.name}.contended")
            if blocking:
                got = self._inner.acquire(True, timeout)
        if got:
            self.registry.note_acquire(self.name)
        return got

    def release(self) -> None:
        self.registry.note_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class TrackedRLock(TrackedLock):
    """Re-entrant variant: only the OUTERMOST acquire/release touch the
    held set (inner re-entries add no ordering information and would
    distort hold times)."""

    _inner_factory = staticmethod(threading.RLock)

    def __init__(self, name: str,
                 registry: LockCheckRegistry | None = None):
        super().__init__(name, registry)
        self._depth = threading.local()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        got = self._inner.acquire(False)
        if not got:
            g_stats.count(f"lock.{self.name}.contended")
            if blocking:
                got = self._inner.acquire(True, timeout)
        if got:
            d = getattr(self._depth, "n", 0)
            self._depth.n = d + 1
            if d == 0:
                self.registry.note_acquire(self.name)
        return got

    def release(self) -> None:
        d = getattr(self._depth, "n", 0)
        self._depth.n = d - 1
        if d == 1:
            self.registry.note_release(self.name)
        self._inner.release()


def make_lock(name: str):
    """A mutex for the hot-lock roster: plain ``threading.Lock`` when
    the auditor is off (zero overhead), :class:`TrackedLock` under
    ``OSSE_LOCKCHECK=1``, and a cooperatively scheduled lock when the
    calling thread is inside an active ``schedcheck.explore``."""
    if _schedcheck._active is not None:
        sched = _schedcheck.maybe_lock(name)
        if sched is not None:
            return sched
    return TrackedLock(name) if ENABLED else threading.Lock()


def make_rlock(name: str):
    """A re-entrant mutex for the roster entry ``name``."""
    if _schedcheck._active is not None:
        sched = _schedcheck.maybe_rlock(name)
        if sched is not None:
            return sched
    return TrackedRLock(name) if ENABLED else threading.RLock()


def make_condition(name: str):
    """A condition variable for the hot-lock roster. Under
    ``OSSE_LOCKCHECK=1`` the inner lock is tracked (wait/notify hold
    times and ordering edges land under ``name``); inside an active
    exploration it is a scheduled condition."""
    if _schedcheck._active is not None:
        sched = _schedcheck.maybe_condition(name)
        if sched is not None:
            return sched
    if ENABLED:
        return threading.Condition(TrackedLock(name))
    return threading.Condition()


def make_event(name: str):
    """An event for the roster: plain outside an exploration (events
    carry no lock-ordering information), scheduled inside one."""
    if _schedcheck._active is not None:
        sched = _schedcheck.maybe_event(name)
        if sched is not None:
            return sched
    return threading.Event()


# --- blocking-call probes ---------------------------------------------------

_probes_installed = False
_orig: dict[str, Any] = {}


def install_probes(registry: LockCheckRegistry | None = None) -> None:
    """Wrap ``time.sleep`` and socket connect/send/recv to flag calls
    made while holding a tracked lock. Idempotent; opt-in only."""
    global _probes_installed
    if _probes_installed:
        return
    import socket as socket_mod
    reg = registry or g_lockcheck

    def _wrap(module: Any, attr: str, what: str) -> None:
        fn = getattr(module, attr)
        _orig[what] = (module, attr, fn)

        def probe(*a: Any, **kw: Any):
            reg.note_blocking(what)
            return fn(*a, **kw)

        probe.__name__ = f"lockcheck_{attr}"
        setattr(module, attr, probe)

    _wrap(time, "sleep", "time.sleep")
    # socket.socket is the Python subclass of _socket.socket, so method
    # overrides stick; every http.client/urllib byte ultimately crosses
    # one of these three
    _wrap(socket_mod.socket, "connect", "socket.connect")
    _wrap(socket_mod.socket, "sendall", "socket.sendall")
    _wrap(socket_mod.socket, "recv", "socket.recv")
    _probes_installed = True


def uninstall_probes() -> None:
    global _probes_installed
    for module, attr, fn in _orig.values():
        setattr(module, attr, fn)
    _orig.clear()
    _probes_installed = False


if ENABLED:
    install_probes()

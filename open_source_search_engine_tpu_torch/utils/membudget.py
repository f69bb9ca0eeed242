"""Host-plane memory budget — the Mem.cpp allocation gate
(reference ``utils/membudget.py:53-333``).

One process-wide :class:`MemBudget` (``g_membudget``) counts labelled
bytes against one limit:

* **reservations** (``reserve``/``release``) — transient working sets
  with a clear lifetime;
* **gauges** (``set_gauge``) — long-lived structures keyed per owner:
  the resident loop's queue under ``serve``, each tenant's resident
  device bytes under ``device``.

An over-budget ``reserve`` first runs the registered **pressure
handlers** (weakly referenced, ascending priority, stopping as soon as
the budget fits), re-checks, and only then refuses; a label's soft cap
(``set_label_cap``) runs a pressure pass scoped to that label instead
of refusing. The tenant plane registers at a low priority, so device
pressure parks cold tenants first.

Departure from the reference: its lock is a plain ``threading.Lock``,
and a gauge dropped from a finalizer (``Cache.__del__``) while the
cyclic garbage collector runs inside a locked section waits on its own
thread forever. Here the lock is re-entrant, and a ``set_gauge`` that
arrives on a thread already inside a locked section is queued and
applied at the start of the next locked call, so it neither waits nor
mutates a table the interrupted frame is iterating; a finalizer queues
its write unconditionally (``set_gauge_later``).

Departure: the reference counts the ``device`` label against the one
host limit (``max_mem``, sized beside a 16 GB TPU). A resident tenant of
100,000 pages holds more than the 4 GiB default alone, so the limit was
always spent: every memtable dumped early and a merge's reservation
parked the serving tenant. Here the labels of :data:`DEVICE_LABELS` are
bounded by their own cap only (``device_budget``); the host limit, the
free bytes and the high water count host labels, and a pressure handler
registered for the device label runs only in a device relief pass.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import deque
from typing import Callable

from .log import get_logger
from .stats import g_stats

log = get_logger("membudget")

#: default budget (4 GB per instance, Conf::m_maxMem)
DEFAULT_LIMIT = 4 << 30

#: the labels /admin/mem always lists
LABELS = ("memtable", "merge", "pack", "docproc", "cache", "device")

#: labels of device memory: bounded by the label's cap, never by the
#: host limit
DEVICE_LABELS = frozenset({"device"})


class MemBudget:
    """Process-wide labelled memory budget with graceful refusal."""

    def __init__(self, limit: int = DEFAULT_LIMIT):
        self._lock = threading.RLock()
        #: per-thread depth inside a locked section
        self._tls = threading.local()
        #: gauge writes that arrived re-entrantly, applied at the next
        #: locked call (deque append and popleft are atomic)
        self._pending: deque = deque()
        self.limit = int(limit)
        #: label -> refused reserves; the most ever used
        self.rejections: dict[str, int] = {}
        self.high_water = 0
        #: label -> reserved bytes (transient working sets)
        self._reserved: dict[str, int] = {}
        #: label -> {owner key -> bytes} (long-lived gauges)
        self._gauges: dict[str, dict[object, int]] = {}
        #: label -> soft cap in bytes; breaching it runs a label-scoped
        #: pressure pass rather than refusing
        self._caps: dict[str, int] = {}
        #: (priority, seq, key, weak fn), run ascending by priority
        self._pressure: list[tuple] = []
        self._pressure_seq = 0
        #: labels with a cap-relief pass in flight (a handler that zeroes
        #: gauges re-enters set_gauge; the guard stops the recursion)
        self._relieving: set[str] = set()

    @contextlib.contextmanager
    def _locked(self):
        """The lock, with the deferred gauge writes applied first."""
        with self._lock:
            depth = getattr(self._tls, "depth", 0)
            self._tls.depth = depth + 1
            try:
                # only the outermost section applies them: an inner one
                # may run inside a frame iterating the gauge tables
                while depth == 0 and self._pending:
                    self._apply_gauge_locked(*self._pending.popleft())
                yield
            finally:
                self._tls.depth = depth

    def set_limit(self, limit: int) -> None:
        """Re-point the budget (the max_mem parm's live update)."""
        with self._locked():
            self.limit = max(int(limit), 1)

    # --- caps ------------------------------------------------------------

    def set_label_cap(self, label: str, nbytes: int) -> None:
        """Soft cap for one label (0 or negative clears). Breaching it
        triggers a label-scoped pressure pass (``membudget.cap_evict``)
        instead of a refusal."""
        with self._locked():
            if int(nbytes) <= 0:
                self._caps.pop(label, None)
                return
            self._caps[label] = int(nbytes)
        g_stats.gauge(f"membudget.cap.{label}", int(nbytes))

    def label_cap(self, label: str) -> int:
        """The label's soft cap, 0 = uncapped."""
        with self._locked():
            return self._caps.get(label, 0)

    # --- accounting ------------------------------------------------------

    def _used_locked(self) -> int:
        """Host bytes: every label but the device labels."""
        return (sum(v for lb, v in self._reserved.items()
                    if lb not in DEVICE_LABELS)
                + sum(sum(g.values()) for lb, g in self._gauges.items()
                      if lb not in DEVICE_LABELS))

    def _label_used_locked(self, label: str) -> int:
        return (self._reserved.get(label, 0)
                + sum(self._gauges.get(label, {}).values()))

    def _label_fits_locked(self, label: str) -> bool:
        cap = self._caps.get(label, 0)
        return cap <= 0 or self._label_used_locked(label) <= cap

    def used(self, label: str | None = None) -> int:
        """One label's bytes, or with no label the host bytes."""
        with self._locked():
            if label is None:
                return self._used_locked()
            return self._label_used_locked(label)

    def free(self) -> int:
        with self._locked():
            return max(self.limit - self._used_locked(), 0)

    def would_fit(self, nbytes: int) -> bool:
        """Whether ``nbytes`` more fit the limit now (no relief runs)."""
        with self._locked():
            return self._used_locked() + int(nbytes) <= self.limit

    def _apply_gauge_locked(self, label: str, key: object,
                            nbytes: int) -> None:
        g = self._gauges.setdefault(label, {})
        if nbytes <= 0:
            g.pop(key, None)
        else:
            g[key] = int(nbytes)

    def set_gauge(self, label: str, key: object, nbytes: int) -> None:
        """Absolute usage of one owner under a label (0 removes it).
        Pushing a capped label over its cap runs the label-scoped
        pressure pass. Called from a finalizer inside a locked section
        of this thread, the write is queued for the next locked call."""
        if getattr(self._tls, "depth", 0) > 0:
            self._pending.append((label, key, int(nbytes)))
            return
        with self._locked():
            self._apply_gauge_locked(label, key, int(nbytes))
            self.high_water = max(self.high_water, self._used_locked())
            cap = self._caps.get(label, 0)
            over = (cap > 0 and label not in self._relieving
                    and self._label_used_locked(label) > cap)
            if over:
                self._relieving.add(label)
        if over:
            try:
                g_stats.count("membudget.cap_evict")
                g_stats.count(f"membudget.cap_evict.{label}")
                with self._locked():
                    excess = self._label_used_locked(label) - cap
                self._relieve(max(excess, 1), label=label)
            finally:
                with self._locked():
                    self._relieving.discard(label)

    def set_gauge_later(self, label: str, key: object, nbytes: int) -> None:
        """``set_gauge`` for finalizers: takes no lock (a deque append is
        atomic) and is applied by the next locked call."""
        self._pending.append((label, key, int(nbytes)))

    def reserve(self, label: str, nbytes: int) -> bool:
        """Claim ``nbytes`` under ``label``; False = over budget after
        pressure relief, and the caller must degrade. Zero or negative
        requests always succeed and claim nothing."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return True

        on_host = label not in DEVICE_LABELS
        from .chaos import g_chaos
        if g_chaos.enabled and \
                g_chaos.decide("membudget.reserve", key=label):
            # forced pressure: the shed-before-refuse path runs even
            # when the reservation would have fit
            self._relieve(nbytes, label=None if on_host else label)

        def _fits_locked() -> bool:
            if on_host and self._used_locked() + nbytes > self.limit:
                return False
            cap = self._caps.get(label, 0)
            return cap <= 0 or \
                self._label_used_locked(label) + nbytes <= cap

        with self._locked():
            fits = _fits_locked()
            globally = not on_host or \
                self._used_locked() + nbytes <= self.limit
        if not fits:
            # a label-cap-only breach relieves scoped to the label; a
            # global breach runs the full ladder
            self._relieve(nbytes, label=None if not globally else label)
            with self._locked():
                fits = _fits_locked()
        if not fits:
            with self._locked():
                self.rejections[label] = self.rejections.get(label, 0) + 1
            g_stats.count("membudget.reject")
            g_stats.count(f"membudget.reject.{label}")
            log.warning(
                "over budget: %s wants %d MB, %d MB free of %d MB — "
                "refusing (caller degrades)", label, nbytes >> 20,
                self.free() >> 20, self.limit >> 20)
            return False
        with self._locked():
            self._reserved[label] = self._reserved.get(label, 0) + nbytes
            self.high_water = max(self.high_water, self._used_locked())
        return True

    def release(self, label: str, nbytes: int) -> None:
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        with self._locked():
            cur = self._reserved.get(label, 0)
            self._reserved[label] = max(cur - nbytes, 0)

    # --- pressure relief -------------------------------------------------

    def add_pressure_handler(self, fn: Callable[[int], int],
                             priority: int = 100,
                             key: str | None = None,
                             label: str | None = None) -> None:
        """Register ``fn(need_bytes) -> freed_bytes_hint``, run before a
        refusal in ascending ``priority``. Bound methods are held through
        ``weakref.WeakMethod`` so registering never pins the owner;
        ``key`` makes registration idempotent; a handler given ``label``
        runs only in a relief pass scoped to that label."""
        with self._locked():
            try:
                ref: object = weakref.WeakMethod(fn)  # bound method
            except TypeError:
                ref = weakref.ref(fn) if hasattr(fn, "__name__") \
                    else (lambda: fn)
            if key is not None:
                self._pressure = [e for e in self._pressure if e[2] != key]
            self._pressure_seq += 1
            self._pressure.append(
                (int(priority), self._pressure_seq, key, ref, label))

    def _relieve(self, need: int, label: str | None = None) -> None:
        """The shed pass: handlers ascending by priority, stopping the
        moment the budget (or, for a cap breach, the label) fits."""
        with self._locked():
            entries = sorted(self._pressure, key=lambda e: (e[0], e[1]))
        dead = []
        for entry in entries:
            if entry[4] is not None and entry[4] != label:
                continue
            fn = entry[3]()
            if fn is None:
                dead.append(entry)  # owner collected: drop the handler
                continue
            try:
                fn(need)
            except Exception as e:  # noqa: BLE001 — relief best-effort
                log.warning("pressure handler failed: %s", e)
            with self._locked():
                fits = self._label_fits_locked(label) if label \
                    else self._used_locked() + need <= self.limit
            if fits:
                break
        if dead:
            with self._locked():
                self._pressure = [e for e in self._pressure
                                  if e not in dead]


    # --- observability -------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/admin/mem`` body: limit, use, and each label's bytes."""
        with self._locked():
            labels = {
                lb: {"reserved": self._reserved.get(lb, 0),
                     "gauged": sum(self._gauges.get(lb, {}).values()),
                     "rejections": self.rejections.get(lb, 0),
                     "cap": self._caps.get(lb, 0)}
                for lb in sorted(set(self._reserved) | set(self._gauges)
                                 | set(self.rejections) | set(LABELS))}
            used = self._used_locked()
            return {"limit": self.limit, "used": used,
                    "free": max(self.limit - used, 0),
                    "high_water": self.high_water,
                    "rejections": sum(self.rejections.values()),
                    "labels": labels}


#: process-wide singleton (reference ``g_mem``)
g_membudget = MemBudget()

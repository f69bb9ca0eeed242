"""jitwatch — runtime kernel-build and host-transfer attribution.

Port of ``open_source_search_engine_tpu/utils/jitwatch.py`` (the port
imports nothing of that package), with the same snapshot: ``totals``
(``compiles``, ``first_traces``, ``retraces``, ``transfers``,
``transfers_offboundary``) and ``events`` keyed by ``(kind, fn, site)``,
each attributed to the repo line that caused it, so a latency cliff names
its line.

Capture channels (all restored exactly by :func:`disable`):

* **Compiles** — a kernel build (``nvcc``) or a library load (``ctypes``)
  by ``query/cuda_build.py``, reported through :func:`note_compile`.
* **Explicit transfers** — the port's own seams report each copy through
  :func:`note_transfer`: ``DeviceIndex._put`` (h2d), the wave fetch
  ``DeviceIndex._queue_fetch`` (d2h), the mesh's and the device build's
  uploads. A site outside :data:`BOUNDARY_SITES` counts as off-boundary.
* **The implicit-transfer tripwire** — while armed on a card,
  ``torch.cuda.set_sync_debug_mode("warn")`` makes every synchronizing
  CUDA call (``.item()``, ``.cpu()``, a blocking copy) warn; the warnings
  are captured (not printed), sited and counted as ``d2h-implicit``
  transfers.

Departures from the reference: the port runs eager torch and no
``torch.compile``, so nothing traces and ``first_traces`` and
``retraces`` stay 0; a compile is a kernel build or load, not an XLA
program. The tripwire is torch's sync-debug mode, not the reference's
``__array__`` patch.

Counters feed ``g_stats`` (``jit.compiles``, ``jit.transfers``,
``jit.transfer.<site>``) and each event drops a zero-width span into the
trace plane. ``OSSE_JITWATCH=1`` turns the watcher on through
:func:`maybe_enable`; unset, this module is inert.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
import warnings
from dataclasses import dataclass
from pathlib import Path

from . import trace
from .stats import g_stats

#: repo-relative module suffixes that OWN device↔host traffic — a
#: transfer attributed elsewhere is a hot-path violation
BOUNDARY_SITES = ("query/devindex.py", "query/scorer.py",
                  "parallel/sharded.py", "build/devbuild.py")

#: the text of torch's sync-debug warning
SYNC_WARNING = "called a synchronizing CUDA operation"

_PKG_ROOT = Path(__file__).resolve().parent.parent
_SELF_FILE = str(Path(__file__).resolve())

#: the kernel build and its wrappers: a compile is sited at the line
#: that called into them
_BUILD_FILES = tuple(str(_PKG_ROOT / "query" / f) for f in (
    "cuda_build.py", "min_scores_kernel.py", "fd_scores_kernel.py"))


@dataclass
class Event:
    """One attributed compile/transfer bucket."""
    kind: str            # compile | first_trace | retrace | transfer
    fn: str              # kernel (or transfer entry point)
    shapes: str          # shape signature ("" when unknown)
    site: str            # file.py:line, package-relative when possible
    count: int = 0
    bytes: int = 0       # transfers only
    last: str = ""       # last detail / direction

    def as_dict(self) -> dict:
        return {"kind": self.kind, "fn": self.fn,
                "shapes": self.shapes, "site": self.site,
                "count": self.count, "bytes": self.bytes,
                "boundary": is_boundary_site(self.site),
                "last": self.last}


def is_boundary_site(site: str) -> bool:
    """Does ``site`` live in a module blessed to touch the host?"""
    path = site.rsplit(":", 1)[0]
    return path.endswith(BOUNDARY_SITES)


def _norm_site(filename: str, lineno: int) -> str:
    try:
        rel = Path(filename).resolve().relative_to(_PKG_ROOT)
        return f"{rel.as_posix()}:{lineno}"
    except ValueError:
        return f"{Path(filename).name}:{lineno}"


def _caller_site(skip: tuple = ()) -> str:
    """First stack frame outside jitwatch, ``skip``, the installed
    packages and the stdlib — the repo line that triggered the event."""
    for fr in reversed(traceback.extract_stack()):
        fn = fr.filename
        if fn == _SELF_FILE or fn in skip or "site-packages" in fn \
                or "/lib/python" in fn or fn.startswith("<"):
            continue
        return _norm_site(fn, fr.lineno or 0)
    return "unknown:0"


class JitWatch:
    """Singleton attribution table; enable()/disable() are idempotent
    and restore every hook they install."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.enabled = False
        self.events: dict[tuple, Event] = {}
        self.totals = {"compiles": 0, "first_traces": 0,
                       "retraces": 0, "transfers": 0,
                       "transfers_offboundary": 0}
        #: the sync-debug tripwire is armed (a card is present)
        self.tripwire = False
        self._saved_showwarning = None
        self._saved_filters = None
        self._saved_sync_mode = None

    # -- lifecycle ----------------------------------------------------

    def enable(self) -> None:
        with self._lock:
            if self.enabled:
                return
            self._saved_showwarning = warnings.showwarning
            self._saved_filters = list(warnings.filters)
            orig_show = self._saved_showwarning

            def showwarning(message, category, filename, lineno,
                            file=None, line=None):
                if SYNC_WARNING in str(message):
                    self._note_sync()
                    return
                orig_show(message, category, filename, lineno, file, line)

            warnings.showwarning = showwarning
            # every occurrence, not the first per line
            warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
            self._arm_tripwire()
            self.enabled = True
            g_stats.gauge("jit.watch_enabled", 1)

    def _arm_tripwire(self) -> None:
        try:
            import torch
            if torch.cuda.is_available():
                self._saved_sync_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
                self.tripwire = True
        except Exception:
            g_stats.count("jit.tripwire_failed")

    def disable(self) -> None:
        with self._lock:
            if not self.enabled:
                return
            if self.tripwire:
                import torch
                torch.cuda.set_sync_debug_mode(self._saved_sync_mode)
                self.tripwire = False
                self._saved_sync_mode = None
            warnings.showwarning = self._saved_showwarning
            warnings.filters[:] = self._saved_filters
            getattr(warnings, "_filters_mutated", lambda: None)()
            self._saved_showwarning = self._saved_filters = None
            self.enabled = False
            g_stats.gauge("jit.watch_enabled", 0)

    def reset(self) -> None:
        """Drop the attribution table (counters in g_stats persist —
        benches snapshot deltas instead)."""
        with self._lock:
            self.events.clear()
            for k in self.totals:
                self.totals[k] = 0

    # -- event plumbing ----------------------------------------------

    def _bump(self, kind: str, fn: str, shapes: str, site: str,
              nbytes: int = 0, last: str = "") -> Event:
        key = (kind, fn, shapes, site)
        with self._lock:
            ev = self.events.get(key)
            if ev is None:
                ev = self.events[key] = Event(kind, fn, shapes, site)
            ev.count += 1
            ev.bytes += nbytes
            if last:
                ev.last = last[:400]
        return ev

    def note_compile(self, fn: str, detail: str) -> None:
        """A kernel build (``detail`` "nvcc") or load ("load")."""
        if not self.enabled:
            return
        now = time.perf_counter()
        site = _caller_site(skip=_BUILD_FILES)
        self._bump("compile", fn, "", site, last=detail)
        with self._lock:
            self.totals["compiles"] += 1
        g_stats.count("jit.compiles")
        trace.record("jit.compile", now, now, fn=fn, site=site)

    def note_transfer(self, fn: str, direction: str, nbytes: int) -> None:
        """An explicit host↔device copy at one of the port's seams."""
        if not self.enabled:
            return
        self._transfer(fn, direction, int(nbytes))

    def _note_sync(self) -> None:
        self._transfer("sync", "d2h-implicit", 0)

    def _transfer(self, fn: str, direction: str, nbytes: int) -> None:
        now = time.perf_counter()
        site = _caller_site()
        self._bump("transfer", fn, "", site, nbytes=nbytes,
                   last=direction)
        offb = not is_boundary_site(site)
        with self._lock:
            self.totals["transfers"] += 1
            if offb:
                self.totals["transfers_offboundary"] += 1
        g_stats.count("jit.transfers")
        g_stats.count(f"jit.transfer.{site}")
        trace.record("jit.transfer", now, now, fn=fn, site=site,
                     direction=direction, bytes=nbytes)

    # -- reporting ----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            events = sorted(self.events.values(),
                            key=lambda e: -e.count)
            return {"enabled": self.enabled,
                    "totals": dict(self.totals),
                    "events": [e.as_dict() for e in events]}


g_jitwatch = JitWatch()


def enable() -> None:
    g_jitwatch.enable()


def disable() -> None:
    g_jitwatch.disable()


def enabled() -> bool:
    return g_jitwatch.enabled


def reset() -> None:
    g_jitwatch.reset()


def snapshot() -> dict:
    return g_jitwatch.snapshot()


def note_compile(fn: str, detail: str) -> None:
    g_jitwatch.note_compile(fn, detail)


def note_transfer(fn: str, direction: str, nbytes: int) -> None:
    g_jitwatch.note_transfer(fn, direction, nbytes)


def maybe_enable() -> None:
    """Enable iff OSSE_JITWATCH=1 — the import-time wiring used by the
    device layer and the server; a true no-op otherwise."""
    if os.environ.get("OSSE_JITWATCH", "") == "1":
        enable()

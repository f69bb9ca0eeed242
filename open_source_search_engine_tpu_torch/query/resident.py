"""Resident serving loop — double-buffered device dispatch.

Port of ``open_source_search_engine_tpu/query/resident.py``. One
always-running consumer thread owns a collection's device dispatch;
callers only enqueue:

* ``submit()`` appends to a queue and returns a :class:`Ticket`; it never
  touches the device, so no host↔device traffic runs on the caller's
  thread.
* The loop thread issues wave N+1 (``DeviceIndex.issue_batch``: plan,
  route, queue the waves and their result copy, fetch nothing) while
  wave N is still computing, then collects the oldest in-flight wave
  (``collect_batch``: wait for that wave's own copy, parse, re-issue the
  escalation rungs). Each issued batch carries its own pinned host
  buffer and completion event, so collecting wave N never waits for
  wave N+1.
* Depth is bounded at :data:`DEPTH`, so a burst cannot pipeline
  unbounded device memory; the queue is bounded at :data:`MAX_QUEUE`,
  and an overload fails the ticket with ``QueueFull``.

Freshness protocol: the loop re-resolves its index through ``di_fn``
only while nothing is in flight. If ``gen_fn()`` (the posdb version)
moves while waves are in flight, those waves finish against the index
they were issued on, and the loop drains them all before it refreshes,
so any ticket submitted after a write is issued against a refreshed
index (``Ticket.generation`` records which). Refreshing mid-flight would
be worse than stale: a delta refresh rewrites the column tails that a
queued wave still reads.

The loop is generic over any index with ``issue_batch(plans, topk,
lang) → pending``, ``collect_batch(pending)`` and ``_built_version``.
With devwatch on, each wave is a flight-recorder record (``wave_begin``
before the issue, ``wave_issued``, ``wave_collect`` around the collect
whose rounds the index notes, ``wave_end``).
"""

from __future__ import annotations

import traceback
from collections import deque
from typing import Callable

from ..utils import deadline as deadline_mod
from ..utils import devwatch
from ..utils import threads as _threads
from ..utils.chaos import g_chaos
from ..utils.lockcheck import make_condition, make_event
from ..utils.log import get_logger
from ..utils.membudget import g_membudget
from ..utils.priority import QueueFull
from ..utils.stats import g_stats

log = get_logger("resident")

#: in-flight wave bound: issue N+1 while N computes (double buffering);
#: deeper pipelines buy nothing once the device is saturated and cost
#: device memory for every staged wave
DEPTH = 2

#: bounded submit queue: an overload burst fails fast with QueueFull
#: (counted, charged to the membudget "serve" label) instead of growing
#: host memory without bound
MAX_QUEUE = 1024

#: per-ticket footprint estimate for the membudget gauge
QUEUE_ENTRY_COST = 2048


class Ticket:
    """One submit()'s handle: ``wait()`` blocks until the loop resolves
    it. After resolution, ``di`` is the index the wave ran against and
    ``generation`` its ``_built_version`` at issue time: callers use
    ``di`` for the page build (sitehash and langid lookups must come from
    the snapshot that scored)."""

    __slots__ = ("plans", "topk", "lang", "deadline", "di",
                 "generation", "_ev", "_res", "_err")

    def __init__(self, plans, topk: int, lang: int, deadline=None):
        self.plans = plans
        self.topk = topk
        self.lang = lang
        self.deadline = deadline
        self.di = None
        self.generation: int | None = None
        self._ev = make_event("resident.ticket")
        self._res = None
        self._err: BaseException | None = None

    def _resolve(self, res) -> None:
        self._res = res
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        # the frames that have returned let go of their locals (the
        # wave's tensors, its index) and keep their file and line; the
        # frame that caught the error drops its wave itself
        traceback.clear_frames(err.__traceback__)
        self._err = err
        self._ev.set()

    def wait(self, timeout: float = 120.0):
        """Block for the wave's raw results (``[(docids, scores, n)]``
        per plan). Raises the loop's error if the wave failed."""
        if not self._ev.wait(timeout):
            raise TimeoutError("resident loop ticket timed out")
        if self._err is not None:
            try:
                raise self._err
            finally:
                # raising put this frame in the error's traceback: with
                # the ticket out of it, the ticket (which keeps the
                # error) makes no cycle with it
                self = None  # noqa: PLW0642
        return self._res


class _Wave:
    """An issued but uncollected batch and the tickets riding it."""

    __slots__ = ("pending", "tickets", "di", "obs")

    def __init__(self, pending, tickets, di, obs=None):
        self.pending = pending
        self.tickets = tickets
        self.di = di
        #: the flight recorder's open record (None with devwatch off)
        self.obs = obs


class ResidentLoop:
    """The per-collection dispatch loop (see the module docstring).

    ``di_fn`` resolves the current index (and refreshes it when the posdb
    moved: ``engine.get_device_index``); ``gen_fn`` reads the live posdb
    version, so the loop sees a write without touching the index."""

    def __init__(self, di_fn: Callable[[], object],
                 gen_fn: Callable[[], int],
                 max_batch: int = 64, name: str = "coll",
                 max_queue: int = MAX_QUEUE):
        self._di_fn = di_fn
        self._gen_fn = gen_fn
        self.name = name
        self._max_batch = max_batch
        self._max_queue = max_queue
        self._cv = make_condition("resident.cv")
        self._queue: deque[Ticket] = deque()
        self._inflight: deque[_Wave] = deque()
        self._alive = True
        self.waves_issued = 0
        self.drains_for_freshness = 0
        self._thread = _threads.spawn(f"resident-loop-{name}", self._run)

    @property
    def alive(self) -> bool:
        return self._alive and self._thread.is_alive()

    def submit(self, plans, *, topk: int = 64, lang: int = 0,
               deadline: deadline_mod.Deadline | None = None) -> Ticket:
        """Enqueue compiled plans; returns at once. A ``deadline`` rides
        the ticket: the loop abandons it before issue if the budget ran
        out while it queued."""
        t = Ticket(list(plans), topk, lang, deadline)
        with self._cv:
            if not self._alive:
                t._fail(RuntimeError("resident loop stopped"))
                return t
            if len(self._queue) >= self._max_queue:
                # bounded admission: fail the ticket, never the loop
                g_stats.count("admission.queue_full")
                t._fail(QueueFull("resident loop queue full"))
                return t
            self._queue.append(t)
            self._gauge_locked()
            self._cv.notify_all()
        return t

    def _gauge_locked(self) -> None:
        g_membudget.set_gauge("serve", self,
                              len(self._queue) * QUEUE_ENTRY_COST)

    def stop(self) -> None:
        """Kill the loop; queued and in-flight waiters fail fast."""
        with self._cv:
            self._alive = False
            self._cv.notify_all()

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the loop thread to end (after ``stop()``); True when
        it has."""
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # ------------------------------------------------------------- loop

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while self._alive and not self._queue \
                            and not self._inflight:
                        self._cv.wait()
                    if not self._alive:
                        self._abort_locked(
                            RuntimeError("resident loop stopped"))
                        return
                if not self._inflight and self._queue:
                    # fill-or-flush: the device is idle, so launch now
                    # with whatever is queued; while waves are in flight,
                    # submitters coalesce until the pipeline frees a slot
                    g_stats.count("resident.idle_flush")
                if len(self._inflight) < DEPTH:
                    self._issue_one()
                if self._inflight and (len(self._inflight) >= DEPTH
                                       or not self._queue):
                    self._collect_one()
        except BaseException as exc:  # noqa: BLE001 — waiters must wake
            log.exception("resident loop died")
            with self._cv:
                self._alive = False
                self._abort_locked(exc)
            if not isinstance(exc, Exception):
                raise

    def _abort_locked(self, exc: BaseException) -> None:
        for t in self._queue:
            t._fail(exc)
        self._queue.clear()
        self._gauge_locked()
        for w in self._inflight:
            for t in w.tickets:
                t._fail(exc)
        self._inflight.clear()

    def _take_batch(self) -> list[Ticket]:
        """The longest same-(topk, lang) prefix of the queue — a prefix,
        not a filter, so resolution order is submit order."""
        with self._cv:
            if not self._queue:
                return []
            head = self._queue[0]
            batch, nplans = [], 0
            while self._queue and len(batch) < self._max_batch:
                t = self._queue[0]
                if (t.topk, t.lang) != (head.topk, head.lang):
                    break
                if batch and nplans + len(t.plans) > self._max_batch:
                    break
                batch.append(self._queue.popleft())
                nplans += len(t.plans)
            self._gauge_locked()
            return batch

    def _index_for_issue(self):
        """The freshness protocol: never re-resolve the index while
        waves are in flight — drain first if the posdb moved, else keep
        issuing against the in-flight snapshot."""
        if self._inflight:
            di = self._inflight[-1].di
            if self._gen_fn() != di._built_version:
                self.drains_for_freshness += 1
                while self._inflight:
                    self._collect_one()
                return self._di_fn()
            return di
        return self._di_fn()

    def _issue_one(self) -> None:
        batch = self._take_batch()
        if not batch:
            return
        live = []
        for t in batch:
            # the budget may have run out while the ticket queued:
            # abandon before the device wave, not after it
            if deadline_mod.check_abandon("resident.issue", t.deadline):
                t._fail(deadline_mod.DeadlineExceeded(
                    "deadline exceeded before resident issue"))
            else:
                live.append(t)
        batch = live
        if not batch:
            return
        if g_chaos.enabled:
            g_chaos.resident_fault("issue")
        obs = devwatch.wave_begin("resident", coll=self.name,
                                  tickets=len(batch),
                                  queue=len(self._queue))
        try:
            di = self._index_for_issue()
            plans = [p for t in batch for p in t.plans]
            pending = di.issue_batch(plans, topk=batch[0].topk,
                                     lang=batch[0].lang)
            devwatch.wave_issued(obs, plans=len(plans),
                                 generation=di._built_version)
            for t in batch:
                t.di = di
                t.generation = di._built_version
            self._inflight.append(_Wave(pending, batch, di, obs))
            self.waves_issued += 1
            g_stats.count("resident.issue")
        except Exception as exc:  # noqa: BLE001 — fail the wave, not the loop
            devwatch.wave_end(obs, error=type(exc).__name__)
            for t in batch:
                t._fail(exc)
        finally:
            # a failed wave's error keeps this frame in its traceback:
            # without the tickets and the index in it, the tickets (which
            # keep the error) make no cycle with it
            batch = live = t = di = plans = pending = None

    def _collect_one(self) -> None:
        wave = self._inflight.popleft()
        try:
            if g_chaos.enabled:
                g_chaos.resident_fault("collect")
            devwatch.wave_collect(wave.obs)
            results = wave.di.collect_batch(wave.pending)
            off = 0
            for t in wave.tickets:
                t._resolve(results[off:off + len(t.plans)])
                off += len(t.plans)
            devwatch.wave_end(wave.obs)
        except Exception as exc:  # noqa: BLE001 — fail the wave, not the loop
            devwatch.wave_end(wave.obs, error=type(exc).__name__)
            for t in wave.tickets:
                t._fail(exc)
        finally:
            # as in ``_issue_one``: this frame lets go of the wave
            wave = t = results = None

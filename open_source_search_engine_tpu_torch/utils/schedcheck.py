"""Deterministic thread-schedule explorer (``OSSE_SCHED=1``).

A port of ``open_source_search_engine_tpu/utils/schedcheck.py`` (the
port imports nothing of that package). The reference engine ran every
state machine on one callback-driven thread (Gigablast's ``Loop.cpp``),
so races were impossible by design; this package has real threads (the
resident loop, tenancy's single flight, admission waiters, cache
refreshers), and an interleaving bug shows only in some schedules. This
module makes the schedule a tested input, in the spirit of loom, rr and
CHESS:

* Threads spawned via ``utils.threads`` and primitives built via
  ``utils.lockcheck.make_lock/make_rlock/make_condition/make_event``
  become **cooperatively scheduled** while an exploration is active:
  real OS threads, but exactly ONE runs at a time, handing a token at
  every yield point (lock acquire/release, condition wait/notify,
  event set/wait, thread spawn/join, and explicit
  :func:`sched_point` marks on shared-state accesses).
* The controller picks the next runnable thread from a **seeded PRNG**
  with **preemption-bound** exploration (bounded context switches per
  run, à la CHESS): one seed = one exact interleaving, replayable
  forever. Forced switches (current thread blocked/finished) are
  deterministic — first ready thread in registration order — so ALL
  nondeterminism lives in the recorded preemption decisions.
* Blocking waits with timeouts use **virtual time**: ``time.monotonic``
  is patched for the duration of a schedule, and when no thread is
  runnable the clock jumps to the earliest pending timeout. A run with
  no runnable thread and no pending timeout is reported as a deadlock,
  with every thread's wait target.
* :func:`explore` runs N distinct seeded schedules and, on failure,
  **shrinks** the failing seed's preemption decisions to a minimal set
  (greedy delta-debugging over the decision list), then raises
  :class:`ScheduleFailure` whose message is the minimal thread/lock
  timeline.

Arming follows the jitwatch/lockcheck contract: with ``OSSE_SCHED``
unset this module is a true no-op — the factories in ``lockcheck`` and
``threads`` check one module global and hand back plain primitives,
and even with the env var set, instrumentation only engages inside an
active :func:`explore` for threads it registered. Tier-1 behavior is
identical with and without the flag.

Cross-reference: scheduled locks feed ``lockcheck``'s acquisition-order
graph (when ``OSSE_LOCKCHECK=1``) under the same lock NAMES, so a
schedcheck failure timeline and a lockcheck cycle report line up
lock-for-lock.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable

#: process-wide opt-in, read once at import (the jitwatch/lockcheck
#: contract: unset ⇒ this module costs one import and one bool check)
ENABLED = os.environ.get("OSSE_SCHED") == "1"

#: real clock captured before any schedule patches ``time.monotonic``
_REAL_MONOTONIC = time.monotonic

#: probability a yield point spends one of the run's preemption budget
_PREEMPT_P = 0.35

#: the active exploration, if any (set only inside :func:`explore`)
_active: "Controller | None" = None


class SchedDeadlock(RuntimeError):
    """No runnable thread and no pending virtual timeout."""


class ScheduleFailure(AssertionError):
    """A seeded schedule broke an invariant; message is the shrunk
    thread/lock timeline (AssertionError so pytest renders it)."""

    def __init__(self, seed: int, error: BaseException,
                 trace: list[str], decisions: list[tuple[int, str]],
                 schedules_run: int, preemption_bound: int):
        self.seed = seed
        self.error = error
        self.trace = list(trace)
        self.decisions = list(decisions)
        self.schedules_run = schedules_run
        self.preemption_bound = preemption_bound
        super().__init__(self._render())

    def _render(self) -> str:
        head = (f"schedule failure: seed {self.seed} (found after "
                f"{self.schedules_run} schedule(s), bound "
                f"{self.preemption_bound}) — {type(self.error).__name__}: "
                f"{self.error}")
        dec = ", ".join(f"step {s}→{n}" for s, n in self.decisions) or "none"
        body = "\n".join(f"  {line}" for line in self.trace)
        return (f"{head}\nminimal preemptions: {dec}\n"
                f"thread/lock timeline:\n{body}")


class _SchedKilled(BaseException):
    """Internal: unwind a cooperating thread after the run is aborted.
    BaseException so scenario ``except Exception`` blocks can't eat it."""


class _TState:
    """Scheduler-side record for one cooperating thread."""

    __slots__ = ("name", "index", "event", "status", "waiting",
                 "deadline", "timed_out", "done")

    def __init__(self, name: str, index: int):
        self.name = name
        self.index = index
        self.event = threading.Event()
        self.status = "ready"            # ready | blocked | done
        self.waiting: tuple[str, str] | None = None
        self.deadline: float | None = None
        self.timed_out = False
        self.done = False


class Controller:
    """One schedule: a seeded token-passing scheduler.

    There is no controller *thread* — scheduling decisions are made by
    whichever cooperating thread holds the token, inside its yield
    point, under ``_mu``. That keeps switches at two Event operations
    and makes the decision sequence a pure function of (seed, program).
    """

    def __init__(self, seed: int, preemption_bound: int,
                 script: dict[int, str] | None = None):
        self.seed = seed
        self.bound = preemption_bound
        self.rng = random.Random(seed)
        #: replay mode: step → thread name to preempt to (shrinker)
        self.script = script
        self.step = 0
        self.preemptions = 0
        self.trace: list[str] = []
        self.decisions: list[tuple[int, str]] = []
        self.killed = False
        self.finished = False
        self.failure: BaseException | None = None
        self.clock_offset = 0.0
        self._mu = threading.Lock()
        self._states: dict[str, _TState] = {}
        self._order: list[str] = []
        self._by_ident: dict[int, _TState] = {}
        self._real_threads: list[threading.Thread] = []

    # --- registration -----------------------------------------------------

    def register(self, name: str) -> _TState:
        with self._mu:
            base, n = name, 2
            while name in self._states:
                name, n = f"{base}~{n}", n + 1
            st = _TState(name, len(self._order))
            self._states[name] = st
            self._order.append(name)
            return st

    def attach(self, st: _TState) -> None:
        """Bind the CURRENT OS thread to ``st`` (run from that thread)."""
        with self._mu:
            self._by_ident[threading.get_ident()] = st

    def attach_main(self) -> _TState:
        st = self.register("main")
        self.attach(st)
        return st

    def me(self) -> _TState | None:
        return self._by_ident.get(threading.get_ident())

    def now(self) -> float:
        return _REAL_MONOTONIC() + self.clock_offset

    # --- scheduling core --------------------------------------------------

    def _pick_locked(self, me: _TState) -> _TState:
        """Choose the next thread to run (caller holds ``_mu``)."""
        while True:
            ready = [self._states[n] for n in self._order
                     if self._states[n].status == "ready"]
            if ready:
                break
            timed = [s for s in self._states.values()
                     if s.status == "blocked" and s.deadline is not None]
            if not timed:
                raise SchedDeadlock(self._deadlock_msg_locked())
            # virtual time: jump to the earliest timeout and fire it
            s = min(timed, key=lambda t: (t.deadline, t.index))
            if s.deadline > self.now():
                self.clock_offset += (s.deadline - self.now()) + 1e-4
            s.timed_out, s.status = True, "ready"
            s.waiting = s.deadline = None
            self.trace.append(f"     ~ virtual timeout fires → {s.name}")
        if me.status != "ready":
            return ready[0]              # forced switch: deterministic
        others = [s for s in ready if s is not me]
        if not others:
            return me
        if self.script is not None:      # scripted replay (shrinker)
            want = self.script.get(self.step)
            for s in others:
                if s.name == want:
                    self.preemptions += 1
                    self.decisions.append((self.step, s.name))
                    self.trace.append(f"     ── preempt → {s.name}")
                    return s
            return me
        if self.preemptions < self.bound and self.rng.random() < _PREEMPT_P:
            s = others[self.rng.randrange(len(others))]
            self.preemptions += 1
            self.decisions.append((self.step, s.name))
            self.trace.append(f"     ── preempt → {s.name}")
            return s
        return me

    def _deadlock_msg_locked(self) -> str:
        waits = "; ".join(
            f"{s.name} awaits {s.waiting[0]} {s.waiting[1]}"
            for n in self._order
            for s in [self._states[n]] if s.status == "blocked")
        return f"deadlock: no runnable thread ({waits or 'no waiters'})"

    def _park(self, me: _TState) -> None:
        me.event.wait()
        me.event.clear()
        if self.killed:
            raise _SchedKilled()

    def yield_point(self, kind: str, target: str) -> None:
        """One scheduling opportunity for the calling thread."""
        me = self.me()
        if me is None or self.finished:
            return
        if self.killed:
            raise _SchedKilled()
        with self._mu:
            self.step += 1
            self.trace.append(
                f"{self.step:4d} {me.name:<16} {kind:<10} {target}")
            nxt = self._pick_locked(me)
            if nxt is me:
                return
            nxt.event.set()
        self._park(me)

    def block_on(self, kind: str, target: str,
                 deadline: float | None = None) -> bool:
        """Block the calling thread on (kind, target) until a waker
        marks it ready or the virtual ``deadline`` fires. Returns True
        when woken, False on timeout."""
        me = self.me()
        if me is None or self.finished:
            return True
        if self.killed:
            raise _SchedKilled()
        with self._mu:
            self.step += 1
            self.trace.append(
                f"{self.step:4d} {me.name:<16} {'block':<10} {kind} {target}")
            me.status, me.waiting = "blocked", (kind, target)
            me.deadline, me.timed_out = deadline, False
            nxt = self._pick_locked(me)
            nxt.event.set()
        self._park(me)
        return not me.timed_out

    def make_ready(self, states: list[_TState]) -> None:
        """Mark blocked threads runnable (called by the token holder;
        the woken threads run only when a later pick selects them)."""
        with self._mu:
            for s in states:
                if s.status == "blocked":
                    s.status = "ready"
                    s.waiting = s.deadline = None

    def wake_waiters(self, kind: str, target: str) -> None:
        with self._mu:
            for s in self._states.values():
                if s.status == "blocked" and s.waiting == (kind, target):
                    s.status = "ready"
                    s.waiting = s.deadline = None

    def finish(self, st: _TState) -> None:
        """The OS thread behind ``st`` is exiting; hand the token on."""
        with self._mu:
            st.status, st.done = "done", True
            if self.killed or self.finished:
                return
            self.trace.append(f"     ✓ {st.name} done")
            for s in self._states.values():
                if s.status != "blocked" or s.waiting is None:
                    continue
                if s.waiting == ("join", st.name):
                    s.status, s.waiting, s.deadline = "ready", None, None
                elif s.waiting == ("drain", "all") and all(
                        o.done for o in self._states.values() if o is not s):
                    s.status, s.waiting, s.deadline = "ready", None, None
            try:
                nxt = self._pick_locked(st)
            except SchedDeadlock as exc:
                self._fail_locked(exc)
                return
            nxt.event.set()

    def drain_remaining(self) -> None:
        """Run every other cooperating thread to completion (main calls
        this after the scenario body returns — leftover threads that
        can never finish surface as a deadlock/leak failure)."""
        me = self.me()
        while True:
            with self._mu:
                if all(s.done for s in self._states.values() if s is not me):
                    return
            self.block_on("drain", "all")

    # --- failure ----------------------------------------------------------

    def _fail_locked(self, exc: BaseException) -> None:
        if self.failure is None:
            self.failure = exc
        self.killed = True
        for s in self._states.values():
            s.event.set()

    def fail(self, exc: BaseException) -> None:
        with self._mu:
            self._fail_locked(exc)


# --- scheduled primitives ---------------------------------------------------


def _lockcheck():
    from . import lockcheck
    return lockcheck


class SchedLock:
    """Cooperatively scheduled mutex. Single-runner discipline means
    owner/waiter state needs no lock of its own — only the token holder
    touches it. Acquires/releases feed lockcheck's order graph under
    the same NAME so failure timelines and cycle reports line up."""

    _reentrant = False

    def __init__(self, ctl: Controller, name: str):
        self._ctl = ctl
        self.name = name
        self._owner: _TState | None = None
        self._depth = 0

    def _note(self, what: str) -> None:
        lc = _lockcheck()
        if lc.ENABLED:
            getattr(lc.g_lockcheck, what)(self.name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ctl = self._ctl
        me = ctl.me()
        if me is None or ctl.finished:
            return True                  # exploration over: degrade
        ctl.yield_point("acquire", self.name)
        dl = (ctl.now() + timeout) if (blocking and timeout is not None
                                       and timeout > 0) else None
        while True:
            if self._owner is None or (self._reentrant
                                       and self._owner is me):
                self._owner = me
                self._depth += 1
                if self._depth == 1:
                    self._note("note_acquire")
                return True
            if not blocking:
                return False
            if not ctl.block_on("lock", self.name, deadline=dl):
                return False

    def release(self) -> None:
        ctl = self._ctl
        me = ctl.me()
        if me is None or ctl.finished:
            self._owner, self._depth = None, 0
            return
        if self._owner is not me:
            raise RuntimeError(f"release of un-held lock {self.name}")
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
            self._note("note_release")
            ctl.wake_waiters("lock", self.name)
            ctl.yield_point("release", self.name)

    def locked(self) -> bool:
        return self._owner is not None

    def _release_all(self) -> int:
        """Condition.wait support: drop the lock whatever the depth."""
        depth, self._depth, self._owner = self._depth, 0, None
        self._note("note_release")
        self._ctl.wake_waiters("lock", self.name)
        return depth

    def _reacquire(self, me: _TState, depth: int) -> None:
        ctl = self._ctl
        while self._owner is not None and self._owner is not me:
            ctl.block_on("lock", self.name)
        self._owner, self._depth = me, depth
        self._note("note_acquire")

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class SchedRLock(SchedLock):
    _reentrant = True


class SchedCondition:
    """Cooperatively scheduled ``threading.Condition`` equivalent."""

    def __init__(self, ctl: Controller, name: str,
                 lock: SchedLock | None = None):
        self._ctl = ctl
        self.name = name
        self._lock = lock if lock is not None else SchedLock(ctl, name)
        self._waiters: list[_TState] = []

    def acquire(self, *a: Any, **kw: Any) -> bool:
        return self._lock.acquire(*a, **kw)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "SchedCondition":
        self._lock.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._lock.release()

    def wait(self, timeout: float | None = None) -> bool:
        ctl = self._ctl
        me = ctl.me()
        if me is None or ctl.finished:
            return True
        if self._lock._owner is not me:
            raise RuntimeError(f"wait() on un-acquired condition {self.name}")
        depth = self._lock._release_all()
        self._waiters.append(me)
        dl = (ctl.now() + max(timeout, 0.0)) if timeout is not None else None
        woken = ctl.block_on("cond", self.name, deadline=dl)
        if me in self._waiters:          # timed out before any notify
            self._waiters.remove(me)
        self._lock._reacquire(me, depth)
        return woken

    def notify(self, n: int = 1) -> None:
        ctl = self._ctl
        me = ctl.me()
        if me is None or ctl.finished:
            return
        woken, self._waiters = self._waiters[:n], self._waiters[n:]
        ctl.make_ready(woken)
        ctl.yield_point("notify", self.name)

    def notify_all(self) -> None:
        self.notify(n=len(self._waiters) or 1)


class SchedEvent:
    """Cooperatively scheduled ``threading.Event`` equivalent."""

    def __init__(self, ctl: Controller, name: str):
        self._ctl = ctl
        self.name = name
        self._flag = False
        self._waiters: list[_TState] = []

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        self._flag = True
        ctl = self._ctl
        me = ctl.me()
        if me is None or ctl.finished:
            return
        if self._waiters:
            woken, self._waiters = self._waiters, []
            ctl.make_ready(woken)
        ctl.yield_point("event-set", self.name)

    def clear(self) -> None:
        self._flag = False

    def wait(self, timeout: float | None = None) -> bool:
        ctl = self._ctl
        me = ctl.me()
        if me is None or ctl.finished:
            return self._flag
        ctl.yield_point("event-wait", self.name)
        while not self._flag:
            dl = (ctl.now() + max(timeout, 0.0)) if timeout is not None \
                else None
            self._waiters.append(me)
            woken = ctl.block_on("event", self.name, deadline=dl)
            if me in self._waiters:
                self._waiters.remove(me)
            if not woken:
                return self._flag
        return True


class SchedThread(threading.Thread):
    """A cooperating thread: real OS thread, but it runs only while it
    holds the scheduler token, and ``join`` is a scheduled wait."""

    def __init__(self, ctl: Controller, name: str,
                 target: Callable[..., Any], args: tuple, kwargs: dict):
        self._ctl = ctl
        self._target0 = target
        self._args0 = args
        self._kwargs0 = kwargs
        self._st: _TState | None = None
        super().__init__(target=self._run_coop, daemon=True, name=name)

    def start(self) -> None:
        ctl = self._ctl
        self._st = ctl.register(self.name)
        ctl._real_threads.append(self)
        super().start()
        ctl.yield_point("spawn", self._st.name)

    def _run_coop(self) -> None:
        ctl, st = self._ctl, self._st
        ctl.attach(st)
        try:
            st.event.wait()              # first scheduling of this thread
            st.event.clear()
            if ctl.killed:
                return
            self._target0(*self._args0, **self._kwargs0)
        except _SchedKilled:
            pass
        except BaseException as exc:     # invariant broke on this thread
            ctl.fail(exc)
        finally:
            ctl.finish(st)

    def join(self, timeout: float | None = None) -> None:
        ctl, st = self._ctl, self._st
        me = ctl.me()
        if st is None or st.done or me is None or ctl.finished:
            super().join(timeout if timeout is not None else 5.0)
            return
        dl = (ctl.now() + max(timeout, 0.0)) if timeout is not None else None
        while not st.done:
            if not ctl.block_on("join", st.name, deadline=dl):
                return                   # timed out (virtual)


# --- factory hooks (called by lockcheck/threads) ----------------------------


def _controlled() -> Controller | None:
    """The active controller, iff the CALLING thread cooperates in it.
    Threads outside the exploration (pytest workers, leaked daemons)
    keep getting plain primitives even mid-run."""
    ctl = _active
    if ctl is None or ctl.finished or ctl.me() is None:
        return None
    return ctl


def maybe_lock(name: str) -> SchedLock | None:
    ctl = _controlled()
    return SchedLock(ctl, name) if ctl is not None else None


def maybe_rlock(name: str) -> SchedRLock | None:
    ctl = _controlled()
    return SchedRLock(ctl, name) if ctl is not None else None


def maybe_condition(name: str) -> SchedCondition | None:
    ctl = _controlled()
    return SchedCondition(ctl, name) if ctl is not None else None


def maybe_event(name: str) -> SchedEvent | None:
    ctl = _controlled()
    return SchedEvent(ctl, name) if ctl is not None else None


def maybe_thread(name: str, target: Callable[..., Any], args: tuple,
                 kwargs: dict) -> SchedThread | None:
    ctl = _controlled()
    if ctl is None:
        return None
    return SchedThread(ctl, name, target, args, kwargs)


def sched_point(name: str) -> None:
    """Mark a shared-state access as a scheduling opportunity. No-op
    outside an active exploration (safe to leave in production code,
    though scenarios usually put these on test doubles)."""
    ctl = _controlled()
    if ctl is not None:
        ctl.yield_point("point", name)


def settle(grace: float = 0.01) -> None:
    """Scenario barrier: park the calling thread behind every other
    runnable thread until the system quiesces (everyone blocked or
    done), then resume via a virtual timeout. Deterministic — forced
    switches pick in registration order — and a no-op outside an
    active exploration."""
    ctl = _controlled()
    if ctl is not None:
        ctl.block_on("settle", "grace", deadline=ctl.now() + grace)


# --- exploration harness ----------------------------------------------------


def _run_one(fn: Callable[[], None], seed: int, bound: int,
             script: dict[int, str] | None = None
             ) -> tuple[Controller, BaseException | None]:
    """Run ``fn`` under one exact schedule; returns (controller, failure)."""
    global _active
    if _active is not None:
        raise RuntimeError("explore() does not nest")
    ctl = Controller(seed, bound, script)
    _active = ctl
    time.monotonic = lambda: _REAL_MONOTONIC() + ctl.clock_offset
    ctl.attach_main()
    failure: BaseException | None = None
    try:
        fn()
        ctl.drain_remaining()
    except (_SchedKilled, SchedDeadlock) as exc:
        failure = ctl.failure if ctl.failure is not None else exc
    except BaseException as exc:
        failure = ctl.failure if ctl.failure is not None else exc
    finally:
        if failure is None and ctl.failure is not None:
            failure = ctl.failure
        with ctl._mu:
            ctl.killed = ctl.finished = True
            for s in ctl._states.values():
                s.event.set()
        time.monotonic = _REAL_MONOTONIC
        _active = None
        for th in ctl._real_threads:
            th.join(timeout=5.0)
    return ctl, failure


def _shrink(fn: Callable[[], None], seed: int, bound: int,
            decisions: list[tuple[int, str]], max_replays: int = 48
            ) -> tuple[Controller, BaseException] | None:
    """Greedy delta-debugging over the preemption decisions: drop one
    decision at a time, keep removals that still fail. Returns the
    minimal failing (controller, failure), or None if even the full
    scripted replay no longer fails (scenario nondeterminism)."""
    script = list(decisions)
    best: tuple[Controller, BaseException] | None = None
    ctl, failure = _run_one(fn, seed, bound, script=dict(script))
    if failure is None:
        return None
    best = (ctl, failure)
    replays, improved = 1, True
    while improved and replays < max_replays:
        improved = False
        for i in range(len(script)):
            trial = script[:i] + script[i + 1:]
            ctl, failure = _run_one(fn, seed, bound, script=dict(trial))
            replays += 1
            if failure is not None:
                script, best, improved = trial, (ctl, failure), True
                break
            if replays >= max_replays:
                break
    return best


def explore(fn: Callable[[], None], schedules: int | None = None,
            preemption_bound: int | None = None, seed: int = 0) -> dict:
    """Run ``fn`` under N distinct seeded schedules.

    ``fn`` builds its own world (threads via ``utils.threads``,
    primitives via the ``lockcheck`` factories) and asserts its
    invariants; any assertion/exception on any cooperating thread, a
    deadlock, or a leaked never-finishing thread fails the schedule.
    The failing seed is shrunk to a minimal preemption trace and
    raised as :class:`ScheduleFailure`.

    Defaults: ``schedules`` from ``OSSE_SCHED_BUDGET`` (64),
    ``preemption_bound`` from ``OSSE_SCHED_PREEMPTIONS`` (3).
    """
    if not ENABLED:
        raise RuntimeError(
            "schedcheck is not armed — run under OSSE_SCHED=1 (the "
            "factories bind to plain primitives otherwise)")
    if schedules is None:
        schedules = int(os.environ.get("OSSE_SCHED_BUDGET", "64"))
    if preemption_bound is None:
        preemption_bound = int(os.environ.get("OSSE_SCHED_PREEMPTIONS", "3"))
    yield_points = 0
    for i in range(schedules):
        s = seed + i
        ctl, failure = _run_one(fn, s, preemption_bound)
        yield_points += ctl.step
        if failure is None:
            continue
        shrunk = _shrink(fn, s, preemption_bound, ctl.decisions)
        if shrunk is None:               # replay diverged; report as-was
            shrunk = (ctl, failure)
        sctl, sfailure = shrunk
        raise ScheduleFailure(
            seed=s, error=sfailure, trace=sctl.trace,
            decisions=sctl.decisions, schedules_run=i + 1,
            preemption_bound=preemption_bound)
    return {"schedules": schedules, "preemption_bound": preemption_bound,
            "yield_points": yield_points, "failures": 0}


def trace_of(fn: Callable[[], None], seed: int,
             preemption_bound: int = 3) -> list[str]:
    """The exact event trace of ONE seeded schedule (determinism probe:
    same seed ⇒ byte-identical trace). Raises nothing — a failing
    schedule's partial trace is still the deterministic artifact."""
    if not ENABLED:
        raise RuntimeError("schedcheck is not armed — set OSSE_SCHED=1")
    ctl, _failure = _run_one(fn, seed, preemption_bound)
    return list(ctl.trace)

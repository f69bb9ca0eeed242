"""The port's schedule explorer (``utils/schedcheck.py``) held to the
cases of the reference's ``tests/test_schedcheck.py``: the unarmed no-op
contract, the explorer itself (byte-identical replay, a lost update
found and shrunk, an ABBA deadlock), the protocol scenarios of
``tests/torch_sched_scenarios.py`` clean under the budget, and both
seeded regressions found.

The toy workloads take the package whose ``schedcheck``, ``lockcheck``
and ``threads`` they run on, so that each also runs under the JAX
package's explorer with the same seed: the traces, the failing seeds,
the shrunk preemptions and the rendered timelines must be equal. The
protocol scenarios drive the port's own modules, which the reference's
explorer cannot schedule, so they are held to their invariants only.

``OSSE_SCHED=1`` arms the explorer when the module is imported. The
explorer's cases arm it in-process instead (the ``armed`` fixture sets
the modules' flags), so that they run in every tier-1 run; the factories
hand out scheduled primitives only inside an active ``explore`` either
way."""

import functools
import os
import threading
import time
from types import SimpleNamespace

import pytest

from open_source_search_engine_tpu.utils import lockcheck as jlockcheck
from open_source_search_engine_tpu.utils import schedcheck as jschedcheck
from open_source_search_engine_tpu.utils import threads as jthreads
from open_source_search_engine_tpu_torch.utils import (lockcheck, schedcheck,
                                                       threads)

from tests import torch_sched_scenarios as scenarios

BUDGET = int(os.environ.get("OSSE_SCHED_BUDGET", "64"))

PORT = SimpleNamespace(schedcheck=schedcheck, lockcheck=lockcheck,
                       threads=threads)
REF = SimpleNamespace(schedcheck=jschedcheck, lockcheck=jlockcheck,
                      threads=jthreads)


@pytest.fixture
def armed(monkeypatch):
    for m in (PORT, REF):
        monkeypatch.setattr(m.schedcheck, "ENABLED", True)
    yield
    for m in (PORT, REF):
        assert m.schedcheck._active is None
        assert time.monotonic is m.schedcheck._REAL_MONOTONIC


# --- the no-op contract ----------------------------------------------------


class TestUnarmedNoOp:
    """Outside an active explore() the plane costs nothing: plain
    primitives, no wrappers, sched_point free, armed or not."""

    def test_factories_return_plain_primitives_when_idle(self):
        assert schedcheck._active is None
        assert not isinstance(lockcheck.make_lock("t.l"),
                              schedcheck.SchedLock)
        assert not isinstance(lockcheck.make_rlock("t.rl"),
                              schedcheck.SchedRLock)
        assert isinstance(lockcheck.make_condition("t.cv"),
                          threading.Condition)
        assert isinstance(lockcheck.make_event("t.ev"), threading.Event)
        t = threads.make_thread("t.th", lambda: None)
        assert type(t) is threading.Thread

    def test_sched_point_and_settle_are_noops_when_idle(self):
        t0 = time.perf_counter()
        schedcheck.sched_point("anywhere")
        schedcheck.settle()
        assert time.perf_counter() - t0 < 1.0

    def test_explore_requires_arming(self, monkeypatch):
        monkeypatch.setattr(schedcheck, "ENABLED", False)
        with pytest.raises(RuntimeError, match="OSSE_SCHED"):
            schedcheck.explore(lambda: None, schedules=1)
        with pytest.raises(RuntimeError, match="OSSE_SCHED"):
            schedcheck.trace_of(lambda: None, seed=0)

    def test_monotonic_unpatched_when_idle(self):
        assert time.monotonic is schedcheck._REAL_MONOTONIC

    def test_factories_hand_scheduled_primitives_inside_explore(self,
                                                                armed):
        got = {}

        def body():
            got["lock"] = lockcheck.make_lock("t.l")
            got["rlock"] = lockcheck.make_rlock("t.rl")
            got["cv"] = lockcheck.make_condition("t.cv")
            got["ev"] = lockcheck.make_event("t.ev")
            got["th"] = threads.make_thread("t.th", lambda: None)
            got["clock"] = time.monotonic is schedcheck._REAL_MONOTONIC

        schedcheck.explore(body, schedules=1)
        assert type(got["lock"]) is schedcheck.SchedLock
        assert type(got["rlock"]) is schedcheck.SchedRLock
        assert type(got["cv"]) is schedcheck.SchedCondition
        assert type(got["ev"]) is schedcheck.SchedEvent
        assert type(got["th"]) is schedcheck.SchedThread
        assert got["clock"] is False  # virtual time inside the schedule




# --- toy workloads for the explorer itself ---------------------------------
# Each takes the package (``PORT`` or ``REF``) whose explorer runs it.


def _toy_lost_update(m):
    counter = {"v": 0}

    def bump(name):
        v = counter["v"]
        m.schedcheck.sched_point(f"{name}.read")
        counter["v"] = v + 1

    ts = [m.threads.make_thread(f"w{i}", functools.partial(bump, f"w{i}"))
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert counter["v"] == 2, f"lost update: counter={counter['v']}"


def _toy_locked_update(m):
    counter = {"v": 0}
    mu = m.lockcheck.make_lock("toy.mu")

    def bump(name):
        with mu:
            v = counter["v"]
            m.schedcheck.sched_point(f"{name}.read")
            counter["v"] = v + 1

    ts = [m.threads.make_thread(f"w{i}", functools.partial(bump, f"w{i}"))
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert counter["v"] == 2


def _toy_abba(m):
    a = m.lockcheck.make_lock("toy.A")
    b = m.lockcheck.make_lock("toy.B")

    def t1():
        with a:
            m.schedcheck.sched_point("t1.holds.A")
            with b:
                pass

    def t2():
        with b:
            m.schedcheck.sched_point("t2.holds.B")
            with a:
                pass

    ts = [m.threads.make_thread("t1", t1), m.threads.make_thread("t2", t2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


TOYS = {"lost_update": _toy_lost_update, "locked_update": _toy_locked_update,
        "abba": _toy_abba}


def _on(m, toy):
    return functools.partial(TOYS[toy], m)


class TestExplorer:
    def test_same_seed_byte_identical_trace(self, armed):
        """One seed = one exact interleaving, replayable forever."""
        t1 = schedcheck.trace_of(_on(PORT, "lost_update"), seed=7)
        t2 = schedcheck.trace_of(_on(PORT, "lost_update"), seed=7)
        assert t1 == t2
        assert any(".read" in ln for ln in t1)

    def test_toy_race_found_and_shrunk(self, armed):
        with pytest.raises(schedcheck.ScheduleFailure) as ei:
            schedcheck.explore(_on(PORT, "lost_update"), schedules=BUDGET)
        f = ei.value
        assert f.schedules_run <= BUDGET
        # one switch between the read and the write is enough
        assert len(f.decisions) <= 2, f.decisions
        assert ".read" in str(f), "the timeline names the racing point"

    def test_locked_toy_survives_exploration(self, armed):
        out = schedcheck.explore(_on(PORT, "locked_update"), schedules=32)
        assert out["failures"] == 0
        assert out["yield_points"] > 0

    def test_abba_deadlock_detected(self, armed):
        with pytest.raises(schedcheck.ScheduleFailure) as ei:
            schedcheck.explore(_on(PORT, "abba"), schedules=BUDGET)
        assert "deadlock" in str(ei.value)

    def test_failure_replay_reproduces(self, armed):
        """The seed in a ScheduleFailure replays to the same failure."""
        with pytest.raises(schedcheck.ScheduleFailure) as ei:
            schedcheck.explore(_on(PORT, "lost_update"), schedules=BUDGET)
        seed = ei.value.seed
        with pytest.raises(schedcheck.ScheduleFailure) as ei2:
            schedcheck.explore(_on(PORT, "lost_update"), schedules=1,
                               seed=seed)
        assert ei2.value.seed == seed


class TestAgainstReference:
    """The same toy workload and seed under the port's explorer and the
    JAX package's: one interleaving, one failing seed, one shrunk
    timeline."""

    @pytest.mark.parametrize("seed", [0, 7, 31])
    @pytest.mark.parametrize("toy", sorted(TOYS))
    def test_same_trace(self, armed, toy, seed):
        want = jschedcheck.trace_of(_on(REF, toy), seed=seed)
        got = schedcheck.trace_of(_on(PORT, toy), seed=seed)
        assert got == want
        assert got, "the toy never reached the plane"

    @pytest.mark.parametrize("seed", [0, 5])
    @pytest.mark.parametrize("toy", ["lost_update", "abba"])
    def test_same_failure_found_and_shrunk(self, armed, toy, seed):
        fails = []
        for m in (REF, PORT):
            with pytest.raises(m.schedcheck.ScheduleFailure) as ei:
                m.schedcheck.explore(_on(m, toy), schedules=BUDGET,
                                     seed=seed)
            fails.append(ei.value)
        want, got = fails
        assert (got.seed, got.schedules_run, got.preemption_bound) == \
            (want.seed, want.schedules_run, want.preemption_bound)
        assert got.decisions == want.decisions
        assert got.trace == want.trace
        assert type(got.error).__name__ == type(want.error).__name__
        assert str(got) == str(want)

    @pytest.mark.parametrize("toy", ["lost_update", "abba"])
    def test_same_replay(self, armed, toy):
        """The reference's failing seed replays to the same failure on
        the port, with the same timeline."""
        with pytest.raises(jschedcheck.ScheduleFailure) as ei:
            jschedcheck.explore(_on(REF, toy), schedules=BUDGET)
        seed = ei.value.seed
        with pytest.raises(schedcheck.ScheduleFailure) as ei2:
            schedcheck.explore(_on(PORT, toy), schedules=1, seed=seed)
        assert ei2.value.seed == seed
        assert ei2.value.trace == ei.value.trace
        assert ei2.value.decisions == ei.value.decisions

    @pytest.mark.parametrize("bound", [1, 3])
    def test_same_clean_exploration(self, armed, bound):
        want = jschedcheck.explore(_on(REF, "locked_update"), schedules=32,
                                   preemption_bound=bound)
        got = schedcheck.explore(_on(PORT, "locked_update"), schedules=32,
                                 preemption_bound=bound)
        assert got == want
        assert got["failures"] == 0 and got["yield_points"] > 0


# --- the protocol scenarios ------------------------------------------------


class TestScenarioSuites:
    @pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
    def test_scenario_clean_under_budget(self, armed, name):
        out = schedcheck.explore(scenarios.SCENARIOS[name],
                                 schedules=BUDGET)
        assert out["failures"] == 0
        assert out["schedules"] == BUDGET
        assert out["yield_points"] > 0, "the scenario never hit the plane"


# --- seeded regressions ----------------------------------------------------


class TestSeededRegressions:
    """The explorer finds, within the budget, the races that test-local
    buggy subclasses put back, with shrunk traces naming the racing
    points."""

    def test_generation_stamp_race_found(self, armed):
        # the cache entry stamped with the generation re-read at put
        # time: a write between compute and put passes a stale value off
        # as fresh
        fn = functools.partial(scenarios.scenario_cache_generation,
                               cache_cls=scenarios.make_buggy_cache_cls())
        with pytest.raises(schedcheck.ScheduleFailure) as ei:
            schedcheck.explore(fn, schedules=BUDGET)
        f = ei.value
        assert f.schedules_run <= BUDGET
        msg = str(f)
        assert "gen.bump" in msg and "buggy.put" in msg, msg

    def test_lone_hog_displacement_found(self, armed):
        # the victim's share computed without the displacer: a lone
        # hog's share is unbounded, so the quiet tenant sheds queue_full
        fn = functools.partial(scenarios.scenario_admission_quota,
                               gate_cls=scenarios.make_buggy_gate_cls())
        with pytest.raises(schedcheck.ScheduleFailure) as ei:
            schedcheck.explore(fn, schedules=BUDGET)
        f = ei.value
        assert f.schedules_run <= BUDGET
        assert "queue_full" in str(f)


@pytest.mark.slow
class TestDeepExploration:
    """1024 schedules per scenario, still no finding."""

    @pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
    def test_scenario_clean_deep(self, armed, name):
        out = schedcheck.explore(scenarios.SCENARIOS[name],
                                 schedules=1024)
        assert out["failures"] == 0

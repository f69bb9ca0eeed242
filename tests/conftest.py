"""A time limit for each test under ``tests/``.

A test that deadlocks would hold its xdist worker, and the files queued
behind it, until the run's own limit cut the whole run. Here a test's
setup, call and teardown together get ``LIMIT_S`` seconds, or those of
its ``@pytest.mark.time_limit(seconds)``. When they run out, ``SIGALRM``
writes every thread's stack to stderr and raises :class:`TimeLimit` in
the main thread, which fails that test, and the rest of the file runs.
Each firing grants the test one more limit, so a teardown that is stuck
after the raise is cut the same way. The alarm is armed only inside the
three phases, never while pytest and xdist report.

It breaks a wait in the main thread. A raise inside a ``__del__`` is
swallowed by the interpreter (the shape of the JAX package's
collector-under-lock deadlock, ROADMAP recorded departure 11), so the
report hook fails that test all the same. It does not break a deadlock
in another thread: that thread keeps its locks, and each later test that
waits on them fails at its own limit."""

import contextlib
import faulthandler
import math
import signal
import sys
import time

import pytest

# at least 3x the setup, call and teardown of the slowest test without a
# time_limit marker under the tier-1 run's six workers (48.13 s), and at
# most 240 s
LIMIT_S = 180

_deadline = pytest.StashKey[float]()
_fired = pytest.StashKey[set]()


class TimeLimit(BaseException):
    """A test ran over its time limit. A ``BaseException``, so that no
    ``except Exception`` in the code under test takes it for its own."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "time_limit(seconds): this test's limit for its setup, "
        f"call and teardown together, in place of {LIMIT_S} s")


def _limit(item):
    marker = item.get_closest_marker("time_limit")
    return marker.args[0] if marker else LIMIT_S


@contextlib.contextmanager
def _alarm(item, when):
    limit = _limit(item)
    capman = item.config.pluginmanager.getplugin("capturemanager")

    def expire(signum, frame):
        item.stash.setdefault(_fired, set()).add(when)
        item.stash[_deadline] = time.monotonic() + limit
        signal.alarm(limit)
        with capman.global_and_fixture_disabled():
            print(f"\n{item.nodeid} ran over its time limit of {limit} s "
                  f"in its {when}", file=sys.stderr, flush=True)
            faulthandler.dump_traceback(sys.stderr, all_threads=True)
        raise TimeLimit(f"{item.nodeid} ran over its time limit of "
                        f"{limit} s")

    left = item.stash[_deadline] - time.monotonic()
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(max(1, math.ceil(left)))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    item.stash[_deadline] = time.monotonic() + _limit(item)
    with _alarm(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _alarm(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _alarm(item, "teardown"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    report = (yield).get_result()
    if report.passed and call.when in item.stash.get(_fired, ()):
        report.outcome = "failed"
        report.longrepr = (f"{item.nodeid} ran over its time limit in its "
                           f"{call.when}; its TimeLimit was swallowed, as "
                           "in a __del__ (the stack dump is on stderr)")

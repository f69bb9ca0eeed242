"""Stage timing: each span adds its wall time to a per-name total and
logs it at DEBUG under the ``perf`` log type. A stand-in for a tracing
plane — no sampling, no span trees; callers read :data:`totals` to see
where a run's time went."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from .log import get_logger

log = get_logger("perf")

#: span name → [calls, seconds] since the last :func:`reset`
totals: defaultdict = defaultdict(lambda: [0, 0.0])


def reset() -> None:
    totals.clear()


@contextlib.contextmanager
def span(name: str, **tags):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        tot = totals[name]
        tot[0] += 1
        tot[1] += dt
        if log.isEnabledFor(10):  # logging.DEBUG
            log.debug("%s %.3f ms %s", name, dt * 1e3, tags or "")


def record(name: str, t0: float, t1: float | None = None, **tags) -> None:
    """Add a stage timed by the caller (``time.perf_counter()`` marks)
    to the totals, as a span would."""
    dt = (time.perf_counter() if t1 is None else t1) - t0
    tot = totals[name]
    tot[0] += 1
    tot[1] += dt
    if log.isEnabledFor(10):
        log.debug("%s %.3f ms %s", name, dt * 1e3, tags or "")


def tag(**tags) -> None:
    """Attach values to the enclosing stage: logged at DEBUG."""
    if log.isEnabledFor(10):
        log.debug("tags %s", tags)

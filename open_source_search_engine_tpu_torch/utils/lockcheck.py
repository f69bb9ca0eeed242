"""Named lock factories (reference ``utils/lockcheck.py:277-325``).

The serving planes create their locks, conditions and events through
these, under the names the reference's lock roster uses. Here they are
plain ``threading`` primitives: the lock-order checker and the blocking
probes wait for the telemetry plane.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A mutex for the lock roster entry ``name``."""
    return threading.Lock()


def make_rlock(name: str):
    """A re-entrant mutex for the lock roster entry ``name``."""
    return threading.RLock()


def make_condition(name: str):
    """A condition variable for the lock roster entry ``name``."""
    return threading.Condition()


def make_event(name: str):
    """An event (events carry no lock-ordering information)."""
    return threading.Event()

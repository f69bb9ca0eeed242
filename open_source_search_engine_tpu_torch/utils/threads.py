"""Named daemon threads — the one way the port spawns a thread.

A copy of ``open_source_search_engine_tpu/utils/threads.py``: every
worker has a name, so a thread dump of a hung process says what each
thread is. Helper threads are daemons; orderly shutdown is each owner's
``stop()``. Inside an active ``schedcheck.explore`` a thread made here
is a cooperatively scheduled one.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from . import schedcheck as _schedcheck


def make_thread(name: str, target: Callable[..., Any], *args: Any,
                **kwargs: Any) -> threading.Thread:
    """A named daemon thread, not started (for callers that publish the
    Thread object before it runs)."""
    if _schedcheck._active is not None:
        sched = _schedcheck.maybe_thread(name, target, args, kwargs)
        if sched is not None:
            return sched
    return threading.Thread(target=target, args=args, kwargs=kwargs,
                            daemon=True, name=name)


def spawn(name: str, target: Callable[..., Any], *args: Any,
          **kwargs: Any) -> threading.Thread:
    """Create and start a named daemon thread; returns it for joining."""
    t = make_thread(name, target, *args, **kwargs)
    t.start()
    return t

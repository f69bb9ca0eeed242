"""Named daemon threads — the one way the port spawns a thread.

A copy of ``open_source_search_engine_tpu/utils/threads.py`` without the
schedule explorer: every worker has a name, so a thread dump of a hung
process says what each thread is. Helper threads are daemons; orderly
shutdown is each owner's ``stop()``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


def spawn(name: str, target: Callable[..., Any], *args: Any,
          **kwargs: Any) -> threading.Thread:
    """Create and start a named daemon thread; returns it for joining."""
    t = threading.Thread(target=target, args=args, kwargs=kwargs,
                         daemon=True, name=name)
    t.start()
    return t

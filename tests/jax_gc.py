"""Garbage-collection hygiene for the port's tests that drive the JAX
package's serving path.

The JAX package's ``DeviceIndex`` keeps its plan cache in a reference
cycle (the cache's generation function closes over the collection that
holds the index), and ``Cache.__del__`` sets a membudget gauge under
that package's non-reentrant lock. When the cyclic collector frees such
a cache inside a locked membudget section of the same thread, the thread
waits on itself forever (ROADMAP §3). :func:`quiet` collects before and
after a block, with no lock held, and keeps the collector off inside it,
so a test never leaves that garbage behind or collects it under the
lock."""

from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def quiet():
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()
        gc.collect()

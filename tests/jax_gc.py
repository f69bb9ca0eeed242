"""Garbage-collection hygiene for the port's tests that drive the JAX
package's serving path.

The JAX package's ``DeviceIndex`` keeps its plan cache in a reference
cycle (the cache's generation function closes over the collection that
holds the index), and ``Cache.__del__`` sets a membudget gauge under
that package's non-reentrant lock. When the cyclic collector frees such
a cache inside a locked membudget section of the same thread, the thread
waits on itself forever (ROADMAP, recorded departure 11). :func:`quiet`
collects before and after a block, with no lock held, and keeps the
collector off inside it, so a test never leaves that garbage behind or
collects it under the lock.

A stopped server is not garbage yet: its QueryBatcher's worker thread
and pool threads still reach it until they end. :func:`release` waits
for them, so the server is unreachable by the time the module's last
collection runs; otherwise it becomes garbage later, in whatever test
runs next on the worker, and the collector may free it there under the
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


def release(*owners, timeout: float = 30.0) -> None:
    """Stop each server or mesh and wait until the threads that reach it
    have ended: a server's batcher worker and pool, its sampler and
    accept loop; a mesh's serving loop and shard pool (a server's mesh
    too)."""
    for obj in owners:
        mesh = getattr(getattr(obj, "sharded", None), "_mesh_resident",
                       None)
        loop = getattr(obj, "_serve_loop", None)
        obj.stop()
        for o in (obj, mesh):
            pool = getattr(o, "_pool", None)
            if pool is not None:
                pool.shutdown(wait=True)
        batcher = getattr(obj, "_batcher", None)
        if batcher is not None:
            batcher._pool.shutdown(wait=True)
            batcher._thread.join(timeout)
        loops = [loop, getattr(mesh, "_serve_loop", None)]
        threads = [getattr(lp, "_thread", None) for lp in loops if lp]
        threads += [getattr(obj, n, None)
                    for n in ("_sampler", "_thread", "_slo_thread")]
        for t in threads:
            if t is not None:
                t.join(timeout)

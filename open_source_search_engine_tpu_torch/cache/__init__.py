"""Cache plane — the RdbCache role as one subsystem.

A copy of ``open_source_search_engine_tpu/cache/__init__.py``; the port imports
nothing of that package.

Gigablast put a single cache class behind every hot lookup (termlists,
title recs, DNS, robots, the Msg17 result cache); this package is that
idea for the TPU port: a registry of named, membudget-charged caches
with generation-based invalidation and single-flight miss suppression.
See :mod:`.plane`.
"""

from .plane import CachePlane, GenCache, g_cacheplane

__all__ = ["CachePlane", "GenCache", "g_cacheplane"]

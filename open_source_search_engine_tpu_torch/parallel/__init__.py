"""The mesh: the shard map, docid-sharded collections and the
scatter-gather query with its cross-shard merge.

Port of ``open_source_search_engine_tpu/parallel/`` without the
multi-process cluster plane (``cluster.py``, ``transport.py``,
``fleet.py``): ``Hostdb`` (the cluster map) → :mod:`hostmap`; Msg1/Msg4
sharded record routing → :class:`sharded.ShardedCollection`; Msg3a/Msg39
scatter-gather with the per-shard intersect and the cross-shard top-k
merge → :func:`sharded.sharded_search` and :class:`sharded.MeshResident`,
over a mesh that is a list of devices, one per shard.
"""

from .hostmap import HostMap, make_mesh
from .sharded import (MeshResident, MeshServeIndex, ShardedCollection,
                      sharded_search, suggest_sharded)

__all__ = ["HostMap", "MeshResident", "MeshServeIndex", "ShardedCollection",
           "make_mesh", "sharded_search", "suggest_sharded"]

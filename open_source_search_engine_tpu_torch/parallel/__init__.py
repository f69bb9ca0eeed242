"""The mesh and the cluster: the shard map, docid-sharded collections,
the scatter-gather query with its cross-shard merge, and shards as node
processes.

Port of ``open_source_search_engine_tpu/parallel/``: ``Hostdb`` (the
cluster map) → :mod:`hostmap`; Msg1/Msg4 sharded record routing →
:class:`sharded.ShardedCollection`; Msg3a/Msg39 scatter-gather with the
per-shard intersect and the cross-shard top-k merge →
:func:`sharded.sharded_search` and :class:`sharded.MeshResident`, over a
mesh that is a list of devices, one per shard; the UdpServer/Multicast/
PingServer host plane (shards as node processes, twin failover,
retry-forever writes, the Msg3a merge over RPC) → :mod:`cluster` on the
pooled, hedged :mod:`transport`, with :mod:`fleet` spawning and
supervising the node processes.
"""

from .cluster import ClusterClient, HostsConf, ShardNodeServer
from .hostmap import HostMap, make_mesh
from .sharded import (MeshResident, MeshServeIndex, ShardedCollection,
                      sharded_search, suggest_sharded)

__all__ = ["ClusterClient", "HostMap", "HostsConf", "MeshResident",
           "MeshServeIndex", "ShardNodeServer", "ShardedCollection",
           "make_mesh", "sharded_search", "suggest_sharded"]

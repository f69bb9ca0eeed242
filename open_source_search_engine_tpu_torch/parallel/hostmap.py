"""Host/shard map: the cluster topology (the reference's ``Hostdb``).

Port of ``open_source_search_engine_tpu/parallel/hostmap.py`` (reference
``Hostdb.cpp/h``: ``hosts.conf`` with ``num-mirrors:`` and
``index-splits:``, key → shard maps ``getShardNum`` ``Hostdb.cpp:2486``,
per-host liveness for failover).

A "mesh" here is an explicit list of ``torch.device``s, one per shard.
With fewer devices than shards the shards wrap onto the devices there
are (on one card every shard lives on ``cuda:0``): still correct, the
shards share the card's time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..index import posdb

#: the mesh axis name of the reference; here it names the shard index of
#: a mesh's device list
SHARD_AXIS = "shards"


def make_mesh(n_shards: int, devices=None) -> list[torch.device]:
    """One device per shard. ``devices`` defaults to every visible CUDA
    device (raising without a card unless the caller passes ``["cpu"]``);
    shards wrap onto the devices when there are fewer of them."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)] or [None]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    return [devs[s % len(devs)] for s in range(n_shards)]


@dataclass
class HostMap:
    """Shard count, replication and key routing: ``index-splits:`` →
    ``n_shards``, ``num-mirrors:`` → ``n_replicas - 1``. Liveness and
    the read latency are per (shard, replica), the reference's per-host
    ping state."""

    n_shards: int
    n_replicas: int = 1
    alive: np.ndarray = field(default=None)  # bool [n_shards, n_replicas]
    #: per-twin read-RTT EWMA seconds: the ``pickBestHost`` load signal
    #: (``Multicast.cpp:520``)
    rtt_s: np.ndarray = field(default=None)  # float [n_shards, n_replicas]

    def __post_init__(self):
        if self.alive is None:
            self.alive = np.ones((self.n_shards, self.n_replicas),
                                 dtype=bool)
        if self.rtt_s is None:
            self.rtt_s = np.zeros((self.n_shards, self.n_replicas),
                                  dtype=np.float64)

    def shard_of_docid(self, docid) -> np.ndarray:
        return posdb.shard_of_docid(docid, self.n_shards)

    def shard_of_keys(self, keys: np.ndarray) -> np.ndarray:
        return posdb.shard_of_keys(keys, self.n_shards)

    def shard_of_site(self, site: str) -> int:
        """Linkdb and tagdb routing by the linkee site's 32-bit hash, the
        one the linkdb key embeds (so ``linkdb.shard_of_keys`` agrees and
        a rebalance routes linkdb records from raw keys)."""
        from ..spider.linkdb import _h32
        from ..utils import ghash
        return int(ghash.hash64_array(
            np.asarray([_h32(site)], np.uint64))[0]
            % np.uint64(self.n_shards))

    def mark_dead(self, shard: int, replica: int = 0) -> None:
        """Dead-host marking (``PingServer.h:61``)."""
        self.alive[shard, replica] = False

    def mark_alive(self, shard: int, replica: int = 0) -> None:
        self.alive[shard, replica] = True

    def serving_replica(self, shard: int) -> int | None:
        """The first alive replica of a shard (``pickBestHost`` skips dead
        twins); None when the whole shard is down."""
        for r in range(self.n_replicas):
            if self.alive[shard, r]:
                return r
        return None

    def serving_vector(self) -> tuple:
        """The serving replica per shard (None where a whole shard is
        down): part of the mesh serving generation, so a death drains the
        resident loop and the next wave packs from the surviving twin."""
        return tuple(self.serving_replica(s)
                     for s in range(self.n_shards))

    def hosts_up(self) -> int:
        return int(self.alive.sum())

    def serving_ok(self) -> bool:
        """Every shard has an alive twin."""
        return all(self.serving_replica(s) is not None
                   for s in range(self.n_shards))

    def observe_rtt(self, shard: int, replica: int, dt_s: float) -> None:
        """Fold one completed read's latency into the twin's EWMA."""
        prev = self.rtt_s[shard, replica]
        self.rtt_s[shard, replica] = (dt_s if prev == 0.0
                                      else 0.8 * prev + 0.2 * dt_s)

    def penalize(self, shard: int, replica: int,
                 dt_s: float = 1.0) -> None:
        """Degrade a twin's load signal without a completed read."""
        self.rtt_s[shard, replica] += dt_s

    def decay_rtt(self, shard: int, replica: int,
                  factor: float = 0.9) -> None:
        """Shrink a twin's penalty toward zero (a health ping answered)."""
        self.rtt_s[shard, replica] *= factor

    def twin_order(self, shard: int) -> list[int]:
        """Replicas in read-preference order: alive first, then the
        fastest observed."""
        return sorted(range(self.n_replicas),
                      key=lambda r: (not self.alive[shard, r],
                                     float(self.rtt_s[shard, r])))

"""Collection — one searchable corpus: its Rdbs, its conf, its speller
dictionary and the device its queries score on; :class:`CollectionDb`,
the registry of a node's collections.

Reference: ``Collectiondb.cpp/h`` (``Collectiondb.h:39``). A
collection owns posdb (positional index, dataless 18-byte keys), titledb
(doc records), clusterdb (site/lang meta), linkdb (the link graph and
inlink anchor text), tagdb (per-site tags), sectiondb (boilerplate
votes), fielddb (numeric fields) and catdb (the directory taxonomy),
plus the doc counter ranking needs (``Posdb.cpp:1225`` numDocsInColl)
and the speller's word popularity.

Every Rdb journals its writes, and ``save()`` checkpoints each memtable
(no run is added), so a restart after a kill -9 or a stop reads back what
was acknowledged. The doc count is written to ``collstats.json`` at a
save or a dump, as in the reference. Departure: an open that replays a
journal (an unclean stop) recounts the documents from titledb's live
records, so the term-frequency weights, and with them the scores, are
the same after a kill -9 as before it; the reference reads the count of
the last save. The speller's dictionary, as in the reference, is
persisted only by a save or a dump.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from pathlib import Path

import torch

from ..device import resolve_device
from ..query.speller import Speller
from ..spider.linkdb import Linkdb
from ..utils.log import get_logger
from ..utils.parms import CollectionConf
from . import clusterdb, posdb, rdblite, titledb
from .catdb import Catdb
from .fielddb import Fielddb
from .sectiondb import Sectiondb
from .tagdb import Tagdb

log = get_logger("collection")


class TermlistCache:
    """(termid, rdb version) → RecordBatch, byte-bounded LRU. A version
    bump drops every entry, so a stale list can never serve."""

    def __init__(self, max_bytes: int = 256 << 20):
        self._d: OrderedDict = OrderedDict()
        self.max_bytes = max_bytes
        self.nbytes = 0
        self._version = -1

    def _roll(self, version: int) -> None:
        if version != self._version:
            self._d.clear()
            self.nbytes = 0
            self._version = version

    def get(self, termid: int, version: int):
        self._roll(version)
        hit = self._d.get(termid)
        if hit is not None:
            self._d.move_to_end(termid)
        return hit

    def put(self, termid: int, version: int, batch) -> None:
        self._roll(version)
        if termid in self._d:
            return
        self._d[termid] = batch
        self.nbytes += int(batch.keys.nbytes)
        while self.nbytes > self.max_bytes and self._d:
            _, old = self._d.popitem(last=False)
            self.nbytes -= int(old.keys.nbytes)


class Collection:
    """``device`` is where queries score: ``None`` means ``cuda``, and
    without CUDA that raises unless ``"cpu"`` is passed."""

    def __init__(self, name: str, base_dir: str | Path,
                 conf: CollectionConf | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.name = name
        self.dir = Path(base_dir) / "coll" / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.conf = conf or CollectionConf(name)
        # per-collection config persists beside the Rdbs (coll.conf)
        self._conf_path = self.dir / "coll.conf"
        if conf is None and self._conf_path.exists():
            try:
                self.conf.load(self._conf_path)
            except (OSError, ValueError) as exc:  # defaults win
                log.warning("%s: coll.conf unreadable (%s); using "
                            "defaults", name, exc)
        self.posdb = rdblite.Rdb("posdb", self.dir, posdb.KEY_DTYPE)
        self.titledb = rdblite.Rdb("titledb", self.dir, titledb.KEY_DTYPE,
                                   has_data=True)
        self.clusterdb = rdblite.Rdb("clusterdb", self.dir,
                                     clusterdb.KEY_DTYPE)
        self.linkdb = Linkdb(self.dir)
        self.tagdb = Tagdb(self.dir)
        self.sectiondb = Sectiondb(self.dir)
        self.fielddb = Fielddb(self.dir)
        self.catdb = Catdb(self.dir)
        self.speller = Speller(self.dir)
        self._stats_path = self.dir / "collstats.json"
        self.num_docs = 0
        if any(db.replayed for db in self.rdbs().values()):
            # an unclean stop: collstats.json holds the count of the last
            # save or dump, which misses the pages written since; each
            # live titlerec is one document
            self.num_docs = self.titledb.count_live()
        elif self._stats_path.exists():
            self.num_docs = json.loads(
                self._stats_path.read_text())["num_docs"]
        #: parsed-titlerec cache keyed by docid (``RdbCache.h:50``)
        self.titlerec_cache: dict[int, dict | None] = {}
        self.titlerec_cache_max = 16384
        self.termlist_cache = TermlistCache()

    def rdbs(self) -> dict[str, rdblite.Rdb]:
        """Every named Rdb this collection owns (the per-collection
        RdbBase set): ``dump_all`` and ``save`` persist each of them."""
        return {"posdb": self.posdb, "titledb": self.titledb,
                "clusterdb": self.clusterdb, "linkdb": self.linkdb.rdb,
                "tagdb": self.tagdb.rdb,
                "sectiondb": self.sectiondb.rdb,
                "fielddb": self.fielddb.rdb,
                "catdb": self.catdb.rdb}

    def _save_stats(self) -> None:
        tmp = self._stats_path.with_name(self._stats_path.name + ".tmp")
        tmp.write_text(json.dumps({"num_docs": self.num_docs}))
        os.replace(tmp, self._stats_path)

    def doc_added(self, n: int = 1) -> None:
        self.num_docs += n

    def doc_removed(self, n: int = 1) -> None:
        self.num_docs = max(0, self.num_docs - n)

    def dump_all(self) -> None:
        """Dump every memtable to a run and persist the doc count and the
        speller's dictionary (the bulk-load and device-build paths)."""
        for db in self.rdbs().values():
            db.dump()
        self.speller.save()
        self._save_stats()

    def save(self) -> None:
        """Checkpoint every Rdb's memtable (no run is added), then the
        speller, the conf and the doc count (``Process::saveRdbTrees``)."""
        for db in self.rdbs().values():
            db.save()
        self.speller.save()
        self.conf.save(self._conf_path)
        self._save_stats()

    def close(self) -> None:
        """Release the process-wide accounting of a collection being
        deleted or unloaded (the delColl half of ``Collectiondb.cpp``):
        zero every Rdb's memtable gauge, so the budget does not bill a
        purged corpus, and drop the host caches. The disk is left as it
        is."""
        from ..utils.membudget import g_membudget
        for db in self.rdbs().values():
            g_membudget.set_gauge("memtable", str(db.dir), 0)
        self.titlerec_cache.clear()
        self.termlist_cache = TermlistCache()


class CollectionDb:
    """Registry of a node's collections (reference ``g_collectiondb``),
    each under ``base_dir/coll/<name>`` and scoring on ``device`` (see
    :class:`Collection`)."""

    def __init__(self, base_dir: str | Path,
                 device: str | torch.device | None = None):
        self.base_dir = Path(base_dir)
        self.device = resolve_device(device)
        self.colls: dict[str, Collection] = {}
        self._lock = threading.Lock()  # lazy open is check-then-create

    def get(self, name: str = "main", create: bool = True) -> Collection:
        """The open collection ``name``, opened (or created) on first
        use. With ``create=False`` an unknown name raises KeyError and
        nothing is written to disk."""
        with self._lock:
            if name not in self.colls:
                if not create and not (self.base_dir / "coll"
                                       / name).exists():
                    raise KeyError(f"no such collection: {name}")
                self.colls[name] = Collection(name, self.base_dir,
                                              device=self.device)
            return self.colls[name]

    def drop(self, name: str) -> Collection | None:
        """Unregister and ``close()`` a collection (its directory is left
        as it is, and the serve layer's residency is the caller's)."""
        with self._lock:
            coll = self.colls.pop(name, None)
        if coll is not None:
            coll.close()
        return coll

    def names(self) -> list[str]:
        disk = {p.name for p in (self.base_dir / "coll").glob("*")
                if p.is_dir()}
        return sorted(disk | set(self.colls))

    def save(self) -> None:
        """``save_all``, so a CollectionDb registers as a Process
        savable."""
        self.save_all()

    def save_all(self) -> None:
        with self._lock:
            colls = list(self.colls.values())
        for c in colls:
            c.save()

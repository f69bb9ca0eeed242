"""Rebalance and Repair: topology growth and index rebuilds.

Port of ``open_source_search_engine_tpu/control/rebalance.py``:

* ``rebalance`` (reference ``Rebalance.h:13``, ``gb scale``,
  ``main.cpp:2356``): after the shard count changes, every record whose
  owning shard moved is sent to its new owner. Each source shard's Rdbs
  are scanned once and their raw records routed by the build plane's
  key → shard maps (posdb by docid, its checksum terms by termid;
  titledb and clusterdb by docid; linkdb by the linkee sitehash in the
  key) into a fresh grid, with the doc counts and the speller's words.
  As in the reference, fielddb, tagdb, catdb and sectiondb are not
  routed.
* ``repair`` (reference ``Repair.h:20-44``, ``g_repairMode``): titlerecs
  store each page's original content, so posdb, clusterdb and linkdb
  (and the speller dictionary) are rebuilt by reindexing every titlerec
  through the normal document pipeline, the recovery path for a corrupt
  or wiped index without a recrawl.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ..build import docproc
from ..index import posdb, titledb
from ..index.collection import Collection
from ..query import engine
from ..spider import linkdb as linkdb_mod
from ..utils.log import get_logger

log = get_logger("rebalance")

_WORD_RE = re.compile(r"\w+", re.UNICODE)


def _route_batch(batch, shard_of, n_shards: int, add_fns) -> int:
    """Scatter one Rdb's merged records to their new owners."""
    if not len(batch):
        return 0
    shards = shard_of(batch.keys, n_shards)
    for s in range(n_shards):
        m = shards == s
        if not m.any():
            continue
        idx = np.nonzero(m)[0]
        keys = batch.keys[idx]
        blobs = [batch.payload(int(i)) for i in idx] if batch.has_data \
            else None
        for add in add_fns(s):
            add(keys, blobs)
    return len(batch)


def _shard_of_docid_key(keys, n):
    return posdb.shard_of_docid(titledb.unpack_key(keys)["docid"], n)


def rebalance(name: str, src_dir, dst_dir: str | Path,
              old_n_shards: int, new_n_shards: int,
              n_replicas: int = 1, device=None):
    """Re-shard a collection grid: ``src_dir`` (``old_n_shards`` shards,
    a path or a live ShardedCollection) → ``dst_dir`` (``new_n_shards``
    shards × ``n_replicas``). Returns the new ShardedCollection, saved;
    ``device`` is where it scores (see :class:`ShardedCollection`)."""
    from ..parallel.sharded import ShardedCollection

    src = (src_dir if isinstance(src_dir, ShardedCollection)
           else ShardedCollection(name, src_dir, n_shards=old_n_shards,
                                  device=device))
    dst = ShardedCollection(name, dst_dir, n_shards=new_n_shards,
                            n_replicas=n_replicas,
                            device=src.device if device is None
                            else device)
    moved = 0
    for old_shard in src.grid:
        c = old_shard[0]  # replica 0 holds the whole shard
        moved += _route_batch(
            c.posdb.get_all(), posdb.shard_of_keys, new_n_shards,
            lambda s: [r.posdb.add for r in dst.replicas_of(s)])
        tb = c.titledb.get_all()
        moved += _route_batch(
            tb, _shard_of_docid_key, new_n_shards,
            lambda s: [r.titledb.add for r in dst.replicas_of(s)])
        moved += _route_batch(
            c.clusterdb.get_all(), _shard_of_docid_key, new_n_shards,
            lambda s: [r.clusterdb.add for r in dst.replicas_of(s)])
        moved += _route_batch(
            c.linkdb.rdb.get_all(), linkdb_mod.shard_of_keys,
            new_n_shards,
            lambda s: [r.linkdb.rdb.add for r in dst.replicas_of(s)])
        # the doc counts and the speller's words follow the titledb
        # records ("did you mean" survives the re-shard)
        docs = titledb.unpack_key(tb.keys)["docid"] if len(tb) else \
            np.empty(0, np.uint64)
        owners = posdb.shard_of_docid(docs, new_n_shards)
        for s in range(new_n_shards):
            m = owners == s
            n = int(m.sum())
            for r in dst.replicas_of(s):
                r.num_docs += n
            if n:
                for i in np.nonzero(m)[0]:
                    rec = titledb.read_title_rec(tb.payload(int(i)))
                    ws = _WORD_RE.findall(
                        (rec.get("title", "") + " "
                         + rec.get("text", "")).lower())
                    for r in dst.replicas_of(s):
                        r.speller.add_doc_words(ws)
    for row in dst.grid:
        for c in row:
            c.save()
    log.info("rebalance %s: %d→%d shards, %d records routed",
             name, old_n_shards, new_n_shards, moved)
    return dst


def repair(coll: Collection) -> int:
    """Rebuild posdb, clusterdb and linkdb of ``coll`` from titledb and
    save it; returns the number of documents reindexed.

    The collection's resident loop and DeviceIndex go first, so no wave
    reads columns of the wiped runs. Two passes, both with anchor
    propagation off: the first refills linkdb's edges, the second
    reindexes with the whole link graph present, so inlink anchor text
    and siteranks equal a build from scratch, without the per-document
    refresh cascade."""
    tb = coll.titledb.get_all()
    engine.drop_device_index(coll)
    coll.posdb.wipe()
    coll.clusterdb.wipe()
    coll.linkdb.rdb.wipe()
    coll.titlerec_cache.clear()

    def _reindex_pass() -> int:
        n = 0
        for i in range(len(tb)):
            blob = tb.payload(i)
            if not blob:
                continue
            rec = titledb.read_title_rec(blob)
            docproc.index_document(
                coll, rec["url"], rec.get("content", rec.get("text", "")),
                is_html=rec.get("is_html", True),
                siterank=rec.get("siterank", 0),
                langid=rec.get("langid"), propagate=False)
            n += 1
        return n

    _reindex_pass()
    n = _reindex_pass()
    coll.save()
    log.info("repair %s: %d docs reindexed from titledb", coll.name, n)
    return n

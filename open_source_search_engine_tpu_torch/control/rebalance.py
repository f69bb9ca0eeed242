"""Repair — rebuild a collection's derived Rdbs from titledb.

Port of ``open_source_search_engine_tpu/control/rebalance.py:122-163``
(reference ``Repair.h:20-44``, ``g_repairMode``): titlerecs store each
page's original content, so posdb, clusterdb and linkdb (and the speller
dictionary) are rebuilt by reindexing every titlerec through the normal
document pipeline, the recovery path for a corrupt or wiped index
without a recrawl. ``rebalance`` (re-sharding a grid) comes with the
multi-process cluster.
"""

from __future__ import annotations

from ..build import docproc
from ..index import titledb
from ..index.collection import Collection
from ..query import engine
from ..utils.log import get_logger

log = get_logger("rebalance")


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

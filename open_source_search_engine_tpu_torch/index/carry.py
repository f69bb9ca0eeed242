"""Carry an index over: a port Collection built from the record arrays
another store holds (for example the reference package's
``rdb.get_all()``), so one index can be scored by both packages."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import clusterdb, posdb, rdblite, sectiondb, titledb
from .collection import Collection


def collection_from_arrays(name: str, base_dir: str | Path,
                           posdb_keys: np.ndarray,
                           titledb_keys: np.ndarray,
                           titledb_blobs: list[bytes],
                           clusterdb_keys: np.ndarray,
                           sectiondb_keys: np.ndarray,
                           num_docs: int,
                           device: str | torch.device | None = None,
                           posdb_mem_keys: np.ndarray | None = None
                           ) -> Collection:
    """A new Collection under ``base_dir`` holding exactly these records,
    one run per database. Key arrays are structured arrays in each
    database's key layout (the byte images are the same in both
    packages), tombstone-free, as ``get_all()`` gives them; unsorted
    input is sorted first.

    ``posdb_mem_keys`` (tombstones allowed, as the other store's
    ``posdb.mem.batch().keys`` gives them) go into the posdb memtable
    after the runs, so a device index built over the carried collection
    sees the same base and delta as one built over the original."""
    coll = Collection(name, base_dir, device=device)
    for rdb, keys, dtype, blobs in (
            (coll.posdb, posdb_keys, posdb.KEY_DTYPE, None),
            (coll.titledb, titledb_keys, titledb.KEY_DTYPE, titledb_blobs),
            (coll.clusterdb, clusterdb_keys, clusterdb.KEY_DTYPE, None),
            (coll.sectiondb.rdb, sectiondb_keys, sectiondb.KEY_DTYPE,
             None)):
        keys = np.ascontiguousarray(keys).view(dtype)
        if not len(keys):
            continue
        if not rdblite.delbits(keys).all():
            raise ValueError(f"{rdb.name}: tombstones in a carried index")
        blobs = list(blobs) if blobs is not None else None
        batch = rdblite.RecordBatch.from_records(
            keys, blobs, presorted=rdblite.keys_sorted(keys))
        rdb.add_run(batch)
    coll.num_docs = int(num_docs)
    coll.dump_all()
    if posdb_mem_keys is not None and len(posdb_mem_keys):
        coll.posdb.add(np.ascontiguousarray(posdb_mem_keys).view(
            posdb.KEY_DTYPE))
    return coll

"""Fielddb — per-document numeric field values (the datedb role,
generalized).

Reference: ``Datedb.h:60`` (an indexdb clone whose score byte carries a
date) and the numeric range and sort operators over structured documents
(``gbmin:``/``gbmax:``/``gbsortby:`` fielded terms, ``Query.h:209``).
On the device a field is one dense ``[D]`` column aligned to the
resident doc axis, read by the waves as a filter mask or a sort key.

Storage is one Rdb: key = fieldhash32 · docid38 · delbit (newest wins,
tombstones annihilate), payload = float64 little-endian. ``date`` is a
built-in field (the document timestamp, seconds since the epoch).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..utils import ghash
from . import rdblite

#: key: fieldhash(32) | docid(38) | delbit(1) packed into 12 bytes
KEY_DTYPE = np.dtype([("lo", "<u8"), ("hi", "<u4")], align=False)

#: the built-in document-timestamp field (the datedb role)
DATE_FIELD = "date"


def field_hash(field: str) -> int:
    return ghash.hash64(field.lower()) & 0xFFFFFFFF


def pack_key(field: str, docid: int, delbit: int = 1) -> np.ndarray:
    fh = field_hash(field)
    lo = (np.uint64(docid & ((1 << 38) - 1)) << np.uint64(1)) \
        | np.uint64(delbit & 1)
    lo |= np.uint64(fh & 0x1FFFFFF) << np.uint64(39)
    out = np.zeros(1, KEY_DTYPE)
    out["lo"] = lo
    out["hi"] = np.uint32(fh >> 25)
    return out


def unpack_keys(keys: np.ndarray) -> dict[str, np.ndarray]:
    lo = keys["lo"].astype(np.uint64)
    hi = keys["hi"].astype(np.uint64)
    return {
        "delbit": (lo & np.uint64(1)).astype(np.uint8),
        "docid": (lo >> np.uint64(1)) & np.uint64((1 << 38) - 1),
        "fieldhash": ((lo >> np.uint64(39)) & np.uint64(0x1FFFFFF))
        | (hi << np.uint64(25)),
    }


def _range_of(field: str) -> tuple[np.ndarray, np.ndarray]:
    """(start, end) keys spanning every docid of one field."""
    fh = field_hash(field)
    start = np.zeros(1, KEY_DTYPE)
    end = np.zeros(1, KEY_DTYPE)
    start["lo"] = np.uint64(fh & 0x1FFFFFF) << np.uint64(39)
    start["hi"] = np.uint32(fh >> 25)
    end["lo"] = (np.uint64(fh & 0x1FFFFFF) << np.uint64(39)) \
        | np.uint64((1 << 39) - 1)
    end["hi"] = np.uint32(fh >> 25)
    return start[0], end[0]


class Fielddb:
    """Per-collection numeric field store over one Rdb."""

    def __init__(self, directory: str | Path):
        self.rdb = rdblite.Rdb("fielddb", directory, KEY_DTYPE,
                               has_data=True)
        #: (field, rdb version) → column: a merged read of a large run
        #: beside a non-empty memtable costs ~0.35 s at 100,000 records,
        #: and a sorted query reads its column twice; any write moves
        #: the version, so a stale column never serves
        self._cols: dict[tuple[str, int], tuple] = {}

    @property
    def empty(self) -> bool:
        return len(self.rdb.mem) == 0 and not self.rdb.runs

    def add(self, keys: np.ndarray, blobs) -> None:
        self.rdb.add(keys, blobs)

    def column(self, field: str) -> tuple[np.ndarray, np.ndarray]:
        """(docids sorted u64, values f64) for one field: the merged,
        tombstone-annihilated view, read-only and cached per version."""
        ck = (field, self.rdb.version)
        hit = self._cols.get(ck)
        if hit is None:
            hit = self._read_column(field)
            for a in hit:
                a.setflags(write=False)
            if len(self._cols) > 16:
                self._cols.clear()
            self._cols[ck] = hit
        return hit

    def _read_column(self, field: str) -> tuple[np.ndarray, np.ndarray]:
        batch = self.rdb.get_list(*_range_of(field))
        if not len(batch):
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        # every payload is one little-endian float64 (an empty one reads
        # 0.0): one gather decodes the column
        start, lens = batch.offsets[:-1], np.diff(batch.offsets)
        if not np.isin(lens, (0, 8)).all():
            raise ValueError(f"fielddb {field!r}: a payload is not 8 bytes")
        vals = np.zeros(len(batch), np.float64)
        full = lens == 8
        vals[full] = batch.data[start[full][:, None] + np.arange(8)].copy(
        ).view("<f8").reshape(-1)
        return unpack_keys(batch.keys)["docid"], vals

    def save(self) -> None:
        """Checkpoint the memtable (no run is added)."""
        self.rdb.save()


def make_records(docid: int, fields: dict[str, float], delbit: int = 1):
    """(keys, blobs) for one document's numeric fields."""
    items = [(f, v) for f, v in sorted(fields.items())
             if isinstance(v, (int, float)) and not isinstance(v, bool)]
    if not items:
        return np.empty(0, KEY_DTYPE), []
    keys = np.concatenate([pack_key(f, docid, delbit) for f, _ in items])
    blobs = [b"" if not delbit else struct.pack("<d", float(v))
             for _, v in items]
    return keys, blobs

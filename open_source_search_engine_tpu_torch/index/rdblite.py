"""Rdb-lite — the host-side LSM record store, one engine for every database.

Reference: the Rdb engine (``Rdb::addList`` ``Rdb.cpp:2006``,
``Rdb::dumpTree`` ``Rdb.cpp:1172``, ``RdbBuckets`` memtable,
``RdbBase::attemptMerge`` ``RdbBase.cpp:1400``, ``RdbList`` with +/-
tombstone annihilation, ``Msg5`` read = merge memtable + runs, Msg4's
``addsinprogress`` journal ``Msg4.cpp:86,115``).

Records are columnar numpy arrays: a sorted run is a structured key array
(+ optional payload blob with offsets), so a termlist range read is a
``searchsorted`` slice. Keys are little-endian structured dtypes whose
*reversed* field order is the comparison order; bit 0 of the least
significant field is the delbit (1 = positive, 0 = tombstone).

A copy of ``open_source_search_engine_tpu/index/rdblite.py`` with the same
on-disk format, so either package opens a directory the other wrote:

* runs are ``run_<id>[_m<id>]`` directories of ``.npy`` files with a
  ``meta.json`` carrying whole-file CRCs, verified when the Rdb opens
  (a corrupt run is quarantined to ``*.corrupt``) and by :meth:`Rdb.scrub`;
* every add and delete is journaled to ``addsinprogress.bin`` before it
  applies and replayed on open, so a kill -9 loses no acknowledged write;
* :meth:`Rdb.save` checkpoints the memtable to ``saved/`` (published
  through ``saved.new``) without adding a run;
* :meth:`Rdb.attempt_merge` keeps the run count bounded.

Key searches and the merge of dataless runs ride the native core
(``native/rdbcore.cpp``) when it is built; the numpy code beside them
computes the same function and takes over without it.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import native
from ..utils.chaos import g_chaos
from ..utils.lockcheck import make_rlock
from ..utils.log import get_logger
from ..utils.membudget import g_membudget
from ..utils.stats import g_stats

log = get_logger("rdb")

#: keys per page of a run's sparse page index (``meta.json``'s
#: ``page_first_keys``, the ``RdbMap`` role)
PAGE_KEYS = 4096

#: an early dump under process-wide memory pressure needs at least this
#: much buffered, so pressure cannot shred the memtable into tiny runs
_EARLY_DUMP_FLOOR = 1 << 20

#: the journal's batch header: record count, CRC32 of the body, body bytes
_JOURNAL_HDR = struct.Struct("<IIQ")


def _locked(fn):
    """Serialize a mutating Rdb method on the instance's re-entrant write
    lock: the indexing path, the autosave clock and the daily merge write
    from different threads, and add → dump → attempt_merge nest."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._wlock:
            return fn(self, *args, **kwargs)
    return wrapper


class CorruptRunError(Exception):
    """A run failed its integrity checks (the Msg5 'Rdb Error
    Correction' symptom: out-of-order keys, a bad map, a CRC mismatch)."""


def _crc_chunks(arr: np.ndarray, chunk_rows: int = 1 << 22) -> int:
    """CRC32 of an array's bytes, streamed in row chunks so an mmap'd run
    is never materialized whole."""
    crc = 0
    for i in range(0, len(arr), chunk_rows):
        crc = zlib.crc32(
            np.ascontiguousarray(arr[i:i + chunk_rows]).tobytes(), crc)
    return crc


def key_sort_order(keys: np.ndarray) -> np.ndarray:
    """argsort in key-compare order: reversed declared fields, stable."""
    return np.lexsort(tuple(keys[f] for f in keys.dtype.names))


def searchsorted_keys(sorted_keys: np.ndarray, probe: np.ndarray,
                      side: str = "left") -> np.ndarray:
    """Searchsorted over structured keys: a binary search comparing
    (most significant, …, least significant) field tuples, every probe
    on one ``side``: :func:`searchsorted_keys_many`."""
    probe = np.atleast_1d(probe)
    return searchsorted_keys_many(sorted_keys, probe,
                                  np.full(len(probe), side == "right"))


def searchsorted_keys_many(sorted_keys: np.ndarray, probes: np.ndarray,
                           right: np.ndarray) -> np.ndarray:
    """Searchsorted of many probes at once over structured keys,
    ``right[i]`` choosing probe i's side: in one native call, or one
    numpy binary search that moves every probe a step per round. A round
    reads one record a probe in place, O(probes · log n) records in all:
    a run may be a multi-GB mmap, and ``np.searchsorted`` on a strided
    field view copies the whole column per call."""
    if native.available():
        return native.searchsorted_many(sorted_keys, probes, right)
    sorted_keys = np.asarray(sorted_keys)
    n = len(sorted_keys)
    lo = np.zeros(len(probes), np.int64)
    hi = np.full(len(probes), n, np.int64)
    fields = tuple(reversed(sorted_keys.dtype.names))
    want = [probes[f] for f in fields]
    while True:
        live = lo < hi
        if not live.any():
            return lo
        mid = (lo + hi) >> 1
        rec = sorted_keys[np.minimum(mid, n - 1)]
        less = np.zeros(len(probes), bool)
        same = np.ones(len(probes), bool)
        for f, w in zip(fields, want):
            less |= same & (rec[f] < w)
            same &= rec[f] == w
        up = live & (less | (same & right))
        lo = np.where(up, mid + 1, lo)
        hi = np.where(live & ~up, mid, hi)


def keys_sorted(keys: np.ndarray) -> bool:
    """Vectorized adjacent-pair check of key-compare order."""
    if len(keys) < 2:
        return True
    violated = np.zeros(len(keys) - 1, bool)
    decided = np.zeros(len(keys) - 1, bool)
    for f in reversed(keys.dtype.names):  # most significant first
        a, b = keys[f][:-1], keys[f][1:]
        violated |= (~decided) & (a > b)
        decided |= a != b
    return not violated.any()


def strip_delbit(keys: np.ndarray) -> np.ndarray:
    """Copy of keys with the delbit cleared — the 'same record' identity
    used by annihilation."""
    out = keys.copy()
    f0 = keys.dtype.names[0]
    out[f0] = out[f0] & ~np.array(1, dtype=keys.dtype[f0])
    return out


def delbits(keys: np.ndarray) -> np.ndarray:
    f0 = keys.dtype.names[0]
    return (keys[f0] & np.array(1, dtype=keys.dtype[f0])).astype(bool)


@dataclass
class RecordBatch:
    """A sorted run of records: keys + optional var-length payloads
    (``data[offsets[i]:offsets[i+1]]`` is record i's blob; both None for
    dataless dbs like posdb)."""

    keys: np.ndarray
    offsets: np.ndarray | None = None  # int64 [n+1]
    data: np.ndarray | None = None     # uint8 blob

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def has_data(self) -> bool:
        return self.offsets is not None

    def payload(self, i: int) -> bytes:
        assert self.offsets is not None and self.data is not None
        return bytes(self.data[self.offsets[i]:self.offsets[i + 1]])

    def payloads(self) -> list[bytes]:
        return [self.payload(i) for i in range(len(self))]

    @staticmethod
    def from_records(keys: np.ndarray, blobs: list[bytes] | None = None,
                     presorted: bool = False) -> "RecordBatch":
        if blobs is not None:
            assert len(blobs) == len(keys)
        if not presorted:
            order = key_sort_order(keys)
            keys = keys[order]
            if blobs is not None:
                blobs = [blobs[i] for i in order]
        if blobs is None:
            return RecordBatch(keys)
        offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        data = np.frombuffer(b"".join(blobs), dtype=np.uint8)
        return RecordBatch(keys, offsets, data)

    def slice(self, lo: int, hi: int) -> "RecordBatch":
        if not self.has_data:
            return RecordBatch(self.keys[lo:hi])
        offs = self.offsets[lo:hi + 1]
        return RecordBatch(self.keys[lo:hi],
                           (offs - offs[0]).astype(np.int64),
                           self.data[offs[0]:offs[-1]])

    def range(self, start_key: np.ndarray, end_key: np.ndarray
              ) -> "RecordBatch":
        """Records with start_key <= key <= end_key: :meth:`ranges` of
        one."""
        return self.ranges(start_key.reshape(1), end_key.reshape(1))

    def ranges(self, start_keys: np.ndarray, end_keys: np.ndarray
               ) -> "RecordBatch":
        """The records of every range ``start_keys[i] <= key <=
        end_keys[i]`` (ranges in key order and disjoint), concatenated
        in key order, with one search for all of them."""
        m = len(start_keys)
        pos = searchsorted_keys_many(
            self.keys, np.concatenate([start_keys, end_keys]),
            np.arange(2 * m) >= m)
        lo, hi = pos[:m], np.maximum(pos[m:], pos[:m])
        cnt = hi - lo
        idx = (np.arange(int(cnt.sum()))
               + np.repeat(lo - (np.cumsum(cnt) - cnt), cnt))
        keys = np.asarray(self.keys)[idx]
        if not self.has_data:
            return RecordBatch(keys)
        offsets = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(self.offsets[idx + 1] - self.offsets[idx],
                  out=offsets[1:])
        # a range's records lie together: one slice of the data a range
        blob = np.asarray(self.data)  # a run's mmap, sliced as a plain view
        data = np.concatenate(
            [blob[0:0]] + [blob[i:j] for i, j in
                           zip(self.offsets[lo].tolist(),
                               self.offsets[hi].tolist())])
        return RecordBatch(keys, offsets, data)


def _dedup_newest(all_keys: np.ndarray, recency: np.ndarray,
                  keep_tombstones: bool) -> np.ndarray:
    """Indices of surviving records, in key order: per key-sans-delbit
    group the highest-recency record wins; surviving tombstones are
    optionally dropped."""
    ident = strip_delbit(all_keys)
    order = np.lexsort((-recency,)
                       + tuple(ident[f] for f in ident.dtype.names))
    ident_sorted = ident[order]
    first_of_group = np.ones(len(order), dtype=bool)
    if len(order) > 1:
        same_as_prev = np.ones(len(order) - 1, dtype=bool)
        for f in ident.dtype.names:
            same_as_prev &= ident_sorted[f][1:] == ident_sorted[f][:-1]
        first_of_group[1:] = ~same_as_prev
    keep = order[first_of_group]
    if not keep_tombstones:
        keep = keep[delbits(all_keys[keep])]
    return keep


def merge_batches(batches: list[RecordBatch],
                  keep_tombstones: bool = False) -> RecordBatch:
    """N-way merge, sources oldest → newest, with newest-wins dedup and
    +/- annihilation (``RdbList.cpp`` ``merge_r``): a surviving tombstone
    drops the record, and is itself dropped unless ``keep_tombstones``
    (the memtable keeps it so it can still annihilate records in runs)."""
    nonempty = [b for b in batches if len(b)]
    if not nonempty:
        if batches:  # keep the caller's key dtype and data-ness
            return batches[0]
        return RecordBatch(np.empty(0, dtype=np.dtype([("n0", "<u2")])))
    if len(nonempty) == 1 and bool(delbits(nonempty[0].keys).all()):
        return nonempty[0]  # sorted single all-positive source: done
    batches = nonempty
    if not batches[0].has_data and native.available():
        return RecordBatch(native.merge_runs([b.keys for b in batches],
                                             keep_tombstones))
    all_keys = np.concatenate([b.keys for b in batches])
    recency = np.concatenate(
        [np.full(len(b), i, dtype=np.int64) for i, b in enumerate(batches)])
    keep = _dedup_newest(all_keys, recency, keep_tombstones)
    kept_keys = all_keys[keep]
    if not batches[0].has_data:
        return RecordBatch(kept_keys)
    starts = np.cumsum([0] + [len(b) for b in batches])
    src = np.searchsorted(starts, keep, side="right") - 1
    blobs = [batches[s].payload(int(j - starts[s]))
             for s, j in zip(src, keep)]
    return RecordBatch.from_records(kept_keys, blobs, presorted=True)


class Run:
    """One immutable sorted run on disk: ``keys.npy`` (+ ``offsets.npy``
    and ``data.npy`` for payload dbs), loaded with ``mmap_mode='r'``, and
    ``meta.json`` (record count, key dtype, the sparse page index and the
    whole-file CRCs). Opening verifies it unless ``verify=False``."""

    def __init__(self, path: Path, verify: bool = True):
        self.path = Path(path)
        try:
            self.meta = json.loads((self.path / "meta.json").read_text())
            self.keys = np.load(self.path / "keys.npy", mmap_mode="r")
            self.offsets = self.data = None
            if (self.path / "offsets.npy").exists():
                self.offsets = np.load(self.path / "offsets.npy",
                                       mmap_mode="r")
                self.data = np.load(self.path / "data.npy", mmap_mode="r")
        except (OSError, ValueError) as e:  # torn write, missing file
            raise CorruptRunError(f"{path}: unreadable ({e})") from e
        if verify:
            self.verify()

    def verify(self) -> None:
        """Record count, key order, offset monotonicity and, where the
        run was written with them, the CRCs of its keys and payloads
        (streamed in chunks). Raises :class:`CorruptRunError`."""
        if self.meta.get("nrecs") != len(self.keys):
            raise CorruptRunError(
                f"{self.path}: nrecs {self.meta.get('nrecs')} != "
                f"{len(self.keys)}")
        if not keys_sorted(self.keys):
            raise CorruptRunError(f"{self.path}: keys out of order")
        if self.offsets is not None:
            offs = np.asarray(self.offsets)
            if len(offs) != len(self.keys) + 1 or offs[0] != 0 \
                    or (np.diff(offs) < 0).any() \
                    or offs[-1] > len(self.data):
                raise CorruptRunError(f"{self.path}: bad offsets")
        crc = self.meta.get("keys_crc")
        if crc is not None and _crc_chunks(self.keys) != crc:
            raise CorruptRunError(f"{self.path}: keys CRC mismatch")
        dcrc = self.meta.get("data_crc")
        if dcrc is not None and self.data is not None \
                and _crc_chunks(self.data) != dcrc:
            raise CorruptRunError(f"{self.path}: data CRC mismatch")

    def __len__(self) -> int:
        return len(self.keys)

    def batch(self) -> RecordBatch:
        return RecordBatch(self.keys, self.offsets, self.data)

    @staticmethod
    def write(path: Path, batch: RecordBatch) -> "Run":
        """RdbDump: persist a sorted batch as an immutable run (written
        to a temporary name, then renamed into place). ``meta.json`` is
        byte for byte the reference's."""
        path = Path(path)
        tmp = path.with_name(path.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        keys_c = np.ascontiguousarray(batch.keys)
        np.save(tmp / "keys.npy", keys_c)
        data_crc = None
        if batch.has_data:
            np.save(tmp / "offsets.npy", batch.offsets)
            np.save(tmp / "data.npy", batch.data)
            data_crc = _crc_chunks(batch.data)
        names = batch.keys.dtype.names
        (tmp / "meta.json").write_text(json.dumps({
            "nrecs": len(batch),
            "dtype": [[n, str(batch.keys.dtype[n])] for n in names],
            "has_data": batch.has_data,
            "page_keys": PAGE_KEYS,
            "page_first_keys": [[int(batch.keys[i][f]) for f in names]
                                for i in range(0, len(batch), PAGE_KEYS)],
            "keys_crc": _crc_chunks(keys_c),
            "data_crc": data_crc,
        }))
        tmp.rename(path)
        return Run(path, verify=False)  # just written from RAM


class MemTable:
    """Append-mostly in-RAM buffer of records (``RdbBuckets.h:87``):
    O(1) appends into a pending list, sorted lazily into size-tiered
    segments (each ≥ twice the next newer one) when a read needs order."""

    def __init__(self, key_dtype: np.dtype, has_data: bool):
        self.key_dtype = key_dtype
        self.has_data = has_data
        self._pending_keys: list[np.ndarray] = []
        self._pending_blobs: list[bytes] = []
        self._segments: list[RecordBatch] = []  # oldest → newest
        self.nbytes = 0

    def __len__(self) -> int:
        return (sum(len(k) for k in self._pending_keys)
                + sum(len(s) for s in self._segments))

    def add(self, keys: np.ndarray, blobs: list[bytes] | None = None) -> None:
        keys = np.atleast_1d(keys).astype(self.key_dtype, copy=False)
        if self.has_data:
            assert blobs is not None and len(blobs) == len(keys)
            self._pending_blobs.extend(blobs)
            self.nbytes += sum(len(b) for b in blobs)
        self._pending_keys.append(keys)
        self.nbytes += keys.nbytes

    def _seal(self) -> None:
        if self._pending_keys:
            keys = np.concatenate(self._pending_keys)
            blobs = self._pending_blobs if self.has_data else None
            # newest-wins within the pending stream itself
            keep = _dedup_newest(keys, np.arange(len(keys), dtype=np.int64),
                                 keep_tombstones=True)
            self._segments.append(RecordBatch.from_records(
                keys[keep],
                [blobs[int(i)] for i in keep] if blobs is not None else None,
                presorted=True))
            self._pending_keys = []
            self._pending_blobs = []
        while (len(self._segments) >= 2
               and len(self._segments[-2]) < 2 * len(self._segments[-1])):
            newer = self._segments.pop()
            older = self._segments.pop()
            self._segments.append(merge_batches([older, newer],
                                                keep_tombstones=True))

    def _empty(self) -> RecordBatch:
        return RecordBatch.from_records(np.empty(0, dtype=self.key_dtype),
                                        [] if self.has_data else None)

    def range(self, start_key: np.ndarray, end_key: np.ndarray
              ) -> RecordBatch:
        """:meth:`ranges` of one."""
        return self.ranges(start_key.reshape(1), end_key.reshape(1))

    def ranges(self, start_keys: np.ndarray, end_keys: np.ndarray
               ) -> RecordBatch:
        """Merged read of many disjoint ranges in key order over the
        segments (newest-wins applied)."""
        self._seal()
        return merge_batches(
            [self._empty()]
            + [s.ranges(start_keys, end_keys) for s in self._segments],
            keep_tombstones=True)

    def batch(self) -> RecordBatch:
        """Sorted view of everything in RAM."""
        self._seal()
        if len(self._segments) > 1:
            self._segments = [merge_batches(self._segments,
                                            keep_tombstones=True)]
        return self._segments[0] if self._segments else self._empty()

    def clear(self) -> None:
        self._pending_keys = []
        self._pending_blobs = []
        self._segments = []
        self.nbytes = 0


class Rdb:
    """One named database for one collection: memtable + immutable runs.
    ``add`` (``Rdb::addList``), ``dump`` (``Rdb::dumpTree``),
    ``attempt_merge`` (``RdbBase::attemptMerge``), ``get_list``
    (``Msg5::getList`` — merged memtable+runs range read), ``save`` /
    ``load_saved`` (the RdbTree ``-saved.dat`` checkpoint).

    ``journal=False`` (spiderdb, which keeps its own journal) or
    ``OSSE_NO_JOURNAL=1`` in the environment (for bulk rebuilds whose
    source is itself durable) turns the write-ahead journal off;
    ``OSSE_JOURNAL_FSYNC=1`` fsyncs each append, for power loss (a flush
    alone survives a kill -9)."""

    def __init__(self, name: str, directory: str | Path,
                 key_dtype: np.dtype, has_data: bool = False,
                 max_memtable_bytes: int = 64 << 20, max_runs: int = 8,
                 journal: bool = True):
        self.name = name
        self.dir = Path(directory) / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.key_dtype = key_dtype
        self.has_data = has_data
        self.max_memtable_bytes = max_memtable_bytes
        self.max_runs = max_runs
        self._wlock = make_rlock(f"rdb.{name}")
        self.mem = MemTable(key_dtype, has_data)
        self.runs: list[Run] = []
        #: runs quarantined as corrupt (on open or by ``scrub``)
        self.quarantined: list[str] = []
        #: the next run id; read back from the run names on open, so a
        #: name is never reused after a merge or a wipe
        self._next_run_id = 0
        #: bumped on every mutation; the termlist cache and the device
        #: index key on it
        self.version = 0
        self.journal_enabled = journal and \
            os.environ.get("OSSE_NO_JOURNAL") != "1"
        self._journal_path = self.dir / "addsinprogress.bin"
        self._journal_f = None
        #: records the journal replayed at this open (0 after a clean
        #: stop)
        self.replayed = 0
        if not self.journal_enabled and self._journal_path.exists() \
                and self._journal_path.stat().st_size > 0:
            # this open neither journals nor truncates on dump, so a
            # later journaled open would replay stale batches over newer
            # state: a journal-less open declares its source durable
            log.warning("%s: journaling disabled but %s holds %d stale "
                        "bytes; truncating it", self.name,
                        self._journal_path.name,
                        self._journal_path.stat().st_size)
            self._journal_path.write_bytes(b"")
        self._load_existing_runs()

    def _gauge(self) -> None:
        g_membudget.set_gauge("memtable", str(self.dir), self.mem.nbytes)

    # --- writes ---

    @_locked
    def add(self, keys: np.ndarray, blobs: list[bytes] | None = None) -> None:
        """Add records: journaled before they apply; a dump when the
        memtable reaches its bound, or earlier once it holds
        ``_EARLY_DUMP_FLOOR`` bytes and the process budget is spent."""
        keys = np.atleast_1d(keys).astype(self.key_dtype, copy=False)
        self._journal_append(keys, blobs)
        self.mem.add(keys, blobs)
        self.version += 1
        self._gauge()
        if self.mem.nbytes >= self.max_memtable_bytes or (
                self.mem.nbytes >= _EARLY_DUMP_FLOOR
                and not g_membudget.would_fit(0)):
            self.dump()

    @_locked
    def delete(self, keys: np.ndarray) -> None:
        """Add tombstones for these keys (delbit cleared)."""
        neg = strip_delbit(np.atleast_1d(keys).astype(self.key_dtype,
                                                      copy=False))
        blobs = [b""] * len(neg) if self.has_data else None
        self._journal_append(neg, blobs)
        self.mem.add(neg, blobs)
        self.version += 1
        self._gauge()

    @_locked
    def wipe(self) -> None:
        """Drop all state: memtable, runs, checkpoint and journal (the
        Repair rebuild's first step, ``Repair.h:20``)."""
        self.mem.clear()
        self._gauge()
        for r in self.runs:
            shutil.rmtree(r.path, ignore_errors=True)
        self.runs = []
        saved = self.dir / "saved"
        if saved.exists():
            shutil.rmtree(saved)
        self._journal_truncate()
        self.version += 1

    def _new_run_path(self, base_id: int | None = None) -> Path:
        """The next run's directory: ``run_<id>``, or for a merge
        ``run_<first merged id>_m<id>``, which sorts right after the runs
        it keeps."""
        rid = self._next_run_id
        self._next_run_id += 1
        if base_id is None:
            return self.dir / f"run_{rid:06d}"
        return self.dir / f"run_{base_id:06d}_m{rid:06d}"

    @_locked
    def add_run(self, batch: RecordBatch) -> Run:
        """Bulk load: install a key-sorted, tombstone-free batch as the
        newest run, without passing it through the memtable."""
        run = Run.write(self._new_run_path(), batch)
        self.runs.append(run)
        self.version += 1
        return run

    @_locked
    def dump(self) -> Run | None:
        """Memtable → new immutable run (RdbDump); the checkpoint and the
        journal it covers go, and past ``max_runs`` runs a merge runs."""
        batch = self.mem.batch()
        if not len(batch):
            return None
        run = Run.write(self._new_run_path(), batch)
        self.runs.append(run)
        self.mem.clear()
        self._gauge()
        self.version += 1
        # a stale checkpoint would resurrect records the run now holds
        saved = self.dir / "saved"
        if saved.exists():
            shutil.rmtree(saved)
        self._journal_truncate()
        log.debug("%s: dumped run %s (%d recs)", self.name, run.path.name,
                  len(run))
        if len(self.runs) > self.max_runs:
            self.attempt_merge()
        return run

    @_locked
    def attempt_merge(self, force: bool = False) -> None:
        """Merge runs to bound their count (``RdbBase::attemptMerge``).

        Only the newest suffix merges, just long enough to bring the count
        back to ``max_runs``, so the big old base run is not rewritten;
        below the bound the newest two fold; ``force`` merges them all
        (the daily merge). A merge reserves twice its inputs' bytes under
        the membudget ``"merge"`` label; refused, it merges fewer, newer
        runs, and defers when not even two fit. Tombstones are kept
        unless the merge includes the oldest run."""
        if len(self.runs) <= 1:
            return
        if force:
            start = 0
        elif len(self.runs) > self.max_runs:
            start = self.max_runs - 1
        else:
            start = len(self.runs) - 2
        start0 = start
        while True:
            est = 2 * sum(
                int(r.keys.nbytes)
                + (int(r.data.nbytes) if r.data is not None else 0)
                for r in self.runs[start:])
            if g_membudget.reserve("merge", est):
                break
            if start >= len(self.runs) - 2:
                log.warning("%s: merge deferred: even the 2-run merge "
                            "(%d MB working set) is over budget",
                            self.name, est >> 20)
                return
            start += 1
        if start != start0:
            log.warning("%s: merge shrunk to the newest %d runs (budget "
                        "pressure)", self.name, len(self.runs) - start)
        try:
            old = self.runs[start:]
            merged = merge_batches([r.batch() for r in old],
                                   keep_tombstones=start != 0)
            base_id = int(old[0].path.name.split("_")[1])
            run = Run.write(self._new_run_path(base_id), merged)
            # readers that took the old list keep their mmaps: the old
            # runs' files stay readable after the rmtree
            self.runs = self.runs[:start] + [run]
            self.version += 1
            for r in old:
                shutil.rmtree(r.path)
            log.debug("%s: merged %d newest runs -> %s (%d recs, %d kept)",
                      self.name, len(old), run.path.name, len(run), start)
        finally:
            g_membudget.release("merge", est)

    def _quarantine(self, path: Path, err: CorruptRunError) -> str:
        q = path.with_name(path.name + ".corrupt")
        if q.exists():
            shutil.rmtree(q)
        path.rename(q)
        self.quarantined.append(q.name)
        g_stats.count("rdb.corrupt_quarantined")
        log.error("%s: QUARANTINED corrupt run: %s", self.name, err)
        return q.name

    @_locked
    def scrub(self) -> list[str]:
        """Re-verify every run now and quarantine the failures; returns
        their new names (the caller heals them from a twin)."""
        bad: list[str] = []
        keep: list[Run] = []
        for r in self.runs:
            try:
                r.verify()
                keep.append(r)
            except CorruptRunError as e:
                bad.append(self._quarantine(r.path, e))
        if bad:
            self.runs = keep
            self.version += 1
        return bad

    @_locked
    def replace_with(self, batch: RecordBatch) -> None:
        """Wipe and reload from one merged batch (the twin patch's
        receiving side)."""
        self.wipe()
        self.quarantined = []
        for p in self.dir.glob("run_*.corrupt"):
            shutil.rmtree(p, ignore_errors=True)
        if len(batch):
            self.mem.add(batch.keys.copy(),
                         batch.payloads() if self.has_data else None)
            self.dump()
        self.version += 1

    # --- reads (Msg5 semantics) ---

    def get_list(self, start_key: np.ndarray, end_key: np.ndarray
                 ) -> RecordBatch:
        """Merged range read across runs + memtable, tombstones applied:
        :meth:`get_ranges` of one."""
        return self.get_ranges(start_key.reshape(1), end_key.reshape(1))

    def get_ranges(self, start_keys: np.ndarray, end_keys: np.ndarray
                   ) -> RecordBatch:
        """Merged read of many disjoint ranges in key order across runs
        + memtable, tombstones applied, with one search of each run and
        of each memtable segment for all of them."""
        if g_chaos.enabled:
            g_chaos.rdb_fault(self)
        sources = [r.batch().ranges(start_keys, end_keys)
                   for r in self.runs]
        sources.append(self.mem.ranges(start_keys, end_keys))
        return merge_batches(sources)

    def get_all(self) -> RecordBatch:
        sources = [r.batch() for r in self.runs]
        sources.append(self.mem.batch())
        return merge_batches(sources)

    def count_live(self) -> int:
        """The live records, tombstones applied (a merge of keys only)."""
        sources = [RecordBatch(r.keys) for r in self.runs]
        sources.append(RecordBatch(self.mem.batch().keys))
        return len(merge_batches(sources))

    # --- the memtable checkpoint (Process::saveRdbTrees) ---

    @_locked
    def save(self) -> None:
        """Persist the memtable to ``saved/`` without adding a run. The
        new checkpoint is written in full to ``saved.new`` before the old
        one goes, so a crash always leaves one that covers the records
        (:meth:`load_saved` adopts a stranded ``saved.new``)."""
        batch = self.mem.batch()
        saved = self.dir / "saved"
        newp = self.dir / "saved.new"
        if newp.exists():
            shutil.rmtree(newp)
        if len(batch):
            Run.write(newp, batch)
            if saved.exists():
                shutil.rmtree(saved)
            newp.rename(saved)
        elif saved.exists():
            shutil.rmtree(saved)
        self._journal_truncate()  # the checkpoint covers the journal

    def load_saved(self) -> None:
        """Load the memtable checkpoint into the memtable."""
        saved = self.dir / "saved"
        newp = self.dir / "saved.new"
        if not saved.exists() and newp.exists():
            try:
                Run(newp)
                newp.rename(saved)
            except CorruptRunError:
                shutil.rmtree(newp)  # torn: the journal still covers it
        if saved.exists():
            b = Run(saved).batch()
            self.mem.add(b.keys.copy(),
                         b.payloads() if self.has_data else None)

    def _load_existing_runs(self) -> None:
        """Open the runs in name order (verified; a corrupt one is
        quarantined and the rest serve), then the checkpoint, then the
        journal."""
        for p in sorted(self.dir.glob("run_*")):
            if not p.is_dir() or p.name.endswith((".tmp", ".corrupt")):
                continue
            parts = p.name.split("_")
            self._next_run_id = max(self._next_run_id, int(parts[1]) + 1)
            if len(parts) > 2 and parts[2].startswith("m"):
                self._next_run_id = max(self._next_run_id,
                                        int(parts[2][1:]) + 1)
            try:
                self.runs.append(Run(p))
            except CorruptRunError as e:
                self._quarantine(p, e)
        self.load_saved()
        if self.journal_enabled:
            self._replay_journal()

    # --- the write-ahead journal (Msg4 addsinprogress) ---

    def _journal_append(self, keys: np.ndarray,
                        blobs: list[bytes] | None) -> None:
        """One append per add batch: a ``<IIQ`` header (records, CRC32 of
        the body, body bytes), the key image, and for payload dbs the
        uint32 blob lengths and the blobs; flushed, and fsynced under
        ``OSSE_JOURNAL_FSYNC=1``."""
        if not self.journal_enabled:
            return
        if self._journal_f is None:
            self._journal_f = open(self._journal_path, "ab")  # noqa: SIM115
        kb = np.ascontiguousarray(keys).tobytes()
        if self.has_data:
            blobs = blobs if blobs is not None else [b""] * len(keys)
            lens = np.array([len(b) for b in blobs], np.uint32)
            body = kb + lens.tobytes() + b"".join(blobs)
        else:
            body = kb
        self._journal_f.write(_JOURNAL_HDR.pack(
            len(keys), zlib.crc32(body) & 0xFFFFFFFF, len(body)) + body)
        self._journal_f.flush()
        if os.environ.get("OSSE_JOURNAL_FSYNC") == "1":
            os.fsync(self._journal_f.fileno())

    def _replay_journal(self) -> None:
        """Re-apply the journaled batches. A torn or corrupt batch stops
        the replay, and the file is cut to the valid prefix, so batches
        appended after this open are not stranded behind it."""
        if not self._journal_path.exists():
            return
        data = self._journal_path.read_bytes()
        ks = self.key_dtype.itemsize
        off, n_rec = 0, 0
        while off + _JOURNAL_HDR.size <= len(data):
            n, crc, blen = _JOURNAL_HDR.unpack_from(data, off)
            off += _JOURNAL_HDR.size
            if off + blen > len(data) or \
                    (zlib.crc32(data[off:off + blen]) & 0xFFFFFFFF) != crc:
                log.warning("%s: journal torn at byte %d; replay stops "
                            "(unacknowledged tail)", self.name,
                            off - _JOURNAL_HDR.size)
                with open(self._journal_path, "r+b") as jf:
                    jf.truncate(off - _JOURNAL_HDR.size)
                break
            body = data[off:off + blen]
            off += blen
            keys = np.frombuffer(body[:n * ks], dtype=self.key_dtype).copy()
            blobs = None
            if self.has_data:
                lens = np.frombuffer(body[n * ks:n * ks + 4 * n], np.uint32)
                p = n * ks + 4 * n
                blobs = []
                for ln in lens:
                    blobs.append(body[p:p + int(ln)])
                    p += int(ln)
            self.mem.add(keys, blobs)
            n_rec += int(n)
        self.replayed = n_rec
        if n_rec:
            self.version += 1
            self._gauge()
            log.info("%s: replayed %d journaled records", self.name, n_rec)
            if self.mem.nbytes >= self.max_memtable_bytes:
                self.dump()

    def _journal_truncate(self) -> None:
        if not self.journal_enabled:
            return
        if self._journal_f is not None:
            self._journal_f.close()
            self._journal_f = None
        if self._journal_path.exists():
            self._journal_path.unlink()

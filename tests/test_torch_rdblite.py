"""The port's Rdb-lite against the reference's scenarios and against the
JAX package's Rdb itself.

The scenarios of ``tests/test_rdblite.py`` (dump and read, deletes
across a dump, merge bounds, the suffix merge that keeps the base run,
the forced full merge, merged runs reloading in order) and of
``tests/test_msg5.py`` (CRCs written and verified, a corrupt run
quarantined on open, a scrub after later corruption, the data CRC,
``replace_with`` healing) run against the port's ``Rdb``. Then the same
seeded operation sequence runs through both packages in two directories,
which must hold byte-equal files (runs, ``meta.json``, ``saved/``,
``addsinprogress.bin``), and each package opens the other's directory,
a torn journal tail included, to a bitwise-equal ``get_all()``."""

import json
import shutil

import numpy as np
import pytest

from open_source_search_engine_tpu.index import rdblite as jrdblite
from open_source_search_engine_tpu.utils.membudget import \
    g_membudget as j_membudget
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.cache.plane import g_cacheplane
from open_source_search_engine_tpu_torch.index import posdb, rdblite
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.index.rdblite import (
    CorruptRunError, RecordBatch, Rdb, Run, keys_sorted, merge_batches)
from open_source_search_engine_tpu_torch.utils.membudget import g_membudget

KD = np.dtype([("n0", "<u8"), ("n1", "<u8")], align=False)


@pytest.fixture(autouse=True)
def _roomy_budgets():
    """Both packages' process budgets wide open: an earlier test file in
    this worker may have lowered one, and a refused merge reservation
    would shrink one package's merge and not the other's."""
    limits = (g_membudget.limit, j_membudget.limit)
    g_membudget.set_limit(1 << 40)
    j_membudget.set_limit(1 << 40)
    yield
    g_membudget.set_limit(limits[0])
    j_membudget.set_limit(limits[1])


def make_keys(termids, docids, wordpos=0, delbit=1):
    return posdb.pack(termid=termids, docid=docids, wordpos=wordpos,
                      delbit=delbit)


def _mk_keys(vals):
    k = np.zeros(len(vals), KD)
    k["n1"] = vals
    k["n0"] = 1
    return k


def _flip_byte(path, offset=-3):
    raw = bytearray(path.read_bytes())
    raw[offset] ^= 0xFF
    path.write_bytes(bytes(raw))


# --- tests/test_rdblite.py's scenarios -------------------------------------

class TestRdb:
    def test_add_dump_read_cycle(self, tmp_path):
        db = Rdb("posdb", tmp_path, posdb.KEY_DTYPE)
        db.add(make_keys([1, 2], [10, 20]))
        db.dump()
        db.add(make_keys([1], [11]))
        f = posdb.unpack(db.get_list(posdb.start_key(1),
                                     posdb.end_key(1)).keys)
        assert sorted(f["docid"].tolist()) == [10, 11]

    def test_delete_across_dump_boundary(self, tmp_path):
        db = Rdb("posdb", tmp_path, posdb.KEY_DTYPE)
        db.add(make_keys([7], [100]))
        db.dump()
        db.delete(make_keys([7], [100]))
        assert len(db.get_list(posdb.start_key(7), posdb.end_key(7))) == 0

    def test_merge_bounds_run_count(self, tmp_path):
        db = Rdb("posdb", tmp_path, posdb.KEY_DTYPE, max_runs=3)
        for i in range(5):
            db.add(make_keys([i], [i]))
            db.dump()
        assert len(db.runs) <= 3 + 1
        assert len(db.get_all()) == 5

    def test_payload_db(self, tmp_path):
        db = Rdb("titledb", tmp_path, posdb.KEY_DTYPE, has_data=True)
        db.add(make_keys([1], [10]), [b"hello world"])
        db.dump()
        db.add(make_keys([1], [11]), [b"second"])
        lst = db.get_list(posdb.start_key(1), posdb.end_key(1))
        assert lst.payloads() == [b"hello world", b"second"]

    def test_restart_recovers_runs_and_memtable(self, tmp_path):
        db = Rdb("posdb", tmp_path, posdb.KEY_DTYPE)
        db.add(make_keys([1], [10]))
        db.dump()
        db.add(make_keys([1], [11]))  # stays in the memtable
        db.save()
        assert len(db.runs) == 1
        db2 = Rdb("posdb", tmp_path, posdb.KEY_DTYPE)
        f = posdb.unpack(db2.get_list(posdb.start_key(1),
                                      posdb.end_key(1)).keys)
        assert sorted(f["docid"].tolist()) == [10, 11]
        assert len(db2.runs) == 1 and len(db2.mem) == 1

    def test_auto_dump_on_budget(self, tmp_path):
        db = Rdb("posdb", tmp_path, posdb.KEY_DTYPE,
                 max_memtable_bytes=1000)
        db.add(make_keys(np.arange(200), np.arange(200)))
        assert len(db.runs) >= 1

    def test_large_roundtrip_with_merge(self, tmp_path):
        rng = np.random.default_rng(2)
        db = Rdb("posdb", tmp_path, posdb.KEY_DTYPE)
        seen = set()
        for _ in range(4):
            tids = rng.integers(0, 20, 2000)
            dids = rng.integers(0, 500, 2000)
            wps = rng.integers(0, 50, 2000)
            db.add(make_keys(tids, dids, wps))
            seen.update(zip(tids.tolist(), dids.tolist(), wps.tolist()))
            db.dump()
        db.attempt_merge(force=True)
        assert len(db.runs) == 1
        f = posdb.unpack(db.get_all().keys)
        assert set(zip(f["termid"].tolist(), f["docid"].tolist(),
                       f["wordpos"].tolist())) == seen


def _pack(termid, n):
    return posdb.pack(termid=termid, docid=np.arange(1, n + 1,
                                                     dtype=np.uint64),
                      wordpos=1, densityrank=1, siterank=0, hashgroup=0,
                      langid=1)


class TestMergePolicy:
    def test_suffix_merge_keeps_base_run(self, tmp_path):
        rdb = Rdb("posdb", tmp_path, posdb.KEY_DTYPE, max_runs=3)
        rdb.add(_pack(1, 5000))
        rdb.dump()
        base_name = rdb.runs[0].path.name
        for i in range(4):
            rdb.add(_pack(10 + i, 50))
            rdb.dump()
        assert len(rdb.runs) <= 3 + 1
        rdb.attempt_merge()
        assert len(rdb.runs) <= 3
        assert rdb.runs[0].path.name == base_name
        assert len(rdb.get_all()) == 5000 + 4 * 50

    def test_forced_full_merge(self, tmp_path):
        rdb = Rdb("posdb", tmp_path, posdb.KEY_DTYPE, max_runs=8)
        for t in range(3):
            rdb.add(_pack(t + 1, 10))
            rdb.dump()
        rdb.attempt_merge(force=True)
        assert len(rdb.runs) == 1
        assert len(rdb.get_all()) == 30

    def test_merged_runs_reload_in_order(self, tmp_path):
        rdb = Rdb("posdb", tmp_path, posdb.KEY_DTYPE, max_runs=2)
        for t in range(5):
            rdb.add(_pack(t + 1, 5))
            rdb.dump()
        names = [r.path.name for r in rdb.runs]
        rdb2 = Rdb("posdb", tmp_path, posdb.KEY_DTYPE, max_runs=2)
        assert [r.path.name for r in rdb2.runs] == names
        assert len(rdb2.get_all()) == len(rdb.get_all()) == 25

    def test_tombstones_survive_a_merge_without_the_oldest_run(self,
                                                               tmp_path):
        rdb = Rdb("posdb", tmp_path, posdb.KEY_DTYPE)
        rdb.add(_pack(1, 5))
        rdb.dump()
        rdb.add(_pack(2, 5))
        rdb.dump()
        rdb.delete(_pack(1, 2))
        rdb.dump()
        rdb.attempt_merge()          # folds the newest two: runs 1 and 2
        assert len(rdb.runs) == 2
        assert not rdblite.delbits(rdb.runs[-1].keys).all()
        assert len(rdb.get_all()) == 8
        rdb.attempt_merge(force=True)  # includes the oldest: dropped
        assert rdblite.delbits(rdb.runs[0].keys).all()
        assert len(rdb.get_all()) == 8

    def test_merge_shrinks_then_defers_under_budget(self, tmp_path):
        rdb = Rdb("posdb", tmp_path, posdb.KEY_DTYPE)
        for t in range(4):
            rdb.add(_pack(t + 1, 100))
            rdb.dump()
        one = 2 * int(rdb.runs[0].keys.nbytes)
        # an earlier test's cached entries would be shed by the pressure
        # pass and let a wider merge fit: none are left to shed
        g_cacheplane.flush()
        g_membudget.set_limit(g_membudget.used() + 2 * one)
        rdb.attempt_merge(force=True)  # 4 runs refused: the newest 2 merge
        assert len(rdb.runs) == 3
        g_membudget.set_limit(g_membudget.used() + one)
        rdb.attempt_merge(force=True)  # not even 2 fit: deferred
        assert len(rdb.runs) == 3
        assert len(rdb.get_all()) == 400


# --- the five port faults --------------------------------------------------

def test_merge_batches_of_nothing_is_an_empty_batch():
    out = merge_batches([])
    assert isinstance(out, RecordBatch) and len(out) == 0


def test_save_adds_no_run_and_empties_no_memtable(tmp_path):
    coll = Collection("s", tmp_path, device="cpu")
    docproc.index_document(coll, "http://s.test/a",
                           "<html><title>A</title><p>alpha words</p></html>")
    coll.dump_all()
    docproc.index_document(coll, "http://s.test/b",
                           "<html><title>B</title><p>beta words</p></html>")
    before = {n: (len(db.runs), len(db.mem)) for n, db in coll.rdbs().items()}
    for _ in range(3):
        coll.save()
    after = {n: (len(db.runs), len(db.mem)) for n, db in coll.rdbs().items()}
    assert after == before
    assert before["posdb"][1] > 0
    assert (coll.posdb.dir / "saved").is_dir()
    again = Collection("s", tmp_path, device="cpu")
    assert {n: (len(db.runs), len(db.mem))
            for n, db in again.rdbs().items()} == before
    for n, db in coll.rdbs().items():
        a, b = db.get_all(), again.rdbs()[n].get_all()
        assert a.keys.tobytes() == b.keys.tobytes(), n


def test_repeated_dumps_keep_eight_runs_or_fewer(tmp_path):
    rdb = Rdb("posdb", tmp_path, posdb.KEY_DTYPE)
    for t in range(30):
        rdb.add(_pack(t + 1, 3))
        rdb.dump()
        assert len(rdb.runs) <= 8
    assert len(rdb.get_all()) == 90
    coll = Collection("d", tmp_path, device="cpu")
    for i in range(20):
        docproc.index_document(coll, f"http://d{i}.test/",
                               f"<p>dump number{i} words</p>")
        coll.dump_all()
    assert all(len(db.runs) <= 8 for db in coll.rdbs().values())
    assert coll.posdb.runs and len(coll.titledb.get_all()) == 20


def test_device_bytes_neither_dump_early_nor_defer_a_merge(tmp_path):
    """A resident index's device gauge above the host limit (5.4 GiB of
    device bytes at 100,000 pages against the 4 GiB default): a memtable
    past the early-dump floor stays in RAM, dumps past ``max_runs`` still
    merge, and no host reservation runs the device pressure handler. The
    device label answers to its own cap."""
    g_membudget.set_limit(4 << 30)
    parked = []

    def park(need):
        parked.append(need)
        return 0

    g_membudget.add_pressure_handler(park, priority=1, key="t.device",
                                     label="device")
    g_membudget.set_gauge("device", "t.resident", 6 << 30)
    try:
        assert g_membudget.would_fit(0)
        rdb = Rdb("posdb", tmp_path, posdb.KEY_DTYPE)
        n = rdblite._EARLY_DUMP_FLOOR // posdb.KEY_DTYPE.itemsize + 1000
        rdb.add(make_keys(np.arange(n) % 50 + 1, np.arange(n) + 1))
        assert not rdb.runs and rdb.mem.nbytes >= rdblite._EARLY_DUMP_FLOOR
        for t in range(12):
            rdb.add(_pack(t + 1, 3))
            rdb.dump()
            assert len(rdb.runs) <= 8
        assert len(rdb.get_all()) == n + 36
        assert g_membudget.reserve("merge", 1 << 20)
        g_membudget.release("merge", 1 << 20)
        assert not parked
        g_membudget.set_label_cap("device", 5 << 30)
        g_membudget.set_gauge("device", "t.resident", 6 << 30)
        assert parked   # over the device cap: the device handler ran
    finally:
        g_membudget.set_label_cap("device", 0)
        g_membudget.set_gauge("device", "t.resident", 0)


def test_run_names_never_collide(tmp_path):
    rdb = Rdb("posdb", tmp_path, posdb.KEY_DTYPE, max_runs=3)
    seen = []
    for t in range(12):
        rdb.add(_pack(t + 1, 2))
        seen.append(rdb.dump().path.name)
        names = [r.path.name for r in rdb.runs]
        assert len(set(names)) == len(names)
    assert len(set(seen)) == len(seen)
    reopened = Rdb("posdb", tmp_path, posdb.KEY_DTYPE, max_runs=3)
    reopened.add(_pack(99, 2))
    name = reopened.dump().path.name
    assert name not in seen
    reopened.wipe()
    reopened.add_run(RecordBatch.from_records(_pack(98, 2)))
    assert reopened.runs[0].path.name not in seen + [name]
    assert sorted(p.name for p in reopened.dir.glob("run_*")) == \
        [reopened.runs[0].path.name]


# --- tests/test_msg5.py's scenarios ----------------------------------------

def test_keys_sorted_check():
    assert keys_sorted(_mk_keys([1, 2, 3]))
    assert not keys_sorted(_mk_keys([1, 3, 2]))
    k = _mk_keys([5, 5])
    k["n0"] = [2, 1]
    assert not keys_sorted(k)


def test_crc_written_and_verified(tmp_path):
    rdb = Rdb("t", tmp_path, KD)
    rdb.add(_mk_keys([3, 1, 2]))
    run = rdb.dump()
    meta = json.loads((run.path / "meta.json").read_text())
    assert "keys_crc" in meta and meta["data_crc"] is None
    Run(run.path).verify()


def test_corrupt_run_quarantined_on_load(tmp_path):
    rdb = Rdb("t", tmp_path, KD)
    rdb.add(_mk_keys(range(100)))
    run = rdb.dump()
    rdb.add(_mk_keys(range(100, 150)))
    rdb.dump()
    _flip_byte(run.path / "keys.npy")
    rdb2 = Rdb("t", tmp_path, KD)
    assert len(rdb2.quarantined) == 1 and len(rdb2.runs) == 1
    assert len(rdb2.get_all()) == 50
    assert (run.path.parent / (run.path.name + ".corrupt")).exists()


def test_scrub_detects_later_corruption(tmp_path):
    rdb = Rdb("t", tmp_path, KD)
    rdb.add(_mk_keys(range(64)))
    run = rdb.dump()
    assert rdb.scrub() == []
    _flip_byte(run.path / "keys.npy")
    bad = rdb.scrub()
    assert len(bad) == 1 and not rdb.runs
    assert rdb.quarantined == bad


def test_data_crc_covers_payloads(tmp_path):
    rdb = Rdb("t", tmp_path, KD, has_data=True)
    rdb.add(_mk_keys([1, 2]), [b"hello", b"world"])
    run = rdb.dump()
    _flip_byte(run.path / "data.npy")
    with pytest.raises(CorruptRunError):
        Run(run.path)


def test_replace_with_heals(tmp_path):
    src = Rdb("s", tmp_path / "a", KD)
    src.add(_mk_keys(range(10)))
    src.dump()
    dst = Rdb("s", tmp_path / "b", KD)
    dst.add(_mk_keys(range(99)))
    run = dst.dump()
    _flip_byte(run.path / "keys.npy")
    assert dst.scrub()
    dst.replace_with(src.get_all())
    assert np.array_equal(dst.get_all().keys, src.get_all().keys)
    assert dst.quarantined == [] and not list(dst.dir.glob("*.corrupt"))


# --- parity with the JAX package's Rdb --------------------------------------

def _ops(pkg, base, tear: bool = False):
    """One seeded operation sequence through ``pkg``'s Rdb: adds and
    deletes of a dataless and a payload db, dumps (past max_runs, so
    merges run), a forced merge, a checkpoint, and adds after it that
    only the journal holds; ``tear`` cuts the journal's last batch."""
    rng = np.random.default_rng(11)
    dbs = [pkg.Rdb("posdb", base, posdb.KEY_DTYPE, max_runs=3),
           pkg.Rdb("blobs", base, KD, has_data=True, max_runs=3)]

    def batch(db, n):
        if db.has_data:
            k = _mk_keys(rng.integers(0, 500, n))
            return k, [bytes(rng.integers(0, 256, int(rng.integers(0, 9)),
                                          dtype=np.uint8)) for _ in range(n)]
        return make_keys(rng.integers(1, 40, n), rng.integers(1, 300, n),
                         rng.integers(0, 64, n)), None

    for step in range(7):
        for db in dbs:
            k, blobs = batch(db, 40)
            db.add(k, blobs)
            db.delete(k[:5])
            if step % 2:
                db.dump()
    for db in dbs:
        db.attempt_merge(force=True)
        k, blobs = batch(db, 30)
        db.add(k, blobs)
        db.save()
        for _ in range(2):
            k, blobs = batch(db, 20)
            db.add(k, blobs)
        db.delete(k[:3])
        if tear:
            jp = db.dir / "addsinprogress.bin"
            jp.write_bytes(jp.read_bytes()[:-7])
    return dbs


def _tree(base):
    return {p.relative_to(base).as_posix(): p.read_bytes()
            for p in sorted(base.rglob("*")) if p.is_file()}


def test_same_operations_write_byte_equal_files(tmp_path):
    _ops(jrdblite, tmp_path / "jax")
    _ops(rdblite, tmp_path / "port")
    a, b = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(a) == sorted(b)
    assert any("_m" in n for n in a)  # merged runs among them
    assert "posdb/saved/meta.json" in a
    for name in a:
        assert a[name] == b[name], name


def test_same_operations_write_byte_equal_journals(tmp_path):
    _ops(jrdblite, tmp_path / "jax")
    _ops(rdblite, tmp_path / "port")
    for db in ("posdb", "blobs"):
        a = (tmp_path / "jax" / db / "addsinprogress.bin").read_bytes()
        b = (tmp_path / "port" / db / "addsinprogress.bin").read_bytes()
        assert a and a == b, db


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_opens_the_others_directory(tmp_path, writer):
    """Runs, the ``saved/`` checkpoint and a journal with a torn tail,
    written by one package, open in both to bitwise-equal records."""
    pkgs = {"jax": jrdblite, "port": rdblite}
    _ops(pkgs[writer], tmp_path / "w", tear=True)
    shutil.copytree(tmp_path / "w", tmp_path / "r")
    reader = "port" if writer == "jax" else "jax"
    for name, dtype, data in (("posdb", posdb.KEY_DTYPE, False),
                              ("blobs", KD, True)):
        own = pkgs[writer].Rdb(name, tmp_path / "w", dtype, has_data=data,
                               max_runs=3)
        other = pkgs[reader].Rdb(name, tmp_path / "r", dtype, has_data=data,
                                 max_runs=3)
        assert [r.path.name for r in own.runs] == \
            [r.path.name for r in other.runs]
        assert not own.quarantined and not other.quarantined
        a, b = own.get_all(), other.get_all()
        assert len(a) > 0 and a.keys.tobytes() == b.keys.tobytes(), name
        if data:
            assert a.payloads() == b.payloads()
        # both cut the torn batch the same way
        assert (tmp_path / "w" / name / "addsinprogress.bin").read_bytes() \
            == (tmp_path / "r" / name / "addsinprogress.bin").read_bytes()

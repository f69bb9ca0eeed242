"""The background base rebuild of the port's ``engine.get_device_index``
(CPU).

After a dump moves the run set, ``get_device_index`` keeps returning the
old index (its pre-dump view) while a thread builds a fresh one, then
swaps it in; the swapped index answers as a DeviceIndex built from
scratch does. When two resident sets would not fit (the reference's
``2 · resident + 2 GiB > 14 GiB`` gate) the rebuild blocks instead, and
a rebuild that fails leaves the old index serving. Every wait has a
timeout."""

import threading
import time

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency

#: the tier-1 run shares the host's cores among several workers
torch.set_num_threads(1)

QUERIES = ["walrus", "herd shore", "fresh", "walrus fresh", "colony"]


def _page(i, extra=""):
    return (f"<html><head><title>Doc {i}</title></head><body><p>walrus "
            f"herd {i} gathers on the shore {extra}. The colony dives."
            "</p></body></html>")


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    g_residency.reset()


@pytest.fixture()
def coll(tmp_path):
    c = Collection("rb", tmp_path, device="cpu")
    c.conf.pqr_enabled = False
    for i in range(24):
        docproc.index_document(c, f"http://rb{i % 4}.test/d{i}", _page(i))
    c.dump_all()
    return c


def _write_and_dump(c):
    for i in range(6):
        docproc.index_document(c, f"http://new{i}.test/x",
                               _page(100 + i, "fresh news"))
    docproc.remove_document(c, "http://rb1.test/d5")
    c.dump_all()


def _wait_rebuilt(c, timeout=60.0):
    end = time.monotonic() + timeout
    while getattr(c, "_di_rebuilding", False):
        assert time.monotonic() < end, "background rebuild did not finish"
        time.sleep(0.01)


def _same_results(a, b):
    for q, (ad, asc, an), (bd, bsc, bn) in zip(
            QUERIES, a.search_batch(QUERIES, topk=16),
            b.search_batch(QUERIES, topk=16)):
        assert an == bn and list(ad) == list(bd), q
        assert np.array_equal(asc.view(np.int32), bsc.view(np.int32)), q


def test_old_index_serves_during_rebuild_then_swaps(coll, monkeypatch):
    old = engine.get_device_index(coll)
    before = old.search_batch(QUERIES, topk=16)
    gate, started = threading.Event(), threading.Event()
    real = engine.build_device_index

    def gated(c, device=None):
        started.set()
        assert gate.wait(timeout=60)
        return real(c, device)

    monkeypatch.setattr(engine, "build_device_index", gated)
    _write_and_dump(coll)
    try:
        assert engine.get_device_index(coll) is old
        assert started.wait(timeout=60)
        assert coll._di_rebuilding
        # the old index keeps serving its pre-dump view, resident too
        assert engine.get_device_index(coll) is old
        for (bd, bs, bn), (gd, gs, gn) in zip(
                before, old.search_batch(QUERIES, topk=16)):
            assert gn == bn and list(gd) == list(bd)
        page = engine.search_device_batch(coll, ["fresh"], resident=True)
        assert page[0].total_matches == 0
    finally:
        gate.set()
    _wait_rebuilt(coll)
    fresh = engine.get_device_index(coll)
    assert fresh is not old and fresh.full_rebuilds == 1
    assert fresh._built_version == coll.posdb.version
    _same_results(fresh, DeviceIndex(coll))
    assert engine.search_device_batch(
        coll, ["fresh"], resident=True)[0].total_matches == 6


def test_gate_forces_a_blocking_rebuild(coll, monkeypatch):
    old = engine.get_device_index(coll)
    monkeypatch.setattr(DeviceIndex, "resident_bytes",
                        lambda self: 8 << 30)
    spawned = []
    monkeypatch.setattr(engine._threads, "spawn",
                        lambda *a, **k: spawned.append(a))
    _write_and_dump(coll)
    di = engine.get_device_index(coll)
    assert di is old and not spawned
    assert not getattr(coll, "_di_rebuilding", False)
    assert di.full_rebuilds == 2
    _same_results(di, DeviceIndex(coll))


def test_failed_rebuild_keeps_the_old_index(coll, monkeypatch):
    old = engine.get_device_index(coll)

    def boom(c, device=None):
        raise RuntimeError("device build failed")

    monkeypatch.setattr(engine, "build_device_index", boom)
    _write_and_dump(coll)
    assert engine.get_device_index(coll) is old
    _wait_rebuilt(coll)
    assert engine.get_device_index(coll) is old
    assert engine.get_device_index(coll) is old  # the next call retries
    _wait_rebuilt(coll)
    monkeypatch.undo()
    assert engine.get_device_index(coll) is old
    _wait_rebuilt(coll)
    fresh = engine.get_device_index(coll)
    assert fresh is not old
    _same_results(fresh, DeviceIndex(coll))

"""The port's tenant plane (``serve/tenancy.py``) and memory budget
(``utils/membudget.py``) (CPU).

Mirrors ``tests/test_tenancy.py`` ``TestLru``, ``TestSingleFlight``, the
device-pressure case of ``TestPressure`` and ``TestColdHotParity``:
residency is LRU with pinning, sized by ``max_resident`` and the
membudget "device" label cap; parking stops the loop, drops the index
and zeroes the gauge; a cold tenant's build is single-flight, riders
shed under their own deadline; device pressure parks cold tenants before
higher-priority handlers run; a tenant parked and promoted again answers
as an always-resident one and as the JAX package does. The admission
quotas belong to ``serve/admission.py``, not carried.

The membudget case: a gauge set from a garbage-collector callback while
``reserve`` holds the budget's lock returns (the reference's plain lock
would wait on its own thread forever)."""

import gc
import threading
import types

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu.serve.tenancy import \
    g_residency as jresidency
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import assert_tie_run_parity
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.query.engine import \
    search_device_batch
from open_source_search_engine_tpu_torch.serve import tenancy as tenancy_mod
from open_source_search_engine_tpu_torch.serve.tenancy import (
    ResidencyManager, g_residency)
from open_source_search_engine_tpu_torch.utils import deadline as deadline_mod
from open_source_search_engine_tpu_torch.utils.membudget import (MemBudget,
                                                                 g_membudget)
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc

#: the tier-1 run shares the host's cores among several workers
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection while this module drives the JAX package's
    device index (``tests/jax_gc.py``)."""
    with jax_gc.quiet():
        yield


DOC = ("<html><head><title>{t}</title></head><body>"
       "<p>walrus {t} herd gathers on the {t} shore. "
       "The walrus colony of {t} dives deep.</p></body></html>")

QUERIES = ["walrus", "herd", "walrus shore", "colony", "nothinghere"]


def _mk_coll(tmp_path, name: str) -> Collection:
    c = Collection(name, tmp_path, device="cpu")
    c.conf.pqr_enabled = False
    docproc.index_document(c, f"http://{name}.test/p", DOC.format(t=name))
    return c


@pytest.fixture(autouse=True)
def _plane_reset():
    """These tests mutate the process-wide singletons: leave them as a
    fresh process has them, with every loop stopped."""
    g_stats.reset()
    g_residency.reset()
    yield
    g_residency.reset()
    g_membudget.set_label_cap("device", 0)


def _count(name: str) -> int:
    return g_stats.snapshot()["counters"].get(name, 0)


def _key(r):
    return (-round(r.score, 3), r.docid)


class TestLru:
    def test_count_bound_evicts_least_recent(self, tmp_path):
        rm = ResidencyManager(max_resident=2)
        ca, cb, cc = (_mk_coll(tmp_path, n) for n in ("ta", "tb", "tc"))
        rm.loop_for(ca)
        rm.loop_for(cb)
        assert rm.resident_names() == ["ta", "tb"]
        loop_a = ca._resident_loop
        rm.loop_for(cc)  # ta is the least recent → parked
        assert rm.resident_names() == ["tb", "tc"]
        snap = rm.snapshot()
        assert snap["tenants"]["ta"]["resident"] is False
        assert snap["parked"] == 1
        # parking released the device gauge and stopped the loop
        assert g_membudget.used("device") == sum(
            t["device_bytes"] for t in snap["tenants"].values())
        assert ca._device_index is None
        assert loop_a.join(timeout=30)
        rm.stop_all()

    def test_pin_protects_and_touch_refreshes_recency(self, tmp_path):
        rm = ResidencyManager(max_resident=2)
        ca, cb, cc = (_mk_coll(tmp_path, n) for n in ("pa", "pb", "pc"))
        rm.loop_for(ca)
        rm.loop_for(cb)
        rm.pin("pa")
        rm.loop_for(cc)  # pa pinned → pb parks instead
        assert rm.resident_names() == ["pa", "pc"]
        loop_c = rm.loop_for(cc)
        assert rm.loop_for(cc) is loop_c  # fast path, same loop
        assert _count("tenancy.hit") >= 1
        rm.unpin("pa")
        rm.loop_for(cb)  # pa now least recent and unpinned → parked
        assert rm.resident_names() == ["pb", "pc"]
        rm.stop_all()

    def test_same_name_different_collection_never_aliases(self, tmp_path):
        rm = ResidencyManager()
        old = _mk_coll(tmp_path / "old", "dup")
        loop_old = rm.loop_for(old)
        new = Collection("dup", tmp_path / "new", device="cpu")
        new.conf.pqr_enabled = False
        docproc.index_document(new, "http://dup.test/q",
                               DOC.format(t="fresh"))
        loop_new = rm.loop_for(new)
        assert loop_new is not loop_old
        assert _count("tenancy.stale_record") == 1
        assert old._resident_loop is None
        assert old._device_index is None
        assert new._resident_loop is loop_new
        assert rm.snapshot()["tenants"]["dup"]["cold_starts"] == 1
        assert rm.loop_for(new) is loop_new
        rm.stop_all()

    def test_repromotion_after_park_counts_a_cold_start(self, tmp_path):
        rm = ResidencyManager()
        ca = _mk_coll(tmp_path, "rp")
        rm.loop_for(ca)
        assert rm.snapshot()["tenants"]["rp"]["cold_starts"] == 1
        rm.park("rp")
        assert rm.snapshot()["tenants"]["rp"]["resident"] is False
        rm.loop_for(ca)
        snap = rm.snapshot()["tenants"]["rp"]
        assert snap["resident"] is True and snap["cold_starts"] == 2
        assert len(rm.coldstart_ms) == 2
        assert _count("tenancy.coldstart") == 2
        rm.stop_all()


class TestSingleFlight:
    def test_concurrent_cold_queries_build_once(self, tmp_path,
                                                monkeypatch):
        rm = ResidencyManager()
        coll = _mk_coll(tmp_path, "sf")
        builds = []
        real = engine.get_device_index

        def counting(c):
            builds.append(c.name)
            return real(c)

        monkeypatch.setattr(engine, "get_device_index", counting)
        loops, errors = [], []
        start = threading.Barrier(8)

        def worker():
            try:
                start.wait(timeout=30)
                loops.append(rm.loop_for(coll))
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)

        ts = [threading.Thread(target=worker, daemon=True)
              for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert not errors, errors
        assert builds == ["sf"]  # one build for 8 concurrent queries
        assert len(set(map(id, loops))) == 1
        assert rm.snapshot()["tenants"]["sf"]["cold_starts"] == 1
        rm.stop_all()

    def test_expired_rider_sheds_instead_of_waiting(self):
        rm = ResidencyManager()
        rm._flights["rx"] = tenancy_mod._Flight()  # a leader in progress
        coll = types.SimpleNamespace(name="rx")
        with pytest.raises(deadline_mod.DeadlineExceeded):
            rm.loop_for(coll, deadline=deadline_mod.Deadline.after(0.0))
        assert _count("tenancy.rider_shed") == 1
        assert _count("tenancy.singleflight_join") >= 1

    def test_leader_failure_propagates_then_clears(self, tmp_path,
                                                   monkeypatch):
        rm = ResidencyManager()
        coll = _mk_coll(tmp_path, "lf")

        def boom(c):
            raise RuntimeError("build failed")

        monkeypatch.setattr(engine, "get_device_index", boom)
        with pytest.raises(RuntimeError, match="build failed"):
            rm.loop_for(coll)
        assert rm._flights == {}  # the failed flight is not wedged
        monkeypatch.undo()
        assert rm.loop_for(coll).alive
        rm.stop_all()


class TestPressure:
    def test_device_pressure_parks_cold_tenant_before_others(
            self, tmp_path):
        """A device-label cap breach parks the least recent tenant
        (priority 10) and never reaches a higher-priority handler."""
        rm = ResidencyManager()
        rm.attach(g_membudget)
        ca, cb = _mk_coll(tmp_path, "va"), _mk_coll(tmp_path, "vb")
        rm.loop_for(ca)
        rm.loop_for(cb)
        used = g_membudget.used("device")
        assert used > 0
        high_prio_calls = []
        g_membudget.add_pressure_handler(
            lambda need: high_prio_calls.append(need) or 0,
            priority=100, key="t.cacheish")
        try:
            g_membudget.set_label_cap("device", used)
            assert g_membudget.reserve("device", 1)
            g_membudget.release("device", 1)
        finally:
            g_membudget.set_label_cap("device", 0)
        assert rm.resident_names() == ["vb"]
        assert _count("tenancy.pressure_evict") == 1
        assert not high_prio_calls
        rm.stop_all()


class TestColdHotParity:
    def test_repromoted_tenant_answers_identically(self, tmp_path):
        """Park a tenant, promote it again through a query: results equal
        the always-resident run, the one-shot batch and the JAX
        package's resident answer on the same documents."""
        coll = _mk_coll(tmp_path / "t", "parity")
        jc = JCollection("parity", tmp_path / "j")
        jc.conf.pqr_enabled = False
        jdocproc.index_document(jc, "http://parity.test/p",
                                DOC.format(t="parity"))
        for i in range(4):
            for c, m in ((coll, docproc), (jc, jdocproc)):
                m.index_document(c, f"http://parity.test/extra{i}",
                                 DOC.format(t=f"extra{i} walrus herd"))
        reference = search_device_batch(coll, QUERIES, topk=10,
                                        site_cluster=False)
        hot = search_device_batch(coll, QUERIES, topk=10,
                                  site_cluster=False, resident=True)
        assert g_residency.snapshot()["tenants"]["parity"]["resident"]
        g_residency.park("parity")
        assert coll._device_index is None
        warm = search_device_batch(coll, QUERIES, topk=10,
                                   site_cluster=False, resident=True)
        assert g_residency.snapshot()["tenants"]["parity"][
            "cold_starts"] == 2
        try:
            jax_res = jengine.search_device_batch(
                jc, QUERIES, topk=10, site_cluster=False, resident=True)
        finally:
            jresidency.release("parity")
        for q, a, b, c, j in zip(QUERIES, reference, hot, warm, jax_res):
            assert b.total_matches == a.total_matches == c.total_matches, q
            assert sorted(map(_key, b.results)) \
                == sorted(map(_key, a.results)) \
                == sorted(map(_key, c.results)), q
            assert_tie_run_parity(
                (np.array([r.docid for r in c.results], np.uint64),
                 np.array([r.score for r in c.results]), c.total_matches),
                (np.array([r.docid for r in j.results], np.uint64),
                 np.array([r.score for r in j.results]), j.total_matches),
                q)


class TestMemBudget:
    def test_gauge_from_gc_inside_reserve_returns(self):
        """A ``gc.callbacks`` hook (a finalizer's stand-in) sets a gauge
        while ``reserve`` holds the budget's lock, on the same thread:
        the call returns within 5 s and the gauge lands at the next
        locked call."""
        class Collecting(MemBudget):
            def _used_locked(self):
                if self.collect_once:
                    self.collect_once = False
                    gc.collect()  # the collector runs inside the lock
                return super()._used_locked()

        mb = Collecting(limit=1 << 30)
        mb.collect_once = False
        fired = []

        def on_gc(phase, info):
            if phase == "stop" and not fired:
                fired.append(threading.get_ident())
                mb.set_gauge("cache", "finalized", 4096)

        done = threading.Event()

        def run():
            mb.collect_once = True
            assert mb.reserve("merge", 1024)
            done.set()

        gc.callbacks.append(on_gc)
        try:
            t = threading.Thread(target=run, daemon=True)
            t.start()
            t.join(timeout=5)
        finally:
            gc.callbacks.remove(on_gc)
        assert done.is_set() and not t.is_alive()
        assert fired == [t.ident]  # the callback ran on reserve's thread
        assert mb.used("cache") == 4096
        assert mb.used("merge") == 1024

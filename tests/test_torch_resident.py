"""The port's resident serving loop (``query/resident.py``) — parity,
ordering, freshness, mid-flight drain, stop and respawn (CPU).

Mirrors ``tests/test_resident.py`` against the port's DeviceIndex: the
loop's issue/collect split answers exactly as one-shot
``search_device_batch`` does; results come back for the plans submitted,
in submit order, under concurrent submitters; a write while waves are in
flight drains them against their issue-time index and every later submit
is issued against a refreshed one. On the golden corpus the port's
``search_device_batch(resident=True)`` equals the JAX package's: totals
exact, scores rtol=1e-5, docids by complete tie runs. Every wait has a
timeout and every loop is stopped at teardown."""

import threading

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
from open_source_search_engine_tpu_torch.query.compiler import compile_query
from open_source_search_engine_tpu_torch.query.engine import (
    get_device_index, get_resident_loop, search_device_batch)
from open_source_search_engine_tpu_torch.query.resident import ResidentLoop
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils import deadline as deadline_mod
from open_source_search_engine_tpu_torch.utils.chaos import ChaosError, g_chaos
from open_source_search_engine_tpu_torch.utils.priority import QueueFull
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc
from tests.golden.corpus import GOLDEN_QUERIES, golden_docs

#: the tier-1 run shares the host's cores among several workers
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection while this module drives the JAX package's
    device index (``tests/jax_gc.py``)."""
    with jax_gc.quiet():
        yield


WAIT_S = 60

DOCS = {
    "http://a.example.com/fruit": """
      <html><head><title>Fruit basics</title></head><body>
      <p>The apple is sweet. A banana is tropical. Apple pie wins.</p>
      </body></html>""",
    "http://b.example.com/apple": """
      <html><head><title>Apple orchard</title></head><body>
      <p>Our orchard grows apple trees. Apple harvest is in fall.</p>
      </body></html>""",
    "http://c.example.org/banana": """
      <html><head><title>Banana farm</title></head><body>
      <p>Banana plantations export banana bunches worldwide.</p>
      </body></html>""",
    "http://d.example.org/cellar": """
      <html><head><title>Vegetables</title></head><body>
      <p>Carrots and beets. Root cellar storage tips.</p></body></html>""",
}

QUERIES = ["apple", "banana", "apple banana", "fruit", "cellar",
           "orchard apple", "zeppelin"]


@pytest.fixture(autouse=True)
def _stop_loops():
    """Every loop a test starts through the tenant plane stops here."""
    yield
    g_residency.reset()
    jresidency.reset()


@pytest.fixture()
def coll(tmp_path):
    c = Collection("res", tmp_path, device="cpu")
    c.conf.pqr_enabled = False
    for u, h in DOCS.items():
        docproc.index_document(c, u, h)
    return c


def _key(r):
    return (-round(r.score, 3), r.docid)


def _plans(qs):
    return [compile_query(q) for q in qs]


def _raw(res):
    return (np.array([r.docid for r in res.results], np.uint64),
            np.array([r.score for r in res.results]), res.total_matches)


class TestParity:
    def test_resident_matches_one_shot_batch(self, coll):
        one_shot = search_device_batch(coll, QUERIES, topk=10,
                                       site_cluster=False)
        res = search_device_batch(coll, QUERIES, topk=10,
                                  site_cluster=False, resident=True)
        for q, a, b in zip(QUERIES, one_shot, res):
            assert b.total_matches == a.total_matches, q
            assert sorted(map(_key, b.results)) == \
                sorted(map(_key, a.results)), q

    def test_raw_ticket_matches_search_batch(self, coll):
        di = get_device_index(coll)
        ref = di.search_batch(_plans(QUERIES), topk=64, lang=0)
        loop = get_resident_loop(coll)
        got = loop.submit(_plans(QUERIES), topk=64, lang=0).wait(WAIT_S)
        assert len(got) == len(ref)
        for q, (rd, rs, rn), (gd, gs, gn) in zip(QUERIES, ref, got):
            assert gn == rn, q
            assert list(gs) == list(rs) and list(gd) == list(rd), q

    def test_golden_resident_matches_jax(self, tmp_path):
        """The golden corpus through both packages' resident loops, with
        a results lock held around the port's page build."""
        jc = JCollection("gold", tmp_path / "j")
        tc = Collection("gold", tmp_path / "t", device="cpu")
        for c in (jc, tc):
            c.conf.pqr_enabled = False
        for url, html in golden_docs().items():
            jdocproc.index_document(jc, url, html)
            docproc.index_document(tc, url, html)
        want = jengine.search_device_batch(
            jc, GOLDEN_QUERIES, topk=10, with_snippets=False,
            site_cluster=False, resident=True)
        got = search_device_batch(
            tc, GOLDEN_QUERIES, topk=10, with_snippets=False,
            site_cluster=False, resident=True,
            results_lock=threading.Lock())
        for q, a, b in zip(GOLDEN_QUERIES, got, want):
            assert_tie_run_parity(_raw(a), _raw(b), q)

    def test_batches_in_flight_keep_their_own_results(self, coll):
        """Two issued batches collected in reverse order: each keeps its
        own result rows (no shared fetch buffer)."""
        di = get_device_index(coll)
        qa, qb = QUERIES[:4], QUERIES[4:]
        ra, rb = di.search_batch(qa, topk=64), di.search_batch(qb, topk=64)
        pa, pb = di.issue_batch(qa, topk=64), di.issue_batch(qb, topk=64)
        assert pa.fetch is not None and pb.fetch is not None
        assert pa.fetch[0] is not pb.fetch[0]
        for want, got in ((rb, di.collect_batch(pb)),
                          (ra, di.collect_batch(pa))):
            for (wd, ws, wn), (gd, gs, gn) in zip(want, got):
                assert gn == wn and list(gs) == list(ws) \
                    and list(gd) == list(wd)


class TestOrdering:
    def test_concurrent_submits_get_their_own_results(self, coll):
        """16 threads × 4 rounds submit distinct queries concurrently;
        every ticket resolves to its own query's results."""
        di = get_device_index(coll)
        ref = {}
        for q in QUERIES:
            ((d, s, n),) = di.search_batch(_plans([q]), topk=64, lang=0)
            ref[q] = (sorted(d.tolist()), n)
        loop = get_resident_loop(coll)
        errors = []
        start = threading.Barrier(16)

        def worker(i):
            try:
                start.wait(timeout=30)
                for r in range(4):
                    q = QUERIES[(i + r) % len(QUERIES)]
                    t = loop.submit(_plans([q]), topk=64, lang=0)
                    ((d, s, n),) = t.wait(timeout=WAIT_S)
                    assert (sorted(d.tolist()), n) == ref[q], q
            except BaseException as exc:  # noqa: BLE001
                errors.append((i, exc))

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert not errors, errors
        assert loop.waves_issued >= 1

    def test_one_submit_many_plans_keeps_plan_order(self, coll):
        loop = get_resident_loop(coll)
        got = loop.submit(_plans(QUERIES), topk=64, lang=0).wait(WAIT_S)
        ref = get_device_index(coll).search_batch(_plans(QUERIES), topk=64)
        for (rd, rs, rn), (gd, gs, gn) in zip(ref, got):
            assert gn == rn and list(gs) == list(rs)


class TestFreshness:
    def test_write_bumps_generation_and_serves_fresh(self, coll):
        loop = get_resident_loop(coll)
        t0 = loop.submit(_plans(["apple"]), topk=64, lang=0)
        t0.wait(timeout=WAIT_S)
        gen0 = t0.generation
        assert gen0 == t0.di._built_version
        docproc.index_document(
            coll, "http://e.example.com/durian",
            "<html><title>Durian</title><body>"
            "<p>The durian fruit is pungent.</p></body></html>")
        assert coll.posdb.version != gen0
        t1 = loop.submit(_plans(["durian"]), topk=64, lang=0)
        ((docids, scores, n),) = t1.wait(timeout=WAIT_S)
        assert n >= 1 and len(docids) >= 1
        assert t1.generation != gen0
        assert t1.generation == t1.di._built_version

    def test_midflight_write_drains_before_refresh(self, coll):
        di = get_device_index(coll)
        gen_before = di._built_version
        loop = ResidentLoop(lambda: get_device_index(coll),
                            lambda: coll.posdb.version, name="midflight")
        try:
            first = loop.submit(_plans(["banana"]), topk=64, lang=0)
            first.wait(timeout=WAIT_S)
            docproc.index_document(
                coll, "http://f.example.com/mango",
                "<html><title>Mango</title><body>"
                "<p>Mango season, mango juice.</p></body></html>")
            tickets = [loop.submit(_plans(["mango"]), topk=64, lang=0)
                       for _ in range(6)]
            for t in tickets:
                t.wait(timeout=WAIT_S)
            last = tickets[-1]
            assert last.generation == coll.posdb.version
            ((d, s, n),) = last.wait(timeout=WAIT_S)
            assert n >= 1
            assert gen_before != last.generation
        finally:
            loop.stop()
            assert loop.join(timeout=WAIT_S)


class TestLifecycle:
    def test_stop_fails_fast_and_loop_respawns(self, coll):
        loop = get_resident_loop(coll)
        loop.submit(_plans(["apple"]), topk=64, lang=0).wait(timeout=WAIT_S)
        loop.stop()
        t = loop.submit(_plans(["apple"]), topk=64, lang=0)
        with pytest.raises(RuntimeError):
            t.wait(timeout=10)
        assert loop.join(timeout=WAIT_S)
        loop2 = get_resident_loop(coll)
        assert loop2 is not loop and loop2.alive
        ((d, s, n),) = loop2.submit(_plans(["apple"]), topk=64,
                                    lang=0).wait(timeout=WAIT_S)
        assert n >= 1

    def test_full_queue_and_expired_deadline_fail_the_ticket(self, coll):
        """A full queue fails the ticket with QueueFull, a deadline that
        ran out while queued abandons it before issue, and an expired
        bound deadline stops the engine before dispatch; the loop keeps
        serving."""
        g_stats.reset()
        full = ResidentLoop(lambda: get_device_index(coll),
                            lambda: coll.posdb.version, name="full",
                            max_queue=0)
        try:
            with pytest.raises(QueueFull):
                full.submit(_plans(["apple"])).wait(timeout=10)
        finally:
            full.stop()
            assert full.join(timeout=WAIT_S)
        assert g_stats.snapshot()["counters"]["admission.queue_full"] == 1
        loop = get_resident_loop(coll)
        late = loop.submit(_plans(["apple"]),
                           deadline=deadline_mod.Deadline.after(0.0))
        with pytest.raises(deadline_mod.DeadlineExceeded):
            late.wait(timeout=WAIT_S)
        assert loop.submit(_plans(["apple"])).wait(WAIT_S)[0][2] >= 1
        with deadline_mod.bind(deadline_mod.Deadline.after(0.0)):
            with pytest.raises(deadline_mod.DeadlineExceeded):
                search_device_batch(coll, ["apple"], resident=True)
        counters = g_stats.snapshot()["counters"]
        assert counters["deadline.abandoned.resident.issue"] == 1
        assert counters["deadline.abandoned.device.dispatch"] == 1
        assert counters["resident.issue"] >= 1

    def test_chaos_faults_fail_the_wave_not_the_loop(self, coll):
        """With the resident.loop chaos point armed at rate 1, every
        issue and collect stalls or drops: a dropped collect fails that
        wave's tickets with ChaosError, a stall only delays it; the loop
        keeps serving, and the same seed replays the same schedule."""
        g_stats.reset()
        loop = get_resident_loop(coll)
        g_chaos.enable(seed=7, rate=1.0, delay_s=0.001)
        try:
            outcomes = []
            for _ in range(6):
                t = loop.submit(_plans(["apple"]))
                try:
                    outcomes.append(t.wait(WAIT_S)[0][2])
                except ChaosError:
                    outcomes.append("dropped")
            fired = sum(v for k, v in g_stats.snapshot()["counters"].items()
                        if k.startswith("chaos.resident.loop."))
            # the replay: one issue and one collect decision per ticket
            g_chaos.enable(seed=7, rate=1.0)
            kinds = [g_chaos.decide("resident.loop") for _ in range(12)]
        finally:
            g_chaos.disable()
        assert fired == 12
        assert outcomes == ["dropped" if k == "drop_collect" else 2
                            for k in kinds[1::2]]
        assert "dropped" in outcomes and 2 in outcomes
        assert loop.alive
        assert loop.submit(_plans(["apple"])).wait(WAIT_S)[0][2] >= 1

"""The chaos plane's Rdb and membudget points in the port
(``utils/chaos.py``: ``rdb.read`` / ``flipbyte``, ``membudget.reserve`` /
``pressure``), on the CPU.

The scenarios of ``tests/test_chaos.py`` that use those points, against
the port: a flipped byte in a posting run trips the scrub's CRC
quarantine and is never served; the ``rdb.read`` seam fires from
``Rdb.get_list``; forced pressure runs the shed pass before a reservation
that fits, and unarmed the same reservation touches no handler. The off
plane decides nothing at any point, and a seed decides the same schedule
at each new point as the JAX package's plane.
"""

import pytest
import torch

from open_source_search_engine_tpu.utils.chaos import ChaosPlane as JPlane
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index import posdb
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query.engine import \
    search_device_batch
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils import ghash
from open_source_search_engine_tpu_torch.utils.chaos import (DEFAULT_POINTS,
                                                             ChaosPlane,
                                                             g_chaos)
from open_source_search_engine_tpu_torch.utils.membudget import MemBudget
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """The collector collects before and after this module and stays off
    inside it (``tests/jax_gc.py``): the JAX package's tests that a
    worker runs next start from no leftover garbage."""
    with jax_gc.quiet():
        yield

NEW_POINTS = ("rdb.read", "membudget.reserve")


@pytest.fixture(autouse=True)
def _chaos_reset():
    """Every test starts unarmed with clean counters and leaves the
    process-wide plane unarmed."""
    g_chaos.disable()
    g_stats.reset()
    yield
    g_chaos.disable()
    g_residency.reset()


def _count(name: str) -> int:
    return g_stats.snapshot()["counters"].get(name, 0)


def _doc(i, words="cluster shared words"):
    return (f"<html><head><title>Doc {i}</title></head><body>"
            f"<p>{words} token{i}.</p></body></html>")


def _coll(tmp_path, name: str) -> Collection:
    coll = Collection(name, tmp_path, device="cpu")
    coll.conf.pqr_enabled = False
    for i in range(20):
        docproc.index_document(coll, f"http://{name}.test/p{i}", _doc(i))
    assert coll.posdb.dump() is not None  # an on-disk run to maim
    return coll


class TestPoints:
    def test_off_is_noop(self):
        p = ChaosPlane()
        assert not p.enabled
        assert all(p.decide(pt) is None for pt in DEFAULT_POINTS)
        assert set(NEW_POINTS) <= set(DEFAULT_POINTS)
        assert DEFAULT_POINTS["rdb.read"] == ("flipbyte",)
        assert DEFAULT_POINTS["membudget.reserve"] == ("pressure",)

    @pytest.mark.parametrize("point", NEW_POINTS)
    def test_same_seed_same_schedule_as_the_reference(self, point):
        mine, ref = ChaosPlane(), JPlane()
        for p in (mine, ref):
            p.enable(42, rate=0.5)
        a = [mine.decide(point, key="k") for _ in range(64)]
        b = [ref.decide(point, key="k") for _ in range(64)]
        assert a == b
        assert any(k is not None for k in a) and any(k is None for k in a)


class TestRdbChaos:
    def test_flipped_byte_trips_scrub_quarantine(self, tmp_path):
        coll = _coll(tmp_path, "chaosrdb")
        g_chaos.enable(31, rate=0.0)
        target = g_chaos.corrupt_one_run(coll.posdb)
        assert target is not None
        assert _count("chaos.rdb.corrupted") == 1
        quarantined = coll.posdb.scrub()
        assert quarantined  # the CRC verify tripped: the bytes never serve
        assert _count("rdb.corrupt_quarantined") >= 1
        g_chaos.disable()
        # the engine still answers from the surviving state
        res = search_device_batch(coll, ["cluster"], topk=5)
        assert res is not None

    def test_rdb_read_seam_fires_via_decide(self, tmp_path):
        coll = _coll(tmp_path, "chaosrdb2")
        g_chaos.enable(37, rate=0.0)
        g_chaos.configure("rdb.read", rate=1.0, kinds=("flipbyte",))
        tid = ghash.term_id("cluster")
        coll.posdb.get_list(posdb.start_key(tid), posdb.end_key(tid))
        assert g_chaos.fired("rdb.read").get("flipbyte", 0) >= 1
        assert coll.posdb.scrub()  # the seam corrupted a real run

    def test_no_run_no_flip(self, tmp_path):
        coll = Collection("chaosempty", tmp_path, device="cpu")
        g_chaos.enable(3, rate=0.0)
        assert g_chaos.corrupt_one_run(coll.posdb) is None
        assert _count("chaos.rdb.corrupted") == 0


class TestMemBudgetChaos:
    def test_forced_pressure_runs_shed_pass(self):
        budget = MemBudget(limit=1 << 20)
        calls = []

        def handler(need):
            calls.append(need)
            return 0

        budget.add_pressure_handler(handler)
        g_chaos.enable(41, rate=0.0)
        g_chaos.configure("membudget.reserve", rate=1.0,
                          kinds=("pressure",))
        # the reservation fits; chaos still forces the shed pass
        assert budget.reserve("chaostest", 1024) is True
        assert calls and calls[0] == 1024
        assert g_chaos.fired("membudget.reserve").get("pressure", 0) >= 1
        budget.release("chaostest", 1024)
        # unarmed, the same reservation never touches the handlers
        g_chaos.disable()
        calls.clear()
        assert budget.reserve("chaostest", 1024) is True
        assert not calls
        budget.release("chaostest", 1024)

    def test_forced_device_pressure_runs_the_device_handlers(self):
        """A device label's forced pass is the device relief pass: the
        handlers registered for the device label run."""
        budget = MemBudget(limit=1 << 20)
        seen = []

        def device_handler(need):
            seen.append("dev")
            return 0

        # held weakly: the local name keeps it alive
        budget.add_pressure_handler(device_handler, label="device")
        g_chaos.enable(43, rate=0.0)
        g_chaos.configure("membudget.reserve", rate=1.0,
                          kinds=("pressure",))
        assert budget.reserve("device", 4096) is True
        assert seen == ["dev"]
        budget.release("device", 4096)

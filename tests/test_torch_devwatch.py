"""The port's device telemetry plane (``utils/devwatch.py``) against the
JAX package's, on the CPU.

The scenarios of ``tests/test_devwatch.py`` run against the port: the
HBM ledger across refresh, park and promote; the flight recorder's
bounded ring and issue → wait → collect split; roofline entries per
(kernel, shape bucket), the first dispatch paying the work count; the
off switch as a true no-op; ``/admin/hbm``, ``/admin/device``,
``/admin/perf``'s HBM row and ``/metrics``' ``osse_hbm_bytes``.

Cross-package, exact: the same records give the same ledger column for
column; the same request sequence gives the same ``devindex.*`` roofline
keys, dispatches and modelled bytes, and ``wave_bytes_per_query`` is
float-equal for the same plans; a ``statsdb.jsonl`` written by either
server is byte-identical for the same ticks (rotation included) and read
by the other, a torn line costing one sample. The port's roofline work
is its own count (``work()`` beside each kernel), so its ``flops`` and
``bytes`` are not compared with XLA's cost model.
"""

import gc
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query.compiler import \
    compile_query as jcompile
from open_source_search_engine_tpu.query.devindex import \
    DeviceIndex as JDeviceIndex
from open_source_search_engine_tpu.serve.server import \
    SearchHTTPServer as JServer
from open_source_search_engine_tpu.utils import devwatch as jdevwatch
from open_source_search_engine_tpu.utils.stats import g_stats as jstats
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import (ROUTE_ENV,
                                                        ROUTE_QUERIES,
                                                        route_docs)
from open_source_search_engine_tpu_torch.index.carry import \
    collection_from_arrays
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.query import fd_scores_kernel as fdk
from open_source_search_engine_tpu_torch.query import \
    min_scores_kernel as msk
from open_source_search_engine_tpu_torch.query.compiler import compile_query
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex
from open_source_search_engine_tpu_torch.serve.server import SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import (
    ResidencyManager, g_residency)
from open_source_search_engine_tpu_torch.utils import devwatch
from open_source_search_engine_tpu_torch.utils.membudget import g_membudget
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)

DOC = ("<html><head><title>{t}</title></head><body>"
       "<p>walrus {t} herd gathers on the {t} shore. "
       "The walrus colony of {t} dives deep.</p></body></html>")


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection while this module drives the JAX package's
    device index (``tests/jax_gc.py``)."""
    with jax_gc.quiet():
        yield


@pytest.fixture(autouse=True)
def _devwatch_reset():
    """Both planes are process-wide singletons: every test starts and
    ends with them disarmed and empty."""
    for dw in (devwatch, jdevwatch):
        dw.disable()
        dw.reset()
    g_stats.reset()
    yield
    for dw in (devwatch, jdevwatch):
        dw.disable()
        dw.reset()
    g_membudget.set_label_cap("device", 0)
    g_residency.reset()


def _mk_coll(tmp_path, name: str, docs: int = 1) -> Collection:
    c = Collection(name, tmp_path, device="cpu")
    c.conf.pqr_enabled = False
    for i in range(docs):
        docproc.index_document(c, f"http://{name}.test/p{i}",
                               DOC.format(t=f"{name}{i}"))
    return c


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------

class TestLedger:
    def test_register_replace_release(self):
        devwatch.enable()
        devwatch.note_columns("ca", "devindex", {"doc": 100, "imp": 50})
        assert devwatch.collection_bytes("ca") == 150
        # re-noting a (coll, plane) replaces the slice
        devwatch.note_columns("ca", "devindex", {"doc": 200})
        assert devwatch.collection_bytes("ca") == 200
        devwatch.note_buffer("ca", "mesh_stage", "wave1", 30)
        assert devwatch.collection_bytes("ca") == 230
        devwatch.drop_buffer("ca", "mesh_stage", "wave1")
        assert devwatch.collection_bytes("ca") == 200
        devwatch.note_columns("cb", "devindex", {"doc": 10})
        assert devwatch.g_devwatch.total_bytes() == 210
        devwatch.drop("ca")  # every plane dies with the collection
        assert devwatch.collection_bytes("ca") == 0
        assert devwatch.g_devwatch.total_bytes() == 10
        assert g_stats.snapshot()["gauges"]["hbm.devindex.bytes"] == 10
        assert g_stats.snapshot()["gauges"]["hbm.total.bytes"] == 10
        # a tensor registers its bytes
        devwatch.note_columns("cc", "devindex",
                              {"x": torch.zeros(7, dtype=torch.int16)})
        assert devwatch.collection_bytes("cc") == 14

    def test_disabled_records_nothing(self):
        devwatch.note_columns("ca", "devindex", {"doc": 100})
        assert devwatch.collection_bytes("ca") == 0
        assert devwatch.wave_begin("test") is None
        snap = devwatch.snapshot()
        assert snap["enabled"] is False
        assert snap["ledger"] == {} and snap["waves"] == []

    def test_reconcile_null_safe_on_cpu(self):
        devwatch.enable()
        devwatch.note_columns("ca", "devindex", {"doc": 100})
        rec = devwatch.reconcile()
        assert rec["ledger_bytes"] == 100
        assert rec["devices"], rec
        for d in rec["devices"]:  # no CUDA: one CPU entry, nulls
            assert d["bytes_in_use"] is None and d["headroom"] is None
        json.dumps(rec)
        # the entry has the reference's keys
        jdevwatch.enable()
        jrec = jdevwatch.reconcile()
        assert sorted(rec) == sorted(jrec)
        assert sorted(rec["devices"][0]) == sorted(jrec["devices"][0])

    def test_delta_fold_lifecycle_tracks_resident_bytes(self, tmp_path):
        devwatch.enable()
        coll = _mk_coll(tmp_path, "dfl", docs=2)
        di = engine.get_device_index(coll)
        assert devwatch.collection_bytes("dfl") == di.resident_bytes()
        # the device build's staging slice was dropped at registration
        assert ("(ingest)", "build") not in devwatch.g_devwatch.ledger
        docproc.index_document(coll, "http://dfl.test/extra",
                               DOC.format(t="extra"))
        # drop the slice by hand: the fold must note it again
        devwatch.drop("dfl")
        assert di.refresh() is True
        assert devwatch.collection_bytes("dfl") == di.resident_bytes() > 0
        ledger = devwatch.g_devwatch.ledger_snapshot()["dfl"]["devindex"]
        assert ledger == {k: t.numel() * t.element_size()
                          for k, t in di.columns().items()}

    def test_park_releases_promote_reregisters(self, tmp_path):
        devwatch.enable()
        rm = ResidencyManager(max_resident=1)
        try:
            ca = _mk_coll(tmp_path / "a", "pka")
            cb = _mk_coll(tmp_path / "b", "pkb")
            rm.loop_for(ca)
            na = devwatch.collection_bytes("pka")
            assert na > 0
            rm.loop_for(cb)  # parks pka (LRU): the ledger drops the slice
            assert devwatch.collection_bytes("pka") == 0
            assert devwatch.collection_bytes("pkb") > 0
            rm.loop_for(ca)  # re-promotion registers again, same bytes
            assert devwatch.collection_bytes("pka") == na
        finally:
            rm.stop_all()

    def test_tenant_bytes_come_from_the_ledger(self, tmp_path):
        devwatch.enable()
        rm = ResidencyManager()
        try:
            c = _mk_coll(tmp_path, "tb")
            rm.loop_for(c)
            t = rm.snapshot()["tenants"]["tb"]
            assert t["device_bytes"] == devwatch.collection_bytes("tb") > 0
        finally:
            rm.stop_all()


    @pytest.mark.parametrize("via", ["engine", "server"])
    def test_a_failed_wave_does_not_keep_its_index(self, tmp_path, via):
        """(5j)'s census on the card found a whole stale index held by a
        failed wave: its error's traceback kept the frames that held its
        tickets, and the tickets kept the error (a reference cycle only
        the collector's full pass frees). With the collector off, a
        failed wave's index goes with the last reference to it."""
        from open_source_search_engine_tpu_torch.query import devcheck
        srv = None
        if via == "server":
            srv = SearchHTTPServer(tmp_path, port=0, device="cpu")
            coll = srv.colldb.get("main")
            coll.conf.pqr_enabled = False
            for i in range(3):
                docproc.index_document(coll, f"http://fw.test/p{i}",
                                       DOC.format(t=f"fw{i}"))
        else:
            coll = _mk_coll(tmp_path, "fw", docs=3)
        # the module keeps the collector off (``jax_gc.quiet``): collect
        # once, and leave it as it was found
        was_enabled = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            ref = weakref.ref(engine.get_device_index(coll))
            devcheck.set_enabled(True)
            try:
                with devcheck.inject("nan"):
                    if srv is None:
                        try:
                            engine.search_device_batch(coll, ["walrus"],
                                                       topk=8, resident=True)
                        except devcheck.DeviceCheckError as exc:
                            where = [f.name for f in traceback.extract_tb(
                                exc.__traceback__)]
                        else:
                            raise AssertionError("the fault did not trip")
                        # the error keeps the frames where the wave failed
                        assert "collect_batch" in where, where
                    else:
                        code, body, _ = srv.handle(
                            "GET", "/search", {"q": "walrus"}, b"")
                        assert code == 500, (code, body[:200])
            finally:
                devcheck.set_enabled(False)
            # the census waits for the stopped loop's thread: until it
            # has run the ``finally`` of the wave it failed, its running
            # frame still holds that wave (tickets, index)
            loop = coll._resident_loop
            if srv is not None:
                srv.stop()
                srv._batcher._pool.shutdown(wait=True)
                srv._batcher._thread.join(30)
            g_residency.reset()
            assert loop.join(30), "the stopped loop's thread did not end"
            del loop
            coll._device_index = None
            assert ref() is None, "a failed wave kept its index alive"
        finally:
            if was_enabled:
                gc.enable()

# ---------------------------------------------------------------------------
# wave flight recorder
# ---------------------------------------------------------------------------

class TestFlightRecorder:
    def test_ring_is_bounded(self):
        devwatch.enable()
        for _ in range(devwatch.RING + 40):
            devwatch.wave_end(devwatch.wave_begin("test"))
        snap = devwatch.snapshot()
        assert len(snap["waves"]) == devwatch.RING
        assert snap["totals"]["waves"] == devwatch.RING + 40

    def test_resident_waves_record_the_split(self, tmp_path):
        devwatch.enable()
        coll = _mk_coll(tmp_path, "fr", docs=3)
        loop = engine.get_resident_loop(coll)
        plan = engine._compile_cached("walrus", 0)
        w0 = loop.waves_issued
        for _ in range(3):
            loop.submit([plan], topk=8).wait(timeout=120)
        snap = devwatch.snapshot()
        waves = [w for w in snap["waves"] if w["source"] == "resident"]
        assert len(waves) == loop.waves_issued - w0 == 3
        w = waves[-1]
        for k in ("issue_s", "wait_s", "collect_s", "total_s"):
            assert w[k] >= 0.0
        assert w["error"] is None and w["coll"] == "fr"
        assert w["rounds"], "collect must attach at least one round"
        r = w["rounds"][0]
        assert r["device_s"] >= 0.0 and r["bytes_out"] > 0
        assert "escalations" in r and "modeled_f1_bytes" in r

    def test_error_wave_is_recorded(self):
        devwatch.enable()
        obs = devwatch.wave_begin("test", coll="x")
        devwatch.wave_end(obs, error="BoomError")
        snap = devwatch.snapshot()
        assert snap["waves"][-1]["error"] == "BoomError"
        assert snap["totals"]["wave_errors"] == 1

    def test_mesh_waves_stage_and_note_rounds(self, tmp_path):
        """The mesh's wave operands are a ``mesh_stage`` buffer from issue
        to collect, and its resident loop's waves carry mesh rounds."""
        from open_source_search_engine_tpu_torch.parallel import (
            MeshResident, ShardedCollection, make_mesh)
        from open_source_search_engine_tpu_torch.parallel.sharded import \
            MeshServeIndex
        devwatch.enable()
        sc = ShardedCollection("ms", tmp_path, n_shards=2, device="cpu")
        for i in range(6):
            sc.index_document(f"http://m{i}.test/p", f"<p>mesh words {i}</p>")
        msi = MeshServeIndex(sc, mesh=make_mesh(2, ["cpu"]))
        pending = msi.issue_batch(["mesh words"], topk=5)
        staged = devwatch.g_devwatch.ledger_snapshot()["ms"]["mesh_stage"]
        assert len(staged) == 1 and min(staged.values()) > 0, staged
        msi.collect_batch(pending)
        assert devwatch.g_devwatch.ledger_snapshot()["ms"]["mesh_stage"] \
            == {}
        mr = MeshResident(sc, devices=["cpu"])
        try:
            assert mr.serve("mesh words", topk=5).total_matches == 6
        finally:
            mr.stop()
        rounds = [r for w in devwatch.snapshot()["waves"]
                  for r in w["rounds"]]
        assert rounds and all(r["kinds"] == "mesh" for r in rounds)
        assert all(r["coll"] == "ms" and r["bytes_out"] > 0 for r in rounds)

    def test_round_outside_a_wave_is_counted(self, tmp_path):
        devwatch.enable()
        coll = _mk_coll(tmp_path, "ua", docs=2)
        engine.get_device_index(coll).search_batch(["walrus"], topk=8)
        assert g_stats.snapshot()["counters"][
            "devwatch.rounds_unattached"] >= 1
        assert devwatch.snapshot()["totals"]["rounds"] == 0


# ---------------------------------------------------------------------------
# roofline attribution
# ---------------------------------------------------------------------------

class TestRoofline:
    def test_first_dispatch_pays_later_ones_count(self):
        devwatch.enable()
        calls = []

        def thunk():
            calls.append(1)
            return {"flops": 1000.0, "bytes accessed": 10.0}

        devwatch.note_cost("kern", (4, 8), thunk, modeled_bytes=9)
        devwatch.note_cost("kern", (4, 8), thunk)
        devwatch.note_cost("kern", (8, 8), thunk)
        assert len(calls) == 2  # one count per bucket, dict hit after
        roofs = devwatch.snapshot()["rooflines"]
        assert len(roofs) == 2
        ent = next(e for e in roofs if e["bucket"] == [4, 8])
        assert ent["dispatches"] == 2 and ent["modeled_bytes"] == 9
        assert ent["flops"] == 1000.0 and ent["bytes"] == 10.0
        assert ent["verdict"] in ("bandwidth-bound", "compute-bound")
        assert ent["assumed"] is True  # no card: the CPU row

    def test_cost_error_degrades_to_unknown(self):
        devwatch.enable()

        def bad_thunk():
            raise RuntimeError("no count here")

        devwatch.note_cost("kern", (2,), bad_thunk)
        ent = devwatch.snapshot()["rooflines"][0]
        assert ent["verdict"] == "unknown"
        assert g_stats.snapshot()["counters"]["devwatch.cost_errors"] == 1

    def test_real_query_populates_a_bucket(self, tmp_path):
        devwatch.enable()
        coll = _mk_coll(tmp_path, "rf", docs=3)
        loop = engine.get_resident_loop(coll)
        plan = engine._compile_cached("walrus herd", 0)
        loop.submit([plan], topk=8).wait(timeout=120)
        loop.submit([plan], topk=8).wait(timeout=120)
        roofs = devwatch.snapshot()["rooflines"]
        ent = next(e for e in roofs if e["kernel"].startswith("devindex."))
        assert ent["flops"] > 0 and ent["bytes"] > 0
        assert ent["dispatches"] >= 2
        # the wave's work is the sum of its kernel launches' counts
        k1 = [e for e in roofs if e["kernel"] == "min_scores"]
        assert k1 and sum(e["dispatches"] for e in k1) >= 2

    def test_kernel_entries_count_the_wrappers_calls(self):
        """Each wrapper call is one dispatch of its kernel's entry, keyed
        by shape; the work is the kernel module's own ``work()``."""
        devwatch.enable()
        rng = np.random.default_rng(5)
        from open_source_search_engine_tpu_torch.corpus import (fd_inputs,
                                                                rand_cube)
        cube = torch.from_numpy(rand_cube(rng, 4, 64).view(np.int32))
        fw = torch.full((4,), 0.5)
        counts = torch.tensor([True, True, False, True])
        for _ in range(3):
            msk.min_scores_fused(cube, fw, counts)
        args = tuple(None if a is None else torch.from_numpy(a)
                     for a in fd_inputs(rng, 4, 64, True))
        fdk.fd_scores(*args)
        roofs = {e["kernel"]: e for e in devwatch.snapshot()["rooflines"]}
        nbytes, ops = msk.work(cube, counts)
        assert roofs["min_scores"]["bucket"] == [1, 4, 16, 64]
        assert roofs["min_scores"]["dispatches"] == 3
        assert roofs["min_scores"]["bytes"] == nbytes
        assert roofs["min_scores"]["flops"] == ops
        g_q, g_s, c, dead, _fw, cnt, tail = args
        assert roofs["fd_scores"]["bucket"] == [4, 4, 64, 1]
        assert (roofs["fd_scores"]["bytes"], roofs["fd_scores"]["flops"]) \
            == fdk.work(g_q, g_s, c, dead, cnt, tail)


# ---------------------------------------------------------------------------
# cross-package: ledger, roofline keys, modelled bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def route_pair(tmp_path_factory):
    """The route corpus in the JAX package and carried into the port's
    records; the indexes are built by each test with both planes on."""
    saved = {k: os.environ.get(k) for k in ROUTE_ENV}
    os.environ.update(ROUTE_ENV)
    jr = JCollection("route", tmp_path_factory.mktemp("jroute"))
    jdocproc.index_batch(jr, route_docs(48))
    jr.posdb.dump()
    jr.titledb.dump()
    tit = jr.titledb.get_all()
    tc = collection_from_arrays(
        jr.name, tmp_path_factory.mktemp("troute"),
        np.concatenate([r.batch().keys for r in jr.posdb.runs]),
        tit.keys, tit.payloads(), jr.clusterdb.get_all().keys,
        jr.sectiondb.rdb.get_all().keys, jr.num_docs, device="cpu",
        posdb_mem_keys=jr.posdb.mem.batch().keys)
    yield jr, tc
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


ROUTE_SET = list(ROUTE_QUERIES) + ["alpha gamma", "alpha beta gamma",
                                   "beta", "dogs", "gamma -zeta"]


class TestAgainstTheReference:
    def test_same_records_give_the_same_ledger(self, route_pair):
        jr, tc = route_pair
        devwatch.enable()
        jdevwatch.enable()
        jdi, tdi = JDeviceIndex(jr), DeviceIndex(tc)
        want = jdevwatch.g_devwatch.ledger_snapshot()
        got = devwatch.g_devwatch.ledger_snapshot()
        assert got == want  # collection → plane → column → bytes, exact
        assert devwatch.collection_bytes("route") == tdi.resident_bytes() \
            == jdi.resident_bytes()

    def test_same_requests_give_the_same_rooflines(self, route_pair):
        jr, tc = route_pair
        devwatch.enable()
        jdevwatch.enable()
        jdi, tdi = JDeviceIndex(jr), DeviceIndex(tc)
        for batch in (ROUTE_SET, ROUTE_SET[:3], list(ROUTE_QUERIES)):
            jdi.search_batch(batch, topk=64)
            tdi.search_batch(batch, topk=64)

        def keyed(snap):
            return {(e["kernel"], tuple(e["bucket"])):
                    (e["dispatches"], e["modeled_bytes"])
                    for e in snap["rooflines"]
                    if e["kernel"].startswith("devindex.")}
        want, got = keyed(jdevwatch.snapshot()), keyed(devwatch.snapshot())
        assert got == want
        assert {k for k, _ in got} == {"devindex._two_phase",
                                       "devindex._full_cube",
                                       "devindex._direct_cube"}
        assert any(m for _, m in got.values())  # F1 carries its model

    def test_wave_bytes_per_query_is_float_equal(self, route_pair):
        jr, tc = route_pair
        jdi, tdi = JDeviceIndex(jr), DeviceIndex(tc)
        jplans = [jdi.plan(jcompile(q)) for q in ROUTE_SET]
        tplans = [tdi.plan(compile_query(q)) for q in ROUTE_SET]
        for packed in (True, False):
            for n in (1, 3, len(ROUTE_SET)):
                a = jdi.wave_bytes_per_query(jplans[:n], packed=packed)
                b = tdi.wave_bytes_per_query(tplans[:n], packed=packed)
                assert a == b and a > 0, (n, packed, a, b)


# ---------------------------------------------------------------------------
# OSSE_DEVWATCH unset — true no-op
# ---------------------------------------------------------------------------

class TestNoop:
    def test_subprocess_off_is_true_noop(self):
        code = (
            "import os\n"
            "from open_source_search_engine_tpu_torch.utils import devwatch\n"
            "from open_source_search_engine_tpu_torch.query import devindex\n"
            "devwatch.maybe_enable()\n"
            "assert not devwatch.enabled()\n"
            "devwatch.note_columns('c', 'devindex', {'doc': 1})\n"
            "devwatch.note_round(coll='c')\n"
            "devwatch.note_cost('k', (1,), lambda: 1/0)\n"
            "obs = devwatch.wave_begin('t')\n"
            "assert obs is None\n"
            "devwatch.wave_issued(obs); devwatch.wave_collect(obs)\n"
            "devwatch.wave_end(obs)\n"
            "s = devwatch.snapshot()\n"
            "assert s['enabled'] is False and s['ledger'] == {}\n"
            "assert s['waves'] == [] and s['rooflines'] == []\n"
            "print('NOOP-OK')\n")
        env = dict(os.environ)
        env["OSSE_DEVWATCH"] = "0"
        p = subprocess.run([sys.executable, "-c", code], env=env,
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
        assert p.returncode == 0, p.stderr
        assert "NOOP-OK" in p.stdout

    def test_env_enables_via_device_layer_import(self):
        code = ("from open_source_search_engine_tpu_torch.query import "
                "devindex\n"
                "from open_source_search_engine_tpu_torch.utils import "
                "devwatch\n"
                "assert devwatch.enabled()\n"
                "print('ON-OK')\n")
        env = dict(os.environ)
        env["OSSE_DEVWATCH"] = "1"
        p = subprocess.run([sys.executable, "-c", code], env=env,
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
        assert p.returncode == 0, p.stderr
        assert "ON-OK" in p.stdout

    def test_disabled_calls_are_cheap(self):
        t0 = time.perf_counter()
        for _ in range(20000):
            devwatch.note_round(coll="c", device_s=0.0)
            devwatch.wave_end(devwatch.wave_begin("t"))
        assert time.perf_counter() - t0 < 1.0


# ---------------------------------------------------------------------------
# admin pages
# ---------------------------------------------------------------------------

def _get(srv, path, **q):
    code, body, ctype = srv.handle("GET", path, q, b"")
    assert code == 200, (path, code, body[:300])
    return body


class TestAdminPages:
    @pytest.fixture
    def srv(self, tmp_path):
        devwatch.enable()
        s = SearchHTTPServer(tmp_path, port=0, device="cpu")
        coll = s.colldb.get("main")
        coll.conf.pqr_enabled = False
        for i in range(3):
            docproc.index_document(coll, f"http://m.test/p{i}",
                                   DOC.format(t=f"m{i}"))
        s.start()
        yield s
        s.stop()

    def test_hbm_page_and_json(self, srv):
        _get(srv, "/search", q="walrus", format="json")
        html = _get(srv, "/admin/hbm")
        assert "HBM ledger" in html and "reconciliation" in html
        assert "devindex" in html
        js = json.loads(_get(srv, "/admin/hbm", format="json"))
        assert js["enabled"] is True
        assert js["total_bytes"] == sum(js["collections"].values())
        assert "reconcile" in js and "planes" in js

    def test_device_page_and_json(self, srv):
        _get(srv, "/search", q="walrus", format="json")
        html = _get(srv, "/admin/device")
        assert "wave waterfall" in html and "roofline" in html
        js = json.loads(_get(srv, "/admin/device", format="json"))
        assert js["enabled"] is True
        assert js["totals"]["waves"] >= 1
        assert js["waves"] and js["rooflines"]
        assert "ridge" in js["peaks"] and "label" in js["peaks"]

    def test_perf_page_carries_hbm_row(self, srv):
        js = json.loads(_get(srv, "/admin/perf", format="json"))
        assert "hbm" in js and js["hbm"]["enabled"] is True
        html = _get(srv, "/admin/perf")
        assert "/admin/hbm" in html and "/admin/device" in html

    def test_metrics_export_hbm_series(self, srv):
        _get(srv, "/search", q="walrus", format="json")
        text = _get(srv, "/metrics")
        assert "# TYPE osse_hbm_bytes gauge" in text
        line = next(ln for ln in text.splitlines() if ln.startswith(
            'osse_hbm_bytes{collection="main",plane="devindex"}'))
        assert int(line.split()[-1]) == devwatch.collection_bytes("main")

    def test_pages_keys_equal_the_reference(self, srv, tmp_path):
        jdevwatch.enable()
        j = JServer(tmp_path / "j", port=0)
        try:
            for path in ("/admin/hbm", "/admin/device", "/admin/jit"):
                a = json.loads(_get(srv, path, format="json"))
                b = json.loads(j.handle("GET", path, {"format": "json"},
                                        b"")[1])
                assert sorted(a) == sorted(b), path
                if path == "/admin/jit":
                    assert sorted(a["totals"]) == sorted(b["totals"])
                if path == "/admin/device":
                    assert sorted(a["peaks"]) == sorted(b["peaks"])
        finally:
            jax_gc.release(j)


# ---------------------------------------------------------------------------
# the statsdb sample ring
# ---------------------------------------------------------------------------

class _Ticks:
    """A stop event whose ``wait`` lets ``n`` sampler ticks run."""

    def __init__(self, n: int):
        self.n = n

    def wait(self, timeout=None) -> bool:
        self.n -= 1
        return self.n < 0

    def set(self) -> None:
        self.n = 0

    def clear(self) -> None:
        pass


class TestStatsdb:
    @pytest.fixture
    def pair(self, tmp_path, monkeypatch):
        """A JAX server and a port server (not started), the clock fixed
        and both registries empty."""
        monkeypatch.setattr(time, "time", lambda: 1790000000.25)
        for sub in ("j", "t"):
            (tmp_path / sub).mkdir()
        j = JServer(tmp_path / "j", port=0)
        t = SearchHTTPServer(tmp_path / "t", port=0, device="cpu")
        jstats.reset()
        g_stats.reset()
        yield j, t
        jax_gc.release(j)
        t.stop()

    @staticmethod
    def _tick(srv, n: int) -> bytes:
        srv._stop_sampling = _Ticks(n)
        srv._sample_loop()
        return srv._statsdb_path.read_bytes()

    def test_lines_are_byte_identical(self, pair):
        j, t = pair
        assert self._tick(j, 3) == self._tick(t, 3)
        line = t._statsdb_path.read_text().splitlines()[0]
        assert json.loads(line) == [1790000000.25, {
            "qps": 0.0, "budget_rejects": 0, "check_trips": 0}]
        # the sample ring got the same samples
        assert [m for _, m in g_stats.series(last_s=1e12)] == \
            [m for _, m in jstats.series(last_s=1e12)]

    def test_rotation_at_512_writes_is_the_reference_s(self, pair):
        j, t = pair
        old = "".join(json.dumps([float(i), {"qps": float(i)}]) + "\n"
                      for i in range(1700))
        for srv in (j, t):
            srv._statsdb_path.write_text(old)
        a, b = self._tick(j, 512), self._tick(t, 512)
        assert a == b
        assert len(b.decode().splitlines()) == 2000

    def test_each_reads_the_other_s_file(self, pair):
        j, t = pair
        self._tick(j, 2)
        self._tick(t, 2)
        jfile, tfile = j._statsdb_path, t._statsdb_path
        torn = b'[1790000001.0, {"qps": 3.5}]\n[17900000'
        jfile.write_bytes(jfile.read_bytes() + torn)
        tfile.write_bytes(tfile.read_bytes() + torn)
        jstats.timeseries.clear()
        g_stats.timeseries.clear()
        # swap: each server reads the file the other wrote
        j._statsdb_path, t._statsdb_path = tfile, jfile
        j._load_statsdb()
        t._load_statsdb()
        assert list(g_stats.timeseries) == list(jstats.timeseries)
        assert len(g_stats.timeseries) == 3
        assert g_stats.timeseries[-1] == (1790000001.0, {"qps": 3.5})
        for reg in (g_stats, jstats):
            assert reg.snapshot()["counters"]["statsdb.corrupt_lines"] == 1

    def test_graph_page_draws_the_ring(self, pair):
        _, t = pair
        g_stats.sample(qps=2.0, p50_ms=5.0)
        g_stats.sample(qps=4.0, p50_ms=3.0)
        svg = t.handle("GET", "/admin/graph", {}, b"")[1]
        assert svg.startswith("<svg") and "polyline" in svg
        assert "qps (max 4.0)" in svg

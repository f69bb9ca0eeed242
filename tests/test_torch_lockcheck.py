"""The port's runtime lock auditor (``utils/lockcheck.py``) on the CPU.

The scenarios of ``tests/test_lockcheck.py`` against the port:
order-graph cycles, held sets and hold times, the contention counter,
the blocking-call probes, and the factories' ``OSSE_LOCKCHECK`` gate.
They drive a private :class:`LockCheckRegistry` (never the process
singleton), so no assertion sees another test's edges, and they hold
whether or not ``OSSE_LOCKCHECK`` is set for the run. The same drive
gives the JAX package's registry the same report. In a subprocess under
``OSSE_LOCKCHECK=1``, a port server answering ``/search`` and
``/inject`` records no lock-order cycle.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from open_source_search_engine_tpu.utils import lockcheck as jlockcheck
from open_source_search_engine_tpu_torch.utils import lockcheck
from open_source_search_engine_tpu_torch.utils.lockcheck import (
    LockCheckRegistry, TrackedLock, TrackedRLock,
)
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """The collector collects before and after this module and stays off
    inside it (``tests/jax_gc.py``): the JAX package's tests that a
    worker runs next start from no leftover garbage."""
    with jax_gc.quiet():
        yield


@pytest.fixture
def reg():
    return LockCheckRegistry()


class TestOrderGraph:
    def test_nested_acquire_records_edge(self, reg):
        a = TrackedLock("A", reg)
        b = TrackedLock("B", reg)
        with a:
            with b:
                pass
        assert reg.edges == {"A": {"B"}}
        assert reg.cycles == []
        info = reg.edge_info[("A", "B")]
        assert threading.current_thread().name in info

    def test_ab_then_ba_is_a_cycle(self, reg):
        """The classic potential deadlock: one code path takes A→B,
        another B→A. Neither run deadlocks alone; the auditor must
        still flag the pair."""
        a = TrackedLock("A", reg)
        b = TrackedLock("B", reg)
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert len(reg.cycles) == 1
        cycle = reg.cycles[0]
        assert set(cycle) == {"A", "B"}
        # the cycle is also visible in the serialized report
        assert reg.report()["cycles"] == [cycle]

    def test_transitive_cycle_detected(self, reg):
        """A→B, B→C, then C→A closes a 3-lock loop."""
        a, b, c = (TrackedLock(n, reg) for n in "ABC")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with a:
                pass
        assert len(reg.cycles) == 1
        assert set(reg.cycles[0]) == {"A", "B", "C"}

    def test_same_name_reentry_is_not_an_edge(self, reg):
        """Two instances of one lock ROLE (e.g. two per-Rdb locks)
        produce no self-edge — the convention is per role name."""
        a1 = TrackedLock("rdb", reg)
        a2 = TrackedLock("rdb", reg)
        with a1:
            with a2:
                pass
        assert reg.edges == {}
        assert reg.cycles == []

    def test_consistent_order_never_cycles(self, reg):
        a = TrackedLock("A", reg)
        b = TrackedLock("B", reg)
        for _ in range(3):
            with a:
                with b:
                    pass
        assert reg.edges == {"A": {"B"}}
        assert reg.cycles == []

    def test_cross_thread_edges_combine(self, reg):
        """Thread 1 takes A→B, thread 2 takes B→A: the graph is
        global, so the cycle is still caught."""
        a = TrackedLock("A", reg)
        b = TrackedLock("B", reg)

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass
        th = threading.Thread(target=t1, daemon=True)
        th.start()
        th.join()
        th = threading.Thread(target=t2, daemon=True)
        th.start()
        th.join()
        assert len(reg.cycles) == 1


class TestHeldSetAndHoldTimes:
    def test_held_is_per_thread_and_ordered(self, reg):
        a = TrackedLock("outer", reg)
        b = TrackedLock("inner", reg)
        with a:
            with b:
                assert reg.held() == ["outer", "inner"]
            assert reg.held() == ["outer"]
        assert reg.held() == []
        seen = []
        t = threading.Thread(target=lambda: seen.extend(reg.held()),
                             daemon=True)
        with a:
            t.start()
            t.join()
        assert seen == []  # other thread holds nothing

    def test_release_records_hold_time_stat(self, reg):
        name = "lockcheck-test-hold"
        before = g_stats.snapshot()["latencies"].get(
            f"lock.{name}.held_ms", {}).get("count", 0)
        lk = TrackedLock(name, reg)
        with lk:
            time.sleep(0.002)
        snap = g_stats.snapshot()["latencies"][f"lock.{name}.held_ms"]
        assert snap["count"] == before + 1

    def test_rlock_reentry_tracks_outermost_only(self, reg):
        lk = TrackedRLock("R", reg)
        other = TrackedLock("S", reg)
        with lk:
            with lk:  # re-entry: no new ordering info
                assert reg.held() == ["R"]
                with other:
                    pass
            assert reg.held() == ["R"]
        assert reg.held() == []
        assert reg.edges == {"R": {"S"}}

    def test_acquire_release_protocol(self, reg):
        lk = TrackedLock("P", reg)
        assert lk.acquire() is True
        assert lk.locked()
        lk.release()
        assert not lk.locked()
        assert lk.acquire(blocking=False) is True
        lk.release()


@pytest.fixture
def probed(reg):
    """Point the probes at the test registry, restoring whatever was
    installed before (under OSSE_LOCKCHECK=1 the suite itself runs
    with global probes on — install_probes is idempotent, so the test
    must swap them out, not stack on top)."""
    was_global = lockcheck._probes_installed
    lockcheck.uninstall_probes()
    lockcheck.install_probes(reg)
    yield reg
    lockcheck.uninstall_probes()
    if was_global:
        lockcheck.install_probes()


class TestBlockingProbes:
    def test_sleep_under_lock_is_flagged(self, reg, probed):
        lk = TrackedLock("nap", reg)
        with lk:
            time.sleep(0)
        assert len(reg.blocking) == 1
        ev = reg.blocking[0]
        assert ev["call"] == "time.sleep"
        assert ev["held"] == ["nap"]

    def test_sleep_without_lock_is_not_flagged(self, reg, probed):
        time.sleep(0)
        assert reg.blocking == []

    def test_uninstall_restores_originals(self, probed):
        probe_sleep = time.sleep
        lockcheck.uninstall_probes()
        try:
            assert time.sleep is not probe_sleep
            assert not lockcheck._probes_installed
        finally:
            lockcheck.install_probes(probed)


class TestFactoryGating:
    def test_factories_match_env_gate(self):
        a = lockcheck.make_lock("gate-test")
        b = lockcheck.make_rlock("gate-test-r")
        if lockcheck.ENABLED:
            assert isinstance(a, TrackedLock)
            assert isinstance(b, TrackedRLock)
        else:
            # plain primitives: zero audit overhead when off
            assert not isinstance(a, TrackedLock)
            assert not isinstance(b, TrackedLock)
        # both support the context protocol either way
        with a:
            pass
        with b:
            with b:
                pass

    def test_reset_clears_registry(self, reg):
        a = TrackedLock("A", reg)
        b = TrackedLock("B", reg)
        with a:
            with b:
                pass
        reg.reset()
        assert reg.report() == {"edges": {}, "edge_info": {},
                                "cycles": [], "cycle_stacks": [],
                                "blocking": []}


class TestContentionAndCycleStacks:
    def test_contended_acquire_counts_stat(self, reg):
        """A blocked acquire bumps ``lock.<name>.contended`` — the
        telemetry that says WHICH lock serializes the fleet."""
        name = "lockcheck-test-contend"
        key = f"lock.{name}.contended"
        lk = TrackedLock(name, reg)
        before = g_stats.snapshot()["counters"].get(key, 0)
        lk.acquire()
        t = threading.Thread(target=lambda: (lk.acquire(), lk.release()),
                             daemon=True)
        t.start()
        time.sleep(0.02)  # let the thread block on the held lock
        lk.release()
        t.join(timeout=5)
        assert g_stats.snapshot()["counters"][key] == before + 1

    def test_uncontended_acquire_does_not_count(self, reg):
        name = "lockcheck-test-uncontend"
        key = f"lock.{name}.contended"
        before = g_stats.snapshot()["counters"].get(key, 0)
        lk = TrackedLock(name, reg)
        with lk:
            pass
        assert g_stats.snapshot()["counters"].get(key, 0) == before

    def test_cycle_report_carries_both_acquisition_stacks(self, reg):
        """The DFS cycle report names where EACH edge of the inversion
        was taken — both sides of the A→B / B→A pair."""
        a = TrackedLock("A", reg)
        b = TrackedLock("B", reg)
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert len(reg.cycle_stacks) == 1
        stacks = reg.cycle_stacks[0]
        assert set(stacks) == {"A->B", "B->A"}
        me = threading.current_thread().name
        assert all(me in where for where in stacks.values())
        assert reg.report()["cycle_stacks"] == [stacks]


def _drive(mod):
    """One drive of a package's auditor: A→B, B→C, C→A, a re-entrant
    lock over a plain one, a same-role pair; returns the report without
    the stack payloads (frames differ by file)."""
    reg = mod.LockCheckRegistry()
    a, b, c = (mod.TrackedLock(n, reg) for n in "ABC")
    r = mod.TrackedRLock("R", reg)
    for x, y in ((a, b), (b, c), (c, a), (r, a)):
        with x:
            with y:
                pass
    with r:
        with r:
            pass
    with mod.TrackedLock("rdb", reg):
        with mod.TrackedLock("rdb", reg):
            pass
    rep = reg.report()
    return {"edges": rep["edges"], "cycles": rep["cycles"],
            "cycle_edges": [sorted(s) for s in rep["cycle_stacks"]],
            "edge_keys": sorted(rep["edge_info"])}


def test_same_drive_same_report_as_the_reference():
    assert _drive(lockcheck) == _drive(jlockcheck)


_SERVER_PROBE = """
import json, sys, tempfile, threading, urllib.request
sys.path.insert(0, {root!r})
from open_source_search_engine_tpu_torch.utils import lockcheck
assert lockcheck.ENABLED and lockcheck._probes_installed
from open_source_search_engine_tpu_torch.serve.server import SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils.stats import g_stats
srv = SearchHTTPServer(tempfile.mkdtemp(), port=0, device="cpu")
assert isinstance(srv._lock, lockcheck.TrackedRLock)
srv.start()
base = "http://127.0.0.1:%d" % srv.port
def get(path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        assert r.status == 200, (path, r.status)
        return r.read()
def post(path, body):
    req = urllib.request.Request(base + path, data=body.encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200, (path, r.status)
for i in range(6):
    post("/inject?u=http://l%d.test/p" % i,
         "<html><title>lock %d</title><p>order audit words %d</p></html>"
         % (i, i))
errs = []
def client(c):
    try:
        for q in ("order audit", "audit words", "lock", "words"):
            json.loads(get("/search?format=json&q=" + q.replace(" ", "+")))
        post("/inject?u=http://c%d.test/" % c, "<p>client %d words</p>" % c)
    except BaseException as e:
        errs.append(repr(e))
ts = [threading.Thread(target=client, args=(c,)) for c in range(4)]
for t in ts: t.start()
for t in ts: t.join(120)
assert not errs, errs
assert json.loads(get("/search?format=json&q=words"))["totalMatches"] == 10
srv.stop()
g_residency.reset()
rep = lockcheck.g_lockcheck.report()
ctr = g_stats.snapshot()
print(json.dumps({{"cycles": rep["cycles"], "edges": rep["edges"],
                  "cycle_count": ctr["counters"].get("lockcheck.cycle", 0),
                  "held": sorted(k for k in ctr["latencies"]
                                 if k.startswith("lock."))}}))
"""


def test_served_search_and_inject_record_no_cycle(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OSSE_LOCKCHECK"] = "1"
    out = subprocess.run(
        [sys.executable, "-c", _SERVER_PROBE.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["cycles"] == [] and rep["cycle_count"] == 0, rep
    # the factories handed out tracked primitives: the server's core lock
    # was held and timed
    assert "lock.server.core.held_ms" in rep["held"], rep["held"]


def test_page_lookups_survive_a_concurrent_refresh(tmp_path):
    """The fault the served drive above met: the resident loop's thread
    refreshes the index (a new doc axis) while the batcher's thread
    builds a page from the same index (``sitehash_of``, ``langid_of``).
    The lazy views are kept with the doc axis they were built for, so a
    lookup never pairs one axis's view with the other's rows."""
    from open_source_search_engine_tpu_torch.build import docproc
    from open_source_search_engine_tpu_torch.index.collection import \
        Collection
    from open_source_search_engine_tpu_torch.query.devindex import \
        DeviceIndex
    c = Collection("axis", tmp_path, device="cpu")
    c.conf.pqr_enabled = False
    for i in range(6):
        docproc.index_document(c, f"http://a{i}.test/", f"<p>axis {i}</p>")
    di = DeviceIndex(c)
    errors: list = []
    stop = threading.Event()

    def pages():
        while not stop.is_set():
            try:
                for d in di.all_docids:
                    di.sitehash_of(int(d))
                    di.langid_of(int(d))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
                return

    t = threading.Thread(target=pages, daemon=True)
    t.start()
    try:
        for i in range(8):
            docproc.index_document(c, f"http://b{i}.test/",
                                   f"<p>axis more {i}</p>")
            di.refresh()
    finally:
        stop.set()
        t.join(30)
    assert not errors, errors[:3]
    fresh = DeviceIndex(c)
    assert [di.sitehash_of(int(d)) for d in fresh.all_docids] == \
        [fresh.sitehash_of(int(d)) for d in fresh.all_docids]
    assert [di.langid_of(int(d)) for d in fresh.all_docids] == \
        [fresh.langid_of(int(d)) for d in fresh.all_docids]

"""Schedule-explorer scenarios for the port's serving protocols.

The port's counterpart of ``tests/sched_scenarios.py``, which imports
the JAX package; this module drives ``open_source_search_engine_tpu_torch``
only and imports no JAX. Each scenario is a zero-argument callable that
builds its own world (threads through ``utils.threads``, primitives
through the ``lockcheck`` factories, so everything cooperates with the
active exploration) and asserts the protocol's interleaving invariant.
``explore(fn)`` runs it under N seeded schedules; an assertion, a
deadlock or a leaked thread fails the schedule, which shrinks to a
minimal preemption trace.

The six scenarios: the resident loop's refresh, tenancy's promotion, the
cache plane's generations, the admission quota, the Rdb against the
daily merge, and a page build against the index's refresh (the race
``test_torch_lockcheck.py::test_page_lookups_survive_a_concurrent_refresh``
holds closed). ``make_buggy_cache_cls`` and ``make_buggy_gate_cls``
reintroduce, in the test only, two interleaving bugs of the reference's
history (the generation re-read at put, the lone hog's displacement
share): ``explore`` must find both within a bounded budget.
"""

from __future__ import annotations

import tempfile
import types
from datetime import datetime

import numpy as np

from open_source_search_engine_tpu_torch.utils import deadline as deadline_mod
from open_source_search_engine_tpu_torch.utils import threads
from open_source_search_engine_tpu_torch.utils.schedcheck import (
    sched_point, settle)


# --------------------------------------------------------------------------
# 1. resident loop: drain-then-refresh vs in-flight waves
# --------------------------------------------------------------------------


class _FakeDI:
    """Duck-typed DeviceIndex: issue/collect with sched points so the
    explorer can preempt mid-wave."""

    def __init__(self, version: int):
        self._built_version = version

    def issue_batch(self, plans, topk: int = 64, lang: int = 0):
        sched_point("di.issue")
        return [("wave", self._built_version, len(plans))]

    def collect_batch(self, pending):
        sched_point("di.collect")
        return [(None, None, 0)] * pending[0][2]

    def resident_bytes(self) -> int:
        return 1024


def scenario_resident_refresh() -> None:
    """A write landing mid-flight must neither starve refresh (the
    post-write ticket resolves in bounded virtual time) nor leak a
    stale generation onto a ticket submitted after the write."""
    from open_source_search_engine_tpu_torch.query import resident

    gen = {"v": 0}
    loop = resident.ResidentLoop(lambda: _FakeDI(gen["v"]),
                                 gen_fn=lambda: gen["v"], name="sched")
    try:
        t0 = loop.submit([("plan", 0)])

        def writer() -> None:
            sched_point("rdb.write")
            gen["v"] += 1
            sched_point("rdb.write.done")

        w = threads.spawn("writer", writer)
        t0.wait(timeout=30.0)        # liveness: the wave resolves
        w.join()
        want = gen["v"]              # stable: the only writer is done
        t1 = loop.submit([("plan", 1)])
        t1.wait(timeout=30.0)        # liveness: refresh window opened
        # drain-then-refresh: a ticket submitted AFTER the write
        # completed is issued against the refreshed base, never the
        # pre-write in-flight snapshot
        assert t1.generation == want, (t1.generation, want)
        assert t0.generation is not None
    finally:
        loop.stop()


# --------------------------------------------------------------------------
# 2. tenancy: single-flight promotion, rider expiry, leader failure
# --------------------------------------------------------------------------


def scenario_tenancy_promotion() -> None:
    from open_source_search_engine_tpu_torch.query import engine
    from open_source_search_engine_tpu_torch.serve import \
        tenancy as tenancy_mod

    built = {"n": 0, "fail_first": True}

    def fake_gdi(coll):
        sched_point("engine.build")
        if built["fail_first"]:
            built["fail_first"] = False
            raise RuntimeError("leader build failed")
        built["n"] += 1
        return _FakeDI(0)

    orig = engine.get_device_index
    engine.get_device_index = fake_gdi
    rm = tenancy_mod.ResidencyManager()
    coll = types.SimpleNamespace(
        name="rx", posdb=types.SimpleNamespace(version=0))
    try:
        # leader failure: the error propagates to the leader and the
        # flight is cleared — no rider can wedge on a dead flight
        try:
            rm.loop_for(coll)
            raise AssertionError("leader failure did not propagate")
        except RuntimeError as exc:
            assert "leader build failed" in str(exc)
        assert rm._flights == {}, rm._flights

        # rider expiry: an expired deadline sheds out of a wedged
        # flight instead of queueing blind behind it
        rm._flights["rx"] = tenancy_mod._Flight()
        try:
            rm.loop_for(coll, deadline=deadline_mod.Deadline.after(0.0))
            raise AssertionError("expired rider did not shed")
        except deadline_mod.DeadlineExceeded:
            pass
        rm._flights.pop("rx")

        # single-flight: concurrent cold hits elect ONE leader; every
        # rider gets the same live loop and the index builds once
        got: list = []

        def hit(i: int) -> None:
            got.append(rm.loop_for(coll))

        ws = [threads.spawn(f"hit{i}", hit, i) for i in range(3)]
        for t in ws:
            t.join()
        assert len(got) == 3 and len({id(x) for x in got}) == 1, got
        assert built["n"] == 1, built["n"]
    finally:
        rm.stop_all()
        engine.get_device_index = orig


# --------------------------------------------------------------------------
# 3. cache plane: entry-time generation stamping vs concurrent writes
# --------------------------------------------------------------------------


def _cache_value_compute(gen: dict):
    def compute():
        v = gen["v"]                 # the data this compute actually read
        sched_point("cache.compute")
        return ("val", v)
    return compute


def scenario_cache_generation(cache_cls=None) -> None:
    """A value served under pinned generation g can never be a
    pre-write (older-generation) compute. The GenCache stamps entries
    with the generation captured at get_or_compute ENTRY; re-reading it
    at put time is the historical bug (:func:`make_buggy_cache_cls`)."""
    from open_source_search_engine_tpu_torch.cache import plane as plane_mod

    cls = cache_cls or plane_mod.GenCache
    gen = {"v": 0}
    cache = cls("schedgen", ttl_s=60.0, gen_fn=lambda: gen["v"])
    compute = _cache_value_compute(gen)

    def writer() -> None:
        sched_point("gen.bump")
        gen["v"] += 1

    def reader(i: int) -> None:
        cache.get_or_compute("k", compute)
        g0 = gen["v"]                # pin a generation...
        hit, hv = cache.lookup("k", gen=g0)
        if hit:                      # ...anything served under it must
            assert hv[1] >= g0, \
                f"pre-write value {hv} served as generation {g0}"

    ws = [threads.spawn("writer", writer),
          threads.spawn("r0", reader, 0),
          threads.spawn("r1", reader, 1)]
    for t in ws:
        t.join()


# --------------------------------------------------------------------------
# 4. admission gate: quota displacement vs grant ordering
# --------------------------------------------------------------------------


def scenario_admission_quota(gate_cls=None) -> None:
    """With the queue full of one hog's waiters, an under-share quiet
    arrival displaces the hog's newest waiter (reason ``quota``) and is
    eventually granted — it never sheds ``queue_full``. Grant order
    stays FIFO for the survivors."""
    from open_source_search_engine_tpu_torch.serve import \
        admission as admission_mod

    cls = gate_cls or admission_mod.AdmissionGate
    gate = cls(max_inflight=1, max_queue=2, max_wait_s=30.0,
               degraded_fn=lambda: False, pressure_fn=lambda: False)
    sheds: dict = {"quiet": None, "hogs": []}
    ran: list = []

    def hog_waiter(i: int) -> None:
        try:
            with gate.admit("interactive", tenant="hog"):
                sched_point("hog.run")
                ran.append(f"hog{i}")
        except admission_mod.Shed as exc:
            sheds["hogs"].append(exc.reason)

    def quiet() -> None:
        try:
            with gate.admit("interactive", tenant="quiet"):
                sched_point("quiet.run")
                ran.append("quiet")
        except admission_mod.Shed as exc:
            sheds["quiet"] = exc.reason

    slot = gate.admit("interactive", tenant="hog")   # hog holds the slot
    ws = [threads.spawn("hog1", hog_waiter, 1),
          threads.spawn("hog2", hog_waiter, 2)]
    settle()                         # both hog waiters queued: queue full
    ws.append(threads.spawn("quiet", quiet))
    settle()                         # the quiet arrival hits a full queue
    slot.__exit__(None, None, None)  # free the slot; grants drain FIFO
    for t in ws:
        t.join()
    assert sheds["quiet"] is None, \
        f"quiet tenant shed {sheds['quiet']!r} with a displaceable hog queued"
    assert "quiet" in ran, (ran, sheds)
    assert sheds["hogs"] == ["quota"], sheds  # newest hog waiter displaced
    assert gate._inflight == 0
    assert sum(len(q) for q in gate._waiting.values()) == 0


# --------------------------------------------------------------------------
# 5. Rdb write lock vs DailyMerge sweep
# --------------------------------------------------------------------------


def scenario_rdb_dailymerge() -> None:
    """Concurrent adds/dumps and forced DailyMerge sweeps conserve the
    key set exactly — the seed's unlocked merge-vs-writer mutation can
    never reappear without this failing."""
    import shutil

    from open_source_search_engine_tpu_torch.control import dailymerge
    from open_source_search_engine_tpu_torch.index import posdb, rdblite

    d = tempfile.mkdtemp(prefix="schedrdb")
    try:
        rdb = rdblite.Rdb("sched", d, posdb.KEY_DTYPE)
        batches = [posdb.pack(termid=np.arange(1, 9) + 100 * b,
                              docid=np.arange(1, 9) + 1000 * b,
                              wordpos=np.full(8, b))
                   for b in range(1, 4)]

        def writer() -> None:
            for i, k in enumerate(batches):
                sched_point(f"rdb.add.{i}")
                rdb.add(k)
                rdb.dump()

        def merger() -> None:
            dm = dailymerge.DailyMerge(
                [types.SimpleNamespace(rdbs=lambda: {"sched": rdb})],
                types.SimpleNamespace(merge_quiet_hours="2-5"))
            sched_point("merge.sweep")
            assert dm.tick(now=datetime(2026, 1, 1, 3, 0))
            sched_point("merge.force")
            rdb.attempt_merge(force=True)

        ts = [threads.spawn("writer", writer),
              threads.spawn("merger", merger)]
        for t in ts:
            t.join()
        rdb.attempt_merge(force=True)
        allk = np.sort(np.concatenate(batches), order=("n2", "n1", "n0"))
        got = rdb.get_list(allk[0], allk[-1])
        assert len(got) == len(allk), (len(got), len(allk))
    finally:
        shutil.rmtree(d, ignore_errors=True)


# --------------------------------------------------------------------------
# 6. a page build against the index's refresh
# --------------------------------------------------------------------------


def scenario_page_build_refresh() -> None:
    """The resident loop's thread refreshes a DeviceIndex (a new doc
    axis) while the batcher's thread builds a page from it
    (``sitehash_of``, ``langid_of``). The lazy views are kept with the
    doc axis they were built for, so a lookup preempted between the
    cluster columns and the docid view never pairs one axis's view with
    the other's rows, and every lookup answers as a fresh index does."""
    import shutil

    from open_source_search_engine_tpu_torch.build import docproc
    from open_source_search_engine_tpu_torch.index.collection import \
        Collection
    from open_source_search_engine_tpu_torch.query.devindex import \
        DeviceIndex

    d = tempfile.mkdtemp(prefix="schedpage")
    try:
        c = Collection("axis", d, device="cpu")
        c.conf.pqr_enabled = False
        for i in range(3):
            docproc.index_document(c, f"http://a{i}.test/",
                                   f"<p>axis {i}</p>")
        di = DeviceIndex(c)
        cluster_cols, docid_pos = di._cluster_cols, di._docid_pos

        def cluster_cols_point():
            sched_point("di.cluster_cols")
            return cluster_cols()

        def docid_pos_point(*a):
            sched_point("di.docid_pos")
            return docid_pos(*a)

        di._cluster_cols, di._docid_pos = cluster_cols_point, \
            docid_pos_point
        seen: list = []

        def pages() -> None:
            for _ in range(2):
                for dd in di.all_docids:
                    seen.append((int(dd), di.sitehash_of(int(dd)),
                                 di.langid_of(int(dd))))

        def refresher() -> None:
            for i in range(2):
                docproc.index_document(c, f"http://b{i}.test/",
                                       f"<p>axis more {i}</p>")
                sched_point("di.refresh")
                di.refresh()

        ts = [threads.spawn("pages", pages),
              threads.spawn("refresh", refresher)]
        for t in ts:
            t.join()
        fresh = DeviceIndex(c)
        want = {int(dd): (fresh.sitehash_of(int(dd)),
                          fresh.langid_of(int(dd)))
                for dd in fresh.all_docids}
        assert seen, "the page thread read nothing"
        for dd, sh, lg in seen:
            assert want[dd] == (sh, lg), (dd, sh, lg, want[dd])
    finally:
        shutil.rmtree(d, ignore_errors=True)


#: name → zero-argument scenario
SCENARIOS = {
    "resident_refresh": scenario_resident_refresh,
    "tenancy_promotion": scenario_tenancy_promotion,
    "cache_generation": scenario_cache_generation,
    "admission_quota": scenario_admission_quota,
    "rdb_dailymerge": scenario_rdb_dailymerge,
    "page_build_refresh": scenario_page_build_refresh,
}


# --------------------------------------------------------------------------
# seeded historical bugs (test-local — NEVER in the tree)
# --------------------------------------------------------------------------


def make_buggy_cache_cls():
    """The generation-stamp race, reintroduced: the entry is stamped
    with the generation RE-READ at put time instead of the one captured
    at entry, so a write landing during the compute makes a pre-write
    value pass as post-write fresh."""
    from open_source_search_engine_tpu_torch.cache import plane as plane_mod

    class BuggyGenCache(plane_mod.GenCache):
        def get_or_compute(self, key, compute, ttl_s=None,
                           gen=plane_mod._UNSET, swr_s=0.0):
            hit, v = self.lookup(key, gen=gen)
            if hit:
                return v, "hit"
            value = compute()
            sched_point("buggy.put")
            # BUG: gen defaults to _UNSET here, so put() re-reads
            # gen_fn() NOW — post-write — instead of the entry-time gen
            self.put(key, value, ttl_s=ttl_s, gen=gen)
            return value, "miss"

    return BuggyGenCache


def make_buggy_gate_cls():
    """The lone hog's displacement bug, reintroduced: the victim's
    share is computed WITHOUT counting the not-yet-queued arrival, so a
    lone hog's share is infinite, displacement never fires, and the
    quiet tenant sheds queue_full."""
    from open_source_search_engine_tpu_torch.serve import \
        admission as admission_mod

    class BuggyGate(admission_mod.AdmissionGate):
        def _displace_locked(self, tenant):
            if self._t_queued.get(tenant, 0) + 1 > \
                    self._share_locked(tenant):
                return False
            from open_source_search_engine_tpu_torch.utils.priority \
                import TIERS
            for t in reversed(TIERS):
                q = self._waiting[t]
                for i in range(len(q) - 1, -1, -1):
                    victim = q[i]
                    vt = victim.get("tenant")
                    if vt is None or vt == tenant:
                        continue
                    # BUG: no extra=tenant — the arrival isn't counted
                    # as active, a lone hog divides by one tenant
                    if self._t_queued.get(vt, 0) > self._share_locked(vt):
                        del q[i]
                        self._t_queued[vt] = \
                            self._t_queued.get(vt, 1) - 1
                        victim["shed"] = "quota"
                        self._cv.notify_all()
                        return True
            return False

    return BuggyGate

"""The port's cache plane (``cache/plane.py``) against the JAX package's,
and the caches the port puts on it (CPU).

Every ``GenCache`` scenario of ``tests/test_cacheplane.py`` runs on both
packages' class with the same steps and must give the same outcomes:
generation invalidation, the default generation, None values, eviction
of dead generations first, single-flight (one compute, a leader's error
reaching its followers, no join across a generation move, a write
during the compute leaving a dead entry), stale-while-revalidate (never
across a generation move) and the disabled cache. Then the port's own
wiring: the registry, memory pressure shedding caches before refusing
work, a finalizer's gauge drop that never takes the membudget lock, the
compiled-plan cache and the DeviceIndex plan cache (hit on a repeat,
miss after a write, and an escalated plan's learned floor giving the
same escalation counts as the JAX package under the same sequence)."""

import gc
import threading
import time

import pytest
import torch

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.cache import GenCache as JGenCache
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query.devindex import \
    DeviceIndex as JDeviceIndex
from open_source_search_engine_tpu.serve.tenancy import \
    g_residency as jresidency
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.cache import GenCache, g_cacheplane
from open_source_search_engine_tpu_torch.corpus import (ROUTE_ENV,
                                                        route_docs)
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils.membudget import g_membudget
from tests import jax_gc
from tests.polling import wait_until

torch.set_num_threads(1)

IMPLS = {"jax": JGenCache, "torch": GenCache}


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection while JAX package caches live
    (``tests/jax_gc.py``); both tenant planes are left empty."""
    with jax_gc.quiet():
        yield
        # inside the quiet block: what parking frees is collected with
        # no lock held
        jresidency.reset()
        g_residency.reset()


# ---------------------------------------------------------------------------
# GenCache scenarios: each returns its observable outcomes
# ---------------------------------------------------------------------------

def s_generation(C):
    c = C("t.gen", ttl_s=60)
    c.put("k", "old", gen=1)
    out = [c.lookup("k", gen=1), c.lookup("k", gen=2)]
    c.put("k", "new", gen=2)
    return out + [c.lookup("k", gen=2)]


def s_gen_fn(C):
    gen = [1]
    c = C("t.genfn", ttl_s=60, gen_fn=lambda: gen[0])
    c.put("k", "v")
    out = [c.get("k"), c.current_gen()]
    gen[0] = 2
    return out + [c.get("k"), c.current_gen()]


def s_none_values(C):
    c = C("t.none", ttl_s=60)
    c.put("k", None)
    return [c.lookup("k"), c.lookup("absent")]


def s_eviction_dead_first(C):
    c = C("t.evict", ttl_s=60, max_entries=4)
    for i in range(3):
        c.put(("dead", i), i, gen=1)
    c.put(("live", 0), 0, gen=2)
    c.put(("live", 1), 1, gen=2)
    return [c.lookup(("live", 0), gen=2), c.lookup(("live", 1), gen=2),
            sorted(c._d), c.evictions]


def s_single_flight(C):
    c = C("t.sf", ttl_s=60)
    n, calls, statuses = 8, [], []
    barrier, lock = threading.Barrier(n), threading.Lock()

    def compute():
        calls.append(1)
        time.sleep(0.25)  # hold the flight open while the others join
        return "answer"

    def worker():
        barrier.wait()
        v, status = c.get_or_compute("hot", compute)
        with lock:
            statuses.append((v, status))

    ts = [threading.Thread(target=worker) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    kinds = [s for _, s in statuses]
    return [len(calls), {v for v, _ in statuses}, kinds.count("miss"),
            set(kinds) <= {"miss", "join", "hit"}, len(statuses)]


def s_leader_error(C):
    c = C("t.sferr", ttl_s=60)
    entered, errors = threading.Event(), []

    def compute():
        entered.set()
        time.sleep(0.1)
        raise RuntimeError("boom")

    def caller(who, wait):
        if wait:
            entered.wait(5)
        try:
            c.get_or_compute("k", compute)
        except RuntimeError as e:
            errors.append((who, str(e)))

    ts = [threading.Thread(target=caller, args=("leader", False)),
          threading.Thread(target=caller, args=("follower", True))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    return [("leader", "boom") in errors, len(errors)]


def s_write_during_compute(C):
    gen = [1]
    c = C("t.race", ttl_s=60, gen_fn=lambda: gen[0])

    def compute():
        gen[0] = 2  # a write lands mid-compute
        return "pre-write"
    return [c.get_or_compute("k", compute), c.lookup("k")]


def s_no_join_across_generations(C):
    gen = [1]
    c = C("t.sfgen", ttl_s=60, gen_fn=lambda: gen[0])
    entered, release, out = threading.Event(), threading.Event(), {}

    def slow_pre_write():
        entered.set()
        release.wait(5)
        return "pre-write"

    t = threading.Thread(target=lambda: out.update(
        leader=c.get_or_compute("k", slow_pre_write)))
    t.start()
    entered.wait(5)
    gen[0] = 2  # the write lands while the leader computes
    follower = c.get_or_compute("k", lambda: "post-write")
    release.set()
    t.join(timeout=10)
    return [follower, out["leader"], c.lookup("k")]


def s_swr(C):
    c = C("t.swr", ttl_s=0.05)
    versions = iter(["v1", "v2"])
    first = c.get_or_compute("k", lambda: next(versions))
    time.sleep(0.08)  # past the TTL, inside the swr window
    stale = c.get_or_compute("k", lambda: next(versions), swr_s=10.0)
    wait_until(lambda: c.get("k") == "v2", timeout=5,
               desc="background refresh")
    return [first, stale, c.get("k"), c.stats()["stale_served"]]


def s_swr_generation(C):
    c = C("t.swrgen", ttl_s=0.05)
    c.put("k", "old", gen=1)
    time.sleep(0.08)
    return [c.get_or_compute("k", lambda: "new", gen=2, swr_s=10.0)]


def s_swr_refresh_during_write(C):
    gen = [1]
    c = C("t.swrrace", ttl_s=0.05, gen_fn=lambda: gen[0])
    c.put("k", "old")
    time.sleep(0.08)

    def refresh_with_write():
        gen[0] = 2
        return "pre-write"
    stale = c.get_or_compute("k", refresh_with_write, swr_s=10.0)

    def idle():
        with c._lock:
            return "k" not in c._inflight
    wait_until(idle, timeout=5, desc="refresh done")
    return [stale, c.lookup("k")]


def s_disabled(C):
    c = C("t.off", ttl_s=60)
    c.enabled = False
    c.put("k", "v")
    return [c.lookup("k"), c.get_or_compute("k", lambda: "computed"),
            c.stats()["entries"]]


def s_invalidate_flush_stats(C):
    c = C("t.flush", ttl_s=60, desc="d")
    c.put("a", "x" * 100, gen=1)
    c.put("b", "y", gen=1)
    c.invalidate("b")
    st = c.stats()
    out = [c.lookup("b", gen=1), st["entries"], st["bytes"], st["hits"],
           st["misses"], st["desc"]]
    freed = c.flush()
    return out + [freed, c.stats()["entries"], c.stats()["bytes"]]


SCENARIOS = [s_generation, s_gen_fn, s_none_values, s_eviction_dead_first,
             s_single_flight, s_leader_error, s_write_during_compute,
             s_no_join_across_generations, s_swr, s_swr_generation,
             s_swr_refresh_during_write, s_disabled,
             s_invalidate_flush_stats]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_gencache_matches_the_jax_package(scenario):
    want = scenario(IMPLS["jax"])
    got = scenario(IMPLS["torch"])
    assert got == want


def test_gencache_outcomes():
    """What the shared scenarios must give (the reference's asserts)."""
    assert s_generation(GenCache) == [(True, "old"), (False, None),
                                      (True, "new")]
    assert s_single_flight(GenCache)[:3] == [1, {"answer"}, 1]
    assert s_leader_error(GenCache) == [True, 2]
    assert s_write_during_compute(GenCache) == [("pre-write", "miss"),
                                                (False, None)]
    assert s_no_join_across_generations(GenCache) == [
        ("post-write", "miss"), ("pre-write", "miss"), (False, None)]
    assert s_swr(GenCache) == [("v1", "miss"), ("v1", "stale"), "v2", 1]
    assert s_swr_generation(GenCache) == [("new", "miss")]
    assert s_disabled(GenCache) == [(False, None), ("computed", "miss"), 0]


# ---------------------------------------------------------------------------
# the port's plane
# ---------------------------------------------------------------------------

def test_plane_registry_uniquifies_and_flushes():
    c1 = g_cacheplane.register("t.reg", ttl_s=60)
    c2 = g_cacheplane.register("t.reg", ttl_s=60)
    assert c1.name == "t.reg" and c2.name == "t.reg#2"
    c1.put("a", "x" * 100)
    assert g_cacheplane.flush("t.reg") > 0 and c1.stats()["entries"] == 0
    assert {"t.reg", "t.reg#2"} <= set(g_cacheplane.snapshot())
    del c1, c2


def test_pressure_sheds_cache_before_refusing_work():
    cache = g_cacheplane.register("t.pressure", ttl_s=60, max_entries=256)
    payload = "x" * (64 << 10)
    for i in range(64):
        cache.put(i, payload)
    assert g_membudget.used("cache") >= cache.stats()["bytes"] > 0
    old = g_membudget.limit
    g_membudget.add_pressure_handler(g_cacheplane._on_pressure)
    try:
        g_membudget.set_limit(g_membudget.used() + (1 << 20))
        assert g_membudget.reserve("pack", 2 << 20)
        assert cache.stats()["entries"] == 0
        g_membudget.release("pack", 2 << 20)
    finally:
        g_membudget.set_limit(old)


def test_finalizer_inside_a_locked_section_does_not_wait():
    """The reference's self-deadlock: the cyclic collector frees a
    cache inside a locked membudget section of the same thread. Here
    the finalizer queues its gauge drop, the section returns, and the
    next locked call applies the drop."""
    cache = GenCache("t.finalizer", ttl_s=60)
    cache.put("k", "x" * 1000)
    cache._self = cache   # a cycle: only the collector frees it
    del cache
    assert g_membudget._gauges["cache"]["t.finalizer"] > 0
    done = threading.Event()

    def under_lock():
        with g_membudget._locked():
            gc.collect()   # runs GenCache.__del__ inside the section
        done.set()

    gc.disable()
    try:
        t = threading.Thread(target=under_lock, daemon=True)
        t.start()
        t.join(timeout=10)
        assert done.is_set(), "the finalizer waited on the lock"
    finally:
        gc.disable()   # the module keeps the collector off
    labels = g_membudget.snapshot()["labels"]
    assert labels["cache"]["gauged"] == g_membudget.used("cache")
    assert "t.finalizer" not in g_membudget._gauges.get("cache", {})


def test_compiled_plan_cache():
    a = engine._compile_cached("alpha bravo", 0)
    b = engine._compile_cached("alpha bravo", 0)
    assert a is b
    assert engine._compile_cached("alpha bravo", 1) is not a


def _route_pair(tmp_path):
    jc = JCollection("route", tmp_path / "j")
    tc = Collection("route", tmp_path / "t", device="cpu")
    for c, dp in ((jc, jdocproc), (tc, docproc)):
        dp.index_batch(c, route_docs(48))
        c.posdb.dump()
        c.titledb.dump()
    return jc, tc


def test_plan_cache_hits_learns_and_invalidates(tmp_path, monkeypatch):
    """A repeated query reuses its ResidentPlan until a write; an
    escalated plan keeps its widened floor, so the repeat escalates no
    more, in the port as in the JAX package."""
    for k, v in ROUTE_ENV.items():
        monkeypatch.setenv(k, v)
    jc, tc = _route_pair(tmp_path)
    jdi, tdi = JDeviceIndex(jc), DeviceIndex(tc)
    esc = []
    for _ in range(2):
        for di in (jdi, tdi):
            di.search_batch(["alpha", "zeta"], topk=64)
        esc.append((jdi.escalations, tdi.escalations))
    assert esc[0][0] == esc[0][1] >= 1       # "alpha" escalates once ...
    assert esc[1] == esc[0]                  # ... and not on the repeat
    st = tdi._plan_cache.stats()
    assert (st["hits"], st["misses"]) == (2, 2)
    assert st["hits"] == jdi._plan_cache.stats()["hits"]
    docproc.index_document(tc, "http://new.test/", "<p>alpha zeta</p>")
    tdi.refresh()
    tdi.search_batch(["alpha"], topk=64)
    assert tdi._plan_cache.stats()["misses"] == 3   # the write moved it

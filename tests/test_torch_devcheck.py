"""The port's device guardrails (``query/devcheck.py``) against the JAX
package's checkify harness (CPU).

The same rows and cubes go through both packages' checks: clean inputs
trip nothing, and a NaN score, a rising score, a live row past
``n_docs`` or a payload whose hashgroup is out of range trips both. On
the route corpus (``route_docs(48)`` under ``ROUTE_ENV``) each injected
fault trips on the same route in both packages, and clean runs trip
nothing. One difference is by design: the JAX package cannot check the
cubes its jitted F1 and F2 programs hand K1, where the port checks every
cube at K1's entry, so ``corrupt_tile`` trips F1 and F2 queries in the
port only. Through the port's server, a trip answers 500 and is
counted."""

import json
import re

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import devcheck as jdevcheck
from open_source_search_engine_tpu.query.devindex import \
    DeviceIndex as JDeviceIndex
from open_source_search_engine_tpu.serve.tenancy import \
    g_residency as jresidency
from open_source_search_engine_tpu.utils.stats import g_stats as jstats
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import (ROUTE_ENV,
                                                        ROUTE_QUERIES,
                                                        route_docs)
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import devcheck
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex
from open_source_search_engine_tpu_torch.serve.server import \
    SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection while this module drives the JAX package
    (``tests/jax_gc.py``); both tenant planes are left empty."""
    with jax_gc.quiet():
        yield
        # inside the quiet block: what parking frees is collected with
        # no lock held
        jresidency.reset()
        g_residency.reset()


@pytest.fixture(autouse=True)
def checks_on(monkeypatch):
    """Both harnesses on (the JAX one eager), counters zeroed; off
    again after."""
    monkeypatch.setenv("OSSE_CHECKIFY_INTERPRET", "1")
    jdevcheck.set_enabled(True)
    devcheck.set_enabled(True)
    jstats.reset()
    g_stats.reset()
    yield
    jdevcheck.set_enabled(None)
    devcheck.set_enabled(None)


def _trip(fn):
    """The route a check tripped on, or None."""
    try:
        fn()
    except (jdevcheck.DeviceCheckError, devcheck.DeviceCheckError) as e:
        return re.match(r"\[([^\]]+)\]", str(e)).group(1)
    return None


ROWS = {
    "clean": ([3.0, 2.0, 2.0, 1.0, 0.0, 0.0], [5, 1, 2, 3, 0, 99]),
    "nan": ([3.0, np.nan, 1.0], [1, 2, 3]),
    "inf": ([np.inf, 1.0], [1, 2]),
    "rising": ([1.0, 3.0], [1, 2]),
    "tie_slack": ([1.0, 1.0 + 5e-6], [1, 2]),
    "oob_live": ([2.0, 1.0], [4, 12]),
    "negative_idx": ([2.0], [-1]),
    "dead_row_past_end": ([2.0, 0.0], [1, 4000]),
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_topk_checks_match(case):
    scores, idx = ROWS[case]
    s, i = np.array(scores, np.float32), np.array(idx, np.int64)
    want = _trip(lambda: jdevcheck.check_topk(s, i, 10, route="f1",
                                              use_jit=False))
    got = _trip(lambda: devcheck.check_topk(s, i, 10, route="f1"))
    assert got == want
    assert (got is None) == (case in ("clean", "tie_slack",
                                      "dead_row_past_end"))
    assert g_stats.counters.get("devcheck.trip.f1", 0) == \
        jstats.counters.get("devcheck.trip.f1", 0)


def _cube(kind):
    rng = np.random.default_rng(7)
    hg = rng.integers(0, 11, (4, 16, 64)).astype(np.uint32)
    cube = (hg << 18) | rng.integers(1, 1 << 18, (4, 16, 64)).astype(
        np.uint32)
    cube[:, 8:] = 0
    if kind == "synonym_bit":
        cube[1, 0, :5] |= np.uint32(1 << 31)
    elif kind == "corrupt":
        cube[2, 3, 17] = np.uint32((0xF << 18) | 1)
    elif kind == "hashgroup_11":
        cube[0, 0, 0] = np.uint32((11 << 18) | 3)
    return cube


@pytest.mark.parametrize("kind", ["clean", "synonym_bit", "corrupt",
                                  "hashgroup_11", "zeros"])
def test_cube_checks_match(kind):
    cube = np.zeros((4, 16, 64), np.uint32) if kind == "zeros" \
        else _cube(kind)
    want = _trip(lambda: jdevcheck.check_cube(cube, route="fd",
                                              use_jit=False))
    got = _trip(lambda: devcheck.check_cube(
        torch.from_numpy(cube.view(np.int32)), route="fd"))
    assert got == want
    assert (got is None) == (kind in ("clean", "synonym_bit", "zeros"))


def test_off_is_a_no_op():
    devcheck.set_enabled(None)
    s = np.array([np.nan], np.float32)
    devcheck.check_topk(s, np.array([0]), 1)
    devcheck.check_cube(torch.full((4,), (0xF << 18) | 1, dtype=torch.int32))
    assert not g_stats.counters.get("devcheck.trip")
    with pytest.raises(ValueError):
        with devcheck.inject("bitflip"):
            pass


@pytest.fixture(scope="module")
def route_pair(tmp_path_factory):
    saved = pytest.MonkeyPatch()
    for k, v in ROUTE_ENV.items():
        saved.setenv(k, v)
    jc = JCollection("route", tmp_path_factory.mktemp("j"))
    tc = Collection("route", tmp_path_factory.mktemp("t"), device="cpu")
    for c, dp in ((jc, jdocproc), (tc, docproc)):
        dp.index_batch(c, route_docs(48))
        c.posdb.dump()
        c.titledb.dump()
    yield JDeviceIndex(jc), DeviceIndex(tc)
    saved.undo()


@pytest.mark.parametrize("fault", [None, "nan", "oob_docid",
                                   "corrupt_tile"])
@pytest.mark.parametrize("q", list(ROUTE_QUERIES))
def test_route_faults_trip_as_in_the_jax_package(route_pair, q, fault):
    jdi, tdi = route_pair

    def run(di, mod):
        if fault is None:
            return _trip(lambda: di.search_batch([q], topk=64))
        with mod.inject(fault):
            return _trip(lambda: di.search_batch([q], topk=64))
    want, got = run(jdi, jdevcheck), run(tdi, devcheck)
    route = ROUTE_QUERIES[q]
    if fault is None:
        assert got is None and want is None
        assert not g_stats.counters.get("devcheck.trip")
    elif fault == "corrupt_tile" and route != "fd":
        # the JAX package's F1/F2 cubes live inside jit, out of reach
        # of its sweep; the port checks every cube K1 scores
        assert want is None and got == "k1"
    else:
        # top-k rows name their wave (FD waves are "f2" waves); the
        # cube sweep before an FD wave names "fd"
        want_route = route if fault == "corrupt_tile" \
            else {"fd": "f2"}.get(route, route)
        assert got == want == want_route
        assert g_stats.counters["devcheck.trip"] == 1
        assert g_stats.counters["devcheck.injected"] >= 1


def test_server_trip_answers_500_and_counts(tmp_path):
    srv = SearchHTTPServer(tmp_path, port=0, device="cpu")
    try:
        c = srv.colldb.get("main")
        c.conf.result_cache_ttl = 0
        for i in range(4):
            docproc.index_document(c, f"http://dc{i}.test/",
                                   f"<p>guarded words number{i}</p>")
        srv.conf.checkify = False   # the parm hook: back to the env
        assert not devcheck.enabled()
        srv.conf.checkify = True
        ok = srv.handle("GET", "/search", {"q": "guarded words"}, b"")
        assert ok[0] == 200 and json.loads(ok[1])["totalMatches"] == 4
        assert not g_stats.counters.get("devcheck.trip")
        with devcheck.inject("nan"):
            code, body, _ = srv.handle("GET", "/search",
                                       {"q": "guarded words"}, b"")
        assert code == 500 and "non-finite" in json.loads(body)["error"]
        assert g_stats.counters["devcheck.trip"] == 1
        assert g_stats.counters["serve.device_error"] == 1
        mem = json.loads(srv.handle("GET", "/admin/mem",
                                    {"format": "json"}, b"")[1])
        assert mem["checkify"] and mem["counters"]["devcheck.trip"] == 1
    finally:
        srv.stop()
        g_residency.reset()

"""The port's fielddb and numeric operators against the JAX package (CPU).

* fielddb keys, ranges and blobs bitwise equal for seeded docids and
  values; the docproc meta lists of HTML, JSON and linked pages bitwise
  equal (posdb, titledb, clusterdb, fielddb), adds and tombstones;
* the scenarios of ``tests/test_facets.py`` that need no mesh (range
  filters, ``gbsortby`` on a number and on the date, ``gbfacet`` counts,
  a delete, a date range) through the port's flat path and device route:
  totals exact, scores rtol=1e-5, docids by complete tie runs
  (``assert_tie_run_parity``) against the JAX package's same route;
* plans and pages of filtered and sorted queries on the route corpus,
  where F1, FD and F2 each carry them;
* a resident batch of mixed specs equals each query alone.

The JAX device route runs only on these small corpora, with the
collector off (``tests/jax_gc.py``)."""

import calendar
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index import fielddb as jfielddb
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu.query.compiler import \
    compile_query as jcompile
from open_source_search_engine_tpu.query.devindex import \
    DeviceIndex as JDeviceIndex
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import (
    ROUTE_ENV, assert_tie_run_parity, route_docs)
from open_source_search_engine_tpu_torch.index import fielddb
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.query.compiler import compile_query
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex
from open_source_search_engine_tpu_torch.serve.tenancy import \
    g_residency as residency
from open_source_search_engine_tpu_torch.utils import ghash
from open_source_search_engine_tpu_torch.utils.url import normalize
from tests import jax_gc

torch.set_num_threads(1)

SC = dict(site_cluster=False, with_snippets=False)


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    with jax_gc.quiet():
        yield


def _doc(i):
    """tests/test_facets.py's JSON product page."""
    return json.dumps({
        "title": f"Product {i} widget",
        "body": "common widget words here",
        "price": 10.0 * (i + 1),
        "rating": i % 5,
        "category": "tools" if i % 3 == 0 else "toys",
        "date": f"2024-0{(i % 8) + 1}-15",
    })


@pytest.fixture(scope="module")
def colls(tmp_path_factory):
    """(JAX collection, port collection) of the 24 facet pages."""
    jc = JCollection("facets", tmp_path_factory.mktemp("jfacets"))
    tc = Collection("facets", tmp_path_factory.mktemp("tfacets"),
                    device="cpu")
    for c, m in ((jc, jdocproc), (tc, docproc)):
        c.conf.pqr_enabled = False
        for i in range(24):
            m.index_document(c, f"http://shop.test/p{i}", _doc(i))
    return jc, tc


def _page(res):
    return (np.array([r.docid for r in res.results], np.uint64),
            np.array([r.score for r in res.results], np.float32),
            res.total_matches)


def _field(c, m, res, name):
    return [m.get_document(c, docid=r.docid)["fields"][name]
            for r in res.results]


# ---- fielddb and the meta lists, bitwise ----------------------------------

def test_fielddb_keys_and_blobs_match_reference(tmp_path):
    rng = np.random.default_rng(7)
    docids = rng.integers(0, 1 << 38, 64, dtype=np.int64)
    vals = rng.normal(0, 1e9, 64)
    for name in ("date", "price", "Rating", "a.b"):
        for d, v in zip(docids[:8], vals[:8]):
            for delbit in (0, 1):
                assert fielddb.pack_key(name, int(d), delbit).tobytes() == \
                    jfielddb.pack_key(name, int(d), delbit).tobytes()
        lo, hi = fielddb._range_of(name)
        jlo, jhi = jfielddb._range_of(name)
        assert lo.tobytes() == jlo.tobytes() and hi.tobytes() == jhi.tobytes()
    recs = {f: float(v) for f, v in zip(("date", "price", "rank"), vals)}
    recs["flag"] = True    # booleans are not numeric fields
    recs["label"] = "x"
    for delbit in (0, 1):
        k, b = fielddb.make_records(int(docids[0]), recs, delbit)
        jk, jb = jfielddb.make_records(int(docids[0]), recs, delbit)
        assert k.tobytes() == jk.tobytes() and b == jb
    keys = np.concatenate([fielddb.pack_key("price", int(d)) for d in docids])
    for a, b in zip(fielddb.unpack_keys(keys).values(),
                    jfielddb.unpack_keys(keys).values()):
        assert np.array_equal(a, b)
    fdb, jfdb = fielddb.Fielddb(tmp_path / "t"), \
        jfielddb.Fielddb(tmp_path / "j")
    for db in (fdb, jfdb):
        for d, v in zip(docids, vals):
            db.add(*fielddb.make_records(int(d), {"price": float(v)}))
        db.add(*fielddb.make_records(int(docids[3]), {"price": 0.0}, 0))
    for a, b in zip(fdb.column("price"), jfdb.column("price")):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(fdb.column("price")[0]) == 63


LINKED = ("<html><head><title>Linked page</title>"
          "<meta name=\"date\" content=\"2023-05-06T07:08:09\"></head><body>"
          "<h1>Heading words</h1><p>body text with a <a href=\"/rel/p2\">"
          "relative anchor</a> and an <a href=\"http://other.test/x\">"
          "outside link</a> here.</p></body></html>")
META_CASES = {
    "html": dict(url="http://a.test/p", content=LINKED),
    "json": dict(url="http://shop.test/j", content=_doc(5), is_html=False),
    "inlinks": dict(url="http://b.test/q", content=LINKED, siterank=4,
                    inlinks=[("anchor text one", 3), ("second", 9),
                             ("", 2)],
                    site="b.test/~u/", fields={"catid": 2.0,
                                                "category": "Top/Sub"}),
}


@pytest.mark.parametrize("delete", [False, True])
@pytest.mark.parametrize("case", list(META_CASES))
def test_meta_lists_match_reference(case, delete):
    kw = dict(META_CASES[case], ts=1.7e9, delete=delete)
    a = docproc.build_meta_list(**kw)
    b = jdocproc.build_meta_list(**kw)
    for f in ("posdb_keys", "titledb_key", "clusterdb_key", "fielddb_keys"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert a.fielddb_blobs == b.fielddb_blobs
    assert a.title_rec == b.title_rec
    assert (a.fields, a.site, a.edge_sites) == (b.fields, b.site,
                                                b.edge_sites)
    assert [(u.full, t) for u, t in a.edges] == \
        [(u.full, t) for u, t in b.edges]


# ---- tests/test_facets.py through both routes ------------------------------

def test_json_fields_extracted_and_stored(colls):
    jc, tc = colls
    rec = docproc.get_document(tc, url="http://shop.test/p3")
    assert rec["fields"] == jdocproc.get_document(
        jc, url="http://shop.test/p3")["fields"]
    assert rec["fields"]["price"] == 40.0 and rec["fields"]["date"] > 1.7e9
    for a, b in zip(tc.fielddb.column("price"), jc.fielddb.column("price")):
        assert np.array_equal(a, b)
    assert tc.fielddb.rdb.get_all().keys.tobytes() == \
        jc.fielddb.rdb.get_all().keys.tobytes()


LO = calendar.timegm((2024, 3, 1, 0, 0, 0))
HI = calendar.timegm((2024, 5, 30, 0, 0, 0))
FACET_QUERIES = {
    "widget gbmin:price:55 gbmax:price:145": 9,
    f"widget gbmin:date:{LO} gbmax:date:{HI}": 9,
    "widget gbsortby:price": 24,
    "widget gbsortbyrev:price": 24,
    "widget gbsortby:date": 24,
    "widget gbmin:rating:2 gbsortbyrev:date": 14,
}


@pytest.mark.parametrize("route", ["flat", "device"])
def test_numeric_operators_match_reference(colls, route):
    jc, tc = colls
    run = {"flat": (engine.search, jengine.search),
           "device": (engine.search_device, jengine.search_device)}[route]
    for q, total in FACET_QUERIES.items():
        got = run[0](tc, q, topk=24, **SC)
        want = run[1](jc, q, topk=24, **SC)
        assert got.total_matches == total, (q, got.total_matches)
        assert_tie_run_parity(_page(got), _page(want), (route, q))
        plan = compile_query(q)
        for fld, (lo, hi) in plan.filters.items():
            assert all(lo <= v <= hi
                       for v in _field(tc, docproc, got, fld)), q
        if plan.sortby is not None:
            fld, desc = plan.sortby
            vals = _field(tc, docproc, got, fld)
            assert vals == sorted(vals, reverse=desc), q


def test_gbfacet_counts(colls):
    jc, tc = colls
    res = engine.search(tc, "widget gbfacet:category", topk=10, **SC)
    assert res.facets == jengine.search(jc, "widget gbfacet:category",
                                        topk=10, **SC).facets
    assert dict(res.facets["category"]) == {"tools": 8, "toys": 16}
    dev = engine.search_device(tc, "widget gbfacet:category", topk=10, **SC)
    assert dev.facets == jengine.search_device(
        jc, "widget gbfacet:category", topk=10, **SC).facets


def test_delete_removes_field_records(tmp_path):
    for c, m in ((JCollection("fdel", tmp_path / "j"), jdocproc),
                 (Collection("fdel", tmp_path / "t", device="cpu"),
                  docproc)):
        m.index_document(c, "http://shop.test/x", _doc(1))
        assert len(c.fielddb.column("price")[0]) == 1
        assert len(c.fielddb.column("date")[0]) == 1
        m.remove_document(c, "http://shop.test/x")
        assert len(c.fielddb.column("price")[0]) == 0
        assert len(c.fielddb.column("date")[0]) == 0
        if isinstance(c, Collection):
            assert engine.search(c, "widget gbsortby:price",
                                 **SC).total_matches == 0


def test_fielddb_write_invalidates_cached_plans(tmp_path):
    """A fielddb write moves the plan cache's generation: a filter sees
    the new value on the next query, with no posdb write."""
    c = Collection("fgen", tmp_path, device="cpu")
    for i in range(6):
        docproc.index_document(c, f"http://shop.test/p{i}", _doc(i))
    q = "widget gbmin:price:1000 gbmax:price:2000"
    assert engine.search_device(c, q, **SC).total_matches == 0
    c.fielddb.add(*fielddb.make_records(
        ghash.doc_id("http://shop.test/p2"), {"price": 1500.0}))
    assert engine.search_device(c, q, **SC).total_matches == 1
    assert engine.search(c, q, **SC).total_matches == 1


# ---- the route corpus: F1, FD and F2 with filters and sort keys -------------

ROUTE_SPECS = ["", " gbmin:rank:20 gbmax:rank:70", " gbsortby:rank",
               " gbsortbyrev:rank", " gbmin:rank:10 gbsortby:date"]
ROUTE_BASES = ["zeta", "alpha", "alpha beta", "boxes dogs"]


@pytest.fixture(scope="module")
def route_pair(tmp_path_factory):
    saved = {k: os.environ.get(k) for k in ROUTE_ENV}
    os.environ.update(ROUTE_ENV)
    rng = np.random.default_rng(11)
    docs = route_docs(48)
    ranks = rng.integers(0, 100, len(docs)).astype(np.float64)
    real = time.time
    time.time = lambda: 1.7e9  # the built-in date of both packages
    try:
        out = []
        for m, c in ((jdocproc, JCollection(
                "route", tmp_path_factory.mktemp("jrf"))),
                (docproc, Collection("route", tmp_path_factory.mktemp(
                    "trf"), device="cpu"))):
            m.index_batch(c, docs)
            c.posdb.dump()
            for (url, _), r in zip(docs, ranks):
                if r % 7:   # a few docs lack the field
                    c.fielddb.add(*fielddb.make_records(
                        ghash.doc_id(normalize(url).full),
                        {"rank": float(r)}))
            out.append(c)
        yield (JDeviceIndex(out[0]), DeviceIndex(out[1]))
    finally:
        time.time = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_route_plans_and_pages_match_reference(route_pair):
    jdi, tdi = route_pair
    qs = [b + s for s in ROUTE_SPECS for b in ROUTE_BASES]
    for q in qs:
        jp, tp = jdi.plan(jcompile(q)), tdi.plan(compile_query(q))
        for f in dataclasses.fields(jp):
            a, b = getattr(jp, f.name), getattr(tp, f.name)
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), (q, f.name)
            else:
                assert a == b, (q, f.name, a, b)
    for di in (jdi, tdi):
        di.route_counts = {"f1": 0, "fd": 0, "f2": 0}
        di.escalations = 0
    got = tdi.search_batch(qs, topk=16)
    want = jdi.search_batch(qs, topk=16)
    assert tdi.route_counts == jdi.route_counts
    assert min(tdi.route_counts.values()) >= len(ROUTE_SPECS) - 1
    assert tdi.escalations == jdi.escalations
    for q, a, b in zip(qs, got, want):
        assert_tie_run_parity(a, b, q)
    # a caller's sort-key base (a mesh passes the cluster-wide minimum)
    qp = "zeta gbsortby:rank"
    base_of = lambda fld, desc: 5.0  # noqa: E731
    assert tdi.plan(compile_query(qp), sort_base_of=base_of).sort_base == \
        jdi.plan(jcompile(qp), sort_base_of=base_of).sort_base == 5.0


def test_mixed_spec_resident_batch_equals_each_alone(colls):
    _, tc = colls
    qs = ["widget", "widget gbmin:price:55 gbmax:price:145",
          "widget gbsortby:date", "widget gbsortbyrev:price",
          "common gbmin:rating:3", "widget gbsortby:price"]
    try:
        batch = engine.search_device_batch(tc, qs, topk=10, resident=True,
                                           **SC)
        for q, res in zip(qs, batch):
            alone = engine.search_device_batch(tc, [q], topk=10,
                                               resident=True, **SC)[0]
            assert_tie_run_parity(_page(res), _page(alone), q)
            assert_tie_run_parity(_page(res), _page(
                engine.search(tc, q, topk=10, **SC)), q)
    finally:
        residency.release(tc.name)

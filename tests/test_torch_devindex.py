"""The port's device-resident route against the JAX package (CPU).

Both packages build a ``DeviceIndex`` over the same records:

* the route corpus, ``route_docs(48)`` as one index under ``ROUTE_ENV``,
  dumped to a run: there the reference routes ``zeta`` and ``alpha`` to
  F1 (``alpha`` escalating once), ``alpha beta``, ``alpha gamma`` and
  ``alpha beta gamma`` to FD, and ``boxes dogs`` to F2;
* the golden corpus, indexed without a dump, so every posting rides the
  delta; the port's copy is carried over with ``collection_from_arrays``
  (the memtable keys included).

Every resident column must be bitwise equal, every plan field equal,
route and escalation counts equal; ``search_batch`` results agree in
match counts (exact), scores (rtol=1e-5, the fused route's tolerance in
``tests/test_pallas.py``) and docids by complete tie runs. The golden
suite runs through the port's ``search_device``, and a base + delta case
(adds, a delete and a re-index after the build) is compared after each
refresh."""

import dataclasses
import os
import shutil
import time

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu.query.compiler import \
    compile_query as jcompile
from open_source_search_engine_tpu.query.devindex import \
    DeviceIndex as JDeviceIndex
from open_source_search_engine_tpu.serve.tenancy import \
    g_residency as jresidency
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import (
    ROUTE_ENV, ROUTE_QUERIES, assert_tie_run_parity, route_docs)
from open_source_search_engine_tpu_torch.index.carry import \
    collection_from_arrays
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.query.compiler import compile_query
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex
from open_source_search_engine_tpu_torch.serve.tenancy import \
    g_residency as residency
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc
from tests.golden.corpus import GOLDEN_QUERIES, golden_docs
from tests.test_golden import _check

#: the tier-1 run shares the host's cores among several workers, and
#: these small tensors gain nothing from intra-op threads
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection while this module drives the JAX package's
    device index (``tests/jax_gc.py``)."""
    with jax_gc.quiet():
        yield


RTOL = 1e-5
ROUTE_SET = list(ROUTE_QUERIES) + ["alpha gamma", "alpha beta gamma",
                                   "beta", "dogs", "gamma -zeta"]
#: a batch in which ``alpha`` recurs across queries and one query comes
#: twice
REPEAT_BATCH = ["alpha beta", "alpha gamma", "alpha beta", "beta",
                "alpha beta gamma"]
COLUMNS = ("payload", "docc", "doc", "imp", "rs", "cnt", "dense_imp",
           "dense_rs", "dense_cnt", "cube", "siterank", "doclang", "dead")


@pytest.fixture(scope="module")
def route_env():
    saved = {k: os.environ.get(k) for k in ROUTE_ENV}
    os.environ.update(ROUTE_ENV)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _carry(jc, base):
    tit = jc.titledb.get_all()
    runs = [r.batch().keys for r in jc.posdb.runs]
    return collection_from_arrays(
        jc.name, base,
        np.concatenate(runs) if runs else jc.posdb.mem.batch().keys[:0],
        tit.keys, tit.payloads(), jc.clusterdb.get_all().keys,
        jc.sectiondb.rdb.get_all().keys, jc.num_docs, device="cpu",
        posdb_mem_keys=jc.posdb.mem.batch().keys)


@pytest.fixture(scope="module")
def pairs(route_env, tmp_path_factory):
    """corpus → (JAX DeviceIndex, port DeviceIndex over the same
    records)."""
    out = {}
    jr = JCollection("route", tmp_path_factory.mktemp("jroute"))
    jdocproc.index_batch(jr, route_docs(48))
    jr.posdb.dump()
    jr.titledb.dump()
    out["route"] = (jr, _carry(jr, tmp_path_factory.mktemp("troute")))
    jg = JCollection("golden", tmp_path_factory.mktemp("jgold"))
    for url, html in golden_docs().items():
        jdocproc.index_document(jg, url, html)
    out["golden"] = (jg, _carry(jg, tmp_path_factory.mktemp("tgold")))
    return {k: (JDeviceIndex(jc), DeviceIndex(tc))
            for k, (jc, tc) in out.items()}


def _assert_column(jdi, tdi, name):
    """One resident column, bitwise (uint32 columns as int32 views)."""
    want = np.asarray(getattr(jdi, "d_" + name))
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    have = tdi.columns()[name].numpy()
    assert have.dtype == want.dtype and have.shape == want.shape, name
    assert np.array_equal(have, want), name


def _plans_equal(jp, tp, label):
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype and np.array_equal(a, b), \
                (label, f.name)
        else:
            assert a == b, (label, f.name, a, b)


def _batch_plans_equal(jdi, tdi, queries, label, **kw):
    """The plans one ``issue_batch`` builds for ``queries`` (the port's
    batch planner; its plan cache emptied before and after) against the
    reference's plan of each query alone."""
    tdi._plan_cache.flush()
    try:
        pending = tdi.issue_batch(queries, topk=16, **kw)
        assert len(pending.plans) == len(queries), label
        for q, tp in zip(queries, pending.plans):
            _plans_equal(jdi.plan(jcompile(q), **kw), tp, (label, q))
        tdi.collect_batch(pending)
    finally:
        tdi._plan_cache.flush()
    return pending


def _sublist_termids(queries) -> list[int]:
    return [s.termid for q in queries for g in compile_query(q).groups
            for s in g.sublists]


# Each test loops over its queries and columns rather than parametrizing
# them: the tier-1 run schedules whole files by test count, largest
# first, and a file of a few tests keeps to the end of that order.

@pytest.mark.parametrize("corpus", ["route", "golden"])
def test_columns_match(pairs, corpus):
    for name in COLUMNS:
        _assert_column(*pairs[corpus], name)


def test_directories_match(pairs):
    for corpus, (jdi, tdi) in pairs.items():
        for attr in ("dir_termids", "base_df", "dir_dstart", "dir_pstart",
                     "base_docids", "dir2_termids", "delta_df",
                     "dir2_dstart", "dir2_pstart", "all_docids", "tomb_df"):
            assert np.array_equal(getattr(jdi, attr), getattr(tdi, attr)), \
                (corpus, attr)
        for attr in ("D_cap", "Nb", "Mb", "N2", "M2", "Vc",
                     "cube_zero_slot", "dense_slot_of", "cube_slot_of"):
            assert getattr(jdi, attr) == getattr(tdi, attr), (corpus, attr)


@pytest.mark.parametrize("corpus,queries", [("route", ROUTE_SET),
                                            ("golden", GOLDEN_QUERIES),
                                            ("route", REPEAT_BATCH)])
def test_plans_match(pairs, corpus, queries):
    """Each query planned alone, and the whole list planned as one batch
    by ``issue_batch``, equal the reference's plan field by field."""
    jdi, tdi = pairs[corpus]
    for q in queries:
        _plans_equal(jdi.plan(jcompile(q)), tdi.plan(compile_query(q)), q)
    pending = _batch_plans_equal(jdi, tdi, queries, corpus)
    # a query that comes twice is planned once
    for i, q in enumerate(queries):
        assert pending.plans[i] is pending.plans[queries.index(q)], q


@pytest.mark.parametrize("corpus", ["route", "golden"])
def test_plans_match_under_mesh_override(pairs, corpus):
    """A mesh's cluster-wide ``df_of`` and ``total_docs``, the same
    callable given to both packages: equal plans, alone and batched, and
    the batch asks ``df_of`` once per distinct termid."""
    jdi, tdi = pairs[corpus]
    queries = (ROUTE_SET if corpus == "route" else GOLDEN_QUERIES) \
        + REPEAT_BATCH
    calls = []

    def df_of(termid):
        calls.append(termid)
        return 3 * jdi._df_of(termid) + 1
    kw = dict(df_of=df_of, total_docs=5 * tdi.coll.num_docs + 3)
    for q in queries:
        _plans_equal(jdi.plan(jcompile(q), **kw),
                     tdi.plan(compile_query(q), **kw), (corpus, q))
    _batch_plans_equal(jdi, tdi, queries, corpus, **kw)
    calls.clear()
    tdi.collect_batch(tdi.issue_batch(queries, topk=16, **kw))
    assert sorted(calls) == sorted(set(_sublist_termids(queries)))


def test_plan_counters_count_a_batch(pairs):
    """``devindex.plan.sublists`` counts the sublists a batch resolves and
    ``devindex.plan.terms`` its distinct termids; a repeated query is
    planned once."""
    tdi = pairs["route"][1]
    names = ("devindex.plan.sublists", "devindex.plan.terms")
    tids = _sublist_termids(dict.fromkeys(REPEAT_BATCH))
    assert len(set(tids)) < len(tids)
    tdi._plan_cache.flush()
    before = [g_stats.counters.get(n, 0) for n in names]
    try:
        tdi.issue_batch(REPEAT_BATCH, topk=16)
    finally:
        tdi._plan_cache.flush()
    assert [g_stats.counters.get(n, 0) - b for n, b in zip(names, before)] \
        == [len(tids), len(set(tids))]


def test_routes_and_escalations_match(pairs):
    """Every route serves a query, and the escalation ladder runs."""
    jdi, tdi = pairs["route"]
    for di in (jdi, tdi):
        di.route_counts = {"f1": 0, "fd": 0, "f2": 0}
        di.escalations = 0
    want = jdi.search_batch(ROUTE_SET, topk=64)
    got = tdi.search_batch(ROUTE_SET, topk=64)
    assert tdi.route_counts == jdi.route_counts
    assert min(tdi.route_counts.values()) >= 1, tdi.route_counts
    assert tdi.escalations == jdi.escalations >= 1
    for q, a, b in zip(ROUTE_SET, got, want):
        assert_tie_run_parity(a, b, q)
    # each pinned query alone takes its route
    for q, route in ROUTE_QUERIES.items():
        for di in (jdi, tdi):
            di.route_counts = {"f1": 0, "fd": 0, "f2": 0}
        assert_tie_run_parity(tdi.search(q, topk=16),
                              jdi.search(q, topk=16), q)
        assert tdi.route_counts[route] == 1, q
        assert tdi.route_counts == jdi.route_counts, q


def test_golden_batch_matches(pairs):
    jdi, tdi = pairs["golden"]
    want = jdi.search_batch(GOLDEN_QUERIES, topk=64)
    got = tdi.search_batch(GOLDEN_QUERIES, topk=64)
    for q, a, b in zip(GOLDEN_QUERIES, got, want):
        assert_tie_run_parity(a, b, q)


@pytest.fixture(scope="module")
def golden_coll(tmp_path_factory):
    c = Collection("golden", tmp_path_factory.mktemp("tgolden_dev"),
                   device="cpu")
    c.conf.pqr_enabled = False
    for url, html in golden_docs().items():
        docproc.index_document(c, url, html)
    return c


def test_golden_device_path(golden_coll):
    for q in GOLDEN_QUERIES:
        res = engine.search_device(golden_coll, q, topk=10,
                                   site_cluster=False, with_snippets=False)
        _check(q, res.total_matches,
               [(r.docid, r.score) for r in res.results], "torch-device")


def test_search_device_batch_matches_jax_engine(tmp_path):
    jc = JCollection("g", tmp_path / "j")
    tc = Collection("g", tmp_path / "t", device="cpu")
    for url, html in golden_docs().items():
        jdocproc.index_document(jc, url, html)
        docproc.index_document(tc, url, html)
    qs = GOLDEN_QUERIES[:12]
    want = jengine.search_device_batch(jc, qs, topk=10, with_snippets=True)
    got = engine.search_device_batch(tc, qs, topk=10, with_snippets=True)
    for q, a, b in zip(qs, got, want):
        assert a.total_matches == b.total_matches, q
        assert a.clustered == b.clustered, q
        np.testing.assert_allclose([r.score for r in a.results],
                                   [r.score for r in b.results], rtol=RTOL)
        assert [(r.url, r.title, r.snippet) for r in a.results] == \
            [(r.url, r.title, r.snippet) for r in b.results], q
    # through each package's resident loop: the same pages
    try:
        want = jengine.search_device_batch(jc, qs, topk=10,
                                           with_snippets=True, resident=True)
        got = engine.search_device_batch(tc, qs, topk=10,
                                         with_snippets=True, resident=True)
    finally:
        jresidency.release(jc.name)
        residency.release(tc.name)
    for q, a, b in zip(qs, got, want):
        assert a.total_matches == b.total_matches, q
        np.testing.assert_allclose([r.score for r in a.results],
                                   [r.score for r in b.results], rtol=RTOL)
        assert [(r.url, r.title, r.snippet) for r in a.results] == \
            [(r.url, r.title, r.snippet) for r in b.results], q


def test_delta_refresh_matches_reference(tmp_path):
    """Adds, a delete and a re-index land in the delta of both packages'
    index (no base rebuild); columns, plans and results stay equal after
    each refresh."""
    jc = JCollection("inc", tmp_path / "j")
    tc = Collection("inc", tmp_path / "t", device="cpu")
    both = ((jc, jdocproc), (tc, docproc))

    def page(i, body):
        return (f"<html><head><title>Doc {i}</title></head><body>"
                f"<p>{body}</p></body></html>")
    for c, m in both:
        for i in range(30):
            m.index_document(c, f"http://inc{i % 5}.test/d{i}",
                             page(i, f"stable corpus text number{i} here."))
        c.posdb.dump()
    jdi, tdi = JDeviceIndex(jc), DeviceIndex(tc)
    queries = ["stable", "freshterm", "rewrittenterm", "number7",
               "stable corpus", "number12"]

    def compare(step):
        assert jdi.refresh() == tdi.refresh(), step
        for name in COLUMNS:
            _assert_column(jdi, tdi, name)
        for q in queries:
            _plans_equal(jdi.plan(jcompile(q)), tdi.plan(compile_query(q)),
                         (step, q))
        _batch_plans_equal(jdi, tdi, queries + queries[:2], step)
        for q, a, b in zip(queries, tdi.search_batch(queries, topk=16),
                           jdi.search_batch(queries, topk=16)):
            assert_tie_run_parity(a, b, (step, q))

    for i in range(3):
        for c, m in both:
            m.index_document(c, f"http://inc9.test/new{i}", page(
                100 + i, f"freshterm arrives number{i} stable."))
        compare(f"add {i}")
    for c, m in both:
        assert m.remove_document(c, "http://inc0.test/d5")
    compare("delete")
    for c, m in both:
        m.index_document(c, "http://inc2.test/d7",
                         page(7, "rewrittenterm stable now."))
    compare("re-index")
    assert tdi.full_rebuilds == 1 and tdi.delta_rebuilds == 6
    assert tdi.search("rewrittenterm")[2] == 1
    assert tdi.search("number7")[2] == 0
    assert tdi.search("stable")[2] == 32


def test_sparse_fold_is_the_flat_scatter_add_sum():
    """F1's phase-1 sparse sum folds the rows one at a time in row order:
    on the CPU it is bitwise the flat ``scatter_add_`` it replaces, with
    targets colliding across rows (synonym and delta rows of one group)
    and masked lanes on the sentinel."""
    from open_source_search_engine_tpu_torch.query.devindex import _fold_rows
    rng = np.random.default_rng(3)
    B, R, L, n = 4, 9, 64, 300
    tgt = np.stack([np.stack([rng.permutation(n)[:L] for _ in range(R)])
                    for _ in range(B)])
    tgt[rng.random(tgt.shape) < 0.2] = n      # masked lanes: the sentinel
    val = rng.random((B, R, L)).astype(np.float32) * np.float32(1e3)
    val[tgt == n] = 0.0
    t, v = torch.from_numpy(tgt), torch.from_numpy(val)
    flat = torch.zeros((B, n + 1), dtype=torch.float32)
    flat.scatter_add_(1, t.view(B, -1), v.view(B, -1))
    folded = _fold_rows(n + 1, t, v)
    assert (np.bincount(tgt[0][tgt[0] < n], minlength=n) > 1).any()
    assert np.array_equal(folded.numpy().view(np.int32),
                          flat.numpy().view(np.int32))


def test_sparse_rows_hold_distinct_docs(pairs):
    """The fold's premise: every F1 sparse row (a term's base or delta
    doc run) targets each doc at most once."""
    for corpus, queries in (("route", ROUTE_SET), ("golden", GOLDEN_QUERIES)):
        tdi = pairs[corpus][1]
        doc = tdi.columns()["doc"].numpy()
        for q in queries:
            p = tdi.plan(compile_query(q))
            for a, n in zip(p.s_start, p.s_len):
                run = doc[a:a + n]
                assert len(np.unique(run)) == n, (corpus, q, a, n)


# --- the disk base cache and the run-set fingerprint ------------------------

def _route_dir(base):
    """The route corpus indexed by the JAX package and dumped, so its
    posdb is one run: a node directory both packages open."""
    jc = JCollection("cache", base)
    jdocproc.index_batch(jc, route_docs(48))
    jc.dump_all()


def _cache_files(base):
    return sorted((base / "coll" / "cache" / "posdb" / "devcache").glob(
        "base_*.npz"))


def _same_index(a, b):
    for name in ("dir_termids", "base_df", "dir_dstart", "dir_pstart",
                 "base_docids", "h_doc_col"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (a.D_cap, a.Vc, a.dense_slot_of, a.cube_slot_of) == \
        (b.D_cap, b.Vc, b.dense_slot_of, b.cube_slot_of)
    for name, x in a.columns().items():
        y = b.columns()[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.dtype == torch.float16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), name


def test_host_oracle_writes_the_reference_cache(route_env, tmp_path,
                                                monkeypatch):
    """Both packages' host oracles write the same cache file (one name:
    the key hashes the same fingerprint) with equal arrays."""
    _route_dir(tmp_path / "j")
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    monkeypatch.setenv("OSSE_DEVBUILD", "0")
    JDeviceIndex(JCollection("cache", tmp_path / "j"))
    tdi = DeviceIndex(Collection("cache", tmp_path / "p", device="cpu"))
    assert tdi.base_source == "host"
    (jf,), (pf,) = _cache_files(tmp_path / "j"), _cache_files(tmp_path / "p")
    assert jf.name == pf.name
    with np.load(jf) as a, np.load(pf) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 14
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k


def test_port_reads_the_jax_cache(route_env, tmp_path, monkeypatch):
    """A cache the JAX package wrote comes first in the port's build and
    gives columns bitwise equal to the port's own device build."""
    _route_dir(tmp_path / "j")
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    monkeypatch.setenv("OSSE_DEVBUILD", "0")
    JDeviceIndex(JCollection("cache", tmp_path / "j"))
    monkeypatch.delenv("OSSE_DEVBUILD")
    cached = DeviceIndex(Collection("cache", tmp_path / "j", device="cpu"))
    built = DeviceIndex(Collection("cache", tmp_path / "p", device="cpu"))
    assert (cached.base_source, built.base_source) == ("cache", "device")
    assert not _cache_files(tmp_path / "p")   # a device build writes none
    _same_index(cached, built)
    for q, a, b in zip(ROUTE_SET, cached.search_batch(ROUTE_SET, topk=16),
                       built.search_batch(ROUTE_SET, topk=16)):
        assert a[2] == b[2] and list(a[0]) == list(b[0]), q
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32)), q


def test_fingerprint_sees_a_rewritten_run(tmp_path, monkeypatch):
    """A run rewritten under the name and the length it had gets a new
    fingerprint, so neither a live index nor the disk cache serves the
    old base."""
    from open_source_search_engine_tpu_torch.index import rdblite
    from open_source_search_engine_tpu_torch.query.devindex import \
        base_fingerprint
    c = Collection("fp", tmp_path, device="cpu")
    for i in range(3):
        docproc.index_document(c, f"http://fp{i}.test/",
                               f"<p>oldword fingerprint number{i}</p>")
    c.dump_all()
    monkeypatch.setenv("OSSE_DEVBUILD", "0")
    di = DeviceIndex(c)
    assert di.base_source == "host" and di.search("oldword")[2] == 3
    run = c.posdb.runs[0]
    keys = run.batch().keys
    other = Collection("other", tmp_path, device="cpu")
    for i in range(3):
        docproc.index_document(other, f"http://fp{i}.test/",
                               f"<p>newword fingerprint number{i}</p>")
    new = other.posdb.mem.batch().keys
    assert len(new) == len(keys) and new.tobytes() != keys.tobytes()
    tmp = run.path.with_name("rewrite")
    rdblite.Run.write(tmp, rdblite.RecordBatch(new))
    shutil.rmtree(run.path)
    tmp.rename(run.path)
    again = Collection("fp", tmp_path, device="cpu")
    assert [(r.path.name, len(r)) for r in again.posdb.runs] == \
        [(run.path.name, len(run))]
    assert base_fingerprint(again.posdb.runs) != di._base_fp
    fresh = DeviceIndex(again)
    assert fresh.base_source == "host"   # the old run set's cache missed
    assert fresh.search("newword")[2] == 3
    assert fresh.search("oldword")[2] == 0


def test_a_merge_rebuilds_the_base_in_the_background(tmp_path):
    c = Collection("mg", tmp_path, device="cpu")
    for i in range(6):
        docproc.index_document(c, f"http://mg{i}.test/",
                               f"<p>merge serving words token{i}</p>")
        c.posdb.dump()
    old = engine.get_device_index(c)
    want = old.search_batch(["merge serving", "token3"], topk=16)
    c.posdb.attempt_merge(force=True)
    assert len(c.posdb.runs) == 1
    assert engine.get_device_index(c) is old
    deadline = time.monotonic() + 60
    while getattr(c, "_di_rebuilding", False):
        assert time.monotonic() < deadline, "rebuild did not finish"
        time.sleep(0.01)
    fresh = engine.get_device_index(c)
    assert fresh is not old and fresh.base_source == "device"
    for a, b in zip(fresh.search_batch(["merge serving", "token3"], topk=16),
                    want):
        assert a[2] == b[2] and list(a[0]) == list(b[0])
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))

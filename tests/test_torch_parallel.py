"""The port's mesh (``parallel/``) against the JAX package's (CPU).

The scenarios of ``tests/test_parallel.py``, each run through both
packages on the same pages, with the port's mesh on ``["cpu"]`` (four
shards wrapped onto one device) and the reference's on the conftest's
virtual CPU devices:

* ``HostMap`` routing bitwise, ``make_mesh`` wrapping shards onto fewer
  devices;
* every shard's Rdbs byte-equal after ``index_document`` and
  ``remove_document`` (twins included);
* ``sharded_search`` pages, with and without site clustering, a
  degraded whole shard and twin failover;
* ``MeshResident.search_batch`` (the host merge over per-shard resident
  indexes) and ``serve_batch`` (the in-program merge under a
  ResidentLoop) against the JAX package and the port's flat device
  route on ``DISTINCT_DOCS`` (unique scores: the two merges order exact
  ties differently), ``clustered`` included; the over-fetch escalation;
  twin failover with zero lost queries; the generation; the df memo;
  the cluster-wide suggestion; the numeric operators on the mesh;
* ``merge_dedup_topk`` against the JAX function on seeded ``[S, k]``
  blocks with ties and sitehash 0.

Tolerances: totals, ``clustered``, suggestions, integer outputs and
bytes exact; scores rtol=1e-5 (the merge's scores bitwise); docids by
complete tie runs (``corpus.assert_tie_run_parity``) where the corpus
has ties, else exact. The JAX objects that hold a cache or a pressure
handler are stopped and dropped inside ``tests/jax_gc.quiet()``."""

import calendar
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.parallel import (
    HostMap as JHostMap, ShardedCollection as JSC, make_mesh as jmake_mesh,
    sharded_search as jsharded_search)
from open_source_search_engine_tpu.parallel import sharded as jsharded
from open_source_search_engine_tpu.query import scorer as jscorer
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import assert_tie_run_parity
from open_source_search_engine_tpu_torch.index import posdb
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.parallel import (
    HostMap, MeshResident, MeshServeIndex, ShardedCollection, make_mesh,
    sharded_search, suggest_sharded)
from open_source_search_engine_tpu_torch.parallel.sharded import \
    mesh_generation
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.query.compiler import compile_query
from open_source_search_engine_tpu_torch.query.scorer import merge_dedup_topk
from open_source_search_engine_tpu_torch.utils import ghash
from open_source_search_engine_tpu_torch.utils.url import normalize
from tests import jax_gc

torch.set_num_threads(1)

CPU = ["cpu"]

DOCS = {
    f"http://site{i % 5}.example.com/page{i}":
        f"""<html><head><title>Page {i} about topic{i % 3}</title></head>
        <body><p>This is page number {i}. It discusses topic{i % 3} at
        length. Common words appear everywhere. {'Rare gem here.' if i == 7
        else ''}</p></body></html>"""
    for i in range(20)
}

# every score unique: the host merge and the in-program merge order
# exact ties differently
DISTINCT_DOCS = {
    f"http://site{i % 5}.example.com/d{i}":
        "<html><title>Doc number %d</title><body><p>%s</p></body></html>"
        % (i, "apple " * (1 + i) + "banana " * (1 + (i * 3) % 11)
           + f"tok{i} gem ")
    for i in range(20)
}

QUERIES = ["topic1", "page number", "common words", "topic0 topic1",
           "gem", "topic2 everywhere", "xylophone", "discusses everywere",
           '"page number"', "site:site2.example.com page",
           "topic1 OR gem", "common -topic1"]

MESH_QUERIES = ["apple banana", "gem", "tok7", "apple gem",
                "apple site:site2.example.com", "banana -tok3"]


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    with jax_gc.quiet():
        yield


@pytest.fixture(scope="module", autouse=True)
def _fixed_clock():
    """Both indexers stamp a page's titlerec and its default date with
    the wall clock: one fixed clock makes their records byte-equal."""
    import time
    import types

    from open_source_search_engine_tpu.build import docproc as jdocproc
    clock = types.SimpleNamespace(time=lambda: 1.7e9,
                                  strptime=time.strptime)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(docproc, "time", clock)
        mp.setattr(jdocproc, "time", clock)
        yield


def _grid(cls, path, docs, n_shards=4, n_replicas=1, **kw):
    sc = cls("ptest", path, n_shards=n_shards, n_replicas=n_replicas, **kw)
    for row in sc.grid:
        for c in row:
            c.conf.pqr_enabled = False
    for url, html in docs.items():
        sc.index_document(url, html)
    return sc


def _page(res):
    return (np.array([r.docid for r in res.results], np.uint64),
            np.array([r.score for r in res.results], np.float32),
            res.total_matches)


def _same(got, want, label, exact=False):
    """Totals, clustered, suggestion and degraded exact; scores rtol=1e-5
    and docids by complete tie runs (exact order with ``exact``)."""
    assert got.total_matches == want.total_matches, label
    assert got.clustered == want.clustered, label
    assert got.suggestion == want.suggestion, label
    assert got.degraded == want.degraded, label
    assert_tie_run_parity(_page(got), _page(want), label)
    if exact:
        assert [r.docid for r in got.results] == \
            [r.docid for r in want.results], label
    assert [(r.url, r.title, r.snippet) for r in
            sorted(got.results, key=lambda r: r.docid)] == \
        [(r.url, r.title, r.snippet) for r in
         sorted(want.results, key=lambda r: r.docid)], label


def _rdb_image(coll):
    """Every Rdb's merged records: key bytes and payloads."""
    out = {}
    for name, rdb in coll.rdbs().items():
        b = rdb.get_all()
        out[name] = (b.keys.tobytes(),
                     [b.payload(i) for i in range(len(b))]
                     if b.has_data else None)
    return out


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    j = _grid(JSC, tmp_path_factory.mktemp("jgrid"), DOCS)
    t = _grid(ShardedCollection, tmp_path_factory.mktemp("tgrid"), DOCS,
              device="cpu")
    yield j, t
    with jax_gc.quiet():
        del j, t


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(4)


@pytest.fixture(scope="module")
def distinct(tmp_path_factory):
    """(JAX grid, port grid, JAX MeshResident, port MeshResident, port
    flat collection) over DISTINCT_DOCS."""
    j = _grid(JSC, tmp_path_factory.mktemp("jd"), DISTINCT_DOCS)
    t = _grid(ShardedCollection, tmp_path_factory.mktemp("td"),
              DISTINCT_DOCS, device="cpu")
    flat = Collection("dflat", tmp_path_factory.mktemp("dflat"),
                      device="cpu")
    flat.conf.pqr_enabled = False
    for url, html in DISTINCT_DOCS.items():
        docproc.index_document(flat, url, html)
    jm, tm = jsharded.MeshResident(j), MeshResident(t, devices=CPU)
    yield j, t, jm, tm, flat
    with jax_gc.quiet():
        jax_gc.release(jm, tm)
        del j, t, jm, tm, flat


# ---- the host map ----------------------------------------------------------

class TestHostMap:
    def test_routing_bitwise_equal_to_reference(self):
        rng = np.random.default_rng(11)
        docids = rng.integers(0, 1 << 38, 4000, dtype=np.uint64)
        termids = rng.integers(0, 1 << 48, 4000, dtype=np.uint64)
        keys = posdb.pack(termids, docids,
                          shardbytermid=rng.integers(0, 2, 4000))
        for n in (1, 2, 4, 8):
            hm, jhm = HostMap(n), JHostMap(n)
            a, b = hm.shard_of_docid(docids), jhm.shard_of_docid(docids)
            assert a.dtype == b.dtype and np.array_equal(a, b)
            a, b = hm.shard_of_keys(keys), jhm.shard_of_keys(keys)
            assert a.dtype == b.dtype and np.array_equal(a, b)
            from open_source_search_engine_tpu.index import posdb as jposdb
            a = posdb.shard_of_termid(termids, n)
            b = jposdb.shard_of_termid(termids, n)
            assert a.dtype == b.dtype and np.array_equal(a, b)
            for site in ("a.example.com", "site3.example.com", "x.test"):
                assert hm.shard_of_site(site) == jhm.shard_of_site(site)
        counts = np.bincount(HostMap(4).shard_of_docid(
            np.arange(1, 4001, dtype=np.uint64)), minlength=4)
        assert counts.min() > 700

    def test_liveness_and_twin_order_match_reference(self):
        hm, jhm = HostMap(3, 2), JHostMap(3, 2)
        for m in (hm, jhm):
            m.mark_dead(1, 0)
            m.observe_rtt(0, 0, 0.5)
            m.observe_rtt(0, 1, 0.1)
            m.penalize(2, 1, 2.0)
            m.decay_rtt(2, 1)
            m.mark_dead(2, 0)
            m.mark_dead(2, 1)
        assert hm.serving_vector() == jhm.serving_vector() == (0, 1, None)
        assert [hm.twin_order(s) for s in range(3)] == \
            [jhm.twin_order(s) for s in range(3)]
        assert hm.hosts_up() == jhm.hosts_up() == 3
        assert not hm.serving_ok() and not jhm.serving_ok()
        assert np.array_equal(hm.rtt_s, jhm.rtt_s)

    def test_make_mesh_wraps_shards_onto_fewer_devices(self):
        mesh = make_mesh(4, CPU)
        assert mesh == [torch.device("cpu")] * 4
        assert make_mesh(3, ["cpu", "cpu"]) == [torch.device("cpu")] * 3
        with pytest.raises(ValueError):
            make_mesh(0, CPU)


# ---- the build plane -------------------------------------------------------

class TestShardedBuild:
    def test_shard_rdbs_byte_equal(self, grids):
        j, t = grids
        assert t.num_docs == j.num_docs == len(DOCS)
        for s in range(4):
            assert t.grid[s][0].num_docs == j.grid[s][0].num_docs, s
            assert _rdb_image(t.grid[s][0]) == _rdb_image(j.grid[s][0]), s
        assert sum(1 for c in t.shards if len(c.posdb.get_all())) >= 3

    def test_remove_and_twins_byte_equal(self, tmp_path):
        docs = dict(list(DOCS.items())[:8])
        j = _grid(JSC, tmp_path / "j", docs, n_replicas=2)
        t = _grid(ShardedCollection, tmp_path / "t", docs, n_replicas=2,
                  device="cpu")
        for sc in (j, t):
            assert sc.remove_document("http://site2.example.com/page7")
            assert sc.remove_document("http://nowhere.test/x") is None
            sc.index_document("http://site1.example.com/page1",
                              "<html><body>rewritten gem page</body></html>")
        assert t.mutations == j.mutations
        for s in range(4):
            for r in range(2):
                assert _rdb_image(t.grid[s][r]) == \
                    _rdb_image(j.grid[s][r]), (s, r)
        assert t.num_docs == j.num_docs == 7

    def test_get_document_routes(self, grids):
        _, t = grids
        url = "http://site2.example.com/page7"
        rec = t.get_document(ghash.doc_id(normalize(url).full))
        assert rec and rec["url"] == url

    def test_scrub_and_resync_replica(self, tmp_path):
        t = _grid(ShardedCollection, tmp_path / "t",
                  dict(list(DOCS.items())[:6]), n_replicas=2, device="cpu")
        assert t.scrub() == {}
        t.hostmap.mark_dead(1, 1)
        t.grid[1][1].posdb.wipe()
        assert t.resync_replica(1, 1)
        assert t.hostmap.alive[1, 1]
        assert _rdb_image(t.grid[1][1]) == _rdb_image(t.grid[1][0])
        t.hostmap.mark_dead(1, 0)
        t.hostmap.mark_dead(1, 1)
        assert not t.resync_replica(1, 1)


# ---- sharded_search --------------------------------------------------------

class TestShardedSearch:
    @pytest.mark.parametrize("site_cluster", [True, False])
    def test_pages_equal_reference(self, grids, jmesh, site_cluster):
        j, t = grids
        for q in QUERIES:
            a = sharded_search(t, q, topk=10, site_cluster=site_cluster)
            b = jsharded_search(j, q, mesh=jmesh, topk=10,
                                site_cluster=site_cluster)
            _same(a, b, q, exact=True)

    def test_matches_the_flat_ranking(self, grids, tmp_path):
        _, t = grids
        flat = Collection("flat", tmp_path, device="cpu")
        flat.conf.pqr_enabled = False
        for url, html in DOCS.items():
            docproc.index_document(flat, url, html)
        for q in ("topic1", "page number", "common words", "topic0 topic1"):
            s = sharded_search(t, q, topk=20, site_cluster=False)
            f = engine.search(flat, q, topk=20, site_cluster=False)
            key = lambda r: (-round(r.score, 3), r.docid)
            assert sorted(map(key, s.results)) == \
                sorted(map(key, f.results)), q
            assert s.total_matches == f.total_matches

    def test_and_no_match_and_paging(self, grids, jmesh):
        j, t = grids
        assert sharded_search(t, "topic2 everywhere",
                              topk=20).total_matches == 6
        res = sharded_search(t, "xylophone")
        assert res.total_matches == 0 and not res.results
        for off in (0, 5, 10):
            _same(sharded_search(t, "page", topk=5, offset=off),
                  jsharded_search(j, "page", mesh=jmesh, topk=5,
                                  offset=off), off, exact=True)

    def test_freq_weights_count_candidateless_shards(self, tmp_path, jmesh):
        docs = {f"http://w{i}.ex.com/c{i}":
                f"<html><body><p>common words for document {i} padding "
                f"text</p></body></html>" for i in range(16)}
        docs["http://w0.ex.com/rare"] = (
            "<html><body><p>common rareterm together in one doc</p>"
            "</body></html>")
        t = _grid(ShardedCollection, tmp_path / "t", docs, device="cpu")
        j = _grid(JSC, tmp_path / "j", docs)
        flat = Collection("fw", tmp_path / "f", device="cpu")
        for u, h in docs.items():
            docproc.index_document(flat, u, h)
        s = sharded_search(t, "common rareterm", topk=5)
        f = engine.search(flat, "common rareterm", topk=5)
        assert len(s.results) == len(f.results) == 1
        assert s.results[0].score == pytest.approx(f.results[0].score,
                                                   rel=1e-5)
        _same(s, jsharded_search(j, "common rareterm", mesh=jmesh, topk=5),
              "rareterm", exact=True)

    def test_delete_then_search(self, grids, jmesh):
        j, t = grids
        url = "http://sitex.example.com/doomed"
        for sc in (j, t):
            sc.index_document(url,
                              "<html><body>unobtainium page</body></html>")
        _same(sharded_search(t, "unobtainium"),
              jsharded_search(j, "unobtainium", mesh=jmesh), "add")
        assert sharded_search(t, "unobtainium").results
        for sc in (j, t):
            assert sc.remove_document(url)
        assert not sharded_search(t, "unobtainium").results
        assert not jsharded_search(j, "unobtainium", mesh=jmesh).results

    def test_suggestion_merges_shards(self, grids):
        _, t = grids
        res = sharded_search(t, "discusses everywere")
        assert res.total_matches == 0
        assert res.suggestion == "discusses everywhere"
        assert suggest_sharded(t, compile_query("everywere")) == \
            "everywhere"

    def test_one_k1_launch_per_query(self, grids, monkeypatch):
        """The shards' cubes score as one [S·B, T, P, D] cube: one
        min-score call per query on a one-device mesh."""
        from open_source_search_engine_tpu_torch.query import scorer
        calls = []
        real = scorer.min_scores_fused

        def spy(cube, *a, **kw):
            calls.append(tuple(cube.shape))
            return real(cube, *a, **kw)
        monkeypatch.setattr(scorer, "min_scores_fused", spy)
        _, t = grids
        sharded_search(t, "topic1", topk=10)
        assert len(calls) == 1 and calls[0][0] == 4


class TestReplicas:
    @pytest.fixture()
    def rpair(self, tmp_path):
        j = _grid(JSC, tmp_path / "j", DOCS, n_replicas=2)
        t = _grid(ShardedCollection, tmp_path / "t", DOCS, n_replicas=2,
                  device="cpu")
        yield j, t
        with jax_gc.quiet():
            del j, t

    def test_twin_failover_serves_identically(self, rpair, jmesh):
        j, t = rpair
        base = sharded_search(t, "topic1", topk=20, site_cluster=False)
        assert not base.degraded
        for s in range(4):
            t.hostmap.mark_dead(s, 0)
            j.hostmap.mark_dead(s, 0)
        res = sharded_search(t, "topic1", topk=20, site_cluster=False)
        assert not res.degraded
        assert [(r.docid, r.score) for r in res.results] == \
            [(r.docid, r.score) for r in base.results]
        _same(res, jsharded_search(j, "topic1", mesh=jmesh, topk=20,
                                   site_cluster=False), "failover", True)

    def test_whole_shard_dead_degrades(self, rpair, jmesh):
        j, t = rpair
        base = sharded_search(t, "topic1", topk=20)
        for sc in (j, t):
            sc.hostmap.mark_dead(1, 0)
            sc.hostmap.mark_dead(1, 1)
        res = sharded_search(t, "topic1", topk=20)
        assert res.degraded
        assert res.total_matches <= base.total_matches
        _same(res, jsharded_search(j, "topic1", mesh=jmesh, topk=20),
              "degraded", exact=True)
        for sc in (j, t):
            sc.hostmap.mark_alive(1, 0)
        back = sharded_search(t, "topic1", topk=20)
        assert not back.degraded
        assert back.total_matches == base.total_matches


# ---- MeshResident: the host merge and the in-program merge -----------------

class TestMeshResident:
    def test_indexes_on_their_devices(self, distinct):
        _, t, _, tm, _ = distinct
        assert tm.devices == [torch.device("cpu")] * 4
        for s, di in enumerate(tm.indexes):
            assert di.device == torch.device("cpu")
            assert di.coll is t.shards[s]

    def test_three_way_parity(self, distinct):
        """Flat device route == host merge == in-program merge, and each
        equal to the JAX package's: docids, scores, totals, clustered."""
        _, _, jm, tm, flat = distinct
        qs = ["apple banana", "gem", "tok7", "apple gem"]
        host = tm.search_batch(qs, topk=5, with_snippets=False)
        meshr = tm.serve_batch(qs, topk=5, with_snippets=False)
        jhost = jm.search_batch(qs, topk=5, with_snippets=False)
        jmeshr = jm.serve_batch(qs, topk=5, with_snippets=False)
        for i, q in enumerate(qs):
            f = engine.search_device(flat, q, topk=5, with_snippets=False)
            for res in (host[i], meshr[i], jhost[i], jmeshr[i]):
                assert res.total_matches == f.total_matches, q
                assert res.clustered == f.clustered, q
                assert [(r.docid, round(r.score, 3))
                        for r in res.results] == \
                    [(r.docid, round(r.score, 3)) for r in f.results], q
            _same(host[i], jhost[i], q, exact=True)
            _same(meshr[i], jmeshr[i], q, exact=True)

    @pytest.mark.parametrize("path", ["search_batch", "serve_batch"])
    def test_batch_equals_reference(self, distinct, path):
        _, _, jm, tm, _ = distinct
        for kw in (dict(topk=5), dict(topk=3, offset=2),
                   dict(topk=8, site_cluster=False)):
            a = getattr(tm, path)(MESH_QUERIES, with_snippets=True, **kw)
            b = getattr(jm, path)(MESH_QUERIES, with_snippets=True, **kw)
            for q, x, y in zip(MESH_QUERIES, a, b):
                _same(x, y, (path, q, kw), exact=True)

    def test_batch_matches_single(self, distinct):
        _, _, _, tm, _ = distinct
        qs = ["gem", "apple", "tok3 gem"]
        batch = tm.search_batch(qs, topk=10, with_snippets=False)
        for q, b in zip(qs, batch):
            s = tm.search(q, topk=10, with_snippets=False)
            assert [r.docid for r in s.results] == \
                [r.docid for r in b.results]

    def test_serve_without_site_cluster_routes_host(self, distinct):
        _, _, _, tm, _ = distinct
        h = tm.search_batch(["apple banana"], topk=8, with_snippets=False,
                            site_cluster=False)
        m = tm.serve_batch(["apple banana"], topk=8, with_snippets=False,
                           site_cluster=False)
        assert [r.docid for r in m[0].results] == \
            [r.docid for r in h[0].results]
        assert m[0].clustered == 0

    def test_mixed_wave_filter_subgroups(self, distinct):
        _, _, _, tm, _ = distinct
        qs = ["apple banana", "apple site:site2.example.com", "gem"]
        host = tm.search_batch(qs, topk=5, with_snippets=False)
        meshr = tm.serve_batch(qs, topk=5, with_snippets=False)
        for q, h, m in zip(qs, host, meshr):
            assert [r.docid for r in m.results] == \
                [r.docid for r in h.results], q
            assert m.total_matches == h.total_matches, q

    def test_no_match_suggestion(self, distinct):
        _, _, jm, tm, _ = distinct
        res = tm.serve("aple banana", with_snippets=False)
        assert res.total_matches == 0 and not res.results
        assert res.suggestion is not None
        assert res.suggestion == jm.serve("aple banana",
                                          with_snippets=False).suggestion

    def test_generation_moves_on_write_and_on_death(self, distinct):
        _, t, _, _, _ = distinct
        g0 = mesh_generation(t)
        assert mesh_generation(t) == g0
        t.hostmap.mark_dead(0, 0)
        try:
            assert mesh_generation(t) != g0
        finally:
            t.hostmap.mark_alive(0, 0)
        assert mesh_generation(t) == g0
        t.mutations += 1
        assert mesh_generation(t) != g0
        t.mutations -= 1

    def test_global_df_memoized(self, distinct):
        _, _, _, tm, _ = distinct
        tm.search("apple", with_snippets=False)
        memo1 = dict(tm._df_memo)
        assert memo1
        gen = tm._df_memo_gen
        tm.search("apple banana", with_snippets=False)
        assert tm._df_memo_gen == gen
        assert all(tm._df_memo[k] == v for k, v in memo1.items())
        tid = next(iter(memo1))
        assert memo1[tid] == sum(di._df_of(tid) for di in tm.indexes)

    def test_the_loop_launches_one_k1_per_wave(self, distinct, monkeypatch):
        from open_source_search_engine_tpu_torch.query import scorer
        calls = []
        real = scorer.min_scores_fused

        def spy(cube, *a, **kw):
            calls.append(tuple(cube.shape))
            return real(cube, *a, **kw)
        monkeypatch.setattr(scorer, "min_scores_fused", spy)
        _, t, _, _, _ = distinct
        msi = MeshServeIndex(t, mesh=make_mesh(4, CPU))
        pend = msi.issue_batch(["apple banana", "gem", "tok1"], topk=48)
        msi.collect_batch(pend)
        # one wave, B padded to the floor of 4: one [S·B] cube
        assert len(calls) == 1 and calls[0][0] == 4 * 4
        assert msi.waves == 1


class TestMeshEscalationAndFailover:
    def test_overfetch_escalation_recall(self, tmp_path):
        """When four sites fill the first k·c merge window, the collect
        regrows it ×4 from the same per-shard blocks until the unique-
        site docs surface: equal to the JAX program's."""
        docs = {}
        for i in range(180):
            docs[f"http://big{i % 4}.example.com/p{i}"] = (
                "<html><body><p>%s</p></body></html>"
                % ("needle " * (3 + i % 37) + f"pad{i} "))
        for i in range(5):
            docs[f"http://unique{i}.example.com/u{i}"] = \
                f"<html><body><p>needle solo{i}</p></body></html>"
        j = _grid(JSC, tmp_path / "j", docs)
        t = _grid(ShardedCollection, tmp_path / "t", docs, device="cpu")
        out = []
        for msi in (MeshServeIndex(t), jsharded.MeshServeIndex(j)):
            pend = msi.issue_batch(["needle"], topk=48)
            first_k = pend.waves[0].out_k
            (res,) = msi.collect_batch(pend)
            assert pend.waves[0].out_k > first_k
            out.append(res)
        (docids, scores, total, clustered, shash), jres = out
        assert total == jres[2] == 185
        assert len(docids) == 4 * 2 + 5
        assert clustered == jres[3] == 185 - 13
        assert np.array_equal(docids, jres[0])
        assert np.array_equal(scores.view(np.int32),
                              jres[1].view(np.int32))
        assert np.array_equal(shash, jres[4])
        mr = MeshResident(t, devices=CPU)
        try:
            (h,) = mr.search_batch(["needle"], topk=13, with_snippets=False)
            (m,) = mr.serve_batch(["needle"], topk=13, with_snippets=False)
            key = lambda r: (-round(r.score, 3), r.docid)
            assert sorted(map(key, m.results)) == sorted(map(key, h.results))
            assert m.clustered == h.clustered
            assert mr._serve_idx.escalations >= 1
        finally:
            with jax_gc.quiet():
                mr.stop()
                del j

    def test_twin_failover_zero_lost_queries(self, tmp_path):
        t = _grid(ShardedCollection, tmp_path / "t", DISTINCT_DOCS,
                  n_replicas=2, device="cpu")
        mr = MeshResident(t, devices=CPU)
        try:
            base = mr.serve("apple banana", topk=5, with_snippets=False)
            assert base.results and not base.degraded
            loop = mr.serve_loop()
            t.hostmap.mark_dead(0, 0)
            after = mr.serve("apple banana", topk=5, with_snippets=False)
            assert not after.degraded
            assert [(r.docid, r.score) for r in after.results] == \
                [(r.docid, r.score) for r in base.results]
            assert loop.alive and loop.drains_for_freshness >= 0
            t.hostmap.mark_dead(0, 1)
            deg = mr.serve("apple banana", topk=5, with_snippets=False)
            assert deg.degraded
            assert deg.total_matches <= base.total_matches
            t.hostmap.mark_alive(0, 0)
            back = mr.serve("apple banana", topk=5, with_snippets=False)
            assert not back.degraded
            assert [r.docid for r in back.results] == \
                [r.docid for r in base.results]
            assert loop.alive
        finally:
            mr.stop()
        # the pool and the loop come back at the next search
        assert mr.serve("gem", topk=5, with_snippets=False).results

    def test_write_reaches_the_next_wave(self, tmp_path):
        t = _grid(ShardedCollection, tmp_path / "t",
                  dict(list(DISTINCT_DOCS.items())[:8]), device="cpu")
        mr = MeshResident(t, devices=CPU)
        try:
            assert mr.serve("zqfresh", with_snippets=False).total_matches \
                == 0
            t.index_document("http://new.example.com/x",
                             "<html><body>zqfresh words</body></html>")
            assert mr.serve("zqfresh", with_snippets=False).total_matches \
                == 1
        finally:
            mr.stop()


# ---- the numeric operators on the mesh --------------------------------------

def _product(i):
    return json.dumps({
        "title": f"Product {i} widget", "body": "common widget words here",
        "price": 10.0 * (i + 1), "rating": i % 5,
        "category": "tools" if i % 3 == 0 else "toys",
        "date": f"2024-0{(i % 8) + 1}-15"})


@pytest.fixture(scope="module")
def shops(tmp_path_factory):
    docs = {f"http://shop{i % 3}.test/p{i}": _product(i) for i in range(24)}
    j = _grid(JSC, tmp_path_factory.mktemp("jshop"), docs)
    t = _grid(ShardedCollection, tmp_path_factory.mktemp("tshop"), docs,
              device="cpu")
    jm, tm = jsharded.MeshResident(j), MeshResident(t, devices=CPU)
    yield j, t, jm, tm
    with jax_gc.quiet():
        jax_gc.release(jm, tm)
        del j, t, jm, tm


NUMERIC = ["widget gbmin:price:55 gbmax:price:145", "widget gbsortby:price",
           "widget gbsortbyrev:date",
           "widget gbmin:date:%d gbmax:date:%d" % (
               calendar.timegm((2024, 3, 1, 0, 0, 0)),
               calendar.timegm((2024, 5, 30, 0, 0, 0))),
           "common gbsortby:rating"]


@pytest.mark.parametrize("q", NUMERIC)
def test_numeric_specs_on_the_mesh(shops, jmesh, q):
    j, t, jm, tm = shops
    a = sharded_search(t, q, topk=24, site_cluster=False,
                       with_snippets=False)
    _same(a, jsharded_search(j, q, mesh=jmesh, topk=24, site_cluster=False,
                             with_snippets=False), q)
    for path in ("search_batch", "serve_batch"):
        x, = getattr(tm, path)([q], topk=24, with_snippets=False)
        y, = getattr(jm, path)([q], topk=24, with_snippets=False)
        _same(x, y, (path, q))
        assert x.total_matches == a.total_matches, (path, q)
    if "gbmin:price" in q:
        assert a.total_matches == 9


# ---- merge_dedup_topk ------------------------------------------------------

@pytest.mark.parametrize("seed,S,k,out_k", [
    (0, 4, 64, 128), (1, 4, 64, 256), (2, 2, 16, 64), (3, 8, 32, 64),
    (4, 1, 8, 4), (5, 3, 20, 1000)])
def test_merge_dedup_topk_equals_reference(seed, S, k, out_k):
    """Seeded [B, S, k] blocks with many exact ties, zero scores (dead
    rows), sitehash 0 rows and crowded sites: every integer output
    exact, the scores bitwise."""
    rng = np.random.default_rng(seed)
    B = 3
    sc = rng.choice(np.float32([0.0, 1.5, 2.25, 7.0, 9.5]), (B, S, k)) \
        * rng.choice(np.float32([1.0, 1.0, 0.5]), (B, S, k))
    sc = sc.astype(np.float32)
    docids = rng.integers(1, 1 << 38, (B, S, k), dtype=np.int64)
    sh = rng.integers(0, 5, (B, S, k), dtype=np.int64)
    n_kept, n_drop, d, h, s, cum = merge_dedup_topk(
        torch.from_numpy(sc), torch.from_numpy(docids),
        torch.from_numpy(sh), out_k)
    for b in range(B):
        hi = (docids[b] >> 32).astype(np.uint32)
        lo = (docids[b] & 0xFFFFFFFF).astype(np.uint32)
        jk, jd, jhi, jlo, jsh, jsc, jcum = (np.asarray(x) for x in
                                            jscorer.merge_dedup_topk(
            jnp.asarray(sc[b]), jnp.asarray(hi), jnp.asarray(lo),
            jnp.asarray(sh[b].astype(np.uint32)), out_k))
        assert int(n_kept[b]) == int(jk) and int(n_drop[b]) == int(jd)
        jdoc = (jhi.astype(np.int64) << 32) | jlo.astype(np.int64)
        assert np.array_equal(d[b].numpy(), jdoc)
        assert np.array_equal(h[b].numpy(), jsh.astype(np.int64))
        assert np.array_equal(s[b].numpy().view(np.int32),
                              jsc.view(np.int32))
        assert np.array_equal(cum[b].numpy(), jcum.astype(np.int64))

"""The port's mesh behind the node and the CLI, against the JAX package
(CPU).

* ``SearchHTTPServer(sharded=...)`` in both ``serve_mesh`` modes (the
  mesh's resident loop with the in-program merge, and
  ``sharded_search`` under the core lock): ``/search`` JSON equal to the
  JAX server's over the same grid (``corpus.assert_pages_match``:
  ``totalMatches``, ``clustered``, ``suggestion`` and ``facets`` exact,
  scores rtol=1e-5, docids by complete tie runs, each result's fields
  exact); ``/admin/hosts``, ``/admin/stats``, and ``/inject``,
  ``/get`` and ``/delete`` routed to the owning shards with every
  shard's Rdbs byte-equal to the JAX grid's after them;
* ``rebalance`` 1 → 4 and 4 → 2 writing files byte-equal to the JAX
  ``rebalance``'s, with the same pages before and after, and the CLI's
  ``rebalance`` verb;
* the golden queries of ``tests/test_golden.py::test_sharded_path``
  through the port's ``sharded_search`` and ``MeshResident``.

The JAX servers and grids are stopped and released inside
``tests/jax_gc.quiet()``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from open_source_search_engine_tpu.control.rebalance import \
    rebalance as jrebalance
from open_source_search_engine_tpu.parallel import sharded as jsharded
from open_source_search_engine_tpu.serve.server import \
    SearchHTTPServer as JServer
from open_source_search_engine_tpu.serve.tenancy import \
    g_residency as jresidency
from open_source_search_engine_tpu_torch.control.rebalance import rebalance
from open_source_search_engine_tpu_torch.corpus import assert_pages_match
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.parallel import (
    MeshResident, ShardedCollection, sharded_search)
from open_source_search_engine_tpu_torch.serve.server import \
    SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from tests import jax_gc
from tests.golden.corpus import GOLDEN_QUERIES, golden_docs
from tests.test_golden import _check
from tests.test_torch_parallel import (DISTINCT_DOCS, _fixed_clock,  # noqa: F401
                                       _grid, _rdb_image)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

SERVE_QUERIES = ["apple banana", "gem", "tok7", "apple gem",
                 "apple site:site2.example.com", "aple banana",
                 "banana -tok3", "doc number"]


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    with jax_gc.quiet():
        yield


def _get(srv, path, **q):
    return srv.handle("GET", path, {k: str(v) for k, v in q.items()}, b"",
                      client_ip="9.9.9.9")


@pytest.fixture(scope="module")
def mesh_servers(tmp_path_factory):
    """A JAX server and a port server (CPU), each fronting a 4-shard grid
    of DISTINCT_DOCS; result cache off."""
    base = tmp_path_factory.mktemp("meshsrv")
    jsc = _grid(jsharded.ShardedCollection, base / "jgrid", DISTINCT_DOCS)
    tsc = _grid(ShardedCollection, base / "tgrid", DISTINCT_DOCS,
                device="cpu")
    j = JServer(base / "j", port=0, sharded=jsc)
    t = SearchHTTPServer(base / "t", port=0, device="cpu", sharded=tsc)
    for srv in (j, t):
        srv.colldb.get("main").conf.result_cache_ttl = 0
    yield j, t
    with jax_gc.quiet():
        jax_gc.release(j, t)
        g_residency.reset()
        jresidency.reset()
        del j, t, jsc, tsc


@pytest.mark.parametrize("serve_mesh", [True, False])
def test_search_pages_equal_reference(mesh_servers, serve_mesh):
    j, t = mesh_servers
    for srv in (j, t):
        srv.conf.serve_mesh = serve_mesh
    for q in SERVE_QUERIES:
        for n in (5, 10):
            (tc, tb, tt), (jc, jb, jt) = (
                _get(s, "/search", q=q, n=n, format="json") for s in (t, j))
            assert (tc, tt) == (jc, jt) == (200, "application/json"), q
            assert_pages_match(tb, jb, (serve_mesh, q, n))
    assert t.stats.get("degraded", 0) == 0


def test_mesh_mode_serves_through_the_mesh_loop(mesh_servers):
    _, t = mesh_servers
    t.conf.serve_mesh = True
    _get(t, "/search", q="apple", format="json")
    mr = t.sharded._mesh_resident
    assert mr._serve_loop is not None and mr._serve_loop.waves_issued >= 1


def test_admin_hosts_and_stats(mesh_servers):
    j, t = mesh_servers
    code, body, ctype = _get(t, "/admin/hosts")
    jcode, jbody, _ = _get(j, "/admin/hosts")
    assert (code, ctype) == (200, "application/json")
    hosts = json.loads(body)
    assert hosts == json.loads(jbody)
    assert hosts["shards"] == 4 and sum(hosts["docsPerShard"]) == 20
    code, body, _ = _get(t, "/admin/stats")
    assert code == 200 and "quarantined_runs" not in json.loads(body)


def test_inject_get_delete_route_through_the_grid(mesh_servers):
    j, t = mesh_servers
    page = ("<html><title>Injected</title><body><p>zqmesh injected words "
            "apple</p></body></html>")
    out = []
    for srv in (j, t):
        code, body, _ = srv.handle("POST", "/inject",
                                   {"u": "http://site9.example.com/inj"},
                                   page.encode())
        assert code == 200
        out.append(json.loads(body))
    assert out[0] == out[1]
    for s in range(4):
        assert _rdb_image(t.sharded.grid[s][0]) == \
            _rdb_image(j.sharded.grid[s][0]), s
    for serve_mesh in (True, False):
        t.conf.serve_mesh = j.conf.serve_mesh = serve_mesh
        tb, jb = (_get(s, "/search", q="zqmesh", format="json")[1]
                  for s in (t, j))
        assert_pages_match(tb, jb, ("inject", serve_mesh))
        assert json.loads(tb)["totalMatches"] == 1
    docid = out[1]["docId"]
    tg, jg = (_get(s, "/get", d=docid, q="zqmesh") for s in (t, j))
    assert tg == jg and tg[0] == 200 and "zqmesh" in tg[1]
    for srv in (j, t):
        code, _, _ = _get(srv, "/delete", u="http://site9.example.com/inj")
        assert code == 200
        assert _get(srv, "/delete",
                    u="http://site9.example.com/inj")[0] == 404
    for s in range(4):
        assert _rdb_image(t.sharded.grid[s][0]) == \
            _rdb_image(j.sharded.grid[s][0]), s
    t.conf.serve_mesh = True
    assert json.loads(_get(t, "/search", q="zqmesh",
                           format="json")[1])["totalMatches"] == 0


def test_cluster_argument_is_not_ported(tmp_path):
    """``cluster=`` is ported since: the server fronts a ClusterClient
    over two node servers, ``/search`` is the client's merged page, and
    ``/inject``, ``/get`` and ``/delete`` go to the owning shard."""
    from open_source_search_engine_tpu_torch.parallel.cluster import (
        ClusterClient, HostsConf, ShardNodeServer)
    from open_source_search_engine_tpu_torch.serve.server import \
        render_results
    nodes = [ShardNodeServer(tmp_path / f"n{s}", device="cpu")
             for s in range(2)]
    for n in nodes:
        n.start()
    client = ClusterClient(HostsConf.parse(
        "num-mirrors: 0\n" + "\n".join(f"127.0.0.1:{n.port}"
                                        for n in nodes)),
        use_heartbeat=False)
    srv = SearchHTTPServer(tmp_path / "proxy", port=0, device="cpu",
                           cluster=client)
    try:
        ids = []
        for i in range(6):
            code, body, _ = srv.handle(
                "POST", "/inject", {"u": f"http://c{i}.test/p"},
                f"<p>zqcluster words page {i}</p>".encode())
            assert code == 200
            ids.append(json.loads(body)["docId"])
        assert sorted(n.coll.num_docs for n in nodes) != [0, 6]
        code, body, _ = _get(srv, "/search", q="zqcluster", format="json")
        assert code == 200 and json.loads(body)["totalMatches"] == 6
        conf = srv.colldb.get("main").conf
        assert json.loads(body) == json.loads(render_results(
            client.search("zqcluster", topk=10, conf=conf), "json")[0])
        code, page, _ = _get(srv, "/get", d=ids[0], q="zqcluster")
        assert code == 200 and "zqcluster" in page
        assert _get(srv, "/delete", u="http://c0.test/p")[0] == 200
        assert json.loads(_get(srv, "/search", q="zqcluster",
                               format="json")[1])["totalMatches"] == 5
        hosts = json.loads(_get(srv, "/admin/hosts")[1])
        assert hosts["shards"] == 2 and sum(hosts["docsPerShard"]) == 5
    finally:
        srv.stop()
        client.close()
        for n in nodes:
            n.stop()


# ---- rebalance -------------------------------------------------------------

def _tree(root: Path) -> dict:
    """Every file under ``root`` by relative path: its bytes."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _snap(res):
    """Total and the page's scores, as ``tests/test_rebalance.py`` holds
    them: a new layout may pick another subset of a tie run the page
    cuts."""
    return (res.total_matches, [r.score for r in res.results])


RB_QUERIES = ["alpha", "alpha bravo", '"lima kilo"', "report -alpha",
              "alpha AND NOT bravo", "site:site0.golden.test alpha",
              "charlie delta report"]


@pytest.mark.parametrize("old_n,new_n", [(1, 4), (4, 2)])
def test_rebalance_byte_equal_to_reference(tmp_path, old_n, new_n):
    docs = golden_docs()
    j = _grid(jsharded.ShardedCollection, tmp_path / "jsrc", docs,
              n_shards=old_n)
    t = _grid(ShardedCollection, tmp_path / "tsrc", docs, n_shards=old_n,
              device="cpu")
    j.save()
    t.save()
    before = {q: _snap(sharded_search(t, q, topk=10, site_cluster=False))
              for q in RB_QUERIES}
    jdst = jrebalance("ptest", j, tmp_path / "jdst", old_n, new_n)
    tdst = rebalance("ptest", tmp_path / "tsrc", tmp_path / "tdst",
                     old_n, new_n, device="cpu")
    assert tdst.n_shards == new_n and tdst.num_docs == jdst.num_docs \
        == len(docs)
    jfiles, tfiles = _tree(tmp_path / "jdst"), _tree(tmp_path / "tdst")
    assert sorted(jfiles) == sorted(tfiles)
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    for row in tdst.grid:
        for c in row:
            c.conf.pqr_enabled = False
    for q in RB_QUERIES:
        assert _snap(sharded_search(tdst, q, topk=10,
                                    site_cluster=False)) == before[q], q
    # a new page routes on the new topology
    tdst.index_document(
        "http://site9.golden.test/late",
        "<html><head><title>Late alpha</title></head><body>"
        "<p>alpha latecomer joins.</p></body></html>")
    assert sharded_search(tdst, "latecomer", topk=5).total_matches == 1
    from open_source_search_engine_tpu_torch.parallel import suggest_sharded
    from open_source_search_engine_tpu_torch.query.compiler import \
        compile_query
    assert suggest_sharded(tdst, compile_query("reprot")) is not None
    with jax_gc.quiet():
        del j, jdst


def test_cli_rebalance_verb(tmp_path):
    """``rebalance`` reshards a saved one-collection directory presented
    as shard 0 of a 1-shard grid."""
    src = tmp_path / "grid1" / "shard_000"
    c = Collection("main", src, device="cpu")
    from open_source_search_engine_tpu_torch.build import docproc
    docproc.index_batch(c, list(golden_docs().items())[:12])
    c.save()
    out = subprocess.run(
        [sys.executable, "-m", "open_source_search_engine_tpu_torch",
         "rebalance", "--dir", str(tmp_path / "grid1"), "--out",
         str(tmp_path / "grid3"), "--old-shards", "1", "--new-shards",
         "3", "--torch-device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "shards": 3, "docs": 12, "out": str(tmp_path / "grid3")}
    dst = ShardedCollection("main", tmp_path / "grid3", n_shards=3,
                            device="cpu")
    assert dst.num_docs == 12
    assert sum(len(row[0].titledb.get_all()) for row in dst.grid) == 12


# ---- the golden queries through the port's mesh ----------------------------

@pytest.fixture(scope="module")
def golden_grid(tmp_path_factory):
    sc = _grid(ShardedCollection, tmp_path_factory.mktemp("goldens"),
               golden_docs(), device="cpu")
    mr = MeshResident(sc, devices=["cpu"])
    yield sc, mr
    mr.stop()


@pytest.mark.parametrize("q", GOLDEN_QUERIES)
def test_golden_sharded_path(golden_grid, q):
    sc, _ = golden_grid
    res = sharded_search(sc, q, topk=10, site_cluster=False)
    _check(q, res.total_matches,
           [(r.docid, r.score) for r in res.results], "sharded")


@pytest.mark.parametrize("q", GOLDEN_QUERIES)
def test_golden_mesh_resident(golden_grid, q):
    _, mr = golden_grid
    res = mr.search(q, topk=10, site_cluster=False, with_snippets=False)
    _check(q, res.total_matches,
           [(r.docid, r.score) for r in res.results], "mesh")

"""The port's cluster against the JAX package's, in process (CPU).

The same 12 documents go through each package's ``ClusterClient`` into
two in-process shard nodes (``ShardNodeServer``; the port's on
``device="cpu"``, on the flat path and on the device route):

* ``HostsConf.dump`` is byte-equal, and parses back to the same map;
* each shard's leg (its batched ``/rpc/search`` reply at the depth the
  client asks for) equals the reference node's: totals exact, scores
  within rtol=1e-5, docids by complete tie runs
  (``corpus.assert_tie_run_parity``, the port's copy of
  ``parallel/routecheck.py::assert_tie_run_parity``);
* merged pages (``corpus.assert_pages_match``), ``get_document`` records
  and the ``degraded`` answer with a shard down are equal;
* the port's ``ClusterClient`` over the reference's nodes gives exactly
  the reference client's pages: the merge alone, on the same legs;
* ``SearchHTTPServer(cluster=...)``: ``/search`` equals the client's
  page, and ``/admin/transport``, ``/admin/perf?format=json``,
  ``/metrics`` and ``/admin/hosts`` answer as the reference server over
  its cluster does (the same keys, the same shard count).

The JAX nodes and servers run inside ``tests/jax_gc.quiet()`` and are
released with ``jax_gc.release``."""

import json

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.parallel import cluster as jcl
from open_source_search_engine_tpu.parallel import transport as jtr
from open_source_search_engine_tpu.serve.server import \
    SearchHTTPServer as JServer
from open_source_search_engine_tpu_torch.corpus import (
    assert_pages_match, assert_tie_run_parity)
from open_source_search_engine_tpu_torch.parallel import cluster as cl
from open_source_search_engine_tpu_torch.parallel import transport as tr
from open_source_search_engine_tpu_torch.serve.server import (
    SearchHTTPServer, render_results)
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from tests import jax_gc
from tests.test_torch_parallel import _fixed_clock  # noqa: F401

torch.set_num_threads(1)

N_SHARDS = 2

DOCS = {
    f"http://s{i % 5}.test/doc{i}": (
        f"<html><head><title>Doc {i} cluster</title></head><body>"
        f"<p>cluster words shared everywhere token{i}. "
        f"{'apple banana ' * (i % 3 + 1)}</p></body></html>")
    for i in range(12)
}

QUERIES = ["cluster words", "token3", "apple banana", "cluster token7",
           "shared everywhere", "apple -token4", "zebra",
           "site:s2.test cluster"]

ROUTES = ["flat", "device"]


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    with jax_gc.quiet():
        yield


def _conf(nodes):
    return "num-mirrors: 0\n" + "\n".join(f"127.0.0.1:{n.port}"
                                          for n in nodes)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory, _fixed_clock):  # noqa: F811
    base = tmp_path_factory.mktemp("clusters")
    jn = [jcl.ShardNodeServer(base / f"j{s}") for s in range(N_SHARDS)]
    tn = {route: [cl.ShardNodeServer(base / f"{route}{s}", device="cpu",
                                     use_device=route == "device")
                  for s in range(N_SHARDS)] for route in ROUTES}
    nodes = jn + [n for ns in tn.values() for n in ns]
    for n in nodes:
        n.start()
    jc = jcl.ClusterClient(jcl.HostsConf.parse(_conf(jn)),
                           use_heartbeat=False)
    tc = {route: cl.ClusterClient(cl.HostsConf.parse(_conf(ns)),
                                  use_heartbeat=False)
          for route, ns in tn.items()}
    try:
        for url, html in DOCS.items():
            jc.index_document(url, html)
            for c in tc.values():
                c.index_document(url, html)
        assert jc.pending_writes == 0
        yield jn, tn, jc, tc
    finally:
        for c in [jc, *tc.values()]:
            c.close()
        for n in nodes:
            n.stop()
        g_residency.reset()


@pytest.mark.parametrize("n_shards,n_replicas", [(1, 1), (2, 2), (4, 1),
                                                 (3, 2)])
def test_hosts_conf_dump_byte_equal(n_shards, n_replicas):
    addrs = [[f"10.0.{s}.{r}:{9000 + s}" for r in range(n_replicas)]
             for s in range(n_shards)]
    mine = cl.HostsConf(n_shards, n_replicas, addrs)
    theirs = jcl.HostsConf(n_shards, n_replicas, addrs)
    assert mine.dump() == theirs.dump()
    back = cl.HostsConf.parse(theirs.dump())
    assert (back.n_shards, back.n_replicas, back.addresses) == \
        (n_shards, n_replicas, addrs)


def _legs(nodes, transport, topk):
    return [transport.request(f"127.0.0.1:{n.port}", "/rpc/search",
                              {"queries": QUERIES, "topk": topk,
                               "lang": 0}, timeout=60.0)["results"]
            for n in nodes]


def _raw(leg):
    return (np.asarray(leg["docids"]), np.asarray(leg["scores"]),
            leg["total"])


@pytest.mark.parametrize("route", ROUTES)
def test_legs_equal_the_reference(clusters, route):
    jn, tn, _, _ = clusters
    topk = cl.leg_topk(10)   # the reference client's depth for a page of 10
    assert topk == 96
    t, jt = tr.Transport(), jtr.Transport()
    try:
        mine, theirs = _legs(tn[route], t, topk), _legs(jn, jt, topk)
    finally:
        t.close()
        jt.close()
    assert sum(leg["total"] for leg in mine[0] + mine[1]) > 0
    for s in range(N_SHARDS):
        for q, a, b in zip(QUERIES, mine[s], theirs[s]):
            assert a["docids"].dtype == b["docids"].dtype
            assert a["scores"].dtype == b["scores"].dtype
            assert_tie_run_parity(_raw(a), _raw(b), (route, s, q))
            if list(a["scores"]) == list(b["scores"]):
                assert list(a["docids"]) == list(b["docids"]), (route, q)


def _page(res):
    return render_results(res, "json")[0]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("site_cluster", [True, False])
def test_merged_pages_equal_the_reference(clusters, route, site_cluster):
    _, _, jc, tc = clusters
    for q in QUERIES:
        kw = dict(topk=5, site_cluster=site_cluster)
        a, b = tc[route].search(q, **kw), jc.search(q, **kw)
        assert a.degraded is b.degraded is False
        assert_pages_match(_page(a), _page(b), (route, q, site_cluster))
    a, b = (c.search_batch(QUERIES, topk=5, with_snippets=False)
            for c in (tc[route], jc))
    for q, x, y in zip(QUERIES, a, b):
        assert_pages_match(_page(x), _page(y), (route, "batch", q))


def test_get_document_records_equal(clusters):
    _, _, jc, tc = clusters
    res = jc.search("cluster", topk=12, site_cluster=False)
    assert res.total_matches == len(DOCS)
    for r in res.results:
        want = jc.get_document(r.docid)
        for c in tc.values():
            assert c.get_document(r.docid) == want, r.docid
    assert tc["flat"].get_document(12345) is None is jc.get_document(12345)


def test_port_client_merges_reference_legs_as_the_reference(clusters):
    jn, _, jc, _ = clusters
    mine = cl.ClusterClient(cl.HostsConf.parse(_conf(jn)),
                            use_heartbeat=False, use_cache=False)
    try:
        for q in QUERIES:
            for kw in (dict(topk=5), dict(topk=3, offset=2),
                       dict(topk=10, site_cluster=False)):
                assert json.loads(_page(mine.search(q, **kw))) == \
                    json.loads(_page(jc.search(q, **kw))), (q, kw)
    finally:
        mine.close()


def test_a_shard_down_is_degraded_as_in_the_reference(clusters):
    """Shard 1's address leads nowhere: both clients answer from shard 0
    alone, flagged ``degraded``, with the same page."""
    import socket
    jn, tn, _, _ = clusters
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    dead = sk.getsockname()[1]
    sk.close()
    text = f"num-mirrors: 0\n127.0.0.1:{{}}\n127.0.0.1:{dead}"
    jc = jcl.ClusterClient(jcl.HostsConf.parse(text.format(jn[0].port)),
                           use_heartbeat=False)
    tc = cl.ClusterClient(cl.HostsConf.parse(
        text.format(tn["flat"][0].port)), use_heartbeat=False)
    try:
        for q in QUERIES[:4]:
            a, b = tc.search(q, site_cluster=False), \
                jc.search(q, site_cluster=False)
            assert a.degraded is b.degraded is True
            assert_pages_match(_page(a), _page(b), ("degraded", q))
            assert a.total_matches < len(DOCS)
    finally:
        jc.close()
        tc.close()


def test_cluster_argument_serves_as_the_reference(clusters, tmp_path):
    jn, tn, jc, tc = clusters
    t = SearchHTTPServer(tmp_path / "t", port=0, device="cpu",
                         cluster=tc["device"])
    j = JServer(str(tmp_path / "j"), port=0, cluster=jc)
    for srv in (t, j):
        srv.colldb.get("main").conf.result_cache_ttl = 0
    try:
        for q in QUERIES:
            code, body, ctype = t.handle("GET", "/search",
                                         {"q": q, "format": "json"}, b"")
            assert (code, ctype) == (200, "application/json")
            assert json.loads(body) == json.loads(
                _page(tc["device"].search(q, topk=10, conf=t.colldb.get(
                    "main").conf))), q
            jbody = j.handle("GET", "/search", {"q": q, "format": "json"},
                             b"")[1]
            assert_pages_match(body, jbody, ("proxy", q))
        pages = {}
        for path in ("/admin/transport", "/admin/perf", "/admin/hosts"):
            got = [json.loads(s.handle("GET", path, {"format": "json"},
                                       b"")[1]) for s in (t, j)]
            pages[path] = got
            assert sorted(got[0]) == sorted(got[1]) or path == \
                "/admin/hosts", (path, sorted(got[0]), sorted(got[1]))
        tt, jt = pages["/admin/transport"]
        assert sorted(tt["hostmap"]) == sorted(jt["hostmap"]) == \
            [f"shard{s}" for s in range(N_SHARDS)]
        assert sorted(tt["hostmap"]["shard0"]) == \
            sorted(jt["hostmap"]["shard0"])
        tp, jp = pages["/admin/perf"]
        assert len(tp["hosts"]) == len(jp["hosts"]) == N_SHARDS
        assert all(w is not None for w in tp["hosts"].values())
        assert "node.search" in tp["fleet"]["latencies"]
        assert tp["fleet"]["latencies"]["node.search"]["count"] == sum(
            w["node.search"]["count"] for w in tp["hosts"].values())
        # the reference shows a cluster as one host; the port shows its
        # shards, with the keys of the reference's mesh page
        th, jh = pages["/admin/hosts"]
        assert jh == {"shards": 1, "mode": "single"}
        assert th["shards"] == N_SHARDS and th["replicas"] == 1
        assert th["alive"] == [[True]] * N_SHARDS
        assert sum(th["docsPerShard"]) == len(DOCS)
        tm, jm = (s.handle("GET", "/metrics", {}, b"")[1] for s in (t, j))
        fams = [{ln.split()[2] for ln in m.splitlines()
                 if ln.startswith("# TYPE")} for m in (tm, jm)]
        assert fams[0] == fams[1]
        for m in (tm, jm):
            assert f"osse_hosts_scraped {N_SHARDS}" in m
        # the telemetry pages answer a cluster front end as the
        # reference's does
        tjit, jjit = (json.loads(s.handle("GET", "/admin/jit",
                                          {"format": "json"}, b"")[1])
                      for s in (t, j))
        assert sorted(tjit) == sorted(jjit)
    finally:
        t.stop()
        jax_gc.release(j)

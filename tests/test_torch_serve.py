"""The port's HTTP entry point (``serve/server.py``) against the JAX
package's, request by request (CPU).

Both servers index the same pages and answer the same requests through
``handle()`` in-process (the HTTP boundary itself is driven through the
port's CLI): ``/search`` JSON is compared with ``serve_device`` on (the
resident device route through the QueryBatcher) and off (the flat
path), on the golden corpus and on ``route_docs(48)`` under
``ROUTE_ENV`` (F1, FD and F2 queries): ``totalMatches``, ``clustered``,
``suggestion`` and ``facets`` exactly, scores within rtol=1e-5, docids
by complete tie runs, and each result's url, title, snippet and site
exactly. Then the other formats, ``/get`` with highlight, the write
path with the result cache, the shed and deadline ladders, autoban,
auth, the 404/400 answers, the port's no-fallback 500, the speller, the
left-out endpoints' 501s and the ``serve`` CLI's restart.

The JAX server's device route compiles each new wave shape on the CPU
(about a second each), so its device-route cases are the golden queries
whose shapes it compiles quickly; every golden query runs on the flat
path."""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.query.speller import Speller as JSpeller
from open_source_search_engine_tpu.serve import admission as jadmission
from open_source_search_engine_tpu.serve.server import \
    SearchHTTPServer as JServer
from open_source_search_engine_tpu.serve.tenancy import \
    g_residency as jresidency
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import (
    ROUTE_ENV, ROUTE_QUERIES, assert_pages_match, route_docs)
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.query.speller import Speller
from open_source_search_engine_tpu_torch.serve import admission
from open_source_search_engine_tpu_torch.serve.server import \
    SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc
from tests.golden.corpus import GOLDEN_QUERIES, golden_docs
from tests.polling import wait_until

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

#: zero-result misspellings: the speller's "did you mean"
MISSPELT = ["alpah", "bravoo report", "chralie"]

#: golden queries the JAX server's CPU device route answers with few
#: wave-shape compiles (every golden query runs on the flat path)
DEVICE_QUERIES = [
    "alpha", "bravo", "kilo", "alphas", "report", "alpha bravo",
    "india juliet kilo", '"alpha bravo"', '"lima kilo"',
    '"bravo overview"', "report -alpha", "bravo -charlie", "kilo -lima",
    "site:site3.golden.test report", "inurl:page7 report",
    "alpha OR bravo", "alpha AND NOT bravo",
    "report AND NOT (alpha OR bravo)", "alpha AND -bravo",
    "lima OR (kilo AND juliet)", '"alpha bravo" -charlie',
    'site:site1.golden.test "lima kilo"', "alpha bravo charlie delta",
    "study", "studies", "topic", "topics", "form", "forms", "zulu",
    "alpha zulu", "-alpha", "report number3", "number12 charlie",
    "echo echo echo", "delta echo foxtrot golf", "bravo study number0",
    "juliet report -echo", "zulu OR yankee", "NOT alpha"]

ROUTE_SET = list(ROUTE_QUERIES) + ["alpha gamma", "beta", "dogs"]


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection while this module drives the JAX package's
    serving path (``tests/jax_gc.py``)."""
    with jax_gc.quiet():
        yield


def _pair(base: Path, name: str, docs, dump: bool = False):
    """A JAX server and a port server (CPU) over the same pages in
    collection ``name``, result cache off (cache cases turn it on)."""
    j = JServer(base / "j", port=0)
    t = SearchHTTPServer(base / "t", port=0, device="cpu")
    for srv, dp in ((j, jdocproc), (t, docproc)):
        c = srv.colldb.get(name)
        c.conf.result_cache_ttl = 0
        dp.index_batch(c, docs)
        if dump:
            c.posdb.dump()
            c.titledb.dump()
    return j, t


def _stop(*servers):
    jax_gc.release(*servers)
    g_residency.reset()
    jresidency.reset()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    j, t = _pair(tmp_path_factory.mktemp("serve"), "main",
                 list(golden_docs().items()))
    yield j, t
    _stop(j, t)


@pytest.fixture()
def edge(tmp_path):
    """A fresh pair for the cases that change a server's conf or gate."""
    j, t = _pair(tmp_path, "main", [
        (f"http://edge{i}.test/p{i}",
         f"<html><title>edge {i}</title><body><p>admission corpus words "
         f"number{i} sunlight</p></body></html>") for i in range(4)])
    yield j, t
    _stop(j, t)


def _get(srv, path, **q):
    return srv.handle("GET", path, {k: str(v) for k, v in q.items()}, b"",
                      client_ip="9.9.9.9")


def _search(srv, q, **kw):
    return _get(srv, "/search", q=q, format="json", **kw)


def _both(servers, q, **kw):
    j, t = servers
    (jc, jb, jt), (tc, tb, tt) = _search(j, q, **kw), _search(t, q, **kw)
    assert (tc, tt) == (jc, jt) == (200, "application/json"), (q, jb, tb)
    return tb, jb


class TestSearchParity:
    @pytest.mark.parametrize("q", DEVICE_QUERIES + MISSPELT)
    def test_device_route(self, servers, q):
        for s in servers:
            s.conf.serve_device = True
        assert_pages_match(*_both(servers, q), q)

    @pytest.mark.parametrize("q", GOLDEN_QUERIES + MISSPELT)
    def test_flat_path(self, servers, q):
        for s in servers:
            s.conf.serve_device = False
        try:
            assert_pages_match(*_both(servers, q), q)
        finally:
            for s in servers:
                s.conf.serve_device = True

    def test_misspelling_suggests(self, servers):
        body, _ = _both(servers, "alpah")
        assert json.loads(body)["suggestion"] == "alpha"

    @pytest.mark.parametrize("fmt,ctype", [("xml", "text/xml"),
                                           ("csv", "text/csv"),
                                           ("html", "text/html")])
    def test_formats(self, servers, fmt, ctype):
        j, t = servers
        (jc, jb, jt), (tc, tb, tt) = (_get(s, "/search", q="alpha",
                                           format=fmt) for s in (j, t))
        assert (tc, tt) == (jc, jt) == (200, ctype)
        # the same rows in the same order; score text within rtol
        num = r"\d+\.\d+(?:e[+-]?\d+)?"
        assert re.sub(num, "#", tb) == re.sub(num, "#", jb)
        np.testing.assert_allclose(
            [float(x) for x in re.findall(num, tb)],
            [float(x) for x in re.findall(num, jb)], rtol=1e-5)

    def test_get_with_highlight(self, servers):
        j, t = servers
        body, _ = _both(servers, "alpha")
        docid = json.loads(body)["results"][0]["docId"]
        got = _get(t, "/get", d=docid, q="alpha")
        assert got == _get(j, "/get", d=docid, q="alpha")
        assert got[0] == 200
        assert re.search(r'background:yellow">alpha</span>', got[1],
                         re.IGNORECASE)
        assert _get(t, "/get", d=12345)[0] == _get(j, "/get", d=12345)[0] \
            == 404


class TestRouteCorpus:
    @pytest.fixture(scope="class")
    def route_servers(self, tmp_path_factory):
        saved = {k: os.environ.get(k) for k in ROUTE_ENV}
        os.environ.update(ROUTE_ENV)
        try:
            j, t = _pair(tmp_path_factory.mktemp("route"), "main",
                         route_docs(48), dump=True)
            yield j, t
            _stop(j, t)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    @pytest.mark.parametrize("q", ROUTE_SET)
    def test_route_parity(self, route_servers, q):
        assert_pages_match(*_both(route_servers, q), q)

    def test_every_route_served(self, route_servers):
        _, t = route_servers
        for q in ROUTE_QUERIES:
            _search(t, q)
        di = t.colldb.get("main")._device_index
        assert min(di.route_counts.values()) >= 1, di.route_counts


class TestWritePath:
    def test_inject_search_delete_search_with_cache(self, edge):
        """The result cache hits on a repeat and a write moves its
        generation: after /inject and /delete the next /search misses
        and shows the write."""
        html = (b"<html><title>D</title><body><p>ephemeral okapi "
                b"content</p></body></html>")
        bodies = []
        for srv in edge:
            srv.colldb.get("main").conf.result_cache_ttl = 30.0
            for i in (1, 2):
                code, out, _ = srv.handle(
                    "POST", "/inject", {"u": f"http://d.test/{i}"}, html)
                assert code == 200 and json.loads(out)["numKeys"] > 0
            first = _search(srv, "okapi")
            assert json.loads(first[1])["totalMatches"] == 2
            h0 = srv.stats.get("result_cache_hits", 0)
            assert _search(srv, "okapi") == first
            assert srv.stats.get("result_cache_hits", 0) == h0 + 1
            assert _get(srv, "/delete", u="http://d.test/1")[0] == 200
            after = json.loads(_search(srv, "okapi")[1])
            assert after["totalMatches"] == 1
            assert all(r["url"] != "http://d.test/1"
                       for r in after["results"])
            assert _get(srv, "/delete", u="http://d.test/ghost")[0] == 404
            bodies.append((first[1], json.dumps(after)))
        assert_pages_match(bodies[1][0], bodies[0][0], "inject")
        assert_pages_match(bodies[1][1], bodies[0][1], "delete")


class TestRebuildAndCache:
    def test_page_from_an_index_behind_a_write_is_not_cached(self, edge):
        """A write, then a dump: the next /search is answered by the old
        index while the background rebuild runs (the pre-write page).
        The port serves that page but does not cache it, so after the
        swap the fresh index answers; the JAX package caches it and
        serves the pre-write page until the TTL ends (ROADMAP §3)."""
        totals = {}
        for which, srv in zip(("jax", "torch"), edge):
            coll = srv.colldb.get("main")
            coll.conf.result_cache_ttl = 60.0
            first = json.loads(_search(srv, "admission corpus")[1])
            srv.handle("POST", "/inject", {"u": "http://late.test/"},
                       b"<p>admission corpus words late</p>")
            coll.dump_all()
            during = json.loads(_search(srv, "admission corpus")[1])
            wait_until(lambda: not getattr(coll, "_di_rebuilding", False),
                       timeout=60, desc="background rebuild")
            after = json.loads(_search(srv, "admission corpus")[1])
            srv._result_cache.flush()
            uncached = json.loads(_search(srv, "admission corpus")[1])
            totals[which] = (first["totalMatches"], during["totalMatches"],
                             after["totalMatches"],
                             uncached["totalMatches"])
        assert totals["torch"] == (4, 4, 5, 5)
        assert totals["jax"] == (4, 4, 4, 5)


class TestEdge:
    @pytest.mark.parametrize("which", ["jax", "torch"])
    def test_shed_ladder(self, edge, which):
        """A gate of one slot, held: the next search sheds 503 with
        Retry-After; with a same-generation stale page, that page."""
        srv = dict(zip(("jax", "torch"), edge))[which]
        adm = {"jax": jadmission, "torch": admission}[which]
        srv.admission = adm.AdmissionGate(max_inflight=1, max_wait_s=0.05)
        srv.colldb.get("main").conf.result_cache_ttl = 0.05
        page = _search(srv, "admission corpus")
        assert page[0] == 200
        held = srv.admission.admit("interactive")
        try:
            code, body, _ = _search(srv, "never cached words")
            assert code == 503 and json.loads(body)["retryAfter"] >= 1
            assert int(dict(adm.pop_response_headers())["Retry-After"]) >= 1
            time.sleep(0.1)   # the cached page expires, same generation
            assert _search(srv, "admission corpus") == page
            assert srv.stats["admission_stale"] == 1
            assert srv.stats["admission_refused"] == 1
        finally:
            held.__exit__(None, None, None)

    @pytest.mark.parametrize("which", ["jax", "torch"])
    def test_deadline_gives_504_or_stale(self, edge, which):
        """A device batch slower than the request's deadline: 504, or
        the same generation's stale page when there is one."""
        srv = dict(zip(("jax", "torch"), edge))[which]
        srv.colldb.get("main").conf.result_cache_ttl = 0.05
        page = _search(srv, "admission corpus")
        assert page[0] == 200
        inner = srv._batcher._run_batch

        def slow(key, qs):
            time.sleep(0.3)
            return inner(key, qs)
        srv._batcher._run_batch = slow
        try:
            code, body, _ = _search(srv, "never cached words",
                                    deadline_ms=50)
            assert code == 504, body
            time.sleep(0.1)
            assert _search(srv, "admission corpus", deadline_ms=50) == page
            assert srv.stats["deadline_stale"] == 1
        finally:
            # the slow batches run on; let them end before teardown
            wait_until(lambda: srv._batcher._inflight == 0, timeout=10,
                       desc="slow batches done")
            srv._batcher._run_batch = inner

    def test_autoban_unknown_coll_missing_q_auth(self, edge, tmp_path):
        outs = []
        for srv in edge:
            srv.colldb.get("main").conf.autoban_qps = 2
            codes = [_search(srv, "admission corpus")[0] for _ in range(4)]
            srv.colldb.get("main").conf.autoban_qps = 0
            srv._ab_banned.clear()
            unknown = _search(srv, "words", c="nosuchcoll")[0]
            missing = _get(srv, "/search")[0]
            srv.conf.master_password = "pw"
            auth = (_get(srv, "/admin/stats")[0],
                    _get(srv, "/admin/stats", pwd="pw")[0],
                    srv.handle("POST", "/inject", {"u": "http://x.test/"},
                               b"<p>x</p>")[0])
            srv.conf.master_password = ""
            outs.append((codes, unknown, missing, auth))
        assert outs[0] == outs[1]
        codes, unknown, missing, auth = outs[1]
        assert codes[:2] == [200, 200] and 429 in codes
        assert (unknown, missing, auth) == (404, 400, (401, 200, 401))
        for srv, sub in zip(edge, "jt"):
            assert not (tmp_path / sub / "coll" / "nosuchcoll").exists()

    def test_slo_tick_feeds_the_admission_signal(self, edge):
        """The server's SLO tick evaluates the declared objectives; a
        burning one raises the degrade signal, and the gate sheds a
        background request while an interactive one is served."""
        from open_source_search_engine_tpu_torch.utils.slo import g_slo
        _, srv = edge
        srv.SLO_TICK_S = 0.02
        g_slo.declare_latency("t_burning", "serve.search",
                              threshold_ms=0.0, target=0.99)
        srv.start()
        try:
            assert _search(srv, "admission corpus")[0] == 200
            wait_until(lambda: g_slo.degraded("t_burning"), timeout=10,
                       desc="the objective burns")
            assert _search(srv, "admission corpus", tier="crawlbot")[0] \
                == 503
            assert _search(srv, "admission corpus")[0] == 200
        finally:
            srv.stop()
            g_slo.objectives.pop("t_burning", None)
            g_slo.evaluate()
        assert not g_slo.degraded()

    def test_failed_device_batch_is_500_without_fallback(self, edge,
                                                         monkeypatch):
        _, srv = edge

        def fail(key, qs):
            raise RuntimeError("kernel launch failed")

        def no_fallback(*a, **k):
            raise AssertionError("the host path answered")
        monkeypatch.setattr(srv._batcher, "_run_batch", fail)
        monkeypatch.setattr(engine, "search", no_fallback)
        before = g_stats.snapshot()["counters"].get("serve.device_error", 0)
        code, body, _ = _search(srv, "admission corpus")
        assert code == 500 and "kernel launch failed" in body
        assert g_stats.snapshot()["counters"]["serve.device_error"] == \
            before + 1
        assert srv.stats["errors"] == 1

    @pytest.mark.parametrize("path", sorted(
        {"/crawlbot", "/admin/hosts", "/admin/transport", "/admin/perf",
         "/admin/jit", "/admin/hbm", "/admin/device", "/admin/profiler",
         "/admin/graph"}))
    def test_left_out_endpoints_answer_501(self, servers, path):
        """Every endpoint once left out (answering 501) is ported now:
        /crawlbot with the crawl plane and /admin/hosts with the mesh,
        the reference's answer; /admin/transport and /admin/perf with the
        cluster, and the telemetry pages with the telemetry plane, the
        reference's status, type and JSON keys (the counters in them are
        each package's own)."""
        code, body, ctype = _get(servers[1], path)
        jcode, jbody, jctype = _get(servers[0], path)
        assert (code, ctype) == (jcode, jctype) and code == 200
        if path in ("/admin/hosts", "/crawlbot"):
            assert json.loads(body) == json.loads(jbody)
            return
        if path == "/admin/graph":
            assert body.startswith("<svg") and jbody.startswith("<svg")
            return
        q = {"sample": "report"} if path == "/admin/profiler" \
            else {"format": "json"}
        tj, jj = (json.loads(_get(srv, path, **q)[1])
                  for srv in (servers[1], servers[0]))
        assert sorted(tj) == sorted(jj), (sorted(tj), sorted(jj))

    @pytest.mark.parametrize("path", [
        "/", "/admin", "/admin/stats", "/admin/mem", "/admin/cache",
        "/admin/parms", "/admin/admission", "/admin/tenants",
        "/admin/traces", "/metrics"])
    def test_pages(self, servers, path):
        j, t = servers
        code, body, ctype = _get(t, path, format="json")
        assert (code, ctype) == _get(j, path, format="json")[::2]
        assert code == 200
        if ctype == "application/json":
            json.loads(body)

    def test_addurl_without_spider_is_503(self, servers):
        for s in servers:
            assert _get(s, "/addurl", u="http://x.test/")[0] == 503


def _connects(server_cls, n: int = 32) -> int:
    """How many of ``n`` connections a listener that accepts nothing
    completes (the rest wait on a dropped SYN)."""
    import socket
    from http.server import BaseHTTPRequestHandler
    srv = server_cls(("127.0.0.1", 0), BaseHTTPRequestHandler)
    socks = []
    try:
        for _ in range(n):
            try:
                socks.append(socket.create_connection(srv.server_address,
                                                      timeout=0.3))
            except OSError:
                break
    finally:
        for s in socks:
            s.close()
        srv.server_close()
    return len(socks)


def test_listener_holds_a_burst_of_connections():
    """The reference's listener (socketserver's backlog of 5) completes
    6 connections that nobody has accepted yet and drops the next SYN,
    which its client retries a second later; the port's holds 32."""
    from http.server import ThreadingHTTPServer
    from open_source_search_engine_tpu_torch.serve.server import \
        NodeHTTPServer
    assert _connects(NodeHTTPServer) == 32
    assert _connects(ThreadingHTTPServer) < 32


def test_speller_suggestions_match(tmp_path):
    words = ("banana apple banana cherry chocolate chocolate recipes "
             "galore recipe alphabet alpha alpha bravo").split()
    typos = ["bananna", "banana", "zzzqq", "chocolote", "recipies",
             "alpah", "brvo", "aple"]
    a, b = JSpeller(tmp_path), Speller(tmp_path)
    for i in range(0, len(words), 3):
        a.add_doc_words(words[i:i + 3])
        b.add_doc_words(words[i:i + 3])
    a.remove_doc_words(["alphabet"])
    b.remove_doc_words(["alphabet"])
    assert dict(a.counts) == dict(b.counts)
    for w in typos:
        assert b.suggest_word(w) == a.suggest_word(w), w
    assert b.suggest_query(typos) == a.suggest_query(typos)


#: one node process: ``serve`` in the main thread (it installs the
#: signal handlers) and a client thread that waits for the port, makes
#: its requests, prints what it got and SIGTERMs its own process
_CLI_NODE = """
import json, os, signal, sys, threading, time, urllib.request
sys.path.insert(0, {root!r})
from open_source_search_engine_tpu_torch.__main__ import main
base, inject = "http://127.0.0.1:{port}/", {inject}

def get(path, data=None):
    with urllib.request.urlopen(urllib.request.Request(base + path,
                                data=data), timeout=60) as r:
        return r.status, r.headers.get_content_type(), json.load(r)

def client():
    try:
        for _ in range(600):
            try:
                get("admin/stats")
                break
            except OSError:
                time.sleep(0.05)
        if inject:
            for i in range(3):
                assert get(f"inject?u=http://cli{{i}}.test/", (
                    f"<html><title>cli {{i}}</title><body><p>restart "
                    f"survives words{{i}}</p></body></html>").encode())[0] \
                    == 200
        out = [get("search?q=restart+survives&format=json"),
               get("search?q=restrat")[2]["suggestion"]]
        print("RESULT " + json.dumps(out), flush=True)
    finally:
        os.kill(os.getpid(), signal.SIGTERM)

threading.Thread(target=client, daemon=True).start()
sys.exit(main(["serve", "--dir", {base!r}, "--port", "{port}",
               "--torch-device", "cpu"]))
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_node(base: Path, inject: bool):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _CLI_NODE.format(
            root=str(ROOT), port=_free_port(), inject=inject,
            base=str(base))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    result = [json.loads(ln[len("RESULT "):]) for ln in lines
              if ln.startswith("RESULT ")]
    assert result and json.loads(lines[-1])["stopped"], out.stdout
    return result[0]


def test_cli_serve_restart_answers_the_same(tmp_path):
    """The HTTP boundary through the ``serve`` CLI: POST /inject and GET
    /search; SIGTERM stops the node and saves every open collection, and
    a restarted node gives the same page and the same suggestion."""
    first = _run_node(tmp_path / "node", inject=True)
    again = _run_node(tmp_path / "node", inject=False)
    (status, ctype, page), suggestion = first
    assert (status, ctype) == (200, "application/json")
    assert page["totalMatches"] == 3 and suggestion == "restart"
    assert again == first

"""The port's crawlbot REST API and ``/addurl`` (``serve/crawlbot.py``,
``serve/server.py``) on the CPU.

``tests/test_crawlbot.py`` (a job's lifecycle over HTTP, the admin gate)
and ``tests/test_tenancy.py``'s crawlbot delete run against the port.
Beside them: a deleted job leaves no tenant, no HBM ledger bytes and no
directory, and a job made again under its name starts afresh; the same
job on both packages' servers reports the same status; a job crawling a
real site over HTTP (robots.txt included) is searched through
``/search?c=crawl_<name>`` as the flat path answers (totals, scores,
docids by tie runs); and
``/addurl`` answers 200 with a spider and 503 without one. Every fetch
goes to a server in this process."""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from open_source_search_engine_tpu.serve.server import \
    SearchHTTPServer as JSearchHTTPServer
from open_source_search_engine_tpu.spider.fetcher import \
    Fetcher as JFetcher
from open_source_search_engine_tpu.spider.fetcher import \
    FetchResult as JFetchResult
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import \
    assert_clustered_page_parity
from open_source_search_engine_tpu_torch.index.collection import \
    CollectionDb
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.serve.crawlbot import (CrawlBot,
                                                                CrawlJob)
from open_source_search_engine_tpu_torch.serve.server import \
    SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.spider.fetcher import (Fetcher,
                                                                FetchResult)
from open_source_search_engine_tpu_torch.spider.loop import SpiderLoop
from open_source_search_engine_tpu_torch.utils import devwatch
from open_source_search_engine_tpu_torch.utils.membudget import g_membudget
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc
from tests.polling import wait_until

#: the tier-1 run shares the host's cores among several workers
torch.set_num_threads(1)

PAGES = {
    "http://cb.test/": "<html><body><p>crawlbot start page "
                       '<a href="/a">a</a> <a href="/b">b</a>'
                       "</p></body></html>",
    "http://cb.test/a": "<html><body><p>crawlbot alpha words"
                        "</p></body></html>",
    "http://cb.test/b": "<html><body><p>crawlbot beta words"
                        "</p></body></html>",
}

DOC = ("<html><head><title>{t}</title></head><body>"
       "<p>walrus {t} herd gathers on the {t} shore. "
       "The walrus colony of {t} dives deep.</p></body></html>")


def _fake_pages(urls, result_cls):
    return [result_cls(url=u, status=200,
                       content=PAGES.get(u.rstrip("/") if u.rstrip("/")
                                         in PAGES else u, ""),
                       content_type="text/html") for u in urls]


class FakeFetcher(Fetcher):
    def __init__(self):
        super().__init__(cache_ttl_s=0)

    def fetch_many(self, urls, **kw):
        return _fake_pages(urls, FetchResult)


class JFakeFetcher(JFetcher):
    def __init__(self):
        super().__init__(cache_ttl_s=0)

    def fetch_many(self, urls, **kw):
        return _fake_pages(urls, JFetchResult)


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection while this module drives the JAX package's
    server (``tests/jax_gc.py``)."""
    with jax_gc.quiet():
        yield


@pytest.fixture(autouse=True)
def _plane_reset():
    g_stats.reset()
    g_residency.reset()
    yield
    devwatch.disable()
    devwatch.reset()
    g_residency.reset()


@pytest.fixture
def srv(tmp_path):
    s = SearchHTTPServer(tmp_path, port=0, device="cpu")
    s.crawl_fetcher_factory = FakeFetcher
    s.start()
    yield s
    s.stop()


def _get(srv, path):
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                   timeout=60)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_done(srv, name, timeout=60.0):
    return wait_until(
        lambda: (lambda b: b if b["done"] else None)(
            _get(srv, f"/crawlbot?name={name}")[1]),
        timeout=timeout, interval=0.05, desc=f"crawl job {name} done")


# ---- tests/test_crawlbot.py ----------------------------------------------

def test_crawlbot_lifecycle(srv):
    st, body = _get(srv, "/crawlbot")
    assert st == 200 and body["jobs"] == []
    st, body = _get(srv, "/crawlbot?name=shop&seeds=http://cb.test/"
                         "&maxpages=10&maxhops=3")
    assert st == 200 and body["name"] == "shop"
    st, _ = _get(srv, "/crawlbot?name=shop&seeds=http://cb.test/")
    assert st == 409  # a duplicate create
    body = _wait_done(srv, "shop")
    assert body["indexed"] == 3 and body["links_found"] >= 2
    # the crawled corpus answers through the normal search surface
    st, res = _get(srv, "/search?q=crawlbot+alpha&c=crawl_shop&format=json")
    assert st == 200 and res["totalMatches"] == 1
    assert res["results"][0]["url"] == "http://cb.test/a"
    st, body = _get(srv, "/crawlbot?name=shop&action=delete")
    assert st == 200 and body["deleted"]
    st, _ = _get(srv, "/crawlbot?name=shop")
    assert st == 404


def test_crawlbot_requires_auth_when_password_set(srv):
    srv.conf.master_password = "pw"
    st, _ = _get(srv, "/crawlbot")
    assert st == 401
    st, body = _get(srv, "/crawlbot?pwd=pw")
    assert st == 200
    srv.conf.master_password = ""


def test_pause_and_resume(srv):
    st, body = _get(srv, "/crawlbot?name=p&action=pause")
    assert st == 404
    _get(srv, "/crawlbot?name=p&seeds=http://cb.test/&maxpages=10")
    st, body = _get(srv, "/crawlbot?name=p&action=pause")
    assert st == 200 and body["paused"]
    st, body = _get(srv, "/crawlbot?name=p&action=resume")
    assert st == 200 and not body["paused"]
    assert _wait_done(srv, "p")["indexed"] == 3
    assert [j["name"] for j in _get(srv, "/crawlbot")[1]["jobs"]] == ["p"]


# ---- tests/test_tenancy.py's delete lifecycle ----------------------------

def test_crawlbot_delete_unserves_and_unbills(tmp_path):
    """A deleted job's collection stops serving (its resident loop
    stopped, its tenant and device gauge gone), stops billing the
    memtable budget, and leaves no directory; a collection made again
    under the name starts empty."""
    colldb = CollectionDb(tmp_path, device="cpu")
    bot = CrawlBot(colldb)
    mem_before = g_membudget.used("memtable")
    coll = colldb.get("crawl_wipe")
    coll.conf.pqr_enabled = False
    docproc.index_document(coll, "http://wipe.test/p", DOC.format(t="wipe"))
    assert g_membudget.used("memtable") > mem_before
    loop = engine.get_resident_loop(coll)
    assert loop.alive
    assert g_membudget.used("device") > 0
    # a job record without a crawl thread: delete() needs the entry only
    bot.jobs["wipe"] = CrawlJob(name="wipe", loop=None, max_pages=1)
    assert bot.delete("wipe")
    assert not loop.alive
    assert "crawl_wipe" not in colldb.colls
    assert "crawl_wipe" not in g_residency.snapshot()["tenants"]
    assert g_membudget.used("device") == 0
    assert g_membudget.used("memtable") <= mem_before
    assert not (tmp_path / "coll" / "crawl_wipe").exists()
    assert colldb.get("crawl_wipe").num_docs == 0
    assert not bot.delete("wipe")  # gone already


def test_delete_drops_the_ledger_and_a_new_job_starts_afresh(srv):
    devwatch.enable()
    _get(srv, "/crawlbot?name=led&seeds=http://cb.test/&maxpages=10")
    assert _wait_done(srv, "led")["indexed"] == 3
    st, res = _get(srv, "/search?q=crawlbot&c=crawl_led&format=json")
    assert st == 200 and res["totalMatches"] == 3
    assert devwatch.collection_bytes("crawl_led") > 0
    assert "crawl_led" in g_residency.snapshot()["tenants"]
    cdir = srv.colldb.base_dir / "coll" / "crawl_led"
    assert (cdir / "spider" / "spiderdb").is_dir()
    assert _get(srv, "/crawlbot?name=led&action=delete")[1]["deleted"]
    assert devwatch.collection_bytes("crawl_led") == 0
    assert "crawl_led" not in g_residency.snapshot()["tenants"]
    assert not cdir.exists()
    # the durable seen set went with the directory: the same seeds crawl
    # again from an empty frontier
    st, body = _get(srv, "/crawlbot?name=led&seeds=http://cb.test/"
                         "&maxpages=10")
    assert st == 200 and body["name"] == "led"
    assert _wait_done(srv, "led")["indexed"] == 3


def test_job_status_equals_the_reference(tmp_path):
    """The same job on both packages' servers, with the same fake fetch,
    ends in the same status."""
    jsrv = JSearchHTTPServer(tmp_path / "jax", port=0)
    jsrv.crawl_fetcher_factory = JFakeFetcher
    tsrv = SearchHTTPServer(tmp_path / "port", port=0, device="cpu")
    tsrv.crawl_fetcher_factory = FakeFetcher
    q = {"name": "same", "seeds": "http://cb.test/", "maxpages": "10",
         "maxhops": "2"}
    try:
        for s in (jsrv, tsrv):
            assert s.handle("GET", "/crawlbot", dict(q), b"")[0] == 200
        bodies = []
        for s in (jsrv, tsrv):
            bodies.append(wait_until(
                lambda s=s: (lambda b: b if b["done"] else None)(json.loads(
                    s.handle("GET", "/crawlbot", {"name": "same"}, b"")[1])),
                timeout=60, interval=0.05, desc="job done"))
        assert bodies[0] == bodies[1]
        assert bodies[1]["indexed"] == 3 and bodies[1]["frontier"] == 0
        lists = [json.loads(s.handle("GET", "/crawlbot", {}, b"")[1])
                 for s in (jsrv, tsrv)]
        assert lists[0] == lists[1]
    finally:
        for s in (jsrv, tsrv):
            bot = s._crawlbot
            if bot is not None and bot.get("same") is not None:
                bot.get("same").thread.join(30)
        jax_gc.release(jsrv)
        tsrv.stop()


# ---- a real crawl over HTTP, searched on the device route -----------------

#: three sites, each page linking to its site's next page and to a page of
#: the next site; /private is disallowed by every robots.txt
N_SITES, N_PAGES = 3, 4


def _site_pages(port_of):
    words = ["otter", "heron", "maple", "cedar", "quartz", "basalt"]
    pages = {}
    for s in range(N_SITES):
        for p in range(N_PAGES):
            nxt = f"/p{(p + 1) % N_PAGES}"
            other = f"http://127.0.0.{(s + 1) % N_SITES + 2}:" \
                    f"{port_of[(s + 1) % N_SITES]}/p{p}"
            extra = '<a href="/private/x">private</a>' if p == 1 else ""
            pages[(s, f"/p{p}")] = (
                f"<html><head><title>site {s} page {p}</title></head><body>"
                f"<p>{words[(s + p) % 6]} {words[(s * p) % 6]} river "
                f"{words[p % 6]} stone</p><a href=\"{nxt}\">next</a> "
                f"<a href=\"{other}\">{words[s % 6]} link</a>{extra}"
                "</body></html>")
        pages[(s, "/")] = "<html><body>" + "".join(
            f'<a href="/p{p}">page {p}</a> ' for p in range(N_PAGES)) + \
            "</body></html>"
    return pages


@pytest.fixture(scope="module")
def sites():
    """One listener per site, each on its own loopback address, so each
    site has its own first IP."""
    servers, port_of, pages = [], {}, {}

    def handler_for(s):
        class _H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/robots.txt":
                    body, ctype = b"User-agent: *\nDisallow: /private\n", \
                        "text/plain"
                elif (s, self.path) in pages:
                    body, ctype = pages[(s, self.path)].encode(), "text/html"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
        return _H

    for s in range(N_SITES):
        httpd = ThreadingHTTPServer((f"127.0.0.{s + 2}", 0), handler_for(s))
        port_of[s] = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
    pages.update(_site_pages(port_of))
    yield [f"http://127.0.0.{s + 2}:{port_of[s]}/" for s in range(N_SITES)]
    for httpd in servers:
        httpd.shutdown()
        httpd.server_close()


def test_real_crawl_is_searched_as_the_flat_path(tmp_path, sites,
                                                  monkeypatch):
    """A job with the real Fetcher over three sites (robots.txt honoured,
    hosts spanned, each IP polite) indexes every allowed page, and
    ``/search?c=crawl_web`` answers each query with the flat path's
    total, scores and docids (by tie runs, site clustering on)."""
    # the fetcher's opener honours http_proxy: keep loopback direct
    monkeypatch.setenv("no_proxy", ",".join(
        f"127.0.0.{s + 2}" for s in range(N_SITES)))
    srv = SearchHTTPServer(tmp_path, port=0, device="cpu")
    srv.conf.master_password = "pw"
    srv.start()
    try:
        st, body = _get(srv, "/crawlbot?pwd=pw&name=web&maxhops=3"
                             "&spanhosts=1&maxpages=100&seeds="
                             + ",".join(sites))
        assert st == 200, body
        done = wait_until(
            lambda: (lambda b: b if b["done"] else None)(
                _get(srv, "/crawlbot?pwd=pw&name=web")[1]),
            timeout=60, interval=0.05, desc="crawl done")
        allowed = N_SITES * (N_PAGES + 1)
        assert done["indexed"] == allowed, done
        assert done["robots_blocked"] == N_SITES and done["errors"] == 0
        assert done["jobError"] == ""
        # the post-query rerank demotes a result by the others in its
        # window, which the clustering picks by tie order: off, so that
        # the unclustered flat scores are the served ones
        st, body = _get(srv, "/admin/parms?pwd=pw&c=crawl_web&pqr=0")
        assert st == 200 and body["updated"] == {"pqr": "0"}, body
        coll = srv.colldb.get("crawl_web")
        assert not coll.conf.pqr_enabled
        for q in ("river stone", "otter", "heron maple", "cedar link",
                  "quartz basalt", "page"):
            st, page = srv.handle("GET", "/search", {
                "q": q, "c": "crawl_web", "format": "json", "n": "10",
                "pwd": "pw"}, b"")[:2]
            assert st == 200
            assert_clustered_page_parity(
                page, engine.search(coll, q, topk=10),
                engine.search(coll, q, topk=100, site_cluster=False,
                              with_snippets=False), q)
        assert not g_stats.counters.get("serve.device_error")
    finally:
        srv.stop()


# ---- /addurl -------------------------------------------------------------

def test_addurl_queues_into_the_spider(tmp_path):
    srv = SearchHTTPServer(tmp_path, port=0, device="cpu")
    try:
        q = {"u": "http://add.test/page"}
        code, body, _ = srv.handle("GET", "/addurl", dict(q), b"")
        assert code == 503 and json.loads(body)["error"] == \
            "spider not running"
        spider = SpiderLoop(srv.colldb.get("main"),
                            fetcher=FakeFetcher())
        spider.sched.resolver = lambda host: "10.0.0.1"
        srv.spider = spider
        code, body, _ = srv.handle("GET", "/addurl", dict(q), b"")
        assert code == 200 and json.loads(body) == {"queued": q["u"]}
        assert len(spider.sched) == 1
        assert srv.handle("GET", "/addurl", {}, b"")[0] == 400
        assert srv.stats["addurls"] == 2
        srv.conf.master_password = "pw"
        assert srv.handle("GET", "/addurl", dict(q), b"")[0] == 401
    finally:
        srv.stop()

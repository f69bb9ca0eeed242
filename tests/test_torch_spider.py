"""The port's crawler against a local HTTP site, and its frontier.

The scenarios of ``tests/test_spider.py`` (scheduler, siterank, a crawl
of a tiny site with robots.txt), ``tests/test_spiderdb.py`` (the durable
frontier), the charset cases of ``tests/test_unicode_syn.py`` and
``tests/test_utils.py``, the scheduler round-trip of
``tests/test_control.py`` and ``tests/test_oddments.py``'s TtlCache run
against the port. Then the same inputs through both packages, compared
exactly: the first-IP fallback, spiderdb's keys and shards, spiderdb's
runs and journal after the same adds, a crawl of the tiny site (its
stats, and titledb, posdb and linkdb written byte for byte alike) and
the ``crawl`` verb's JSON line. Every fetch goes to a server in this
process."""

import contextlib
import json
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from open_source_search_engine_tpu.__main__ import main as jmain
from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.spider import Fetcher as JFetcher
from open_source_search_engine_tpu.spider import SpiderLoop as JSpiderLoop
from open_source_search_engine_tpu.spider import \
    SpiderScheduler as JSpiderScheduler
from open_source_search_engine_tpu.spider import \
    UrlFilterRule as JUrlFilterRule
from open_source_search_engine_tpu.spider import spiderdb as jspiderdb
from open_source_search_engine_tpu.utils import ipresolve as jipresolve
from open_source_search_engine_tpu_torch.__main__ import main
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.spider import (
    Fetcher, Linkdb, SpiderLoop, SpiderScheduler, UrlFilterRule, site_rank)
from open_source_search_engine_tpu_torch.spider import spiderdb
from open_source_search_engine_tpu_torch.spider.fetcher import (
    FetchResult, sniff_charset)
from open_source_search_engine_tpu_torch.spider.spiderdb import (
    DurableSpiderScheduler, shard_of_url, urlhash63)
from open_source_search_engine_tpu_torch.utils import ipresolve
from open_source_search_engine_tpu_torch.utils.ttlcache import TtlCache
from open_source_search_engine_tpu_torch.utils.unicodenorm import \
    resolve_charset

# the reference's tiny site: home -> a, b; a -> b, secret; b -> a (a
# cycle); /secret disallowed by robots.txt
PAGES = {
    "/robots.txt": ("text/plain", "User-agent: *\nDisallow: /secret\n"),
    "/": ("text/html",
          "<html><head><title>Home</title></head><body>"
          "<p>Welcome to the homepage of testsite.</p>"
          '<a href="/a">page a</a> <a href="/b">page b</a></body></html>'),
    "/a": ("text/html",
           "<html><head><title>Alpha</title></head><body>"
           "<p>Alpha page discusses aardvarks.</p>"
           '<a href="/b">to b</a> <a href="/secret">hidden</a>'
           "</body></html>"),
    "/b": ("text/html",
           "<html><head><title>Beta</title></head><body>"
           "<p>Beta page discusses badgers.</p>"
           '<a href="/a">back to a</a></body></html>'),
    "/secret": ("text/html",
                "<html><body><p>classified zebra data</p></body></html>"),
}


class _SiteHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        hit = PAGES.get(self.path)
        if hit is None:
            self.send_error(404)
            return
        ctype, body = hit
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture(scope="module")
def site():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _SiteHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def linker(site):
    """A second site, ``localhost`` on its own port, whose home page links
    to the tiny site's pages: its edges reach linkdb."""
    body = ("<html><head><title>Links</title></head><body><p>A directory "
            f'of <a href="{site}/a">aardvark pages</a> and <a href="{site}'
            '/b">badger pages</a>.</p></body></html>').encode()

    class _Linker(_SiteHandler):
        def do_GET(self):
            if self.path != "/":
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Linker)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://localhost:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


@contextlib.contextmanager
def _fixed_clock():
    """Both indexers stamp a page's titlerec and its default date with
    the wall clock: one fixed clock makes their records byte-equal."""
    clock = types.SimpleNamespace(time=lambda: 1.7e9,
                                  strptime=time.strptime)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(docproc, "time", clock)
        mp.setattr(jdocproc, "time", clock)
        yield


def _tree(root: Path) -> dict:
    """Every file under ``root`` by relative path: its bytes."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ---- tests/test_spider.py ------------------------------------------------

class TestScheduler:
    def test_dedup_and_hops(self):
        s = SpiderScheduler(max_hops=1)
        assert s.add_url("http://x.test/")
        assert not s.add_url("http://x.test/")          # seen
        assert s.add_url("http://x.test/p", hopcount=1)
        assert not s.add_url("http://x.test/q", hopcount=2)  # too deep

    def test_priority_order(self):
        s = SpiderScheduler(filters=[
            UrlFilterRule("important", priority=5),
            UrlFilterRule("*", priority=0)])
        s.add_url("http://a.test/x")
        s.add_url("http://b.test/important")
        batch = s.next_batch(2)
        assert batch[0].url.endswith("important")

    def test_filter_block(self):
        s = SpiderScheduler(filters=[
            UrlFilterRule("spam", allow=False), UrlFilterRule("*")])
        assert not s.add_url("http://spam.test/page")
        assert s.add_url("http://ok.test/page")

    def test_politeness_same_host_spacing(self):
        s = SpiderScheduler(filters=[UrlFilterRule("*", delay_s=60.0)])
        s.add_url("http://slow.test/1")
        s.add_url("http://slow.test/2")
        now = time.monotonic()
        b = s.next_batch(2, now=now)
        assert len(b) == 1                    # one IP: one in flight
        assert len(s.next_batch(2, now=now)) == 0
        # in flight: the IP stays locked until the fetch completes
        assert len(s.next_batch(2, now=now + 61)) == 0
        s.release(b[0].url, now=now)          # done: the window runs
        assert len(s.next_batch(2, now=now + 1)) == 0
        assert len(s.next_batch(2, now=now + 61)) == 1

    def test_per_ip_discipline_across_hosts(self):
        """Two hosts resolving to one IP share a politeness window and
        are never in flight together."""
        ips = {"a.shared.test": "10.0.0.7", "b.shared.test": "10.0.0.7",
               "other.test": "10.0.0.9"}
        s = SpiderScheduler(filters=[UrlFilterRule("*", delay_s=30.0)],
                            resolver=lambda h: ips.get(h, "10.9.9.9"))
        s.add_url("http://a.shared.test/x")
        s.add_url("http://b.shared.test/y")
        s.add_url("http://other.test/z")
        now = time.monotonic()
        b = s.next_batch(3, now=now)
        assert len(b) == 2
        assert {r.first_ip for r in b} == {"10.0.0.7", "10.0.0.9"}
        assert len(s.next_batch(3, now=now + 999)) == 0  # in flight
        for r in b:
            s.release(r.url, now=now)
        assert len(s.next_batch(3, now=now + 1)) == 0
        assert len(s.next_batch(3, now=now + 31)) == 1


def test_site_rank_step_table():
    assert site_rank(0) == 0
    assert site_rank(1) == 1
    assert site_rank(7) == 6
    assert site_rank(100) == 10
    assert site_rank(10**6) == 15


class TestCrawl:
    @pytest.fixture(scope="class")
    def crawled(self, tmp_path_factory, site):
        coll = Collection("crawl", tmp_path_factory.mktemp("crawl"),
                          device="cpu")
        loop = SpiderLoop(
            coll,
            scheduler=SpiderScheduler(
                filters=[UrlFilterRule("*", delay_s=0.0)], max_hops=3),
            fetcher=Fetcher(n_threads=4, timeout=5.0))
        loop.add_url(site + "/")
        stats = loop.crawl(max_pages=20)
        loop.fetcher.close()
        return coll, loop, stats, site

    def test_crawl_reaches_linked_pages(self, crawled):
        coll, loop, stats, site = crawled
        assert stats.indexed == 3  # home, a, b; not /secret, not robots
        assert stats.robots_blocked >= 1

    def test_crawled_content_searchable(self, crawled):
        coll, _, _, site = crawled
        res = engine.search(coll, "aardvarks")
        assert len(res.results) == 1
        assert res.results[0].url.endswith("/a")
        res = engine.search(coll, "badgers")
        assert res.results[0].title == "Beta"

    def test_robots_page_not_indexed(self, crawled):
        coll, _, _, site = crawled
        assert not engine.search(coll, "zebra").results

    def test_cycle_fetched_once(self, crawled):
        _, loop, stats, _ = crawled
        # the a <-> b cycle is not fetched again: /, /a, /b and the
        # robots-blocked /secret
        assert stats.fetched == 4

    def test_linkdb_counts_external_only(self, tmp_path):
        ldb = Linkdb(tmp_path)
        ldb.add_link("target.com", "linker1.com", "http://linker1.com/x")
        ldb.add_link("target.com", "linker1.com", "http://linker1.com/y")
        ldb.add_link("target.com", "linker2.com", "http://linker2.com/")
        ldb.add_link("target.com", "target.com", "http://target.com/self")
        assert ldb.site_num_inlinks("target.com") == 2  # distinct sites
        assert ldb.site_num_inlinks("other.com") == 0


def test_fetch_many_shares_one_opener_under_contention(site):
    """Sixteen fetch threads over the tiny site, the interpreter switching
    threads every microsecond: every fetch answers, in the URLs' order,
    through the one direct opener the Fetcher builds."""
    import sys
    urls = [site + p for p in ("/", "/a", "/b")] * 32
    f = Fetcher(n_threads=16, timeout=10.0, respect_robots=False,
                cache_ttl_s=0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res = f.fetch_many(urls)
    finally:
        sys.setswitchinterval(old)
        f.close()
    assert [r.status for r in res] == [200] * len(urls)
    assert [r.url for r in res] == urls
    assert [r.content for r in res[:3]] == [PAGES[p][1]
                                            for p in ("/", "/a", "/b")]
    assert list(f._openers) == [None]


# ---- tests/test_spiderdb.py ----------------------------------------------

def urls(n, host="a.test"):
    return [f"http://{host}/p{i}" for i in range(n)]


class TestDurableFrontier:
    def test_checkpoint_restart_resumes_exact_frontier(self, tmp_path):
        s = DurableSpiderScheduler(tmp_path, max_hops=5)
        for u in urls(20):
            assert s.add_url(u)
        batch = []
        for i in range(8):  # one per politeness window (one host)
            got = s.next_batch(1, now=1000.0 * (i + 1))
            batch += got
            for r in got:
                s.release(r.url, now=1000.0 * (i + 1))
        assert len(batch) == 8
        for r in batch:
            s.mark_done(r.url)
        s.checkpoint()
        # a kill -9: the object is dropped without a further save
        done = {r.url for r in batch}
        s2 = DurableSpiderScheduler(tmp_path, max_hops=5)
        assert len(s2) == 12
        doled = []
        t = 1e12
        while not s2.exhausted:
            t += 1000.0
            got = s2.next_batch(50, now=t)
            doled += [r.url for r in got]
            for r in got:
                s2.release(r.url, now=t)
        assert set(doled) == set(urls(20)) - done
        for u in urls(20):
            assert not s2.add_url(u)

    def test_unreplied_inflight_redoles(self, tmp_path):
        s = DurableSpiderScheduler(tmp_path)
        for u in urls(4, host="b.test"):
            s.add_url(u)
        inflight = s.next_batch(1, now=1e9) + s.next_batch(1, now=2e9)
        s.checkpoint()
        s2 = DurableSpiderScheduler(tmp_path)
        redo = {r.url for r in (s2.next_batch(50, now=1e12)
                                + s2.next_batch(50, now=2e12))}
        assert {r.url for r in inflight} <= redo

    def test_every_add_survives_a_crash(self, tmp_path):
        s = DurableSpiderScheduler(tmp_path)
        for u in urls(6, host="c.test"):
            s.add_url(u)
        s.add_url("http://c.test/late")           # never checkpointed
        s2 = DurableSpiderScheduler(tmp_path)     # a crash restart
        assert len(s2) == 7
        assert not s2.add_url("http://c.test/late")

    def test_host_hash_sharding_consistent(self):
        for u in ["http://x.test/a", "http://x.test/b"]:
            assert shard_of_url(u, 4) == shard_of_url("http://x.test/z", 4)
        spread = {shard_of_url(f"http://h{i}.test/", 8) for i in range(64)}
        assert len(spread) > 4

    def test_crawl_loop_integration(self, tmp_path):
        pages = {
            f"http://crawl.test/p{i}": (
                f"<html><head><title>P{i}</title></head><body>"
                f"<p>page {i} words"
                + (f' <a href="/p{i+1}">next</a>' if i < 5 else "")
                + "</p></body></html>")
            for i in range(6)
        }

        class FakeFetcher(Fetcher):
            def fetch_many(self, urls, **kw):
                return [FetchResult(url=u, status=200,
                                    content=pages.get(u, ""),
                                    content_type="text/html")
                        for u in urls]

        c = Collection("crawl", tmp_path / "coll", device="cpu")
        sched = DurableSpiderScheduler(tmp_path / "sp", max_hops=10)
        loop = SpiderLoop(c, scheduler=sched, fetcher=FakeFetcher(),
                          batch_size=2)
        loop.add_url("http://crawl.test/p0")
        for _ in range(30):
            loop.crawl_step()
            sched.ip_ready_at.clear()             # skip the politeness
            if sched.exhausted:
                break
        assert loop.stats.indexed == 6
        s2 = DurableSpiderScheduler(tmp_path / "sp", max_hops=10)
        assert len(s2) == 0
        assert not s2.add_url("http://crawl.test/p3")


def test_same_ip_hosts_share_shard_and_never_fetch_concurrently(tmp_path):
    ips = {"a.cdn.test": "93.1.2.3", "b.cdn.test": "93.1.2.3",
           "c.cdn.test": "93.1.2.3", "solo.test": "94.4.5.6"}

    def res(h):
        return ips.get(h, "0.0.0.1")
    for n in (2, 4, 16):
        shards = {shard_of_url(f"http://{h}/p{i}", n, resolver=res)
                  for h in ("a.cdn.test", "b.cdn.test", "c.cdn.test")
                  for i in range(5)}
        assert len(shards) == 1
    s = DurableSpiderScheduler(tmp_path, resolver=res)
    for h in ("a.cdn.test", "b.cdn.test", "c.cdn.test", "solo.test"):
        assert s.add_url(f"http://{h}/page")
    got = s.next_batch(10, now=1e9)
    by_ip = {}
    for r in got:
        by_ip[r.first_ip] = by_ip.get(r.first_ip, 0) + 1
    assert by_ip == {"93.1.2.3": 1, "94.4.5.6": 1}
    assert s.next_batch(10, now=2e9) == []  # both IPs in flight
    for r in got:
        s.release(r.url, now=2e9)
    assert len(s.next_batch(10, now=3e9)) == 1


# ---- charsets, the scheduler round-trip, TtlCache ------------------------

def test_charset_aliases():
    """``tests/test_unicode_syn.py::test_charset_aliases``."""
    assert resolve_charset("x-sjis") == "shift_jis"
    assert resolve_charset("ks_c_5601-1987") == "cp949"
    assert resolve_charset("totally-bogus") is None
    assert sniff_charset(b"<meta charset='gb2312'>", None) == "gb2312"
    assert sniff_charset(b"\xef\xbb\xbfrest", None) == "utf-8"


def test_charset_sniff():
    """``tests/test_utils.py::test_charset_sniff``."""
    assert sniff_charset(b"<html>", "iso-8859-1") == "iso-8859-1"
    assert sniff_charset(
        b'<html><meta charset="windows-1251"><body>', None) \
        == "windows-1251"
    assert sniff_charset(
        b"<meta http-equiv=Content-Type content='text/html; "
        b"charset=shift_jis'>", None) == "shift_jis"
    assert sniff_charset(b"\xef\xbb\xbfhello", None) == "utf-8"
    assert sniff_charset(b"<html>", None) == "utf-8"
    assert sniff_charset(b"x", "not-a-charset") == "utf-8"


def test_latin1_page_decodes_and_indexes(tmp_path):
    raw = "Münchner Straßenfest".encode("latin-1")
    text = raw.decode(sniff_charset(raw, "iso-8859-1"))
    coll = Collection("l", tmp_path, device="cpu")
    docproc.index_document(
        coll, "http://l.test/1",
        f"<html><body><p>{text} beginnt morgen</p></body></html>")
    assert engine.search(coll, "münchner", topk=5).total_matches == 1


class TestSpiderPersistence:
    def test_save_load_roundtrip(self, tmp_path):
        s = SpiderScheduler()
        s.add_url("http://a.test/1")
        s.add_url("http://a.test/2")
        s.next_batch(1)
        s.save_to(tmp_path / "spider.json")
        s2 = SpiderScheduler()
        assert s2.load_from(tmp_path / "spider.json")
        assert len(s2) == len(s)
        assert s2.seen == s.seen
        assert not s2.add_url("http://a.test/1")  # still deduped
        assert [d.url for d in sorted(s2.heap)] == \
            [d.url for d in sorted(s.heap)]

    def test_load_missing_is_false(self, tmp_path):
        assert not SpiderScheduler().load_from(tmp_path / "nope.json")


class TestTtlCache:
    def test_ttl_and_eviction(self):
        c = TtlCache(ttl_s=0.05, max_entries=4)
        c.put("a", 1)
        assert c.get("a") == 1
        time.sleep(0.06)
        assert c.get("a") is None
        for i in range(5):
            c.put(i, i)
        assert c.stats()["entries"] <= 4

    def test_version_invalidation(self):
        c = TtlCache(ttl_s=60)
        c.put("k", "v")
        c.bump_version()
        assert c.get("k") is None

    def test_put_sheds_dead_entries_before_live(self):
        c = TtlCache(ttl_s=60, max_entries=4)
        for k in ("a", "b", "c"):
            c.put(k, k)
        c.bump_version()
        c.put("d", "d")
        c.put("e", "e")   # at the cap: the dead go, not the live
        assert c.get("d") == "d" and c.get("e") == "e"
        st = c.stats()
        assert st["entries"] == 2 and st["live"] == 2


# ---- the same inputs through both packages -------------------------------

CROSS_URLS = [
    "http://a.test/", "http://a.test/p?q=1", "https://b.example.com/x/y",
    "http://Mixed.Case.test/Path", "http://xn--bcher-kva.test/",
    "http://10.0.0.7:8080/z", "http://deep.sub.site.test/a/b/c.html",
    "http://a.test/p#frag"] + [f"http://h{i}.test/p{i}" for i in range(24)]


def test_first_ip_fallback_keys_and_shards_equal_the_reference():
    from open_source_search_engine_tpu.spider.spiderdb import \
        unpack_keys as junpack
    hosts = ["a.test", "b.example.com", "localhost.invalid", "h7.test",
             "", "xn--bcher-kva.test"] + [f"s{i}.test" for i in range(32)]
    for h in hosts:
        assert ipresolve._pseudo_ip(h) == jipresolve._pseudo_ip(h), h

    def res(h):
        return ipresolve._pseudo_ip(h)
    keys, jkeys = [], []
    for u in CROSS_URLS:
        full = jspiderdb.normalize(u).full
        assert urlhash63(full) == jspiderdb.urlhash63(full), u
        for n in (1, 2, 4, 7, 16):
            assert shard_of_url(u, n, resolver=res) == \
                jspiderdb.shard_of_url(u, n, resolver=res), (u, n)
        for t in (spiderdb.TYPE_REQUEST, spiderdb.TYPE_REPLY):
            k = spiderdb.pack_key(u, t, resolver=res)
            jk = jspiderdb.pack_key(u, t, resolver=res)
            assert k.tobytes() == jk.tobytes(), (u, t)
            keys.append(k)
            jkeys.append(jk)
    a, b = np.stack(keys), np.stack(jkeys)
    for name, col in spiderdb.unpack_keys(a).items():
        assert np.array_equal(col, junpack(b)[name]), name


def _frontier_ops(mod, base: Path):
    """The same adds, doles, replies and checkpoints through one
    package's durable scheduler."""
    ips = {f"h{i}.test": f"10.0.{i % 3}.{i}" for i in range(12)}
    s = mod.DurableSpiderScheduler(base, max_hops=4,
                                   resolver=lambda h: ips.get(h, "10.9.9.9"))
    for i, u in enumerate([f"http://h{i % 12}.test/p{i}"
                           for i in range(40)]):
        s.add_url(u, hopcount=i % 3)
    got = s.next_batch(8, now=1e9)
    for r in got[:5]:
        s.mark_done(r.url, first_ip=r.first_ip)
    s.db.rdb.dump()
    for u in ("http://h1.test/late", "http://h2.test/late"):
        s.add_url(u)
    s.mark_done("http://h1.test/late", first_ip=ips["h1.test"])
    s.db.rdb.save()
    s.db._journal.close()
    return s


def test_spiderdb_runs_and_journal_equal_the_reference(tmp_path):
    _frontier_ops(spiderdb, tmp_path / "port")
    _frontier_ops(jspiderdb, tmp_path / "jax")
    a, b = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(a) == sorted(b)
    assert "spiderdb/addsinprogress.jsonl" in a
    assert any(n.startswith("spiderdb/run_") for n in a)
    for name in a:
        assert a[name] == b[name], name
    # each package reopens the other's frontier to the same state
    port = DurableSpiderScheduler(tmp_path / "jax")
    ref = jspiderdb.DurableSpiderScheduler(tmp_path / "port")
    assert [d.url for d in sorted(port.heap)] == \
        [d.url for d in sorted(ref.heap)]
    assert port._seen63 == ref._seen63 and len(port) == 36


def test_tiny_site_crawl_equals_the_reference(tmp_path, site, linker):
    """The reference's tiny site, and a second site linking into it,
    crawled by both packages with no politeness delay: one dole, fetch
    and index order, so equal stats and byte-equal titledb, posdb and
    linkdb after a save and a dump."""
    with _fixed_clock():
        port = Collection("crawl", tmp_path / "port", device="cpu")
        ref = JCollection("crawl", tmp_path / "jax")
        stats = []
        for coll, loop_cls, sched_cls, rule, fetch_cls in (
                (port, SpiderLoop, SpiderScheduler, UrlFilterRule, Fetcher),
                (ref, JSpiderLoop, JSpiderScheduler, JUrlFilterRule,
                 JFetcher)):
            loop = loop_cls(coll, scheduler=sched_cls(
                filters=[rule("*", delay_s=0.0)], max_hops=3),
                fetcher=fetch_cls(n_threads=4, timeout=5.0))
            loop.add_url(linker + "/")
            loop.add_url(site + "/")
            stats.append(loop.crawl(max_pages=20))
            loop.fetcher.close()
            coll.save()
    assert stats[0].__dict__ == stats[1].__dict__
    assert stats[0].indexed == 4 and stats[0].links_found == 7
    for name in ("titledb", "posdb", "linkdb"):
        a = _tree(tmp_path / "port" / "coll" / "crawl" / name)
        b = _tree(tmp_path / "jax" / "coll" / "crawl" / name)
        assert "saved/meta.json" in a, sorted(a)
        assert a == b, name
    port.dump_all()
    ref.dump_all()
    for name in ("titledb", "posdb", "linkdb"):
        a = _tree(tmp_path / "port" / "coll" / "crawl" / name)
        b = _tree(tmp_path / "jax" / "coll" / "crawl" / name)
        assert any(n.startswith("run_") for n in a), sorted(a)
        assert a == b, name


def test_crawl_verb_json_equals_the_reference(tmp_path, site, capsys):
    outs = []
    for fn, extra in ((main, ["--torch-device", "cpu"]), (jmain, [])):
        d = tmp_path / ("port" if fn is main else "jax")
        assert fn(["crawl", "--dir", str(d), "--seeds", site + "/",
                   "--max-pages", "10"] + extra) == 0
        outs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert outs[0] == outs[1] == {"fetched": 4, "indexed": 3, "errors": 0,
                                  "docs": 3}
    # the frontier is durable: a second crawl of the same seeds fetches
    # only the robots-blocked /secret again (a block writes no reply)
    assert main(["crawl", "--dir", str(tmp_path / "port"), "--seeds",
                 site + "/", "--torch-device", "cpu"]) == 0
    again = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert again == {"fetched": 1, "indexed": 0, "errors": 0, "docs": 3}


def test_crawl_over_a_sharded_collection_equals_the_reference(tmp_path):
    """The loop over a ShardedCollection reads siterank from the owning
    shard's linkdb and writes each page through the mesh's scatter: the
    same fake crawl of four sites into both packages' 2-shard grids writes
    every shard byte for byte alike, and sharded_search finds its pages."""
    from open_source_search_engine_tpu.parallel.sharded import \
        ShardedCollection as JShardedCollection
    from open_source_search_engine_tpu_torch.parallel import (
        ShardedCollection, sharded_search)

    sites = [f"http://s{i}.test" for i in range(4)]
    pages = {}
    for i, s in enumerate(sites):
        other = sites[(i + 1) % 4]
        pages[s + "/"] = (f"<html><head><title>site {i}</title></head><body>"
                          f"<p>sharded crawl root {i}</p>"
                          f'<a href="/p">inner</a> '
                          f'<a href="{other}/p">neighbour page</a></body>'
                          "</html>")
        pages[s + "/p"] = (f"<html><body><p>sharded crawl page {i} "
                           f'words</p><a href="{other}/">next site</a>'
                           "</body></html>")

    def fake(cls, result_cls):
        class _Fake(cls):
            def fetch_many(self, urls):
                return [result_cls(url=u, status=200, content=pages[u],
                                   content_type="text/html") for u in urls]
        return _Fake

    from open_source_search_engine_tpu.spider.fetcher import \
        FetchResult as JFetchResult
    with _fixed_clock():
        port = ShardedCollection("sc", tmp_path / "port", n_shards=2,
                                 device="cpu")
        ref = JShardedCollection("sc", tmp_path / "jax", n_shards=2)
        stats = []
        for sc, loop_cls, sched_cls, rule, fetch in (
                (port, SpiderLoop, SpiderScheduler, UrlFilterRule,
                 fake(Fetcher, FetchResult)),
                (ref, JSpiderLoop, JSpiderScheduler, JUrlFilterRule,
                 fake(JFetcher, JFetchResult))):
            loop = loop_cls(sc, scheduler=sched_cls(
                filters=[rule("*", delay_s=0.0)],
                resolver=lambda h: "10.0.0." + h[1]),
                fetcher=fetch(cache_ttl_s=0))
            for s in sites:
                loop.add_url(s + "/")
            stats.append(loop.crawl(max_pages=20))
            loop.fetcher.close()
            for row in sc.grid:
                for c in row:
                    c.save()
    assert stats[0].__dict__ == stats[1].__dict__
    assert stats[0].indexed == 8 and stats[0].errors == 0
    a, b = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    names = [n for n in a if "/titledb/" in n or "/posdb/" in n
             or "/linkdb/" in n]
    assert any("/linkdb/saved/" in n for n in names), sorted(a)
    for n in names:
        assert a[n] == b.get(n), n
    assert sharded_search(port, "sharded crawl", topk=10).total_matches == 8


def test_recrawl_delta_equals_the_reference(tmp_path, site, linker):
    """A crawl leaves re-indexed pages in the memtable over a dumped base
    (the inlink propagation tombstones and re-adds its linkees): the
    DeviceIndex's delta, its tombstone dfs included, equals the JAX
    package's over the same records."""
    from open_source_search_engine_tpu.query.devindex import \
        DeviceIndex as JDeviceIndex
    from open_source_search_engine_tpu_torch.query.devindex import \
        DeviceIndex
    from tests import jax_gc

    new_home = ("<html><head><title>Links</title></head><body><p>New "
                f'<a href="{site}/a">aardvark guide</a> and <a href="'
                f'{site}/b">badger guide</a>.</p></body></html>')
    with _fixed_clock(), jax_gc.quiet():
        port = Collection("crawl", tmp_path / "port", device="cpu")
        ref = JCollection("crawl", tmp_path / "jax")
        for coll, loop_cls, sched_cls, rule, fetch_cls, dp in (
                (port, SpiderLoop, SpiderScheduler, UrlFilterRule, Fetcher,
                 docproc),
                (ref, JSpiderLoop, JSpiderScheduler, JUrlFilterRule,
                 JFetcher, jdocproc)):
            loop = loop_cls(coll, scheduler=sched_cls(
                filters=[rule("*", delay_s=0.0)]),
                fetcher=fetch_cls(n_threads=4, timeout=5.0))
            loop.add_url(linker + "/")
            loop.add_url(site + "/")
            loop.crawl(max_pages=20)
            loop.fetcher.close()
            coll.dump_all()
            dp.index_document(coll, linker + "/", new_home)
        jdi, tdi = JDeviceIndex(ref), DeviceIndex(port, device="cpu")
        for attr in ("dir_termids", "base_df", "base_docids", "dir2_termids",
                     "delta_df", "all_docids", "tomb_df"):
            assert np.array_equal(getattr(jdi, attr), getattr(tdi, attr)), \
                attr
        assert tdi.tomb_df.sum() > 0 and len(port.posdb.runs) == 1
        del jdi, tdi

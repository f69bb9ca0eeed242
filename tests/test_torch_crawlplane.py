"""The port's crawl plane: the wire DNS resolver with TTLs, the proxy pool
with ban rotation, and the binary-document converters.

``tests/test_crawlplane.py``'s scenarios run against the port, each
fetch and query against a server in this process. Then the same inputs
through both packages, compared exactly: DNS query packets and parsed
responses, ``pdf_text_builtin`` and ``kind_of``."""

import socket
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from open_source_search_engine_tpu.build import convert as jconvert
from open_source_search_engine_tpu.utils import dnsresolver as jdns
from open_source_search_engine_tpu_torch.build.convert import (
    convert_to_text, is_convertible, kind_of, pdf_text_builtin)
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.spider import (SpiderLoop,
                                                        SpiderScheduler)
from open_source_search_engine_tpu_torch.spider.fetcher import Fetcher
from open_source_search_engine_tpu_torch.spider.proxies import (ProxyPool,
                                                                looks_banned)
from open_source_search_engine_tpu_torch.utils import dnsresolver, ipresolve
from open_source_search_engine_tpu_torch.utils.dnsresolver import (
    QTYPE_A, QTYPE_CNAME, QTYPE_NS, DnsResolver, build_query,
    parse_response)

# ---- DNS --------------------------------------------------------------


def _name_bytes(name: str) -> bytes:
    out = b""
    for lb in name.strip(".").split("."):
        out += bytes([len(lb)]) + lb.encode()
    return out + b"\x00"


def _rr(name: str, rtype: int, ttl: int, rdata: bytes) -> bytes:
    return (_name_bytes(name)
            + struct.pack(">HHIH", rtype, 1, ttl, len(rdata)) + rdata)


def _response(query: bytes, answers=(), authority=(), additional=(),
              rcode: int = 0) -> bytes:
    qid = struct.unpack(">H", query[:2])[0]
    qend = 12  # the question section, echoed
    while query[qend]:
        qend += 1 + query[qend]
    qend += 5
    hdr = struct.pack(">HHHHHH", qid, 0x8000 | rcode, 1, len(answers),
                      len(authority), len(additional))
    return hdr + query[12:qend] + b"".join(answers) + \
        b"".join(authority) + b"".join(additional)


class FakeDnsServer:
    """A canned-answer UDP DNS server: ``responder(name, query)`` builds
    the reply (None: no reply)."""

    def __init__(self, responder):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.responder = responder
        self.queries: list[str] = []
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def _loop(self):
        self.sock.settimeout(0.2)
        while not self._stop:
            try:
                data, peer = self.sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                return
            name, _ = dnsresolver._read_name(data, 12)
            self.queries.append(name)
            reply = self.responder(name, data)
            if reply is not None:
                self.sock.sendto(reply, peer)

    def stop(self):
        self._stop = True
        self.sock.close()
        self.thread.join(5)


class TestDnsResolver:
    def test_a_record_with_ttl_cached(self):
        def responder(name, q):
            return _response(q, answers=[
                _rr(name, QTYPE_A, 300, socket.inet_aton("10.1.2.3"))])
        srv = FakeDnsServer(responder)
        try:
            r = DnsResolver([srv.addr])
            assert r.resolve("example.test") == "10.1.2.3"
            assert r.resolve("example.test") == "10.1.2.3"
            assert len(srv.queries) == 1  # the second came from the cache
            # the record's own TTL, on the cache plane's (expiry, gen,
            # cost, value) entry
            exp = r._cache._d["example.test"][0]
            assert 200 < exp - time.monotonic() <= 300
        finally:
            srv.stop()

    def test_cname_chain(self):
        def responder(name, q):
            if name == "www.alias.test":
                return _response(q, answers=[
                    _rr(name, QTYPE_CNAME, 60, _name_bytes("real.test")),
                    _rr("real.test", QTYPE_A, 60,
                        socket.inet_aton("10.9.9.9"))])
            return _response(q, rcode=3)
        srv = FakeDnsServer(responder)
        try:
            assert DnsResolver([srv.addr]).resolve("www.alias.test") \
                == "10.9.9.9"
        finally:
            srv.stop()

    def test_nxdomain_negative_cached(self):
        srv = FakeDnsServer(lambda name, q: _response(q, rcode=3))
        try:
            r = DnsResolver([srv.addr])
            assert r.resolve("nope.test") is None
            assert r.resolve("nope.test") is None
            assert len(srv.queries) == 1
        finally:
            srv.stop()

    def test_timeout_budget(self, monkeypatch):
        srv = FakeDnsServer(lambda name, q: None)  # a black hole
        monkeypatch.setattr(dnsresolver, "TOTAL_BUDGET_S", 1.0)
        monkeypatch.setattr(dnsresolver, "TRY_TIMEOUT_S", 0.3)
        try:
            t0 = time.monotonic()
            assert DnsResolver([srv.addr]).resolve("slow.test") is None
            assert time.monotonic() - t0 < 3.0
        finally:
            srv.stop()

    def test_iterative_referral_walk(self):
        """A root-style server refers to the authority (NS and glue A);
        the walk follows the referral to the answer."""
        auth = FakeDnsServer(lambda name, q: _response(q, answers=[
            _rr(name, QTYPE_A, 120, socket.inet_aton("10.77.0.1"))]))

        def root_responder(name, q):
            return _response(
                q, authority=[_rr("test", QTYPE_NS, 120,
                                  _name_bytes("ns1.test"))],
                additional=[_rr("ns1.test", QTYPE_A, 120,
                                socket.inet_aton("127.0.0.1"))])
        root = FakeDnsServer(root_responder)
        try:
            # the glue names 127.0.0.1; the resolver's port routes the
            # follow-up to the authority server
            r = DnsResolver([root.addr], iterative=True, port=auth.port)
            assert r.resolve("www.deep.test") == "10.77.0.1"
            assert root.queries and auth.queries
        finally:
            root.stop()
            auth.stop()

    def test_first_ip_uses_the_wire_resolver(self, monkeypatch):
        """``OSSE_DNS_SERVERS`` routes ``ipresolve.first_ip`` through the
        wire resolver; an unresolvable host takes the pseudo-IP."""
        def responder(name, q):
            if name == "wired.test":
                return _response(q, answers=[
                    _rr(name, QTYPE_A, 300, socket.inet_aton("10.4.4.4"))])
            return _response(q, rcode=3)
        srv = FakeDnsServer(responder)
        monkeypatch.setenv("OSSE_DNS_SERVERS", srv.addr)
        ipresolve.clear_cache()
        try:
            assert ipresolve.first_ip("wired.test") == "10.4.4.4"
            assert ipresolve.first_ip("gone.test") == \
                ipresolve._pseudo_ip("gone.test")
            assert ipresolve.first_ip("wired.test") == "10.4.4.4"
            assert srv.queries.count("wired.test") == 1
        finally:
            srv.stop()
            monkeypatch.delenv("OSSE_DNS_SERVERS")
            ipresolve.clear_cache()


# ---- proxies ----------------------------------------------------------


class TestProxyPool:
    def test_sticky_and_ban_rotation(self):
        pool = ProxyPool(["p1:1", "p2:2", "p3:3"])
        first = pool.pick("1.2.3.4")
        pool.release(first)
        again = pool.pick("1.2.3.4")
        pool.release(again)
        assert first == again  # sticky per target ip
        assert pool.report(first, "1.2.3.4", 403)  # a ban
        nxt = pool.pick("1.2.3.4")
        pool.release(nxt)
        assert nxt != first
        # other target ips still use the banned proxy
        others = {pool.pick(f"9.9.9.{i}") for i in range(12)}
        assert first in others

    def test_all_banned_goes_direct(self):
        pool = ProxyPool(["p1:1", "p2:2"])
        pool.report("p1:1", "5.5.5.5", 429)
        pool.report("p2:2", "5.5.5.5", 403)
        assert pool.pick("5.5.5.5") is None

    def test_ban_page_detection(self):
        assert looks_banned(403, "")
        assert looks_banned(429, "")
        assert looks_banned(200, "<html>Please solve this CAPTCHA")
        assert not looks_banned(200, "a perfectly fine page " * 20)
        assert not looks_banned(200, "long article mentioning captcha "
                                + "filler " * 2000)

    def test_fetcher_rotates_on_ban(self):
        hits = {"ban": 0, "good": 0}

        class _Proxy(BaseHTTPRequestHandler):
            banned = False

            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.banned:
                    hits["ban"] += 1
                    body = b"Access Denied - CAPTCHA required"
                else:
                    hits["good"] += 1
                    body = (b"<html><title>ok</title>"
                            b"<body>proxied page body</body></html>")
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class _Banned(_Proxy):
            banned = True

        s_ban = ThreadingHTTPServer(("127.0.0.1", 0), _Banned)
        s_ok = ThreadingHTTPServer(("127.0.0.1", 0), _Proxy)
        for s in (s_ban, s_ok):
            threading.Thread(target=s.serve_forever, daemon=True).start()
        ipresolve.resolver_override = lambda host: "10.0.0.1"
        try:
            # the sticky pick may start on either proxy; the banned one
            # is detected and rotated away from
            pool = ProxyPool([f"127.0.0.1:{s_ban.server_address[1]}",
                              f"127.0.0.1:{s_ok.server_address[1]}"])
            f = Fetcher(respect_robots=False, cache_ttl_s=0, proxies=pool)
            res = f.fetch_one("http://proxied.test/page")
            f.close()
            assert res.ok and "proxied page body" in res.content
            assert hits["good"] >= 1
        finally:
            ipresolve.resolver_override = None
            ipresolve.clear_cache()
            s_ban.shutdown()
            s_ok.shutdown()


# ---- convert ----------------------------------------------------------


def _tiny_pdf(text: str) -> bytes:
    stream = f"BT /F1 12 Tf ({text}) Tj ET".encode()
    return (b"%PDF-1.4\n1 0 obj\n<< /Length " + str(len(stream)).encode()
            + b" >>\nstream\n" + stream
            + b"\nendstream\nendobj\ntrailer\n<<>>\n%%EOF\n")


def _flate_pdf(raw: bytes, head: bytes = b"/Filter /FlateDecode") -> bytes:
    comp = zlib.compress(raw)
    return (b"%PDF-1.4\n1 0 obj\n<< " + head + b" /Length "
            + str(len(comp)).encode() + b" >>\nstream\n" + comp
            + b"\nendstream\nendobj\n%%EOF\n")


class TestConverters:
    def test_kind_detection(self):
        assert is_convertible("application/pdf")
        assert is_convertible("", "http://x.test/a/b.PDF")
        assert is_convertible("application/msword")
        assert not is_convertible("text/html")

    def test_builtin_pdf_extraction(self):
        pdf = _tiny_pdf("quarterly aardwolf report 2021")
        assert "quarterly aardwolf report 2021" in pdf_text_builtin(pdf)

    def test_builtin_pdf_flate_and_escapes(self):
        out = pdf_text_builtin(_flate_pdf(
            rb"BT (line \(one\)) Tj T* (line two) Tj ET"))
        assert "line (one)" in out and "line two" in out

    def test_convert_to_text_pdf(self):
        pdf = _tiny_pdf("wombat migration study")
        assert "wombat migration study" in convert_to_text(
            pdf, "application/pdf")

    def test_crawl_ingests_pdf(self, tmp_path):
        """The spider fetches a PDF URL, the converter turns it into text
        and the page is found."""
        pdf = _tiny_pdf("subterranean wombat census results")

        class _Site(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/robots.txt":
                    body, ctype = b"", "text/plain"
                elif self.path == "/report.pdf":
                    body, ctype = pdf, "application/pdf"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Site)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            coll = Collection("c", tmp_path, device="cpu")
            sched = SpiderScheduler()
            sched.add_url(f"{base}/report.pdf")
            loop = SpiderLoop(coll, sched, fetcher=Fetcher(cache_ttl_s=0))
            loop.crawl_step()
            loop.fetcher.close()
            res = engine.search(coll, "wombat census", topk=5)
            assert res.total_matches == 1
            assert res.results[0].url.endswith("/report.pdf")
        finally:
            httpd.shutdown()
            httpd.server_close()


# ---- the same inputs through both packages ----------------------------

QUERIES = [("example.test", 1, QTYPE_A, True), ("a.b.c.d.test.", 65535,
                                                QTYPE_A, False),
           ("bücher.example", 4242, QTYPE_A, True),
           ("ns1.test", 7, QTYPE_NS, True), ("x", 0, QTYPE_CNAME, False),
           ("Mixed.Case.TEST", 31337, QTYPE_A, True)]


@pytest.mark.parametrize("name,qid,qtype,recurse", QUERIES)
def test_query_packets_equal_the_reference(name, qid, qtype, recurse):
    assert build_query(name, qid, qtype, recurse) == \
        jdns.build_query(name, qid, qtype, recurse)


def _compressed_answer(q: bytes) -> bytes:
    """A CNAME and an A record whose names point back into the question
    (name compression), and one record of an unknown type."""
    qid = struct.unpack(">H", q[:2])[0]
    hdr = struct.pack(">HHHHHH", qid, 0x8180, 1, 3, 0, 0)
    body = q[12:]
    ptr = b"\xc0\x0c"  # the question's name
    cname = ptr + struct.pack(">HHIH", QTYPE_CNAME, 1, 30, 6) + \
        b"\x03www" + ptr
    a = b"\x03www" + ptr + struct.pack(">HHIH", QTYPE_A, 1, 45, 4) + \
        socket.inet_aton("192.0.2.9")
    txt = ptr + struct.pack(">HHIH", 16, 1, 5, 3) + b"\x02hi"
    return hdr + body + cname + a + txt


def _responses():
    q = build_query("alias.test", 99)
    ref = build_query("www.deep.test", 5, recurse=False)
    yield _response(q, answers=[_rr("alias.test", QTYPE_A, 300,
                                    socket.inet_aton("10.1.2.3"))])
    yield _response(q, rcode=3)
    yield _response(ref, authority=[
        _rr("test", QTYPE_NS, 120, _name_bytes("ns1.test")),
        _rr("test", QTYPE_NS, 120, _name_bytes("ns2.test"))],
        additional=[_rr("ns1.test", QTYPE_A, 120,
                        socket.inet_aton("127.0.0.1"))])
    yield _compressed_answer(q)


@pytest.mark.parametrize("i", range(4))
def test_parsed_responses_equal_the_reference(i):
    pkt = list(_responses())[i]
    got, want = parse_response(pkt), jdns.parse_response(pkt)
    assert got == want
    assert got["answers"] or got["authority"] or got["rcode"] == 3


@pytest.mark.parametrize("pkt", [
    b"\x00" * 5,                                   # short
    b"\x00\x01" + b"\x00" * 3 + b"\x01" + b"\x00" * 6 + b"\x05ab",
    b"\x00\x01" + b"\x00" * 3 + b"\x01" + b"\x00" * 6 + b"\xc0\x0c",
    b"\x00\x01\x80\x00\x00\x00\x00\x01\x00\x00\x00\x00\x00\x00\x01"])
def test_malformed_packets_raise_as_in_the_reference(pkt):
    with pytest.raises(ValueError) as got:
        parse_response(pkt)
    with pytest.raises(ValueError) as want:
        jdns.parse_response(pkt)
    assert str(got.value) == str(want.value)


def _pdfs():
    yield _tiny_pdf("quarterly aardwolf report 2021")
    yield _flate_pdf(rb"BT (line \(one\)) Tj T* (line two) Tj ET")
    yield _flate_pdf(rb"BT [(Kern)-120(ed) (words\051)] TJ Td "
                     rb"(oct\101\7\\al) Tj TD (tab\there) Tj ET")
    yield _flate_pdf(b"BT (ascii85 skipped) Tj ET",
                     head=b"/Filter /ASCII85Decode")
    yield (b"%PDF-1.4\n1 0 obj\n<< /Filter /FlateDecode >>\nstream\n"
           b"not zlib at all\nendstream\nendobj\n" + _tiny_pdf("after bad"))
    yield _tiny_pdf("spaced    \t out   text") + _tiny_pdf("second stream")
    yield b"no streams here"


@pytest.mark.parametrize("i", range(7))
def test_pdf_text_builtin_equals_the_reference(i):
    pdf = list(_pdfs())[i]
    assert pdf_text_builtin(pdf) == jconvert.pdf_text_builtin(pdf)


def test_kind_of_equals_the_reference():
    cases = [("application/pdf", ""), ("Application/PDF; charset=x", ""),
             ("", "http://x.test/a.Doc?x=1"), ("text/html", "http://x/y.ps"),
             ("", "http://x.test/a.eps"), ("text/html", "http://x.test/"),
             ("application/postscript", ""), (None, "")]
    for ct, url in cases:
        assert kind_of(ct, url) == jconvert.kind_of(ct, url), (ct, url)


def test_external_converters_run_as_in_the_reference(monkeypatch):
    """``_run_tool`` pipes the document through a tool on PATH and caps
    its output; a missing tool, a failing one or a timeout gives None, and
    a kind whose tools are all missing converts to None, as in the JAX
    package."""
    from open_source_search_engine_tpu_torch.build import convert
    for mod in (convert, jconvert):
        assert mod._run_tool(["cat"], b"plain words") == "plain words"
        assert mod._run_tool(["osse-no-such-tool"], b"x") is None
        assert mod._run_tool(["false"], b"x") is None
    monkeypatch.setattr(convert, "MAX_TEXT_BYTES", 5)
    assert convert._run_tool(["cat"], b"0123456789") == "01234"
    monkeypatch.setattr(convert, "CONVERT_TIMEOUT_S", 0.2)
    assert convert._run_tool(["sleep", "5"], b"") is None
    monkeypatch.setattr(convert.shutil, "which", lambda name: None)
    assert convert.convert_to_text(b"\xd0\xcf", "application/msword") \
        is None
    assert convert.convert_to_text(b"%!PS", "", "http://x.test/a.ps") \
        is None
    assert convert.convert_to_text(b"<p>x</p>", "text/html") is None

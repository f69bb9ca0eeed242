"""Fetcher: the robots-aware HTTP download service (the Msg13 role).

Port of ``open_source_search_engine_tpu/spider/fetcher.py`` (reference
``Msg13.{h,cpp}``): robots.txt fetched and cached, gzip, a response
cache, charset sniffing, proxy rotation on a ban page
(``spider/proxies.py``) and binary documents kept as bytes for the
converters (``build/convert.py``). Politeness lives in the scheduler.

A thread pool of blocking ``urllib`` fetches stands for the reference's
callback chains. Its opener honours the environment's ``http_proxy``
and ``no_proxy``. Departure: a Fetcher builds each opener (direct, or per
proxy) once, where the reference builds one per fetch; building one
loads the default TLS context's CA store, about 20 ms of CPU under the
GIL.
"""

from __future__ import annotations

import re
import urllib.error
import urllib.parse
import urllib.request
import urllib.robotparser
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from ..utils.lockcheck import make_lock
from ..utils.log import get_logger

log = get_logger("fetch")

USER_AGENT = "osse-tpu-bot/0.1"
MAX_DOC_BYTES = 2 << 20  # the reference's maxTextDocLen cap


@dataclass
class FetchResult:
    url: str
    status: int            # HTTP status; 0 = network error; 999 = robots
    content: str = ""
    content_type: str = ""
    error: str = ""
    #: the undecoded body of a binary document (pdf, doc, ps), which the
    #: converters turn into text
    raw: bytes = b""

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300

    @property
    def is_html(self) -> bool:
        return "html" in self.content_type or self.content_type == ""


class RobotsCache:
    """robots.txt fetched, parsed and cached per origin, on the cache
    plane (``/admin/cache`` sees it and memory pressure may shed it)."""

    ROBOTS_TTL_S = 3600.0

    def __init__(self, fetch_fn=None):
        from ..cache import g_cacheplane
        self._cache = g_cacheplane.register(
            "spider.robots", ttl_s=self.ROBOTS_TTL_S, max_entries=8192,
            desc="parsed robots.txt per origin (Msg13 robots cache)")
        self._fetch_fn = fetch_fn  # injectable for tests

    def allowed(self, url: str) -> bool:
        parts = urllib.parse.urlsplit(url)
        origin = f"{parts.scheme}://{parts.netloc}"
        hit, rp = self._cache.lookup(origin)
        if not hit:
            rp = urllib.robotparser.RobotFileParser()
            try:
                raw = (self._fetch_fn(origin + "/robots.txt")
                       if self._fetch_fn else
                       _raw_get(origin + "/robots.txt"))
                rp.parse(raw.splitlines())
            except Exception:  # noqa: BLE001 — unreachable robots.txt
                rp.parse([])  # allows everything
            self._cache.put(origin, rp)
        return rp.can_fetch(USER_AGENT, url)


_META_CHARSET_RE = re.compile(
    rb"""<meta[^>]+charset\s*=\s*["']?([a-zA-Z0-9_\-]+)""", re.IGNORECASE)


def sniff_charset(data: bytes, declared: str | None) -> str:
    """The document's charset: the HTTP header's, else a BOM's, else a
    ``<meta charset>`` or http-equiv in the first 4 KiB, else utf-8.
    Web spellings map through ``unicodenorm.CHARSET_ALIASES``; a name
    nobody knows decodes as utf-8 with replacement."""
    from ..utils.unicodenorm import resolve_charset
    cand = declared
    if not cand:
        if data[:3] == b"\xef\xbb\xbf":
            cand = "utf-8"
        elif data[:2] in (b"\xff\xfe", b"\xfe\xff"):
            cand = "utf-16"
        else:
            m = _META_CHARSET_RE.search(data[:4096])
            if m:
                cand = m.group(1).decode("ascii", "replace")
    return resolve_charset(cand) or "utf-8"


def _gunzip_capped(data: bytes) -> bytes:
    """Decompress at most MAX_DOC_BYTES of output: a gzip bomb must not
    defeat the download cap."""
    return zlib.decompressobj(wbits=47).decompress(data, MAX_DOC_BYTES)


def _raw_get(url: str, timeout: float = 10.0) -> str:
    req = urllib.request.Request(url, headers={
        "User-Agent": USER_AGENT, "Accept-Encoding": "gzip"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        data = r.read(MAX_DOC_BYTES)
        if r.headers.get("Content-Encoding") == "gzip":
            data = _gunzip_capped(data)
        return data.decode(r.headers.get_content_charset() or "utf-8",
                           "replace")


class ResponseCache:
    """url -> FetchResult under a TTL (Msg13's response cache,
    ``Msg13.h:168``: a repeated fetch within the TTL does not hit the
    site again), on the cache plane."""

    def __init__(self, ttl_s: float = 3600.0, max_entries: int = 1024):
        from ..cache import g_cacheplane
        self._cache = g_cacheplane.register(
            "spider.responses", ttl_s=ttl_s, max_entries=max_entries,
            desc="url → FetchResult bodies (Msg13 response cache)")

    def get(self, url: str) -> FetchResult | None:
        return self._cache.get(url)

    def put(self, url: str, res: FetchResult) -> None:
        self._cache.put(url, res)


class Fetcher:
    """Parallel robots-aware downloader."""

    def __init__(self, n_threads: int = 8, timeout: float = 10.0,
                 respect_robots: bool = True, cache_ttl_s: float = 3600.0,
                 proxies=None):
        self.pool = ThreadPoolExecutor(max_workers=n_threads,
                                       thread_name_prefix="fetch")
        self.timeout = timeout
        self.respect_robots = respect_robots
        self.robots = RobotsCache()
        self.cache = ResponseCache(ttl_s=cache_ttl_s) \
            if cache_ttl_s > 0 else None
        #: the SpiderProxy pool; None or empty fetches directly
        self.proxies = proxies
        #: proxy address (None: direct) -> its urllib opener
        self._openers: dict = {}
        self._openers_lock = make_lock("spider.fetcher.openers")

    def _opener(self, proxy: str | None):
        with self._openers_lock:
            opener = self._openers.get(proxy)
            if opener is None:
                opener = self._openers[proxy] = \
                    urllib.request.build_opener(urllib.request.ProxyHandler(
                        {"http": f"http://{proxy}",
                         "https": f"http://{proxy}"})) if proxy \
                    else urllib.request.build_opener()
            return opener

    def fetch_one(self, url: str) -> FetchResult:
        if self.cache is not None:
            hit = self.cache.get(url)
            if hit is not None:
                return hit
        if self.respect_robots and not self.robots.allowed(url):
            return FetchResult(url=url, status=999, error="robots.txt")
        # a proxy per target first IP; a ban page rotates to the next
        tries = 1
        target_ip = ""
        if self.proxies:
            from ..utils import ipresolve
            target_ip = ipresolve.first_ip(
                urllib.parse.urlsplit(url).hostname or "")
            tries = 3
        banned_all = False
        for _ in range(tries):
            proxy = self.proxies.pick(target_ip) if self.proxies else None
            try:
                res = self._get(url, proxy)
            finally:
                if proxy:
                    self.proxies.release(proxy)
            if proxy and res.status == 0:
                # a dead proxy: cool the pair down like a ban, so the
                # sticky assignment rotates away
                self.proxies.report(proxy, target_ip, 403, "")
                banned_all = True
                continue
            if proxy and self.proxies.report(proxy, target_ip, res.status,
                                             res.content):
                banned_all = True
                continue
            if self.cache is not None and res.ok:
                self.cache.put(url, res)
            return res
        # every try banned or failed: an error, never the ban page as
        # content (indexing a captcha page poisons the document)
        return FetchResult(url=url, status=0,
                           error="ban page or dead proxy via every "
                                 "assigned proxy"
                                 if banned_all else "proxy fetch failed")

    def _get(self, url: str, proxy: str | None) -> FetchResult:
        req = urllib.request.Request(url, headers={
            "User-Agent": USER_AGENT, "Accept-Encoding": "gzip"})
        try:
            with self._opener(proxy).open(req, timeout=self.timeout) as r:
                data = r.read(MAX_DOC_BYTES)
                if r.headers.get("Content-Encoding") == "gzip":
                    data = _gunzip_capped(data)
                ctype = r.headers.get_content_type()
                from ..build.convert import is_convertible
                if is_convertible(ctype, r.url):
                    # a binary document: the bytes go to the converters
                    return FetchResult(url=r.url, status=r.status, raw=data,
                                       content_type=ctype)
                charset = sniff_charset(data,
                                        r.headers.get_content_charset())
                return FetchResult(url=r.url, status=r.status,
                                   content=data.decode(charset, "replace"),
                                   content_type=ctype)
        except urllib.error.HTTPError as e:
            return FetchResult(url=url, status=e.code, error=str(e))
        except Exception as e:  # noqa: BLE001 — network errors are data
            return FetchResult(url=url, status=0, error=str(e))

    def fetch_many(self, urls: list[str]) -> list[FetchResult]:
        """Fetch in parallel; the results keep the URLs' order."""
        return list(self.pool.map(self.fetch_one, urls))

    def close(self) -> None:
        self.pool.shutdown(wait=False, cancel_futures=True)

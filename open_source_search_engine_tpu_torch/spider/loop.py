"""Spider loop: crawl, parse, index, harvest links, end to end.

Port of ``open_source_search_engine_tpu/spider/loop.py`` (reference
``SpiderLoop::spiderDoledUrls``, ``Spider.cpp:6758``, doling ready URLs
to ``XmlDoc::indexDoc``, which fetches (Msg13), parses, takes the site's
inlink count for its siterank (Msg25), writes every db (Msg4) and queues
the outlinks).

Rounds are batch-synchronous: dole a batch, fetch it in parallel, index
it serially into the collection (single-writer Rdbs), queue the
outlinks. A site's link-derived siterank feeds the pages indexed in
later rounds, as the reference's incremental siteNumInlinks does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..utils.log import get_logger
from ..utils.url import normalize
from .fetcher import Fetcher
from .linkdb import site_rank
from .scheduler import SpiderScheduler

log = get_logger("spider")


@dataclass
class CrawlStats:
    fetched: int = 0
    indexed: int = 0
    errors: int = 0
    robots_blocked: int = 0
    links_found: int = 0
    by_status: dict = field(default_factory=dict)


class SpiderLoop:
    """Drives one collection's crawl (a node's, or over a
    ShardedCollection)."""

    def __init__(self, coll_or_sharded,
                 scheduler: SpiderScheduler | None = None,
                 fetcher: Fetcher | None = None, batch_size: int = 8):
        self.target = coll_or_sharded
        # not `scheduler or ...`: an empty scheduler is falsy, and a
        # durable frontier starts empty
        self.sched = scheduler if scheduler is not None \
            else SpiderScheduler(banned=self._tagdb_banned)
        if fetcher is None:
            # the SpiderProxy pool from the spider_proxies parm; an empty
            # pool fetches directly
            from .proxies import ProxyPool
            conf = getattr(coll_or_sharded, "conf", None)
            pool = ProxyPool.from_conf(conf) if conf is not None else None
            fetcher = Fetcher(proxies=pool if pool else None)
        self.fetcher = fetcher
        self.batch_size = batch_size
        self.stats = CrawlStats()

    def add_url(self, url: str) -> bool:
        return self.sched.add_url(url)

    def _tagdb_banned(self, url: str) -> bool:
        """The frontier's ban gate (tagdb manualban)."""
        tagdb = getattr(self.target, "tagdb", None)
        return tagdb.is_banned(url) if tagdb is not None else False

    def _site_num_inlinks(self, site: str) -> int:
        if hasattr(self.target, "site_num_inlinks"):  # ShardedCollection
            return self.target.site_num_inlinks(site)
        return self.target.linkdb.site_num_inlinks(site)

    def _index(self, url: str, content: str, is_html: bool):
        """Index one page; its MetaList's ``links`` are the outlinks of
        the same tokenize pass. The indexer records the linkdb edges and
        the inlink-text postings."""
        from ..build import docproc  # docproc imports the collection
        site = normalize(url).site
        sr = site_rank(self._site_num_inlinks(site))
        if hasattr(self.target, "index_document"):  # ShardedCollection
            return self.target.index_document(url, content,
                                              is_html=is_html, siterank=sr)
        return docproc.index_document(self.target, url, content,
                                      is_html=is_html, siterank=sr)

    def crawl_step(self) -> int:
        """One dole-fetch-index round; returns the pages indexed."""
        from ..build import docproc
        batch = self.sched.next_batch(self.batch_size)
        if not batch:
            return 0
        results = self.fetcher.fetch_many([r.url for r in batch])
        indexed = 0
        mark_done = getattr(self.sched, "mark_done", None)
        release = getattr(self.sched, "release", None)
        for req, res in zip(batch, results):
            # every outcome releases the IP's in-flight lock; its
            # politeness window starts at the fetch's completion
            if release is not None:
                release(req.url, first_ip=req.first_ip or None)
            if mark_done is not None and not (
                    res.status == 0 or res.status == 999
                    or 500 <= res.status < 600):
                # the SpiderReply, for completed attempts only (a success
                # or a permanent 4xx): network errors, 5xx and robots
                # blocks stay unreplied and dole again in a later crawl
                mark_done(req.url, first_ip=req.first_ip or None)
            self.stats.fetched += 1
            self.stats.by_status[res.status] = \
                self.stats.by_status.get(res.status, 0) + 1
            if res.status == 999:
                self.stats.robots_blocked += 1
                continue
            if not res.ok:
                self.stats.errors += 1
                log.debug("fetch failed %s: %s %s", req.url, res.status,
                          res.error)
                continue
            content, is_html = res.content, res.is_html
            if res.raw and not content:
                # a binary document (pdf, doc, ps): the converters
                # (XmlDoc.cpp:19206)
                from ..build.convert import convert_to_text
                text = convert_to_text(res.raw, res.content_type, res.url)
                if not text:
                    self.stats.errors += 1
                    log.debug("unconvertible %s (%s)", req.url,
                              res.content_type)
                    continue
                content, is_html = text, False
            try:
                ml = self._index(res.url, content, is_html)
                if ml is None:  # tagdb manualban (EDOCBANNED)
                    self.stats.errors += 1
                    continue
                indexed += 1
                self.stats.indexed += 1
            except Exception as e:  # noqa: BLE001 — one page, not the crawl
                self.stats.errors += 1
                log.warning("index failed %s: %s", req.url, e)
                continue
            # queue the outlinks (the indexer recorded their edges)
            linker = normalize(res.url)
            for href, _anchor in (ml.links if res.is_html else []):
                absu = docproc.absolutize(linker.full, href)
                if not absu:
                    continue
                self.stats.links_found += 1
                self.sched.add_url(absu, hopcount=req.hopcount + 1)
        cp = getattr(self.sched, "checkpoint", None)
        if cp is not None:
            cp()
        return indexed

    def crawl(self, max_pages: int = 100, max_steps: int | None = None
              ) -> CrawlStats:
        """Crawl until the frontier drains or max_pages are indexed."""
        steps = 0
        while self.stats.indexed < max_pages and not self.sched.exhausted:
            if max_steps is not None and steps >= max_steps:
                break
            before = self.stats.fetched
            self.crawl_step()
            steps += 1
            if self.stats.fetched == before:
                # every IP in the frontier is inside its politeness
                # window: sleep instead of spinning the heap
                time.sleep(0.05)
        return self.stats

"""Build plane: the crawler — scheduler, fetcher, link graph, crawl loop.

Port of ``open_source_search_engine_tpu/spider/`` (the reference's
Spider, Msg13 and Linkdb subsystem): the scheduler owns the frontier and
politeness (spiderdb and doledb; :mod:`.spiderdb` makes it durable), the
fetcher downloads with robots.txt (Msg13) through the proxy pool
(:mod:`.proxies`), linkdb holds the link graph that feeds siterank, and
:class:`SpiderLoop` ties them to the indexer.
"""

from .fetcher import Fetcher, FetchResult, RobotsCache
from .linkdb import Linkdb, site_rank
from .loop import CrawlStats, SpiderLoop
from .scheduler import SpiderScheduler, UrlFilterRule

__all__ = [
    "Fetcher", "FetchResult", "RobotsCache", "Linkdb", "site_rank",
    "CrawlStats", "SpiderLoop", "SpiderScheduler", "UrlFilterRule",
]

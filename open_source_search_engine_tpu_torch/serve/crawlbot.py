"""Crawlbot: the REST bulk-crawl API.

Port of ``open_source_search_engine_tpu/serve/crawlbot.py`` (reference
``PageCrawlBot.cpp``): REST calls create named crawl jobs, each with its
own collection and URL filters, report their status, pause and resume
them, and delete them. The server's ``/crawlbot`` route (admin-gated):

* ``/crawlbot?name=X&seeds=url1,url2&maxpages=N&maxhops=H[&spanhosts=1]``
  creates and starts a job: a collection ``crawl_X`` on the server's
  device with a durable per-IP frontier, crawled by a background thread;
* ``/crawlbot?name=X``: the job's status;
* ``/crawlbot?name=X&action=pause|resume|delete``;
* ``/crawlbot``: every job.

A job's pages are searched through ``/search?c=crawl_X``, on the device
route like any other collection.
"""

from __future__ import annotations

import shutil
import threading
import time
from dataclasses import dataclass, field

from ..spider.loop import SpiderLoop
from ..spider.scheduler import UrlFilterRule
from ..spider.spiderdb import DurableSpiderScheduler
from ..utils import threads
from ..utils.lockcheck import make_lock
from ..utils.log import get_logger

log = get_logger("crawlbot")


@dataclass
class CrawlJob:
    name: str
    loop: SpiderLoop
    max_pages: int
    thread: threading.Thread | None = None
    paused: bool = False
    done: bool = False
    error: str = ""
    lock: object = field(default_factory=lambda: make_lock("crawlbot.job"))

    def status(self) -> dict:
        st = self.loop.stats
        return {
            "name": self.name,
            "indexed": st.indexed, "fetched": st.fetched,
            "errors": st.errors, "robots_blocked": st.robots_blocked,
            "links_found": st.links_found,
            "frontier": len(self.loop.sched),
            "maxPages": self.max_pages,
            "paused": self.paused, "done": self.done,
            "jobError": self.error,
        }


class CrawlBot:
    """The registry and runner of REST-created crawl jobs."""

    def __init__(self, colldb, fetcher_factory=None):
        self.colldb = colldb
        #: a zero-argument callable making each job's fetcher (tests pass
        #: a fake); None: a real Fetcher with the collection's proxy pool
        self.fetcher_factory = fetcher_factory
        self.jobs: dict[str, CrawlJob] = {}
        self._lock = make_lock("crawlbot.jobs")

    def create(self, name: str, seeds: list[str], max_pages: int = 100,
               max_hops: int = 3, same_host_only: bool = True,
               delay_s: float = 0.25) -> CrawlJob:
        with self._lock:
            if name in self.jobs:
                raise ValueError(f"job {name!r} already exists")
            coll = self.colldb.get(f"crawl_{name}")
            sched = DurableSpiderScheduler(
                coll.dir / "spider",
                filters=[UrlFilterRule("*", delay_s=delay_s)],
                max_hops=max_hops, same_host_only=same_host_only,
                banned=coll.tagdb.is_banned)
            loop = SpiderLoop(coll, scheduler=sched,
                              fetcher=(self.fetcher_factory()
                                       if self.fetcher_factory else None))
            job = CrawlJob(name=name, loop=loop, max_pages=max_pages)
            self.jobs[name] = job

        def run():
            try:
                # seeded on the job's thread: each new host resolves its
                # first IP, which can take seconds, and the REST handler
                # holds the server's lock
                for u in seeds:
                    loop.add_url(u)
                while (not job.done
                       and job.loop.stats.indexed < job.max_pages
                       and not job.loop.sched.exhausted):
                    if job.paused:
                        time.sleep(0.2)
                        continue
                    before = job.loop.stats.fetched
                    with job.lock:
                        job.loop.crawl_step()
                    if job.loop.stats.fetched == before:
                        # every IP inside its politeness window
                        time.sleep(0.05)
            except Exception as e:  # noqa: BLE001 — surfaced in status
                job.error = str(e)
                log.exception("crawl job %s failed", name)
            finally:
                job.done = True
                try:
                    job.loop.sched.save()
                    coll.save()
                except Exception as exc:  # noqa: BLE001 — the job is done
                    log.warning("crawl job %s final save failed: %s",
                                name, exc)

        job.thread = threads.spawn(f"crawlbot-{name}", run)
        log.info("crawl job %s started (%d seeds, max %d pages)", name,
                 len(seeds), max_pages)
        return job

    def get(self, name: str) -> CrawlJob | None:
        with self._lock:
            return self.jobs.get(name)

    def delete(self, name: str) -> bool:
        """Unregister the job and purge its corpus and frontier: a job
        made again under the name starts afresh (the durable seen set
        would otherwise dedup its seeds away)."""
        with self._lock:
            job = self.jobs.pop(name, None)
        if job is None:
            return False
        job.done = True
        if job.thread is not None:
            job.thread.join(5.0)  # the loop notices before the purge
        cname = f"crawl_{name}"
        try:
            # unserve before the purge: stop the resident loop and drop
            # the device gauge and the HBM ledger's slice (the tenant
            # plane), then the collection's memtable gauges (drop), then
            # the directory
            from .tenancy import g_residency
            g_residency.release(cname)
            coll = self.colldb.drop(cname)
            cdir = coll.dir if coll is not None else None
            if cdir is None:
                base = self.colldb.base_dir / "coll" / cname
                cdir = base if base.exists() else None
            if cdir is not None:
                shutil.rmtree(cdir, ignore_errors=True)
        except Exception:  # noqa: BLE001 — the purge is best-effort
            log.exception("crawl job %s purge failed", name)
        return True

    def list_jobs(self) -> list[dict]:
        with self._lock:
            jobs = list(self.jobs.values())
        return [j.status() for j in jobs]

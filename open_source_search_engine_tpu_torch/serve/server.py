"""HTTP front end — search, cached pages, injection, admin.

Port of ``open_source_search_engine_tpu/serve/server.py`` (reference
``HttpServer.cpp`` + the ``Pages.cpp`` page table: ``PageResults.cpp``,
``PageGet.cpp``, ``PageInject.cpp``/``PageAddUrl.cpp``, the admin
pages). A stdlib threading server; the accept/parse plane is not the
bottleneck, queries are.

``/search`` with ``serve_device`` on (the default) goes through
:class:`QueryBatcher`: concurrent requests coalesce into one
``engine.search_device_batch(..., resident=True)`` call, which the
collection's ResidentLoop serves in waves on the collection's device
(K1 and K2 on the card). In front of it sit autoban, the admission gate
(``serve/admission.py``) and the generation-keyed result cache on the
cache plane (``cache/plane.py``).

Endpoints (the reference's query-string names: ``q``, ``n``, ``s``,
``c``, ``format``):

* ``GET /search?q=...&n=10&c=main&format=json|xml|csv|html``
* ``GET /get?d=<docid>&q=...`` — cached page, query terms highlighted
* ``GET|POST /inject?u=<url>`` (body = content), ``/delete?u=<url>``
* ``GET /addurl?u=<url>`` — queue a URL for the spider (``spider=``, a
  :class:`~..spider.loop.SpiderLoop`; 503 without one)
* ``GET /crawlbot?name=...&seeds=...`` — the REST crawl jobs
  (:mod:`.crawlbot`); a job's pages are searched with ``c=crawl_<name>``
* ``GET /metrics`` and ``/admin``, ``/admin/stats``, ``/admin/mem``,
  ``/admin/cache``, ``/admin/parms``, ``/admin/admission``,
  ``/admin/tenants``, ``/admin/traces``
* the telemetry pages: ``/admin/jit`` (jitwatch), ``/admin/hbm`` and
  ``/admin/device`` (devwatch's ledger, flight recorder and roofline),
  ``/admin/profiler`` (stage timings; ``?sample=start|stop|reset|report``
  drives the sampling profiler) and ``/admin/graph`` (the statsdb sample
  ring as SVG). Every 10 s the statsdb sampler adds qps, p50 and the
  guardrail counters to the sample ring and qps and the counters to
  ``statsdb.jsonl`` beside the collections (the reference's lines; the
  file is a ring, rotated at 512 writes; a torn line costs one sample
  when a restart reads it back), and runs the SLO evaluation.
* ``GET /`` — a minimal search form

With ``sharded=`` (a :class:`~..parallel.sharded.ShardedCollection`)
the server fronts the mesh: ``/search`` goes through the mesh's resident
loop (``engine.get_mesh_resident(...).serve``, the in-program merge)
when the ``serve_mesh`` parm is on, else through ``sharded_search``
under the core lock; ``/get``, ``/inject`` and ``/delete`` route to the
owning shards, and ``/admin/hosts`` shows the shard map.

With ``cluster=`` (a :class:`~..parallel.cluster.ClusterClient`, the
``proxy`` verb) the server fronts node processes: ``/search`` is the
client's scatter-gather and Msg3a merge over RPC, ``/get``, ``/inject``
and ``/delete`` go to the owning shard's twins, the result cache's
generation is the cluster's shard-generation vector, and ``/admin/perf``,
``/metrics`` and the SLO tick read the fleet view (every node's
``/rpc/stats`` merged bucket-wise). ``/admin/transport`` shows the
transport's pools, RTT EWMAs and counters with the cluster's twin
preferences, and ``/admin/hosts`` the cluster's shards with a fresh ping
of each node (the reference answers ``{"shards": 1, "mode": "single"}``
for a cluster).

Departures from the reference:

* **No host fallback.** The reference answers a failed device batch
  from ``engine.search``; that hides the device, so here a failed batch
  answers 500 with the error and counts ``serve.device_error``.
  ``QueueFull`` and ``DeadlineExceeded`` still take the shed and stale
  ladders.
* **No pre-write page in the result cache.** A page answered by a
  device index behind the request's posdb version (the old index
  serving during a background rebuild) is served but not cached; the
  reference caches it under the new version until its TTL ends.
* **A listen backlog of 128** (:class:`NodeHTTPServer`), not
  socketserver's 5: with 5, a burst of concurrent new connections has
  its SYNs dropped and those clients wait a second to retry.
"""

from __future__ import annotations

import html as html_mod
import json
import os
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..build import docproc
from ..cache import g_cacheplane
from ..index.collection import CollectionDb
from ..query import devcheck, engine
from ..query.summary import highlight
from ..utils import chaos as chaos_mod
from ..utils import deadline as deadline_mod
from ..utils import devwatch, jitwatch
from ..utils import parms as parms_mod
from ..utils import priority as priority_mod
from ..utils import threads
from ..utils import trace as trace_mod
from ..utils.lockcheck import make_lock, make_rlock
from ..utils.log import get_logger
from ..utils.membudget import g_membudget
from ..utils.nice import NicenessGate
from ..utils.parms import Conf
from ..utils.profiler import g_profiler
from ..utils.slo import g_slo
from ..utils.stats import _bucket_bounds, g_stats, merge_wire
from ..utils.trace import g_tracer
from ..utils.users import Users
from . import admission as admission_mod
from .tenancy import g_residency

log = get_logger("http")


class QueryBatcher:
    """Msg40 micro-batching: concurrent /search requests coalesce into one
    device dispatch, so the plane's ceiling is not 1/latency qps.

    Requests enqueue and wait; a single worker drains the queue in
    same-key batches of at most MAX_B and hands each to a pool of two,
    so batch N's page build overlaps batch N+1's device waves. While
    both are busy the queue is held, so that the requests arriving
    meanwhile ride one batch instead of queueing behind the pool one by
    one. Each waiter sleeps on its own event, woken only by its batch.
    An error reaches every waiter of the failing batch."""

    MAX_B = 64
    #: batches dispatched at once: one in its device waves while the
    #: other builds its page
    WORKERS = 2
    WINDOW_S = 0.002  # brief collect window while a wave is in flight
    #: bounded admission: an overload burst fails fast with QueueFull
    #: (the serve edge sheds stale-or-503) instead of growing host memory
    MAX_QUEUE = 512
    #: per-waiter footprint charged to the membudget "serve" label
    QUEUE_ENTRY_COST = 4096

    def __init__(self, run_batch):
        #: run_batch((coll_name, topk, offset), [queries]) → [results]
        self._run_batch = run_batch
        self._cv = threading.Condition()
        #: (key, query, holder, parent span, deadline, tier, tenant,
        #: enqueue time)
        self._queue: list[tuple] = []
        self._inflight = 0  # batches currently dispatched
        self._alive = True
        #: batches dispatched and queries in them (chip smoke reads both)
        self.batches = 0
        self.batched_queries = 0
        self._pool = ThreadPoolExecutor(self.WORKERS)
        self._thread = threads.spawn("query-batcher", self._loop)

    @property
    def alive(self) -> bool:
        return self._alive

    def stop(self) -> None:
        """Stop the worker; queued waiters fail fast."""
        with self._cv:
            self._alive = False
            for e in self._queue:
                _answer(e[2], "err", RuntimeError("query batcher stopped"))
            self._queue.clear()
            self._gauge_locked()
            self._cv.notify_all()
        self._pool.shutdown(wait=False)

    def _gauge_locked(self) -> None:
        g_membudget.set_gauge(
            "serve", self, len(self._queue) * self.QUEUE_ENTRY_COST)

    def search(self, key: tuple, q: str, timeout: float = 60.0):
        holder: dict = {"done": threading.Event()}
        # the wait ends at its own timeout or the query's deadline,
        # whichever is sooner
        dl = deadline_mod.current()
        deadline = deadline_mod.Deadline.after(timeout)
        if dl is not None and dl.at < deadline.at:
            deadline = dl
        with self._cv:
            if len(self._queue) >= self.MAX_QUEUE:
                g_stats.count("admission.queue_full")
                raise priority_mod.QueueFull("query batcher queue full")
            self._queue.append((key, q, holder, trace_mod.current_span(), dl,
                                priority_mod.current_tier(),
                                priority_mod.current_tenant(),
                                time.perf_counter()))
            self._gauge_locked()
            self._cv.notify_all()
        while not holder["done"].is_set():
            left = deadline.remaining()
            if left <= 0:
                if dl is not None and dl.expired():
                    raise deadline_mod.DeadlineExceeded(
                        "query deadline exceeded in batcher")
                raise TimeoutError("query batcher timeout")
            holder["done"].wait(timeout=left)
        if "err" in holder:
            raise holder["err"]
        return holder["res"]

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._alive and not self._queue:
                    self._cv.wait()
                # every worker busy: hold the queue until one frees
                while self._alive and self._inflight >= self.WORKERS:
                    self._cv.wait()
                if not self._alive:
                    return
                # fill-or-flush: a batch in flight buys a collect window
                # (up to WINDOW_S to fill a same-key batch); an idle
                # device launches at once with whatever is queued
                if self._inflight > 0:
                    w = deadline_mod.Deadline.after(self.WINDOW_S)
                    while (self._alive and self._inflight > 0
                           and len(self._queue) < self.MAX_B):
                        left = w.remaining()
                        if left <= 0:
                            break
                        self._cv.wait(timeout=left)
                else:
                    g_stats.count("admission.wave.idle_flush")
                if not self._alive:
                    return
                if not self._queue:  # stop() drained it mid-window
                    continue
                key = self._queue[0][0]
                batch = [e for e in self._queue if e[0] == key][: self.MAX_B]
                for e in batch:
                    self._queue.remove(e)
                self._gauge_locked()
                self._inflight += 1
                self.batches += 1
                self.batched_queries += len(batch)
            try:
                self._pool.submit(self._run_one, key, batch)
            except RuntimeError as exc:  # pool shut down by stop()
                with self._cv:
                    self._inflight -= 1
                    for e in batch:
                        _answer(e[2], "err", exc)
                    self._cv.notify_all()
                return

    def _run_one(self, key, batch) -> None:
        try:
            self._run_one_inner(key, batch)
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()  # wake the fill-or-flush window

    def _run_one_inner(self, key, batch) -> None:
        # each request's wait, from its arrival to its batch's start
        t_disp = time.perf_counter()
        for e in batch:
            with trace_mod.attach(e[3]):
                trace_mod.record("serve.batch_wait", e[7], t_disp)
        try:
            # a pool thread has an empty contextvars context: re-attach
            # the first traced waiter's span, and mark the other waiters'
            # traces with a "coalesced" interval
            parents = [e[3] for e in batch if e[3] is not None]
            # the coalesced dispatch runs under the LONGEST rider budget
            # (a short-deadline rider must not abandon the others' wave)
            # and the HIGHEST rider tier; riders of one key share a
            # collection, so a tenant
            dls = [e[4] for e in batch if e[4] is not None]
            dl = max(dls, key=lambda d: d.at) if dls else None
            tiers = [e[5] for e in batch if e[5] is not None]
            tier = (min(tiers, key=priority_mod.TIERS.index)
                    if tiers else None)
            tenants = [e[6] for e in batch if e[6] is not None]
            t0 = time.perf_counter()
            with trace_mod.attach(parents[0] if parents else None), \
                    deadline_mod.bind(dl), \
                    priority_mod.bind_tier(tier), \
                    priority_mod.bind_tenant(tenants[0] if tenants
                                             else None):
                res = self._run_batch(key, [e[1] for e in batch])
            for p in parents[1:]:
                p.record("query.device_batch", t0, coalesced=True,
                         batch=len(batch))
            for e, r in zip(batch, res):
                _answer(e[2], "res", r)
        except Exception as exc:  # noqa: BLE001 — waiters must wake
            for e in batch:
                _answer(e[2], "err", exc)


def _answer(holder: dict, kind: str, value) -> None:
    """Give a batcher waiter its result or error, and wake it."""
    holder[kind] = value
    holder["done"].set()


class NodeHTTPServer(ThreadingHTTPServer):
    """The listener. socketserver's default backlog of 5 (the
    reference's) drops the SYNs of a burst of new connections once the
    accept queue holds 6, and each such client retries only after a
    second; the backlog here holds a full batch of them."""

    request_queue_size = 128


def _xml_escape(s: str) -> str:
    return html_mod.escape(s, quote=True)


def render_results(res: engine.SearchResults, fmt: str,
                   trace_id: str | None = None) -> tuple[str, str]:
    """SERP rendering (PageResults.cpp HTML/XML/JSON/CSV). ``trace_id``
    (``debug=1`` requests) is echoed in the body so the query can be
    looked up on ``/admin/traces``."""
    if fmt == "json":
        payload = {
            "query": res.query,
            "totalMatches": res.total_matches,
            "clustered": res.clustered,
            "suggestion": res.suggestion,
            "facets": {f: [[v, c] for v, c in pairs]
                       for f, pairs in (res.facets or {}).items()},
            "results": [
                {"docId": r.docid, "score": r.score, "url": r.url,
                 "title": r.title, "snippet": r.snippet, "site": r.site}
                for r in res.results
            ],
        }
        if trace_id:
            payload["traceId"] = trace_id
        return json.dumps(payload), "application/json"
    if fmt == "xml":
        rows = "".join(
            f"<result><docId>{r.docid}</docId>"
            f"<score>{r.score}</score>"
            f"<url>{_xml_escape(r.url)}</url>"
            f"<title>{_xml_escape(r.title)}</title>"
            f"<snippet>{_xml_escape(r.snippet)}</snippet></result>"
            for r in res.results)
        tid = (f"<traceId>{_xml_escape(trace_id)}</traceId>"
               if trace_id else "")
        return (f'<?xml version="1.0" encoding="UTF-8"?>'
                f"<response><query>{_xml_escape(res.query)}</query>"
                f"<totalMatches>{res.total_matches}</totalMatches>"
                f"{tid}{rows}</response>", "text/xml")
    if fmt == "csv":
        lines = ["docid,score,url,title"]
        for r in res.results:
            t = r.title.replace('"', '""')
            lines.append(f'{r.docid},{r.score},"{r.url}","{t}"')
        return "\n".join(lines), "text/csv"
    items = "".join(
        f'<li><a href="{html_mod.escape(r.url)}">'
        f"{html_mod.escape(r.title) or html_mod.escape(r.url)}</a>"
        f"<br><small>{html_mod.escape(r.snippet)}</small>"
        f"<br><code>{html_mod.escape(r.url)}</code> "
        f"<i>{r.score:.1f}</i></li>"
        for r in res.results)
    tid = (f'<p><small>trace <a href="/admin/traces?id='
           f'{html_mod.escape(trace_id)}">{html_mod.escape(trace_id)}'
           f"</a></small></p>" if trace_id else "")
    return (f"<html><head><title>{html_mod.escape(res.query)} - search"
            f"</title></head><body>"
            f'<form action="/search"><input name="q" '
            f'value="{html_mod.escape(res.query)}"><input type="submit" '
            f'value="search"></form>'
            f"<p>{res.total_matches} matches</p><ol>{items}</ol>{tid}"
            f"</body></html>", "text/html")


def _json(status: int, body: dict) -> tuple[int, str, str]:
    return status, json.dumps(body), "application/json"


class SearchHTTPServer:
    """Owns a node's collections and serves the reference's public
    endpoints. ``device`` is where every collection scores (``None``
    means ``cuda``, which raises without a card; pass ``"cpu"`` to run
    on the CPU). ``colldb``: an already open registry over ``base_dir``
    to serve (its collections keep their device). ``sharded``: a
    ShardedCollection to front instead of the flat collections;
    ``cluster``: a ClusterClient over node processes to front instead;
    ``spider``: the SpiderLoop that ``/addurl`` queues into."""

    BAN_COOLDOWN_S = 60.0

    def __init__(self, base_dir, host: str = "127.0.0.1", port: int = 8000,
                 sharded=None, cluster=None, conf: Conf | None = None,
                 device=None, colldb: CollectionDb | None = None,
                 spider=None):
        #: ShardedCollection | None (the in-process mesh)
        self.sharded = sharded
        #: ClusterClient | None (the multi-process cluster)
        self.cluster = cluster
        #: SpiderLoop | None: the spider queue /addurl feeds
        self.spider = spider
        self.colldb = colldb if colldb is not None \
            else CollectionDb(base_dir, device=device)
        self.host = host
        self.port = port
        self.conf = conf or Conf()
        gbconf = Path(base_dir) / "gb.conf"
        if conf is None and gbconf.exists():
            self.conf.load(gbconf)
        # guardrail wiring: the process memory budget follows max_mem,
        # and the checkify parm arms the device checks
        g_membudget.set_limit(self.conf.max_mem)
        if self.conf.checkify:
            devcheck.set_enabled(True)
        # trace plane: sampling and slow-query threshold from the parms,
        # the slowlog in the base directory (the tracer is process-wide:
        # the last server constructed owns the slowlog path)
        g_tracer.configure(sample_n=self.conf.trace_sample,
                           slow_ms=self.conf.slow_query_ms,
                           slowlog_path=Path(base_dir) / "slowlog.jsonl",
                           host=f"{host}:{port}")
        self.conf.on_update(self._on_guardrail_parm)
        self.stats = {"queries": 0, "injects": 0, "addurls": 0,
                      "gets": 0, "errors": 0, "auth_denied": 0}
        self._httpd: NodeHTTPServer | None = None
        self._thread: threading.Thread | None = None
        #: statsdb persistence (reference Statsdb: an on-disk ring of
        #: timestamped metric samples behind the PagePerf graphs); its
        #: sampler's tick also evaluates the SLOs
        self._statsdb_path = Path(base_dir) / "statsdb.jsonl"
        self._sampler: threading.Thread | None = None
        self._stop_sampling = threading.Event()
        # the Rdbs, memtables and caches are single-writer structures:
        # the threaded accept plane serializes at this lock
        self._lock = make_rlock("server.core")
        #: /search micro-batching onto the resident device route
        self._batcher = QueryBatcher(self._run_device_batch)
        #: the admission plane: a bounded, tiered gate in front of the
        #: batcher that sheds stale-or-503 before memory runs out
        self.admission = admission_mod.AdmissionGate()
        #: the tenant plane owns each collection's (DeviceIndex,
        #: ResidentLoop); its hot-set count rides tenant_hot, its byte
        #: bound the membudget "device" label cap (device_budget)
        g_residency.configure(max_resident=int(self.conf.tenant_hot))
        g_residency.attach(g_membudget)
        if int(self.conf.device_budget) > 0:
            g_membudget.set_label_cap("device",
                                      int(self.conf.device_budget))
        #: AutoBan (AutoBan.cpp): per-IP query rate limiting. hits =
        #: ip → recent request times; banned = ip → ban expiry
        self._ab_lock = make_lock("server.autoban")
        self._ab_hits: dict[str, list[float]] = {}
        self._ab_banned: dict[str, float] = {}
        #: niceness gate: background requests yield to interactive ones
        self.nice_gate = NicenessGate()
        #: Msg17/Msg40Cache: rendered result pages on the cache plane,
        #: keyed per request with the index generation (_result_gen)
        self._result_cache = g_cacheplane.register(
            "server.results", ttl_s=30.0, max_entries=2048,
            desc="rendered result pages (Msg17/Msg40Cache role)")
        #: per-user admin accounts (Users.cpp / users.txt)
        self.users = Users(base_dir)
        #: the crawlbot job registry (made at the first /crawlbot), and
        #: the factory of its jobs' fetchers (None: a real Fetcher)
        self._crawlbot = None
        self.crawl_fetcher_factory = None

    def _on_guardrail_parm(self, name: str, value) -> None:
        """Live parm updates feeding the guardrail planes."""
        if name == "max_mem":
            g_membudget.set_limit(int(value))
        elif name == "checkify":
            # False reverts to the env default rather than forcing off,
            # so OSSE_CHECKIFY=1 runs survive a parm update
            devcheck.set_enabled(True if value else None)
        elif name == "trace_sample":
            g_tracer.configure(sample_n=int(value))
        elif name == "slow_query_ms":
            g_tracer.configure(slow_ms=float(value))
        elif name == "tenant_hot":
            g_residency.configure(max_resident=int(value))
        elif name == "device_budget":
            g_membudget.set_label_cap("device", int(value))

    def _autobanned(self, ip: str, limit_qps: int) -> bool:
        """A sliding one-second window per client IP; exceeding the limit
        bans the IP for BAN_COOLDOWN_S."""
        if not limit_qps or not ip:
            return False
        now = time.monotonic()
        with self._ab_lock:
            until = self._ab_banned.get(ip, 0.0)
            if until > now:
                return True
            hits = self._ab_hits.setdefault(ip, [])
            hits.append(now)
            del hits[: max(0, len(hits) - 4 * limit_qps)]
            recent = [t for t in hits if t > now - 1.0]
            if len(recent) > limit_qps:
                self._ab_banned[ip] = now + self.BAN_COOLDOWN_S
                # the cooldown is the penalty: drop the window, so the
                # first request after the ban is judged on fresh traffic
                self._ab_hits.pop(ip, None)
                if len(self._ab_banned) > 4096:
                    self._ab_banned = {
                        k: v for k, v in self._ab_banned.items()
                        if v > now}
                log.warning("autoban: %s exceeded %d qps", ip, limit_qps)
                return True
            if len(self._ab_hits) > 8192:  # bound the tracking table
                self._ab_hits = {ip: hits}
        return False

    def _run_device_batch(self, key: tuple, queries: list[str]):
        cname, topk, offset = key
        # the device wave runs outside the core lock (the ResidentLoop
        # serializes issue and collect itself); the lock covers the
        # collection lookup and, through results_lock, the page build,
        # which reads the single-writer Rdbs. Holding it across the
        # batch would deadlock the batcher against the request threads.
        with self._lock:
            coll = self.colldb.get(cname)
        return engine.search_device_batch(
            coll, queries, topk=topk, offset=offset,
            resident=True, results_lock=self._lock)

    def _authorized(self, query: dict, min_role: str = "admin") -> bool:
        """The master password or a users-table credential at the
        required role; neither configured = an open instance."""
        pwd = self.conf.master_password
        has_users = bool(self.users.names())
        if not pwd and not has_users:
            return True
        if pwd and query.get("pwd", "") == pwd:
            return True
        u = query.get("user", "")
        return bool(u) and self.users.check(u, query.get("upwd", ""),
                                            min_role=min_role)

    # --- request handling -------------------------------------------------

    def handle(self, method: str, path: str, query: dict,
               body: bytes, client_ip: str = "",
               niceness: int = 0,
               tier: str | None = None,
               tenant: str | None = None) -> tuple[int, str, str]:
        """Route one request → (status, payload, content_type).
        Background (niceness 1) requests yield to interactive ones;
        ``tier``/``tenant`` are propagated X-OSSE-Priority /
        X-OSSE-Tenant verdicts."""
        # drop any response headers an earlier request left on this
        # thread's context (direct handle() callers never pop them)
        admission_mod.pop_response_headers()
        self.nice_gate.enter(niceness)
        try:
            return self._handle_inner(method, path, query, body,
                                      client_ip, niceness=niceness,
                                      header_tier=tier,
                                      header_tenant=tenant)
        finally:
            self.nice_gate.exit(niceness)

    def _handle_inner(self, method: str, path: str, query: dict,
                      body: bytes, client_ip: str = "",
                      niceness: int = 0,
                      header_tier: str | None = None,
                      header_tenant: str | None = None
                      ) -> tuple[int, str, str]:
        try:
            if path == "/":
                return 200, self._page_root(), "text/html"
            if path == "/search":
                # autoban runs before any collection lookup, and read
                # paths never create collections: arbitrary c= names
                # mint no directories (nor bypass the rate limit)
                coll = self._coll_read(query)
                limit = int(coll.conf.autoban_qps) if coll is not None \
                    else int(parms_mod.parm("autoban_qps").default)
                if self._autobanned(client_ip, limit):
                    g_stats.count("autoban.rejected")
                    return _json(429, {"error": "query rate limit "
                                                "(autoban)"})
                if coll is None and self.sharded is None \
                        and self.cluster is None:
                    return _json(404, {"error": "no such collection"})
                # front-door classification: tier= param > propagated
                # header > niceness bit > interactive
                tier = priority_mod.classify(query, niceness=niceness,
                                             header_tier=header_tier)
                g_stats.count(f"admission.tier.{tier}")
                # the billing tenant is the collection
                tenant = header_tenant or query.get("c", "main")
                # not under the core lock: the batcher's worker takes it
                with priority_mod.bind_tier(tier), \
                        priority_mod.bind_tenant(tenant):
                    return self._page_search(query, tier=tier,
                                             tenant=tenant)
            with self._lock:
                return self._route(method, path, query, body)
        except Exception as e:  # noqa: BLE001 — the server must not die
            self.stats["errors"] += 1
            log.warning("error handling %s: %s", path, e)
            return _json(500, {"error": str(e)})

    def _route(self, method: str, path: str, query: dict,
               body: bytes) -> tuple[int, str, str]:
        if path == "/get":
            return self._page_get(query)
        if path in ("/inject", "/addurl", "/delete", "/crawlbot"):
            # index-mutating endpoints are admin-gated once a master
            # password is set (PageInject/Pages auth)
            if not self._authorized(query):
                self.stats["auth_denied"] += 1
                return _json(401, {"error": "bad or missing pwd"})
            if path == "/inject":
                return self._page_inject(query, body)
            if path == "/delete":
                return self._page_delete(query)
            if path == "/addurl":
                return self._page_addurl(query)
            return self._page_crawlbot(query)
        if path == "/metrics":
            # Prometheus-style exposition for external scrapers: like
            # /search, unauthenticated read-only plumbing
            return 200, self._metrics_text(), "text/plain"
        if path.startswith("/admin") and not self._authorized(query):
            self.stats["auth_denied"] += 1
            return _json(401, {"error": "bad or missing pwd"})
        if path in ("/admin", "/admin/"):
            return 200, self._page_admin_index(query), "text/html"
        if path == "/admin/profiler":
            return self._page_profiler(query)
        if path == "/admin/graph":
            return 200, self._page_graph(), "image/svg+xml"
        if path == "/admin/stats":
            stats = dict(self.stats)
            # runs quarantined as corrupt (on open or by a scrub), per
            # replica of the mesh
            if self.sharded is not None:
                q = {f"shard{s}_r{r}:{rn}": rdb.quarantined
                     for s, row in enumerate(self.sharded.grid)
                     for r, coll in enumerate(row)
                     for rn, rdb in coll.rdbs().items()
                     if rdb.quarantined}
            else:
                q = {f"{cn}:{rn}": rdb.quarantined
                     for cn in self.colldb.names()
                     for rn, rdb in self.colldb.get(cn).rdbs().items()
                     if rdb.quarantined}
            if q:
                stats["quarantined_runs"] = q
            return _json(200, stats)
        if path == "/admin/mem":
            return self._page_mem(query)
        if path == "/admin/cache":
            return self._page_cache(query)
        if path == "/admin/traces":
            return self._page_traces(query)
        if path == "/admin/parms":
            return self._page_parms(query)
        if path == "/admin/admission":
            return self._page_admission(query)
        if path == "/admin/tenants":
            return self._page_tenants(query)
        if path == "/admin/hosts":
            return 200, self._page_hosts(), "application/json"
        if path == "/admin/perf":
            return self._page_perf(query)
        if path == "/admin/transport":
            return self._page_transport(query)
        if path == "/admin/jit":
            return self._page_jit(query)
        if path == "/admin/hbm":
            return self._page_hbm(query)
        if path == "/admin/device":
            return self._page_device(query)
        return _json(404, {"error": "no such page"})

    def _coll(self, query: dict):
        return self.colldb.get(query.get("c", "main"))

    def _coll_read(self, query: dict):
        """Read-path lookup: never creates on-disk state for arbitrary
        ``c=`` names, except the default collection (a fresh instance
        answers ``/search?q=x`` with zero results, not 404). None for an
        unknown collection."""
        name = query.get("c", "main")
        try:
            return self.colldb.get(name, create=(name == "main"))
        except KeyError:
            return None

    def _page_root(self) -> str:
        return ('<html><body><form action="/search">'
                '<input name="q"><input type="submit" value="search">'
                "</form></body></html>")

    def _page_search(self, query: dict, tier: str = "interactive",
                     tenant: str | None = None) -> tuple[int, str, str]:
        q = query.get("q", "")
        if not q:
            return _json(400, {"error": "missing q"})
        # debug=1 forces this query's trace and echoes its id
        debug = query.get("debug", "") not in ("", "0")
        with g_tracer.start("search", sampled=True if debug else None,
                            q=q, tier=tier) as tr:
            # the whole-request latency histogram (cache hits and
            # degraded answers included), and its per-tier twin
            with trace_mod.timed_span("serve.search"), \
                    trace_mod.timed_span(f"serve.search.{tier}"):
                return self._page_search_traced(query, q, debug, tr,
                                                tier=tier, tenant=tenant)

    def _query_deadline(self, query: dict):
        """The per-query budget: ``deadline_ms=`` on the request, else
        ``OSSE_DEADLINE_MS``; absent or 0 = unbudgeted."""
        raw = query.get("deadline_ms", "") \
            or os.environ.get("OSSE_DEADLINE_MS", "")
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            return None
        if ms <= 0:
            return None
        return deadline_mod.Deadline.after(ms / 1000.0)

    def _count_cache_hit(self, status: str) -> None:
        self.stats["result_cache_hits"] = \
            self.stats.get("result_cache_hits", 0) + 1
        trace_mod.tag(result_cache=status)

    def _page_search_traced(self, query: dict, q: str, debug: bool,
                            tr, tier: str = "interactive",
                            tenant: str | None = None
                            ) -> tuple[int, str, str]:
        n = min(int(query.get("n", 10)), 100)
        # deep paging (PageResults s=), bounded so a hostile s cannot
        # force a corpus-sized top-k
        s = min(max(int(query.get("s", 0)), 0), 100000)
        fmt = query.get("format", "json")
        self.stats["queries"] += 1
        cname = query.get("c", "main")
        rc_coll = self._coll_read(query)
        if rc_coll is not None:
            conf = rc_coll.conf
        elif self.sharded is not None:
            conf = self.sharded.shards[0].conf
        else:  # a cluster front end: the default collection's parms
            conf = self.colldb.get("main").conf
        ttl = float(conf.result_cache_ttl)
        swr = float(conf.result_cache_swr)
        ckey = gen = None
        # debug requests bypass the result cache both ways: a cached
        # body would echo a stale trace id
        if ttl > 0 and not debug:
            gen = self._result_gen(rc_coll)
            ckey = (cname, q, n, s, fmt)
        dl = self._query_deadline(query)
        # a fresh cache hit bypasses the admission gate: serving from
        # memory costs nothing the gate protects
        if ckey is not None:
            hit, page = self._result_cache.lookup(ckey, gen=gen)
            if hit:
                self._count_cache_hit("hit")
                return page
        try:
            token = self.admission.admit(tier, deadline=dl, tenant=tenant)
        except admission_mod.Shed as shed:
            return self._shed_response(shed, ckey, gen)
        try:
            with token, deadline_mod.bind(dl):
                out = self._search_cached(query, q, n, s, fmt, rc_coll,
                                          debug, tr, ckey, gen, ttl, swr)
            deadline_mod.note_met(dl)
            return out
        except priority_mod.QueueFull:
            # a bounded dispatch queue refused past the gate: the same
            # shed ladder
            return self._shed_response(admission_mod.Shed("queue_full"),
                                       ckey, gen)
        except deadline_mod.DeadlineExceeded:
            # the budget burned downstream: the same generation's
            # just-expired page beats a refusal, marked degraded
            if ckey is not None:
                hit, page = self._result_cache.lookup_stale(ckey, gen=gen)
                if hit:
                    g_stats.count("deadline.stale_served")
                    trace_mod.tag(deadline="expired", results="degraded")
                    self.stats["deadline_stale"] = \
                        self.stats.get("deadline_stale", 0) + 1
                    return page
            g_stats.count("deadline.refused")
            return _json(504, {"error": "deadline exceeded"})

    def _shed_response(self, shed: admission_mod.Shed, ckey, gen
                       ) -> tuple[int, str, str]:
        """The shed ladder, cheapest first: the same generation's stale
        page marked degraded, else 503 + Retry-After. Every shed is
        counted."""
        if ckey is not None:
            hit, page = self._result_cache.lookup_stale(ckey, gen=gen)
            if hit:
                g_stats.count("admission.shed.stale")
                trace_mod.tag(admission=shed.reason, results="degraded")
                self.stats["admission_stale"] = \
                    self.stats.get("admission_stale", 0) + 1
                return page
        g_stats.count("admission.shed.refused")
        trace_mod.tag(admission=shed.reason, results="refused")
        self.stats["admission_refused"] = \
            self.stats.get("admission_refused", 0) + 1
        retry = max(1, int(round(shed.retry_after_s)))
        admission_mod.set_response_header("Retry-After", str(retry))
        return _json(503, {"error": f"overloaded ({shed.reason})",
                           "retryAfter": retry})

    def _search_cached(self, query: dict, q: str, n: int, s: int,
                       fmt: str, rc_coll, debug: bool, tr, ckey, gen,
                       ttl: float, swr: float) -> tuple[int, str, str]:
        """Msg17/Msg40Cache: identical pages within the TTL serve from
        memory; the index version in the generation invalidates them at
        once on a write. A page answered by a device index behind that
        version (the old index serving while a background rebuild runs)
        is served but not cached, so the fresh index's first answer is
        not shadowed by a pre-write page. A degraded page (a whole shard
        missing) is served and never cached."""
        answered: dict = {}
        if ckey is not None:
            hit, page = self._result_cache.lookup(ckey, gen=gen)
            if hit:
                self._count_cache_hit("hit")
                return page
            if swr > 0:
                # stale-while-revalidate: serve the just-expired page
                # and refresh in the background, never across a
                # generation move (get_or_compute enforces that)
                page, status = self._result_cache.get_or_compute(
                    ckey,
                    lambda: self._render_search(query, q, n, s, fmt,
                                                rc_coll, debug, tr,
                                                answered=answered),
                    ttl_s=ttl, gen=gen, swr_s=swr)
                if status in ("hit", "stale", "join"):
                    self._count_cache_hit(status)
                if answered.get("generation", gen[1]) != gen[1] \
                        or answered.get("degraded"):
                    self._result_cache.invalidate(ckey)
                return page
        page = self._render_search(query, q, n, s, fmt, rc_coll, debug, tr,
                                   answered=answered)
        if ckey is not None and not answered.get("degraded") and \
                answered.get("generation", gen[1]) == gen[1]:
            self._result_cache.put(ckey, page, ttl_s=ttl, gen=gen)
        return page

    def _result_gen(self, rc_coll) -> tuple:
        """The result cache's generation: the version a write to the
        collection's posdb moves; on the mesh, every twin's posdb
        version; on a cluster, every shard's generation pair."""
        if self.cluster is not None:
            return ("cluster",) + self.cluster.gen_vector()
        if self.sharded is not None:
            return ("sharded",) + tuple(
                coll.posdb.version
                for row in self.sharded.grid for coll in row)
        return ("flat", rc_coll.posdb.version)

    def _render_search(self, query: dict, q: str, n: int, s: int,
                       fmt: str, rc_coll, debug: bool, tr,
                       answered: dict | None = None
                       ) -> tuple[int, str, str]:
        """One page; ``answered["generation"]`` receives the posdb
        version the device route answered at, ``answered["degraded"]``
        whether a whole shard was missing (such a page is not cached)."""
        if self.cluster is not None:
            # the conf only carries the PQR factors; the read-only lookup
            # above never created a collection for it
            res = self.cluster.search(
                q, topk=n, offset=s,
                conf=rc_coll.conf if rc_coll is not None else None)
        elif self.sharded is not None:
            if self.conf.serve_mesh:
                # the mesh's resident loop serializes the device work;
                # the core lock covers only the page build
                res = engine.get_mesh_resident(self.sharded).serve(
                    q, topk=n, offset=s, results_lock=self._lock)
            else:
                from ..parallel import sharded_search
                with self._lock:
                    res = sharded_search(self.sharded, q, topk=n,
                                         offset=s)
        elif self.conf.serve_device:
            # the resident device route through the micro-batcher. No
            # host fallback: a failed batch answers 500 (serve.device_
            # error); overload and expiry take the serve edge's ladders
            try:
                res = self._batcher.search((query.get("c", "main"), n, s),
                                           q)
            except (deadline_mod.DeadlineExceeded,
                    priority_mod.QueueFull):
                raise
            except Exception:
                g_stats.count("serve.device_error")
                raise
        else:
            with self._lock:
                res = engine.search(rc_coll, q, topk=n, offset=s)
        if res.degraded:
            if answered is not None:
                answered["degraded"] = True
            self.stats["degraded"] = self.stats.get("degraded", 0) + 1
            trace_mod.tag(results="degraded")
        if answered is not None and res.generation is not None:
            answered["generation"] = res.generation
        with trace_mod.span("serve.render"):
            payload, ctype = render_results(
                res, fmt,
                trace_id=tr.trace_id if (debug and tr is not None)
                else None)
        return 200, payload, ctype

    def _page_get(self, query: dict) -> tuple[int, str, str]:
        """Cached page with optional highlight (PageGet.cpp)."""
        docid = int(query.get("d", "0"))
        self.stats["gets"] += 1
        if self.cluster is not None:
            rec = self.cluster.get_document(docid)
        elif self.sharded is not None:
            rec = self.sharded.get_document(docid)
        else:
            coll = self._coll_read(query)  # read path: never mint colls
            rec = docproc.get_document(coll, docid=docid) \
                if coll is not None else None
        if rec is None:
            return _json(404, {"error": "not found"})
        content = rec.get("content", rec.get("text", ""))
        terms = [w for w in query.get("q", "").split() if w]
        if terms:
            content = highlight(content, terms,
                                pre='<span style="background:yellow">',
                                post="</span>")
        return 200, content, "text/html"

    def _page_inject(self, query: dict, body: bytes) -> tuple[int, str, str]:
        """Direct content injection (PageInject.cpp)."""
        url = query.get("u") or query.get("url")
        if not url:
            return _json(400, {"error": "missing u"})
        content = body.decode("utf-8", "replace") if body else \
            query.get("content", "")
        self.stats["injects"] += 1
        if self.cluster is not None:
            # delivered to every twin of the owning shard (a dead twin's
            # copy parks in its ordered retry queue)
            return _json(200, {"docId": int(
                self.cluster.index_document(url, content))})
        if self.sharded is not None:
            ml = self.sharded.index_document(url, content)
        else:
            ml = docproc.index_document(self._coll(query), url, content)
        if ml is None:  # tagdb manualban (EDOCBANNED)
            return _json(403, {"error": "banned by tagdb"})
        return _json(200, {"docId": ml.docid,
                           "numKeys": len(ml.posdb_keys)})

    def _page_delete(self, query: dict) -> tuple[int, str, str]:
        """Remove a url from the index. The write moves posdb's version,
        which invalidates every dependent cache entry."""
        url = query.get("u") or query.get("url")
        if not url:
            return _json(400, {"error": "missing u"})
        self.stats["deletes"] = self.stats.get("deletes", 0) + 1
        if self.cluster is not None:
            self.cluster.remove_document(url)
            return _json(200, {"deleted": url})
        if self.sharded is not None:
            ok = self.sharded.remove_document(url)
        else:
            ok = docproc.remove_document(self._coll(query), url)
        if not ok:
            return _json(404, {"error": "not found"})
        return _json(200, {"deleted": url})

    def _page_addurl(self, query: dict) -> tuple[int, str, str]:
        """Queue a url for spidering (PageAddUrl.cpp); 503 when the
        server has no spider."""
        url = query.get("u") or query.get("url")
        if not url:
            return _json(400, {"error": "missing u"})
        self.stats["addurls"] += 1
        if self.spider is None:
            return _json(503, {"error": "spider not running"})
        self.spider.add_url(url)
        return _json(200, {"queued": url})

    def _page_crawlbot(self, query: dict) -> tuple[int, str, str]:
        """The REST crawl jobs (PageCrawlBot.cpp): create, status, pause,
        resume, delete and the job list."""
        from .crawlbot import CrawlBot
        # under the core lock, so two first requests build one CrawlBot
        with self._lock:
            if self._crawlbot is None:
                self._crawlbot = CrawlBot(
                    self.colldb, fetcher_factory=self.crawl_fetcher_factory)
            bot = self._crawlbot
        name = query.get("name", "")
        if not name:
            return _json(200, {"jobs": bot.list_jobs()})
        action = query.get("action", "")
        if action in ("pause", "resume"):
            job = bot.get(name)
            if job is None:
                return _json(404, {"error": "no such job"})
            job.paused = action == "pause"
            return _json(200, job.status())
        if action == "delete":
            ok = bot.delete(name)
            return _json(200 if ok else 404, {"deleted": ok})
        seeds = [u for u in (query.get("seeds", "") or "").replace(
            ",", " ").split() if u]
        if seeds:
            try:
                job = bot.create(
                    name, seeds, max_pages=int(query.get("maxpages", 100)),
                    max_hops=int(query.get("maxhops", 3)),
                    same_host_only=query.get("spanhosts", "0")
                    not in ("1", "true"))
            except ValueError as e:
                return _json(409, {"error": str(e)})
            return _json(200, job.status())
        job = bot.get(name)
        if job is None:
            return _json(404, {"error": "no such job"})
        return _json(200, job.status())

    def _page_parms(self, query: dict) -> tuple[int, str, str]:
        """The parameter table, and live updates of the collection's
        parms by cgi name (``&rcttl=...``), which fire the conf's
        ``on_update`` listeners."""
        coll = self._coll(query)
        updated = {}
        for cgi, value in query.items():
            if cgi in ("c",):
                continue
            try:
                coll.conf.set_from_cgi(cgi, value)
                updated[cgi] = value
            except KeyError:
                continue
        table = [{"name": p.name, "cgi": p.cgi, "type": p.type.__name__,
                  "default": p.default, "scope": p.scope, "desc": p.desc}
                 for p in parms_mod.parm_table()]
        return _json(200, {"updated": updated, "coll": coll.conf.to_dict(),
                           "table": table})

    # --- admin pages -------------------------------------------------------

    def _page_admin_index(self, query: dict) -> str:
        pwd = query.get("pwd", "")
        sfx = f"?pwd={urllib.parse.quote(pwd)}" if pwd else ""
        links = "".join(
            f'<li><a href="/admin/{p}{sfx}">{p}</a></li>'
            for p in ("stats", "hosts", "perf", "mem", "transport",
                      "cache", "traces", "parms", "jit", "hbm",
                      "device", "admission", "tenants", "profiler",
                      "graph")) \
            + '<li><a href="/metrics">metrics</a></li>'
        rows = "".join(f"<tr><td>{k}</td><td>{v}</td></tr>"
                       for k, v in self.stats.items())
        colls = ", ".join(self.colldb.names())
        return (f"<html><head><title>gb admin</title></head><body>"
                f"<h1>admin</h1><p>collections: {colls}</p>"
                f"<ul>{links}</ul><table border=1>{rows}</table>"
                f"</body></html>")

    def _page_admission(self, query: dict) -> tuple[int, str, str]:
        """Gate occupancy and tier queues, the shed/tier counters and the
        queue-delay histogram. ``?format=json`` returns the snapshot."""
        snap = self.admission.snapshot()
        adm = g_stats.prefixed("admission.")
        snap["counters"] = dict(sorted(adm["counters"].items()))
        snap["queue_delay"] = adm["latencies"].get(
            "admission.queue_delay", {})
        if query.get("format") == "json":
            return _json(200, snap)
        qrows = "".join(f"<tr><td>{t}</td><td>{n}</td></tr>"
                        for t, n in snap["queued"].items())
        crows = "".join(f"<tr><td>{k}</td><td>{v}</td></tr>"
                        for k, v in snap["counters"].items()) \
            or "<tr><td colspan=2>none</td></tr>"
        return 200, (
            "<html><head><title>gb admission</title></head><body>"
            "<h1>admission</h1>"
            f"<p>inflight {snap['inflight']}/{snap['max_inflight']}"
            f" &middot; queued {snap['queued_total']}/{snap['max_queue']}"
            f" &middot; svc EWMA {snap['svc_ewma_ms']} ms"
            f" &middot; admitted {snap['admitted_total']}"
            f" &middot; shed {snap['shed_total']}</p>"
            "<table border=1><tr><th>tier</th><th>queued</th></tr>"
            f"{qrows}</table>"
            f"<h2>queue delay</h2><p>{json.dumps(snap['queue_delay'])}</p>"
            f"<h2>counters</h2><table border=1>{crows}</table>"
            "</body></html>"), "text/html"

    def _page_tenants(self, query: dict) -> tuple[int, str, str]:
        """The resident set (ResidencyManager) beside each tenant's
        admission ledger. ``?format=json`` returns both snapshots."""
        res = g_residency.snapshot()
        adm = self.admission.snapshot().get("tenants", {})
        if query.get("format") == "json":
            return _json(200, {"residency": res, "admission": adm})
        rows = []
        for n in sorted(set(res["tenants"]) | set(adm)):
            rt, at = res["tenants"].get(n, {}), adm.get(n, {})
            served, shed = at.get("served", 0), at.get("shed", 0)
            burn = shed / (served + shed) if served + shed else 0.0
            rows.append(
                f"<tr><td>{html_mod.escape(n)}</td>"
                f"<td>{'RESIDENT' if rt.get('resident') else 'parked'}"
                f"{' (pinned)' if rt.get('pinned') else ''}</td>"
                f"<td>{rt.get('device_bytes', 0) / (1 << 20):.2f}</td>"
                f"<td>{rt.get('hits', 0)}</td>"
                f"<td>{rt.get('cold_starts', 0)}</td>"
                f"<td>{at.get('weight', 1.0):g}</td>"
                f"<td>{served}</td><td>{shed}</td>"
                f"<td>{100.0 * burn:.1f}%</td></tr>")
        table = "".join(rows) or "<tr><td colspan=9>no tenants</td></tr>"
        return 200, (
            "<html><head><title>gb tenants</title></head><body>"
            "<h1>tenant plane</h1>"
            f"<p>resident {res['resident']} &middot; parked "
            f"{res['parked']} &middot; device "
            f"{res['device_bytes'] / (1 << 20):.1f} MB &middot; cold "
            f"starts {res['coldstarts']} (p50 "
            f"{res['coldstart_p50_ms']:.1f} ms, p99 "
            f"{res['coldstart_p99_ms']:.1f} ms)</p>"
            "<table border=1><tr><th>tenant</th><th>state</th>"
            "<th>device MB</th><th>hits</th><th>cold starts</th>"
            "<th>weight</th><th>served</th><th>shed</th>"
            f"<th>shed rate</th></tr>{table}</table>"
            "</body></html>"), "text/html"

    def _page_mem(self, query: dict) -> tuple[int, str, str]:
        """The memory budget by label, with the guardrail counters.
        ``?format=json`` returns the snapshot."""
        snap = g_membudget.snapshot()
        snap["counters"] = {
            k: v for k, v in sorted(g_stats.snapshot()["counters"].items())
            if k.startswith(("membudget.", "devcheck."))}
        snap["checkify"] = devcheck.enabled()
        if query.get("format") == "json":
            return _json(200, snap)

        def mb(n):
            return f"{n / (1 << 20):.2f}"
        rows = "".join(
            f"<tr><td>{lb}</td><td>{mb(d['reserved'])}</td>"
            f"<td>{mb(d['gauged'])}</td><td>{d['rejections']}</td></tr>"
            for lb, d in snap["labels"].items())
        crows = "".join(f"<tr><td>{k}</td><td>{v}</td></tr>"
                        for k, v in snap["counters"].items()) \
            or "<tr><td colspan=2>none</td></tr>"
        return 200, (
            "<html><head><title>gb mem</title></head><body>"
            "<h1>memory budget</h1>"
            f"<p>limit {mb(snap['limit'])} MB &middot; "
            f"used {mb(snap['used'])} MB &middot; "
            f"free {mb(snap['free'])} MB &middot; "
            f"high water {mb(snap['high_water'])} MB &middot; "
            f"rejections {snap['rejections']} &middot; "
            f"checkify {'on' if snap['checkify'] else 'off'}</p>"
            "<table border=1><tr><th>label</th><th>reserved MB</th>"
            f"<th>gauged MB</th><th>rejections</th></tr>{rows}</table>"
            f"<h2>guardrail counters</h2><table border=1>{crows}</table>"
            "</body></html>"), "text/html"

    def _page_cache(self, query: dict) -> tuple[int, str, str]:
        """Every registered cache with entries, bytes, hit rate and
        generation; ``?flush=<name>`` or ``?flush=all`` flushes, and
        ``?format=json`` returns the snapshot and the ``cache.*``
        metrics."""
        flush = query.get("flush", "")
        flushed = None
        if flush:
            flushed = g_cacheplane.flush(None if flush == "all" else flush)
        snap = g_cacheplane.snapshot()
        if query.get("format") == "json":
            body = {"caches": snap, "enabled": g_cacheplane.enabled,
                    "metrics": g_stats.prefixed("cache.")}
            if flushed is not None:
                body["flushed_bytes"] = flushed
            return _json(200, body)
        pwd = query.get("pwd", "")
        sfx = f"&pwd={urllib.parse.quote(pwd)}" if pwd else ""
        rows = "".join(
            f"<tr><td>{nm}</td><td>{st['entries']}</td>"
            f"<td>{st['bytes'] / (1 << 10):.1f}</td>"
            f"<td>{st['hits']}</td><td>{st['misses']}</td>"
            f"<td>{100.0 * st['hit_rate']:.1f}%</td>"
            f"<td>{st['evictions']}</td><td>{st['stale_served']}</td>"
            f"<td><code>{html_mod.escape(st['generation'])}</code></td>"
            f"<td><a href=\"/admin/cache?flush="
            f"{urllib.parse.quote(nm)}{sfx}\">flush</a></td></tr>"
            for nm, st in snap.items()) \
            or "<tr><td colspan=10>no registered caches</td></tr>"
        note = (f"<p>flushed {flushed} bytes</p>"
                if flushed is not None else "")
        return 200, (
            "<html><head><title>gb cache</title></head><body>"
            "<h1>cache plane</h1>"
            f"<p>plane {'enabled' if g_cacheplane.enabled else 'DISABLED'}"
            f" &middot; <a href=\"/admin/cache?flush=all{sfx}\">"
            "flush all</a></p>" + note +
            "<table border=1><tr><th>cache</th><th>entries</th>"
            "<th>KB</th><th>hits</th><th>misses</th><th>hit rate</th>"
            "<th>evict</th><th>stale</th><th>generation</th><th></th>"
            f"</tr>{rows}</table></body></html>"), "text/html"

    def _page_traces(self, query: dict) -> tuple[int, str, str]:
        """Recent sampled traces and the slow-query log. ``?id=`` shows
        one trace's span tree; ``?format=json`` returns the ring and the
        slowlog tail."""
        recent = g_tracer.recent()
        slowlog = g_tracer.slowlog_tail(50)
        if query.get("format") == "json":
            return _json(200, {"recent": recent, "slowlog": slowlog,
                               "sample_n": g_tracer.sample_n,
                               "slow_ms": g_tracer.slow_ms})
        tid = query.get("id", "")
        if tid:
            tr = g_tracer.find(tid) or next(
                (t for t in reversed(slowlog)
                 if t.get("trace_id") == tid), None)
            if tr is None:
                return _json(404, {"error": "no such trace"})
            return 200, (
                "<html><head><title>trace</title></head><body>"
                f"{self._trace_tree(tr)}"
                '<p><a href="/admin/traces">all traces</a></p>'
                "</body></html>"), "text/html"
        blocks = "".join(self._trace_tree(t) for t in reversed(recent[-20:]))
        slows = "".join(
            f'<tr><td><a href="/admin/traces?id='
            f'{html_mod.escape(str(t.get("trace_id", "")))}">'
            f'{html_mod.escape(str(t.get("trace_id", "")))}</a></td>'
            f'<td>{t.get("dur_ms", 0):.1f}</td></tr>'
            for t in reversed(slowlog)) or "<tr><td colspan=2>empty</td></tr>"
        return 200, (
            "<html><head><title>gb traces</title></head><body>"
            "<h1>traces</h1>"
            f"<p>sampling 1/{g_tracer.sample_n} &middot; slow &ge; "
            f"{g_tracer.slow_ms:.0f} ms &middot; ring {len(recent)}</p>"
            "<h2>slow queries (slowlog.jsonl)</h2>"
            "<table border=1><tr><th>trace</th><th>ms</th></tr>"
            f"{slows}</table><h2>recent traces</h2>{blocks}"
            "</body></html>"), "text/html"

    @staticmethod
    def _trace_tree(tr: dict) -> str:
        """One trace as an indented list of its spans."""
        rows: list[str] = []

        def walk(node: dict, depth: int) -> None:
            tags = " ".join(f"{k}={v}" for k, v in
                            (node.get("tags") or {}).items())
            rows.append(
                f'<div style="margin-left:{depth * 16}px">'
                + html_mod.escape(
                    f"{node.get('name', '?')} +{node.get('start_ms', 0)}"
                    f" ms, {node.get('dur_ms', 0):.2f} ms {tags}")
                + "</div>")
            for c in node.get("children", []):
                walk(c, depth + 1)

        walk(tr.get("root") or {}, 0)
        return (f'<div style="border:1px solid #ccc;margin:8px">'
                f'<p>trace <b>{html_mod.escape(str(tr.get("trace_id")))}'
                f'</b> &middot; {tr.get("dur_ms", 0):.1f} ms'
                + (" &middot; <b>slow</b>" if tr.get("slow") else "")
                + f'</p>{"".join(rows)}</div>')

    def _fleet_view(self) -> tuple[dict, dict]:
        """(hosts, fleet): per-host ``Stats.wire()`` payloads (None for an
        unreachable host) and their bucket-wise merge. A cluster front
        end scrapes every node's ``/rpc/stats``; a single process is a
        one-host fleet."""
        if self.cluster is not None:
            sc = self.cluster.scrape()
            return sc["hosts"], sc["fleet"]
        w = g_stats.wire()
        return {"local": w}, merge_wire([w])

    def _page_perf(self, query: dict) -> tuple[int, str, str]:
        """The fleet perf dashboard (PagePerf across hosts): one row per
        latency metric with each host's p99 and the merged fleet
        distribution (fleet percentiles come from merged histogram
        buckets, never from averaging per-host percentiles), the SLO
        burn rates, gauges and counters. ``?format=json`` returns the
        merged view raw."""
        from ..utils.stats import LatencyStat
        hosts, fleet = self._fleet_view()
        # evaluate against the view just scraped, so the page is fresh
        if g_slo.objectives:
            try:
                g_slo.evaluate(fleet["counters"], fleet["latencies"])
            except Exception:  # noqa: BLE001 — the page still renders
                g_stats.count("slo.eval_errors")
        slo_status = g_slo.status()
        alerts = []
        n_ovf = fleet["counters"].get("build.postings_overflow", 0)
        if n_ovf:
            alerts.append({
                "name": "shard_split_needed", "count": n_ovf,
                "hint": ("a shard hit the 2^31 stored-postings pack limit "
                         "(build.postings_overflow): split the collection "
                         "across more shards before the node boot-loops")})
        # the HBM row: the ledger's total beside what the first card's
        # allocator holds and its free bytes (nulls on the CPU or with
        # devwatch off: the row still renders)
        rec = devwatch.reconcile()
        dev0 = rec["devices"][0] if rec["devices"] else {}
        hbm = {"enabled": devwatch.enabled(),
               "ledger_bytes": rec["ledger_bytes"],
               "bytes_in_use": dev0.get("bytes_in_use"),
               "headroom": dev0.get("headroom")}
        if query.get("format") == "json":
            return _json(200, {
                "hosts": {
                    a: None if w is None else {
                        k: LatencyStat.from_wire(v).to_dict()
                        for k, v in w.get("latencies", {}).items()}
                    for a, w in hosts.items()},
                "fleet": {
                    "counters": fleet["counters"],
                    "gauges": fleet["gauges"],
                    "latencies": {
                        k: {**st.to_dict(),
                            "exemplars": [
                                {"trace_id": tid, "ms": ms}
                                for _, (tid, ms)
                                in sorted(st.exemplars.items())]}
                        for k, st in fleet["latencies"].items()},
                },
                "slo": slo_status,
                "alerts": alerts,
                "hbm": hbm,
            })
        pwd = query.get("pwd", "")
        sfx = f"&pwd={urllib.parse.quote(pwd)}" if pwd else ""
        addrs = sorted(hosts)
        per_host = {
            a: {} if hosts[a] is None else {
                k: LatencyStat.from_wire(v)
                for k, v in hosts[a].get("latencies", {}).items()}
            for a in addrs}
        lat_rows = []
        for name in sorted(fleet["latencies"]):
            st = fleet["latencies"][name]
            cells = "".join(
                f"<td>{per_host[a][name].quantile(0.99):.2f}</td>"
                if name in per_host[a] else "<td>-</td>" for a in addrs)
            d = st.to_dict()
            ex = ""
            if st.exemplars:
                tid, _ms = st.exemplars[max(st.exemplars)]
                ex = f' <a href="/admin/traces?id={tid}{sfx}">ex</a>'
            lat_rows.append(
                f"<tr><td>{name}</td>{cells}"
                f"<td>{d['count']}</td><td>{d['avg_ms']:.2f}</td>"
                f"<td>{d['p50_ms']:.2f}</td>"
                f"<td>{d['p99_ms']:.2f}{ex}</td>"
                f"<td>{d['max_ms']:.2f}</td></tr>")
        hdr = "".join(f"<th>{html_mod.escape(a)} p99</th>" for a in addrs)

        def spark(metric: str, color: str) -> str:
            pts = [(t, m.get(metric))
                   for t, m in g_stats.series(last_s=600)
                   if m.get(metric) is not None]
            if len(pts) < 2:
                return ""
            t0, t1 = pts[0][0], pts[-1][0]
            span = max(t1 - t0, 1.0)
            top = max(v for _, v in pts) or 1.0
            xy = " ".join(f"{(t - t0) / span * 120:.1f},"
                          f"{28.0 - v / top * 24.0:.1f}"
                          for t, v in pts)
            return (f'<svg xmlns="http://www.w3.org/2000/svg" '
                    f'width="124" height="30">'
                    f'<polyline fill="none" stroke="{color}" '
                    f'points="{xy}"/></svg> {metric} (max {top:g})')

        lsfx = f"?pwd={urllib.parse.quote(pwd)}" if pwd else ""
        slo_rows = "".join(
            f"<tr><td>{n}</td><td>{st['kind']}</td><td>{st['target']}</td>"
            f"<td>{st['window_total']}</td><td>{st['window_bad']}</td>"
            f"<td>{st['burn_rate']:.3f}</td>"
            f"<td>{st['budget_remaining']:.3f}</td>"
            f"<td>{'BURNING' if st['burning'] else 'ok'}</td></tr>"
            for n, st in sorted(slo_status.items())) \
            or "<tr><td colspan=8>no objectives declared</td></tr>"
        gauge_rows = "".join(f"<tr><td>{k}</td><td>{v:g}</td></tr>"
                             for k, v in sorted(fleet["gauges"].items()))
        ctr_rows = "".join(f"<tr><td>{k}</td><td>{v}</td></tr>"
                           for k, v in sorted(fleet["counters"].items()))
        up = sum(1 for w in hosts.values() if w is not None)
        alert_html = "".join(
            f'<p style="color:#fff;background:#c00;padding:6px">'
            f"ALERT {a['name']} (&times;{a['count']}): {a['hint']}</p>"
            for a in alerts)
        return 200, (
            "<html><head><title>gb perf</title></head><body>"
            "<h1>fleet perf</h1>"
            f"{alert_html}"
            f"<p>{up}/{len(hosts)} hosts scraped &middot; "
            f'<a href="/admin/perf?format=json{sfx}">json</a> &middot; '
            f'<a href="/metrics">metrics</a></p>'
            f"<p>HBM: ledger {hbm['ledger_bytes'] >> 20} MB &middot; "
            f"in use {hbm['bytes_in_use'] if hbm['bytes_in_use'] is not None else 'n/a'}"
            f" &middot; headroom "
            f"{hbm['headroom'] if hbm['headroom'] is not None else 'n/a'}"
            f" &middot; devwatch "
            f"{'on' if hbm['enabled'] else 'off'} &middot; "
            f'<a href="/admin/hbm{lsfx}">hbm</a> '
            f'<a href="/admin/device{lsfx}">device</a></p>'
            f"<p>{spark('qps', '#1f77b4')}<br>"
            f"{spark('p50_ms', '#d62728')}</p>"
            f"<h2>latencies (ms)</h2>"
            f"<table border=1><tr><th>metric</th>{hdr}"
            "<th>fleet n</th><th>avg</th><th>p50</th><th>p99</th>"
            f"<th>max</th></tr>{''.join(lat_rows)}</table>"
            "<h2>SLOs</h2>"
            "<table border=1><tr><th>objective</th><th>kind</th>"
            "<th>target</th><th>window n</th><th>bad</th>"
            "<th>burn rate</th><th>budget left</th><th></th></tr>"
            f"{slo_rows}</table>"
            f"<h2>gauges</h2><table border=1>{gauge_rows}</table>"
            f"<h2>counters</h2><table border=1>{ctr_rows}</table>"
            "</body></html>"), "text/html"

    def _page_transport(self, query: dict) -> tuple[int, str, str]:
        """Cluster transport health (JSON): the ``transport.*`` counters,
        latencies and gauges, each peer's pool and RTT EWMAs, and on a
        cluster the twin preferences of every shard."""
        from ..parallel.transport import g_transport
        body = g_stats.prefixed("transport.")
        tr = (self.cluster.transport if self.cluster is not None
              else g_transport)
        body["peers"] = tr.stats()
        if self.cluster is not None:
            hm = self.cluster.hostmap
            body["hostmap"] = {
                f"shard{s}": {
                    "twin_order": hm.twin_order(s),
                    "alive": [bool(a) for a in hm.alive[s]],
                    "rtt_ms": [round(1000.0 * float(v), 3)
                               for v in hm.rtt_s[s]],
                    "addrs": self.cluster.conf.addresses[s],
                } for s in range(hm.n_shards)}
        return _json(200, body)

    def _metrics_text(self) -> str:
        """Prometheus-style text exposition of the merged fleet view:
        latency histograms (with OpenMetrics exemplars where a sampled
        trace landed in a bucket), per-tenant outcomes, counters, gauges
        and the number of hosts scraped. Metric names ride in a ``name``
        label."""
        hosts, fleet = self._fleet_view()
        lines = [
            "# HELP osse_latency_ms merged fleet latency histogram (ms)",
            "# TYPE osse_latency_ms histogram",
        ]
        for name in sorted(fleet["latencies"]):
            st = fleet["latencies"][name]
            cum = 0
            for idx in sorted(st.buckets):
                cum += st.buckets[idx]
                hi = _bucket_bounds(idx)[1]
                line = (f'osse_latency_ms_bucket{{name="{name}",'
                        f'le="{hi:g}"}} {cum}')
                ex = st.exemplars.get(idx)
                if ex is not None:
                    line += f' # {{trace_id="{ex[0]}"}} {ex[1]:g}'
                lines.append(line)
            lines.append(f'osse_latency_ms_bucket{{name="{name}",'
                         f'le="+Inf"}} {st.count}')
            lines.append(f'osse_latency_ms_sum{{name="{name}"}} '
                         f"{st.total_ms:g}")
            lines.append(f'osse_latency_ms_count{{name="{name}"}} '
                         f"{st.count}")
        lines.append("# TYPE osse_tenant_requests_total counter")
        for k, v in sorted(fleet["counters"].items()):
            if not k.startswith("admission.tenant."):
                continue
            t, _, outcome = k[len("admission.tenant."):].rpartition(".")
            if t and outcome in ("served", "shed"):
                lines.append(f'osse_tenant_requests_total{{tenant="{t}",'
                             f'outcome="{outcome}"}} {v}')
        lines.append("# TYPE osse_counter counter")
        lines.extend(f'osse_counter{{name="{k}"}} {v}'
                     for k, v in sorted(fleet["counters"].items()))
        lines.append("# TYPE osse_gauge gauge")
        lines.extend(f'osse_gauge{{name="{k}"}} {v:g}'
                     for k, v in sorted(fleet["gauges"].items()))
        # per-(collection, plane) device residency from the HBM ledger
        # (OSSE_DEVWATCH=1; no rows when off)
        lines.append("# TYPE osse_hbm_bytes gauge")
        for c, planes in sorted(
                devwatch.g_devwatch.ledger_snapshot().items()):
            for p, cols in sorted(planes.items()):
                lines.append(f'osse_hbm_bytes{{collection="{c}",'
                             f'plane="{p}"}} {sum(cols.values())}')
        lines.append(f"osse_hosts_scraped "
                     f"{sum(1 for w in hosts.values() if w is not None)}")
        return "\n".join(lines) + "\n"

    def _page_jit(self, query: dict) -> tuple[int, str, str]:
        """Kernel-build and transfer attribution from the jit watcher
        (OSSE_JITWATCH=1): every event keyed by (kind, function,
        call-site), so a steady-state build or a hidden host sync names
        its line. ``?format=json`` returns the raw snapshot."""
        snap = jitwatch.snapshot()
        counters = g_stats.snapshot()["counters"]
        snap["counters"] = {k: v for k, v in sorted(counters.items())
                            if k.startswith("jit.")}
        if query.get("format") == "json":
            return 200, json.dumps(snap), "application/json"
        t = snap["totals"]
        rows = "".join(
            f"<tr><td>{e['kind']}</td><td>{e['fn']}</td>"
            f"<td>{e['site']}</td><td>{e['count']}</td>"
            f"<td>{e['bytes']}</td>"
            f"<td>{'yes' if e['boundary'] else 'NO'}</td>"
            f"<td>{e['shapes'] or e['last']}</td></tr>"
            for e in snap["events"]) \
            or "<tr><td colspan=7>none</td></tr>"
        return 200, (
            "<html><head><title>gb jit</title></head><body>"
            "<h1>jit plane</h1>"
            f"<p>watcher {'enabled' if snap['enabled'] else 'DISABLED'}"
            f" &middot; compiles {t['compiles']}"
            f" &middot; first traces {t['first_traces']}"
            f" &middot; retraces {t['retraces']}"
            f" &middot; transfers {t['transfers']}"
            f" (off-boundary {t['transfers_offboundary']})</p>"
            "<table border=1><tr><th>kind</th><th>fn</th><th>site</th>"
            "<th>count</th><th>bytes</th><th>boundary</th>"
            f"<th>detail</th></tr>{rows}</table>"
            "</body></html>"), "text/html"

    def _page_hbm(self, query: dict) -> tuple[int, str, str]:
        """HBM ledger (OSSE_DEVWATCH=1): every registered device
        buffer by (collection, plane, column), plane totals, and the
        reconciliation against ``torch.cuda.memory_stats`` and
        ``mem_get_info`` — live bytes the ledger cannot name are
        allocator slack + unregistered temporaries (the fragmentation
        column). ``?format=json`` returns the raw ledger."""
        snap = devwatch.snapshot()
        body = {k: snap[k] for k in ("enabled", "ledger", "planes",
                                     "collections", "total_bytes",
                                     "reconcile")}
        if query.get("format") == "json":
            return 200, json.dumps(body), "application/json"
        rows = "".join(
            f"<tr><td>{c}</td><td>{p}</td><td>{col}</td>"
            f"<td>{n}</td></tr>"
            for c, planes in sorted(snap["ledger"].items())
            for p, cols in sorted(planes.items())
            for col, n in sorted(cols.items())) \
            or "<tr><td colspan=4>none</td></tr>"
        dev_rows = "".join(
            f"<tr><td>{d['device']}</td><td>{d['kind']}</td>"
            f"<td>{d['bytes_in_use']}</td>"
            f"<td>{d['peak_bytes_in_use']}</td>"
            f"<td>{d['headroom']}</td>"
            f"<td>{d['fragmentation']}</td></tr>"
            for d in snap["reconcile"]["devices"]) \
            or "<tr><td colspan=6>no devices</td></tr>"
        planes = " &middot; ".join(
            f"{p}: {n >> 20} MB"
            for p, n in sorted(snap["planes"].items())) or "empty"
        return 200, (
            "<html><head><title>gb hbm</title></head><body>"
            "<h1>HBM ledger</h1>"
            f"<p>devwatch {'enabled' if snap['enabled'] else 'DISABLED'}"
            f" &middot; ledger {snap['total_bytes'] >> 20} MB"
            f" &middot; {planes}</p>"
            "<table border=1><tr><th>collection</th><th>plane</th>"
            f"<th>column</th><th>bytes</th></tr>{rows}</table>"
            "<h2>memory_stats reconciliation</h2>"
            "<table border=1><tr><th>device</th><th>kind</th>"
            "<th>bytes_in_use</th><th>peak</th><th>headroom</th>"
            f"<th>fragmentation</th></tr>{dev_rows}</table>"
            "</body></html>"), "text/html"

    def _page_device(self, query: dict) -> tuple[int, str, str]:
        """Wave flight recorder + roofline attribution
        (OSSE_DEVWATCH=1): the recorder ring's issue→wait→collect
        waterfall with per-round escalations, and the per-(kernel,
        shape-bucket) flops/bytes verdicts against the card's peaks.
        ``?format=json`` returns the raw ring + cost table."""
        snap = devwatch.snapshot()
        body = {k: snap[k] for k in ("enabled", "totals", "waves",
                                     "rooflines", "peaks")}
        if query.get("format") == "json":
            return 200, json.dumps(body), "application/json"
        waves = list(snap["waves"])[-64:]
        scale = max((w["total_s"] for w in waves), default=0.0) or 1e-9

        def bar(w):
            return "".join(
                f'<div style="display:inline-block;height:10px;'
                f'width:{max(1, int(300 * w[f] / scale))}px;'
                f'background:{c}"></div>'
                for f, c in (("issue_s", "#4c78a8"),
                             ("wait_s", "#eeca3b"),
                             ("collect_s", "#e45756")))
        rows = "".join(
            f"<tr><td>{w['seq']}</td><td>{w['source']}</td>"
            f"<td>{w.get('coll', '')}</td>"
            f"<td>{w.get('plans', w.get('tickets', ''))}</td>"
            f"<td>{w['total_s'] * 1000:.1f}</td><td>{bar(w)}</td>"
            f"<td>{len(w['rounds'])}</td>"
            f"<td>{sum(r.get('escalations', 0) for r in w['rounds'])}"
            f"</td><td>{w['error'] or ''}</td></tr>"
            for w in reversed(waves)) \
            or "<tr><td colspan=9>none</td></tr>"
        roof = "".join(
            f"<tr><td>{e['kernel']}</td><td>{e['bucket']}</td>"
            f"<td>{e['flops']:.3g}</td><td>{e['bytes']:.3g}</td>"
            f"<td>{e['intensity']:.2f}</td><td>{e['ridge']:.2f}</td>"
            f"<td>{e['verdict']}</td>"
            f"<td>{e['modeled_bytes'] or ''}</td>"
            f"<td>{e['dispatches']}</td></tr>"
            for e in snap["rooflines"]) \
            or "<tr><td colspan=9>none</td></tr>"
        pk = snap["peaks"]
        return 200, (
            "<html><head><title>gb device</title></head><body>"
            "<h1>device plane</h1>"
            f"<p>devwatch {'enabled' if snap['enabled'] else 'DISABLED'}"
            f" &middot; waves {snap['totals']['waves']}"
            f" &middot; rounds {snap['totals']['rounds']}"
            f" &middot; errors {snap['totals']['wave_errors']}"
            f" &middot; peaks {pk['label']}"
            f" ({pk['flops']:.3g} FLOP/s, {pk['bw']:.3g} B/s"
            f"{', assumed' if pk['assumed'] else ''})</p>"
            "<h2>wave waterfall (issue / wait / collect)</h2>"
            "<table border=1><tr><th>seq</th><th>source</th>"
            "<th>coll</th><th>plans</th><th>ms</th><th>split</th>"
            "<th>rounds</th><th>escalations</th><th>error</th></tr>"
            f"{rows}</table>"
            "<h2>roofline per (kernel, shape bucket)</h2>"
            "<table border=1><tr><th>kernel</th><th>bucket</th>"
            "<th>flops</th><th>bytes</th><th>intensity</th>"
            "<th>ridge</th><th>verdict</th><th>modeled bytes</th>"
            f"<th>dispatches</th></tr>{roof}</table>"
            "</body></html>"), "text/html"

    def _page_profiler(self, query: dict) -> tuple[int, str, str]:
        """Per-stage timing table + on-demand SAMPLING profiler (the
        two halves of the Profiler.cpp role: the message-latency stats
        and the realtime stack sampler started/stopped from the admin
        page — ``startRealTimeProfiler``, ``Profiler.cpp:1586``).

        ``?sample=start|stop|reset`` controls the sampler;
        ``?sample=report`` (or format=json with the sampler running)
        returns the aggregated stack histogram."""
        action = query.get("sample", "")
        if action == "start":
            g_profiler.start()
            return 200, json.dumps({"sampling": True}), \
                "application/json"
        if action == "stop":
            g_profiler.stop()
            return 200, json.dumps(g_profiler.report()), \
                "application/json"
        if action == "reset":
            g_profiler.reset()
            return 200, json.dumps({"reset": True}), "application/json"
        if action == "report":
            return 200, json.dumps(g_profiler.report()), \
                "application/json"
        snap = g_stats.snapshot()
        if query.get("format") == "json":
            return 200, json.dumps(snap["latencies"]), "application/json"
        rows = "".join(
            f"<tr><td>{html_mod.escape(k)}</td><td>{v['count']}</td>"
            f"<td>{v['avg_ms']:.1f}</td><td>{v['p50_ms']:.1f}</td>"
            f"<td>{v['p99_ms']:.1f}</td><td>{v['max_ms']:.1f}</td></tr>"
            for k, v in sorted(snap["latencies"].items()))
        return 200, (
            "<html><head><title>profiler</title></head><body>"
            "<h1>stage timings (ms)</h1><table border=1>"
            "<tr><th>stage</th><th>n</th><th>avg</th><th>p50</th>"
            f"<th>p99</th><th>max</th></tr>{rows}</table>"
            "</body></html>"), "text/html"

    def _page_graph(self) -> str:
        """qps/latency time-series as inline SVG (PagePerf/Statsdb
        graphs without image deps)."""
        series = g_stats.series(last_s=3600)
        w, h = 600, 160
        if not series:
            return (f'<svg xmlns="http://www.w3.org/2000/svg" '
                    f'width="{w}" height="{h}"><text x="10" y="20">'
                    f"no samples yet</text></svg>")
        t0, t1 = series[0][0], series[-1][0]
        span = max(t1 - t0, 1.0)

        def poly(metric: str, color: str) -> str:
            pts = [(t, m.get(metric)) for t, m in series
                   if m.get(metric) is not None]
            if not pts:
                return ""
            top = max(v for _, v in pts) or 1.0
            xy = " ".join(
                f"{10 + (t - t0) / span * (w - 20):.1f},"
                f"{h - 20 - v / top * (h - 40):.1f}" for t, v in pts)
            return (f'<polyline fill="none" stroke="{color}" '
                    f'points="{xy}"/>'
                    f'<text x="12" y="{h - 6}" fill="{color}" '
                    f'font-size="10">{metric} (max {top:.1f})</text>')
        return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
                f'height="{h}" style="background:#fff">'
                + poly("qps", "#1f77b4") + poly("p50_ms", "#d62728")
                + "</svg>")

    # --- statsdb persistence (Statsdb.cpp sample ring) -------------------

    #: the statsdb sampler's tick, which also evaluates the SLOs, so the
    #: degrade signal the admission gate reads follows the traffic
    SLO_TICK_S = 10.0

    def _sample_loop(self) -> None:
        self._lines_written = 0
        last_q = self.stats["queries"]
        last_t = time.monotonic()
        while not self._stop_sampling.wait(self.SLO_TICK_S):
            now = time.monotonic()
            dq = self.stats["queries"] - last_q
            qps = dq / max(now - last_t, 1e-9)
            last_q, last_t = self.stats["queries"], now
            full = g_stats.snapshot()
            snap = full["latencies"].get("query.device_batch") or {}
            # guardrail counters ride the same sample ring so PagePerf
            # graphs budget pressure and check trips over time
            rejects = full["counters"].get("membudget.reject", 0)
            trips = full["counters"].get("devcheck.trip", 0)
            g_stats.sample(qps=round(qps, 2),
                           p50_ms=round(snap.get("p50_ms", 0.0), 1),
                           budget_rejects=rejects, check_trips=trips)
            # SLO tick: objectives consume the merged fleet stream on
            # a coordinator, the local registry otherwise; a scrape
            # failure costs one tick, never the sampler thread
            try:
                if g_slo.objectives:
                    if self.cluster is not None:
                        fl = self.cluster.scrape()["fleet"]
                        g_slo.evaluate(fl["counters"],
                                       fl["latencies"])
                    else:
                        g_slo.evaluate()
            except Exception:  # noqa: BLE001 — keep sampling
                log.exception("slo evaluation failed")
                g_stats.count("slo.eval_errors")
            try:
                with open(self._statsdb_path, "a",
                          encoding="utf-8") as fh:
                    fh.write(json.dumps(
                        [time.time(), {"qps": round(qps, 2),
                                       "budget_rejects": rejects,
                                       "check_trips": trips}]) + "\n")
                self._lines_written += 1
                if self._lines_written >= 512:  # it IS a ring: rotate
                    tail = self._statsdb_path.read_text(
                        encoding="utf-8").splitlines()[-2000:]
                    self._statsdb_path.write_text(
                        "\n".join(tail) + "\n", encoding="utf-8")
                    self._lines_written = 0
            except OSError:
                pass

    def _load_statsdb(self) -> None:
        if not self._statsdb_path.exists():
            return
        try:
            lines = self._statsdb_path.read_text(
                encoding="utf-8", errors="replace").splitlines()[-500:]
        except OSError:
            return
        # per-line tolerance: a kill-9 mid-append leaves ONE torn line;
        # it must cost one sample, not the whole ring
        for line in lines:
            if not line.strip():
                continue
            try:
                t, m = json.loads(line)
                g_stats.timeseries.append((float(t), m))
            except Exception:  # noqa: BLE001 — torn/corrupt line
                g_stats.count("statsdb.corrupt_lines")

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        # the traffic-plane objective, declared by default so every
        # server exports slo.query_p99.* (operators may declare richer
        # objectives before start())
        jitwatch.maybe_enable()
        devwatch.maybe_enable()  # OSSE_DEVWATCH=1 arms the hbm plane
        chaos_mod.maybe_enable()  # OSSE_CHAOS=<seed> arms the plane
        if not g_slo.objectives:
            g_slo.declare_latency(
                "query_p99",
                "cluster.query" if self.cluster is not None
                else "serve.search", threshold_ms=500.0, target=0.99)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: HTTP/1.0 (the default) closes the connection
            # after every response. Headers and body go out as two
            # writes, so Nagle is off, else the body would wait for the
            # peer's delayed ACK on every kept-alive request
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # route to our logger
                log.debug("%s " + fmt, self.client_address[0], *args)

            def _serve(self, method: str):
                parsed = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(parsed.query))
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                try:
                    nice = int(self.headers.get("X-Niceness") or 0)
                except ValueError:
                    nice = 0
                tier = priority_mod.tier_from_header(
                    self.headers.get(priority_mod.PRIORITY_HEADER))
                tenant = priority_mod.tenant_from_header(
                    self.headers.get(priority_mod.TENANT_HEADER))
                status, payload, ctype = outer.handle(
                    method, parsed.path, query, body,
                    client_ip=self.client_address[0], niceness=nice,
                    tier=tier, tenant=tenant)
                data = payload.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", ctype + "; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                # a shed 503 stashes Retry-After on the side channel
                # (handle() ran on this thread)
                for hname, hval in admission_mod.pop_response_headers():
                    self.send_header(hname, hval)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._serve("GET")

            def do_POST(self):
                self._serve("POST")

        self._httpd = NodeHTTPServer((self.host, self.port), Handler)
        # TLS (gb.pem role): wrap the listening socket when a cert is
        # configured; the handshake happens on first read, in the
        # connection's thread, so a stalled client cannot block accept
        cert = self.conf.ssl_cert or ""
        if cert:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, keyfile=self.conf.ssl_key or None)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
            log.info("TLS enabled (cert=%s)", cert)
        self.port = self._httpd.server_address[1]  # resolve port 0
        g_tracer.configure(host=f"{self.host}:{self.port}")
        self._thread = threads.spawn(f"httpd-{self.port}",
                                     self._httpd.serve_forever)
        if not self._batcher.alive:  # a stop()/start() cycle
            self._batcher = QueryBatcher(self._run_device_batch)
        self._load_statsdb()
        self._stop_sampling.clear()
        self._sampler = threads.spawn("statsdb", self._sample_loop)
        log.info("http server on %s:%d", self.host, self.port)

    def _page_hosts(self) -> str:
        """The shard map (``PageHosts.cpp``). On a cluster each node is
        pinged now: ``alive`` is who answered, ``docsPerShard`` the doc
        count of each shard's first answering twin (None when none
        did)."""
        if self.cluster is not None:
            from ..parallel.cluster import PING_TIMEOUT_S
            conf = self.cluster.conf
            pings = [[self.cluster.transport.probe(a, timeout=PING_TIMEOUT_S)
                      for a in conf.addresses[s]]
                     for s in range(conf.n_shards)]
            return json.dumps({
                "shards": conf.n_shards,
                "replicas": conf.n_replicas,
                "alive": [[p is not None for p in row] for row in pings],
                "docsPerShard": [next((p["docs"] for p in row
                                       if p is not None), None)
                                 for row in pings],
            })
        if self.sharded is None:
            return json.dumps({"shards": 1, "mode": "single"})
        hm = self.sharded.hostmap
        return json.dumps({
            "shards": hm.n_shards,
            "replicas": hm.n_replicas,
            "alive": hm.alive.tolist(),
            "docsPerShard": [c.num_docs for c in self.sharded.shards],
        })

    def stop(self) -> None:
        """Stop the batcher, park every resident tenant (their records
        survive, so a restart cold-starts cleanly), stop the mesh's
        serving loop and close the socket."""
        self._stop_sampling.set()
        self._batcher.stop()
        g_residency.stop_all()
        if self.sharded is not None:
            # respawned at the next mesh search
            mr = getattr(self.sharded, "_mesh_resident", None)
            if mr is not None:
                mr.stop()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in (self._thread, self._sampler):
            if t is not None:
                t.join(timeout=10)
        self._thread = self._sampler = None


def serve(base_dir, host: str = "127.0.0.1", port: int = 8000,
          device=None) -> SearchHTTPServer:
    """Construct and start a server (see :class:`SearchHTTPServer`)."""
    s = SearchHTTPServer(base_dir, host, port, device=device)
    s.start()
    return s

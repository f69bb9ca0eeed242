"""Search engine front end — query in, ranked page out (the flat path).

Reference: ``Msg40::getResults`` (``Msg40.cpp:171``) orchestrates
docid ranking then per-result title/summary. Two routes rank docids:

* the flat path (:func:`search`): compile → pack → score on the
  collection's device → titledb lookup;
* the device-resident route (:func:`search_device_batch`,
  :func:`search_device`): the collection's :class:`DeviceIndex` holds the
  postings on the device and answers a batch of queries per round trip.

Docid-range multipass (``Msg39.cpp:277-305``): when the candidate set
exceeds ``max_docs_per_pass``, the engine scores candidate slices and
merges the top-k across passes.

The device route serves through the collection's resident loop
(``search_device_batch(resident=True)``, owned by the tenant plane) and
rebuilds its base in the background after a dump
(:func:`get_device_index`). Compiled plans come from the cache plane
(:func:`_compile_cached`); a query that matches nothing carries the
speller's "did you mean" (:func:`_suggest`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from ..build import docproc
from ..cache import g_cacheplane
from ..index import clusterdb as cdb
from ..index import titledb
from ..index.collection import Collection
from ..utils import deadline as deadline_mod
from ..utils import threads as _threads
from ..utils import trace
from ..utils.log import get_logger
from ..utils.stats import g_stats
from . import summary as summary_mod
from .compiler import QueryPlan, compile_query
from .devindex import DeviceIndex, base_fingerprint
from .packer import pack_pass, prepare_query
from .rerank import post_query_rerank
from .scorer import run_query

log = get_logger("query")

#: site clustering: at most this many results per site (Msg51.h:96)
MAX_PER_SITE = 2

#: PostQueryRerank window: only the top PQR_SCAN merged results are
#: reranked (reference m_pqr_docsToScan), fixed by rank so pagination
#: stays consistent
PQR_SCAN = 48

#: facet counts come from the top FACET_SAMPLE matched docs
FACET_SAMPLE = 256

#: compiled-plan cache: compile_query is pure in (raw, lang) and a
#: QueryPlan is not changed after compile, so plans never invalidate: no
#: generation, just TTL/LRU bounds
_compiled_cache = g_cacheplane.register(
    "query.compiled", ttl_s=600.0, max_entries=4096,
    desc="compiled QueryPlans, pure in (raw, lang)")


def _compile_cached(q: str, lang: int) -> QueryPlan:
    ck = (q, lang)
    hit, plan = _compiled_cache.lookup(ck)
    if not hit:
        plan = compile_query(q, lang=lang)
        _compiled_cache.put(ck, plan)
    return plan


def _suggest(coll: Collection, plan: QueryPlan) -> str | None:
    """Zero-result fallback: the speller's "did you mean" over the
    query's scored words (Msg40's spell-check integration)."""
    words = [g.display for g in plan.scored_groups
             if " " not in g.display and ":" not in g.display]
    return coll.speller.suggest_query(words) if words else None


@dataclass
class Result:
    docid: int
    score: float
    url: str = ""
    title: str = ""
    snippet: str = ""
    site: str = ""


@dataclass
class SearchResults:
    query: str
    total_matches: int
    results: list[Result] = field(default_factory=list)
    clustered: int = 0  # results hidden by site clustering (Msg51)
    suggestion: str | None = None  # "did you mean" (Speller)
    #: gbfacet: results — field → [(value, count)]
    facets: dict = field(default_factory=dict)
    #: a whole shard (every twin) was down: its documents are missing
    #: from this answer
    degraded: bool = False
    #: scoring passes run (one min-score launch each), escalations
    #: included
    passes: int = 0
    #: device route: the posdb version the answering index was built at
    #: (behind the posdb while a background rebuild runs); None on the
    #: flat path, which reads the Rdbs as they are
    generation: int | None = None


def build_results(get_doc, docids, scores, plan: QueryPlan, *,
                  topk: int, with_snippets: bool = True,
                  site_cluster: bool = True,
                  dedup_content: bool = True, sitehashes=None,
                  page: tuple[int, int] | None = None
                  ) -> tuple[list[Result], int]:
    """One query's :func:`build_results_batch`."""
    return build_results_batch(
        get_doc, [(docids, scores)], [plan], topk=topk,
        with_snippets=with_snippets, site_cluster=site_cluster,
        dedup_content=dedup_content,
        sitehashes=None if sitehashes is None else [sitehashes],
        page=page)[0]


#: what the predicting walk reads in place of a record: present, with
#: no content hash (so never a duplicate) and no site
_ANY_RECORD = {"url": ""}


def build_results_batch(get_doc, rows, plans, *, topk: int,
                        with_snippets: bool = True,
                        site_cluster: bool = True,
                        dedup_content: bool = True, sitehashes=None,
                        page: tuple[int, int] | None = None,
                        prefetch=None) -> list[tuple[list[Result], int]]:
    """Msg40's post-merge stage for a batch of queries, ``rows`` =
    ``(docids, scores)`` each: walk each query's merged candidates
    best-first, fetch titlerecs, apply content-hash dedup and site
    clustering (at most MAX_PER_SITE per site), build summaries. Returns
    (results, number hidden by clustering/dedup) per query.

    ``sitehashes`` (per query, the clusterdb sitehash of each row)
    clusters before any titledb read. ``page`` = (offset, n): with
    ``sitehashes``, rows past the PQR_SCAN window and outside the page
    keep only docid and score (no titledb read; content dedup skips
    them). ``prefetch`` (docids → None), when given, is handed every
    docid the walks will read if no record is missing or a duplicate,
    before the first read: the batch's titlerecs in one lookup. The
    summaries of all the rows are built in one pass."""
    walks = []
    for qi, (docids, scores) in enumerate(rows):
        sh = None if sitehashes is None \
            else np.asarray(sitehashes[qi]).tolist()
        walks.append((np.asarray(docids).tolist(),
                      np.asarray(scores).tolist(), sh))
    if prefetch is not None:
        want: list[int] = []

        def predict(d):
            want.append(d)
            return _ANY_RECORD
        for docids, scores, sh in walks:
            _walk(predict, docids, scores, sh, topk=topk,
                  site_cluster=site_cluster, dedup_content=dedup_content,
                  page=page)
        prefetch(want)
    out = []
    snip: list[tuple[Result, dict, list[str]]] = []
    n_rows = 0
    for (docids, scores, sh), plan in zip(walks, plans):
        results, clustered, walked, recs = _walk(
            get_doc, docids, scores, sh, topk=topk,
            site_cluster=site_cluster, dedup_content=dedup_content,
            page=page)
        n_rows += walked
        for r, rec in recs:
            r.url = rec.get("url", "")
            r.title = summary_mod.choose_title(rec)
        if with_snippets:
            words = plan.match_words()
            snip += [(r, rec, words) for r, rec in recs]
        out.append((results, clustered))
    g_stats.count("page.rows", n_rows)
    _summarize(snip)
    return out


def _walk(get_doc, docids, scores, sh, *, topk, site_cluster,
          dedup_content, page):
    """One query's walk of :func:`build_results_batch`. Returns
    (results, clustered, rows walked, [(result, record)] of the results
    that read a record, whose URL and title the caller sets)."""
    per_site: dict = {}
    seen_hashes: set[int] = set()
    results: list[Result] = []
    recs: list[tuple[Result, dict]] = []
    clustered = 0
    walked = 0
    for i, (docid, score) in enumerate(zip(docids, scores)):
        if len(results) >= topk:
            break
        walked += 1
        if score <= 0.0:
            continue
        if site_cluster and sh is not None:
            if sh[i] and per_site.get(sh[i], 0) >= MAX_PER_SITE:
                clustered += 1
                continue
        rank = len(results)
        if (page is not None and sh is not None
                and rank >= PQR_SCAN
                and not (page[0] <= rank < page[0] + page[1])):
            if site_cluster and sh[i]:
                per_site[sh[i]] = per_site.get(sh[i], 0) + 1
            results.append(Result(docid=docid, score=score))
            continue
        rec = get_doc(docid)
        r = Result(docid=docid, score=score)
        if rec:
            r.site = rec.get("site", "")
            ch = rec.get("content_hash")
            if dedup_content and ch is not None:
                if ch in seen_hashes:
                    clustered += 1
                    continue
                seen_hashes.add(ch)
            if site_cluster and sh is not None:
                if sh[i]:
                    per_site[sh[i]] = per_site.get(sh[i], 0) + 1
            elif site_cluster and r.site:
                seen = per_site.get(r.site, 0)
                if seen >= MAX_PER_SITE:
                    clustered += 1
                    continue
                per_site[r.site] = seen + 1
            recs.append((r, rec))
        results.append(r)
    return results, clustered, walked, recs


def _summarize(rows) -> None:
    """Set each ``(result, record, query words)`` row's snippet, all the
    rows' summaries in one :func:`summary.make_summaries` pass."""
    if not rows:
        return
    snips = summary_mod.make_summaries(
        [(rec.get("text", ""), words, rec.get("meta_description", ""))
         for _, rec, words in rows])
    for (r, _, _), sn in zip(rows, snips):
        r.snippet = sn


def apply_pqr(results, conf=None, qlang: int = 0, langid_of=None) -> None:
    """PostQueryRerank over the top PQR_SCAN window (factors from the
    collection conf)."""
    if conf is not None and not conf.pqr_enabled:
        return
    kw = {}
    if conf is not None:
        kw = dict(lang_demote=conf.pqr_lang_demote,
                  site_demote=conf.pqr_site_demote,
                  depth_demote=conf.pqr_depth_demote)
    window = results[:PQR_SCAN]
    post_query_rerank(window, qlang, langid_of=langid_of, **kw)
    results[:PQR_SCAN] = window


def _coll_langid_of(coll: Collection):
    """Docid → langid via a clusterdb point read."""
    def f(docid: int) -> int:
        lst = coll.clusterdb.get_list(titledb.start_key(docid),
                                      titledb.end_key(docid))
        if not len(lst):
            return 0
        return int(cdb.unpack_key(lst.keys)["langid"][-1])
    return f


def finish_page(results, *, offset: int, topk: int, conf=None,
                qlang: int = 0, langid_of=None, get_doc=None,
                words=None, with_snippets: bool = True):
    """One query's :func:`finish_pages`."""
    return finish_pages([results], offset=offset, topk=topk, conf=conf,
                        qlangs=[qlang], langid_of=langid_of,
                        get_doc=get_doc, words=[words or []],
                        with_snippets=with_snippets)[0]


def finish_pages(results_list, *, offset: int, topk: int, conf=None,
                 qlangs, langid_of=None, get_doc=None, words,
                 with_snippets: bool = True):
    """The post-merge tail of a batch of queries: PQR over each one's
    fixed top window → slice the requested pages → summaries for the
    page rows only, all the batch's in one pass."""
    with trace.span("query.rerank"):
        for results, qlang in zip(results_list, qlangs):
            apply_pqr(results, conf, qlang, langid_of=langid_of)
    pages = [results[offset:offset + topk] for results in results_list]
    if with_snippets and get_doc is not None:
        with trace.span("query.summary", rows=sum(map(len, pages))):
            _summarize([(r, rec, w) for page, w in zip(pages, words)
                        for r in page if not r.snippet
                        for rec in (get_doc(int(r.docid)),) if rec])
    return pages


def compute_facets(plan: QueryPlan, docids, get_doc) -> dict:
    """field → [(value, count)] over a sample of matched docs."""
    if not plan.facets:
        return {}
    counters = {f: Counter() for f in plan.facets}
    for d in list(docids)[:FACET_SAMPLE]:
        flds = (get_doc(int(d)) or {}).get("fields") or {}
        for f in plan.facets:
            if f in flds:
                counters[f][flds[f]] += 1
    return {f: c.most_common(16) for f, c in counters.items()}


def search(coll: Collection, q: str | QueryPlan, *, topk: int = 10,
           lang: int = 0, max_docs_per_pass: int = 1 << 16,
           with_snippets: bool = True, site_cluster: bool = True,
           offset: int = 0) -> SearchResults:
    """Execute a query against one collection, scoring on
    ``coll.device``. ``offset`` = deep-paging start row."""
    plan = q if isinstance(q, QueryPlan) else _compile_cached(q, lang)

    def get_doc(d):
        return docproc.get_document(coll, docid=d)

    with trace.span("query.prepare", q=plan.raw):
        prep = prepare_query(coll, plan)
    # over-fetch + escalate: when site clustering leaves the page short,
    # re-score with a larger k (the Msg40 recall loop, Msg40.cpp:2117)
    want = max(topk + offset, PQR_SCAN)
    k = max(want, 64)
    passes = 0
    while True:
        all_docids: list[np.ndarray] = []
        all_scores: list[np.ndarray] = []
        total = 0
        doc_off = 0
        while doc_off < len(prep.cand):
            with trace.span("query.pack", doc_off=doc_off):
                pq = pack_pass(prep, doc_offset=doc_off,
                               max_docs=max_docs_per_pass,
                               budget_shrink=True)
            if pq is None:
                break
            with trace.span("query.score", n_docs=pq.n_docs):
                docids, scores, n_matched = run_query(pq, coll.device,
                                                      topk=k)
            passes += 1
            total += n_matched
            all_docids.append(docids)
            all_scores.append(scores)
            doc_off += pq.n_docs
        if not all_docids:
            return SearchResults(query=plan.raw, total_matches=0,
                                 passes=passes,
                                 suggestion=_suggest(coll, plan))
        docids = np.concatenate(all_docids)
        scores = np.concatenate(all_scores)
        order = np.argsort(-scores, kind="stable")
        with trace.span("query.results"):
            results, clustered = build_results(
                get_doc, docids[order], scores[order], plan, topk=want,
                with_snippets=False, site_cluster=site_cluster)
        if (len(results) >= want or clustered == 0
                or k >= len(prep.cand)):
            break
        k *= 4
    page = finish_page(
        results, offset=offset, topk=topk, conf=coll.conf,
        qlang=plan.lang, langid_of=_coll_langid_of(coll), get_doc=get_doc,
        words=plan.match_words(), with_snippets=with_snippets)
    return SearchResults(
        query=plan.raw, total_matches=total, results=page,
        clustered=clustered, passes=passes,
        suggestion=_suggest(coll, plan) if total == 0 else None,
        facets=compute_facets(plan, docids[order], get_doc))


# ---------------------------------------------------- device-resident route

#: guards the creation of each collection's device-index lock
_DI_CREATE_LOCK = threading.Lock()


def get_device_index(coll: Collection):
    """The collection's device-resident index, built at first use and
    refreshed when the posdb version moves.

    A memtable write refreshes the delta in this call (O(memtable)). A
    run-set move (a dump or a merge) rebuilds the base in a background
    thread against a fresh DeviceIndex while the old one keeps serving
    its pre-dump view, then swaps it in. The rebuild runs on a CUDA
    stream of its own, so that serving waves do not queue behind its
    sorts, and waits for that stream before the swap, so that no wave
    reads a half-built column. When the device cannot hold two resident
    sets (the reference's 16 GB budget: 2 · resident + 2 GiB > 14 GiB),
    the rebuild blocks instead. A rebuild that fails logs and leaves the
    old index serving."""
    lock = getattr(coll, "_di_lock", None)
    if lock is None:
        with _DI_CREATE_LOCK:
            lock = getattr(coll, "_di_lock", None)
            if lock is None:
                lock = coll._di_lock = threading.Lock()
    di = getattr(coll, "_device_index", None)
    if di is None:
        with lock:
            di = getattr(coll, "_device_index", None)
            if di is None:
                di = coll._device_index = build_device_index(coll)
        return di

    rdb = coll.posdb
    if rdb.version == di._built_version:
        return di
    if base_fingerprint(rdb.runs) == di._base_fp:
        with lock:  # concurrent searches must not both mutate it
            di.refresh()  # delta only: O(memtable)
        return di
    # the run set moved: a full rebuild. Old and new columns must both
    # fit while the swap is in flight.
    if 2 * di.resident_bytes() + (2 << 30) > (14 << 30):
        with lock:
            di.refresh()  # blocking rebuild: two sets would not fit
        return di
    with lock:
        if getattr(coll, "_di_rebuilding", False):
            return di  # a rebuild is in flight: serve the old view
        coll._di_rebuilding = True
        _threads.spawn("devindex-rebuild", _rebuild, coll, lock, di)
    return di


def _rebuild(coll: Collection, lock, old) -> None:
    """The background base rebuild (see :func:`get_device_index`). The
    fresh index replaces ``old`` only if ``old`` is still the current
    one: a tenant parked meanwhile stays parked."""
    try:
        t0 = time.perf_counter()
        if coll.device.type == "cuda":
            stream = torch.cuda.Stream(coll.device)
            with torch.cuda.stream(stream):
                fresh = build_device_index(coll)
            stream.synchronize()
        else:
            fresh = build_device_index(coll)
        with lock:
            if getattr(coll, "_device_index", None) is old:
                coll._device_index = fresh
        trace.record("devindex.rebuild", t0)
    except Exception:  # noqa: BLE001 — keep serving the old index
        log.exception("background device rebuild failed")
    finally:
        with lock:
            coll._di_rebuilding = False


def drop_device_index(coll: Collection) -> None:
    """Stop the collection's resident loop and drop its DeviceIndex, so
    that no wave reads columns built from runs a repair or a wipe is about
    to remove; the next search cold-starts a fresh index. A background
    rebuild in flight finds its old index gone and does not swap in."""
    from ..serve.tenancy import g_residency
    g_residency.release_collection(coll)
    loop = getattr(coll, "_resident_loop", None)
    if loop is not None:
        loop.stop()
        coll._resident_loop = None
    coll._device_index = None


def build_device_index(coll: Collection, device=None):
    """A fresh DeviceIndex over ``coll`` (on the collection's device
    unless ``device`` is given)."""
    return DeviceIndex(coll, device=device)


def spawn_resident_loop(di_fn, gen_fn, **kw):
    """A ResidentLoop over ``di_fn`` (see :mod:`.resident`)."""
    from .resident import ResidentLoop
    return ResidentLoop(di_fn, gen_fn=gen_fn, **kw)


def get_mesh_resident(sc):
    """The ShardedCollection's :class:`~..parallel.sharded.MeshResident`
    (one resident base per shard and the in-program merge under a
    ResidentLoop), created at first use like the flat device index.
    Imported here: ``parallel.sharded`` imports this module."""
    from ..parallel.sharded import MeshResident
    mr = getattr(sc, "_mesh_resident", None)
    if mr is not None:
        return mr
    with _DI_CREATE_LOCK:
        mr = getattr(sc, "_mesh_resident", None)
        if mr is None:
            mr = MeshResident(sc)
            sc._mesh_resident = mr
    return mr


def get_resident_loop(coll: Collection, deadline=None):
    """The collection's ResidentLoop, owned by the tenant plane's
    :class:`~..serve.tenancy.ResidencyManager` (LRU hot set, parked cold
    tenants, single-flight cold start)."""
    from ..serve.tenancy import g_residency
    return g_residency.loop_for(coll, deadline=deadline)


def search_device_batch(coll: Collection, queries, *, topk: int = 10,
                        lang: int = 0, with_snippets: bool = True,
                        site_cluster: bool = True, offset: int = 0,
                        resident: bool = False, results_lock=None
                        ) -> list[SearchResults]:
    """Batched device-resident search: the batch's queries are planned on
    the host and answered in waves on the collection's device, one fetch
    per round; then :func:`build_pages` builds the batch's pages, with
    clusterdb site clustering.

    ``resident=True`` hands the batch to the collection's ResidentLoop,
    which is already double-buffering waves, instead of issuing and
    waiting here. ``results_lock``, when given, is held only around the
    page build (titledb reads mutate rdblite state), never around the
    device wait."""
    plans = [q if isinstance(q, QueryPlan) else _compile_cached(q, lang)
             for q in queries]
    g_stats.count("query", len(plans))
    ktot = max((topk + offset) * 2, 64)
    if deadline_mod.check_abandon("device.dispatch"):
        # the deadline passed while this batch queued: abandon before
        # the device wave, not after it
        raise deadline_mod.DeadlineExceeded(
            "deadline exceeded before device dispatch")
    if resident:
        loop = get_resident_loop(coll, deadline=deadline_mod.current())
        with trace.timed_span("query.device_batch", queries=len(plans),
                              resident=True):
            ticket = loop.submit(plans, topk=ktot, lang=lang,
                                 deadline=deadline_mod.current())
            try:
                raw = ticket.wait()
                di = ticket.di  # the index the wave ran against
            finally:
                # a failed wave's error keeps this frame in its
                # traceback: with the ticket out of it, the ticket and
                # its index make no cycle with the error
                del ticket
    else:
        di = get_device_index(coll)
        with trace.timed_span("query.device_batch", queries=len(plans)):
            raw = di.search_batch(plans, topk=ktot, lang=lang)

    return build_pages(coll, di, plans, raw, topk=topk, offset=offset,
                       with_snippets=with_snippets,
                       site_cluster=site_cluster,
                       results_lock=results_lock)


def build_pages(coll: Collection, di, plans, raw, *, topk: int = 10,
                offset: int = 0, with_snippets: bool = True,
                site_cluster: bool = True, results_lock=None
                ) -> list[SearchResults]:
    """The page build of a device batch, ``raw`` = ``(docids, scores,
    n_matched)`` per plan from ``di``: the rows' sitehashes in one
    clusterdb-column search, the titlerecs the walks will read in one
    titledb lookup, then the walks, PQR and every page's summaries in
    one pass. ``results_lock``, when given, is held around it (titledb
    reads mutate rdblite state)."""
    # one titlerec memo for the whole batch: the rows the walks will
    # read come in one titledb lookup; a row that content dedup or a
    # missing record brings in past them is read on its own
    doc_memo: dict[int, dict | None] = {}
    n_reads = n_hits = n_fallback = 0

    def prefetch(docids):
        nonlocal n_reads, n_hits
        recs, read = docproc.get_documents(coll, docids)
        doc_memo.update(recs)
        n_reads += read
        n_hits += len(recs) - read

    def get_doc(d: int):
        nonlocal n_fallback
        d = int(d)
        if d not in doc_memo:
            n_fallback += 1
            doc_memo[d] = docproc.get_document(coll, docid=d)
        return doc_memo[d]

    lock_ctx = results_lock if results_lock is not None \
        else contextlib.nullcontext()
    t_res = time.perf_counter()
    with lock_ctx:
        rows = [(docids, scores) for docids, scores, _ in raw]
        sh = di.sitehashes_of(np.concatenate(
            [np.asarray(d, np.uint64) for d, _ in rows]
            or [np.empty(0, np.uint64)]))
        cuts = np.cumsum([len(d) for d, _ in rows])[:-1]
        built = build_results_batch(
            get_doc, rows, plans, topk=max(topk + offset, PQR_SCAN),
            with_snippets=False, site_cluster=site_cluster,
            sitehashes=np.split(sh, cuts), page=(offset, topk),
            prefetch=prefetch)
        pages = finish_pages(
            [results for results, _ in built], offset=offset, topk=topk,
            conf=coll.conf, qlangs=[plan.lang for plan in plans],
            langid_of=di.langid_of, get_doc=get_doc,
            words=[plan.match_words() for plan in plans],
            with_snippets=with_snippets)
        out = [SearchResults(
            query=plan.raw, total_matches=n_matched, results=page,
            clustered=clustered,
            suggestion=_suggest(coll, plan) if n_matched == 0 else None,
            facets=compute_facets(plan, docids, get_doc),
            generation=di._built_version)
            for plan, (docids, _, n_matched), (_, clustered), page
            in zip(plans, raw, built, pages)]
    trace.record("query.results_batch", t_res, queries=len(out))
    g_stats.count("page.doc_reads", n_reads)
    g_stats.count("page.doc_cache_hits", n_hits)
    g_stats.count("page.doc_fallback", n_fallback)
    return out


def search_device(coll: Collection, q, **kw) -> SearchResults:
    """One query through the device-resident route."""
    return search_device_batch(coll, [q], **kw)[0]

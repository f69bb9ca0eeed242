"""Document indexer — tokens → database records (the XmlDoc equivalent).

Reference: ``XmlDoc::indexDoc`` (``XmlDoc.cpp:2455``) → ``getMetaList``
(``XmlDoc.cpp:23825``) assembles every database's records for one
document: posdb postings via ``hashAll`` (``XmlDoc.cpp:28957``), the
compressed TitleRec (``XmlDoc.cpp:5385``), the clusterdb record, the
linkdb outlink edges and the fielddb numeric fields; deletion/reindex
regenerates the *old* document's meta list with tombstone keys.

Rank semantics (kept faithful so scoring matches):

* density rank = ``MAXDENSITYRANK - (alnum words in sentence - 1)``,
  clamped to ≥1; whole-group count for title/meta groups, per anchor for
  inlink text (``getDensityRanks``, ``XmlDoc.cpp:41733``).
* word spam rank: 15 = no spam; a repetition heuristic lowers it, and
  tokens of a section repeated across the site (sectiondb votes) are
  docked to ``BOILER_SPAMRANK``. Inlink anchor words carry the linker's
  siterank in this slot (``XmlDoc::hashIncomingLinkText``).
* diversity rank is stored as MAXDIVERSITYRANK (its weights are all 1.0).
* a content-checksum term sharded by termid is emitted for duplicate
  detection.

Tagdb gates indexing (a ``manualban`` drops the page, ``sitepathdepth``
moves the site boundary, ``siterank`` pins the site's rank); linkdb
feeds inlink anchor text into the linkee's postings and records this
page's outlinks; catdb adds the site's category fields; fielddb holds
the numeric fields, the built-in ``date`` among them.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..index import clusterdb, posdb, titledb
from ..index import fielddb as fielddb_mod
from ..index.collection import Collection
from ..index.sectiondb import BOILER_SPAMRANK, MIN_SECTION_WORDS
from ..spider import linkdb as linkdb_mod
from ..utils import ghash
from ..utils.lang import detect_language
from ..utils.log import get_logger
from ..utils.membudget import g_membudget
from ..utils.url import normalize
from .tokenizer import _WORD_RE, TokenizedDoc, tokenize_html, tokenize_text

log = get_logger("build")

CONTENT_HASH_PREFIX = "gbcontenthash"
SITE_PREFIX = "site"


@dataclass
class MetaList:
    """Everything one document contributes to the databases."""

    docid: int
    posdb_keys: np.ndarray
    titledb_key: np.ndarray
    title_rec: bytes
    clusterdb_key: np.ndarray
    langid: int
    site: str
    #: this page's section content hashes (sectiondb records) and the
    #: subset demoted as boilerplate at build time — both stored in the
    #: TitleRec so tombstones regenerate the exact same postings
    sections: list = field(default_factory=list)
    boiler_sections: list = field(default_factory=list)
    #: every extracted field (strings feed facets) with the resolved
    #: ``date``; the numeric subset becomes the fielddb records
    fields: dict = field(default_factory=dict)
    #: the page's words: the speller's popularity counts follow them
    words: list = field(default_factory=list)
    #: resolved outlink edges [(linkee Url, anchor)] and the linkee →
    #: site-boundary map frozen at build time (stored in the TitleRec, so
    #: the delete path tombstones the linkdb edges under the add's keys)
    edges: list = field(default_factory=list)
    edge_sites: dict = field(default_factory=dict)
    #: the page's raw outlinks [(href, anchor)] from the same tokenize
    #: pass (the spider queues them)
    links: list = field(default_factory=list)
    #: linkees whose anchor set this add or remove touched (the next
    #: propagation wave, read by :func:`refresh_linkees`)
    refresh_targets: list = field(default_factory=list)
    fielddb_keys: np.ndarray | None = None
    fielddb_blobs: list = field(default_factory=list)


def doc_section_hashes(tdoc: TokenizedDoc) -> dict[int, int]:
    """section id → 32-bit content hash of its words (sections under
    MIN_SECTION_WORDS words are skipped)."""
    nat = tdoc.native
    if nat is not None:
        return {int(p): ghash.hash64(c) & 0xFFFFFFFF
                for p, wc, c in zip(nat.sect_hash, nat.sect_words,
                                    nat.sect_content)
                if wc >= MIN_SECTION_WORDS}
    by_sid: dict[int, list[str]] = {}
    for sid, w in zip(tdoc.section_ids, tdoc.words):
        if sid:
            by_sid.setdefault(sid, []).append(w)
    return {sid: ghash.hash64(" ".join(ws)) & 0xFFFFFFFF
            for sid, ws in by_sid.items()
            if len(ws) >= MIN_SECTION_WORDS}


def _density_ranks(hashgroups: np.ndarray,
                   sentences: np.ndarray) -> np.ndarray:
    """Vectorized getDensityRanks: per-sentence word counts for body/
    heading/inlink text, whole-group counts for the rest."""
    n = len(hashgroups)
    out = np.empty(n, dtype=np.uint64)
    per_sentence = (hashgroups == posdb.HASHGROUP_BODY) | (
        hashgroups == posdb.HASHGROUP_HEADING) | (
        hashgroups == posdb.HASHGROUP_INLINKTEXT)
    if per_sentence.any():
        _, inv, counts = np.unique(sentences[per_sentence],
                                   return_inverse=True, return_counts=True)
        dr = posdb.MAXDENSITYRANK - (counts[inv] - 1)
        out[per_sentence] = np.clip(dr, 1, posdb.MAXDENSITYRANK)
    if (~per_sentence).any():
        _, inv, counts = np.unique(hashgroups[~per_sentence],
                                   return_inverse=True, return_counts=True)
        dr = posdb.MAXDENSITYRANK - (counts[inv] - 1)
        out[~per_sentence] = np.clip(dr, 1, posdb.MAXDENSITYRANK)
    return out


def _spam_ranks(words: list[str]) -> np.ndarray:
    """15 = clean. Words filling >12.5% of a ≥40-word doc get docked in
    proportion."""
    n = len(words)
    ranks = np.full(n, posdb.MAXWORDSPAMRANK, dtype=np.uint64)
    if n < 40:
        return ranks
    _, inv, counts = np.unique(np.asarray(words, dtype=object),
                               return_inverse=True, return_counts=True)
    frac = counts[inv] / n
    docked = np.maximum(
        2, (posdb.MAXWORDSPAMRANK * (1.0 - frac) * 0.8).astype(np.int64)
    ).astype(np.uint64)
    return np.where(frac > 0.125, docked, ranks)


def extract_fields(content: str) -> dict:
    """Structured document fields: a JSON document's scalars become
    fields (nested objects flatten with dots)."""
    import json as _json
    fields: dict = {}
    stripped = content.lstrip()
    if stripped.startswith("{"):
        try:
            obj = _json.loads(stripped)
        except ValueError:
            obj = None
        if isinstance(obj, dict):
            def flat(prefix, o):
                for k, v in o.items():
                    key = f"{prefix}{k}" if not prefix else \
                        f"{prefix}.{k}"
                    if isinstance(v, dict):
                        flat(key, v)
                    elif isinstance(v, (int, float, str)) \
                            and not isinstance(v, bool):
                        fields[key.lower()] = v
            flat("", obj)
    return fields


def _parse_date(val) -> float | None:
    """Best-effort document date → epoch seconds."""
    if isinstance(val, (int, float)):
        return float(val)
    if not isinstance(val, str) or not val:
        return None
    from datetime import datetime, timezone
    for fmt in ("%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d",
                "%Y/%m/%d"):
        try:
            dt = datetime.strptime(val[:19], fmt)
            return dt.replace(tzinfo=timezone.utc).timestamp()
        except ValueError:
            continue
    return None


def _tokenize_doc(content: str, url: str, is_html: bool) -> TokenizedDoc:
    """Structured (JSON) docs tokenize their string field values as the
    searchable text; everything else goes through the HTML/plain
    tokenizers."""
    jf = extract_fields(content)
    if jf:
        text = " . ".join(str(v) for v in jf.values()
                          if isinstance(v, str))
        if text:
            return tokenize_text(text)
    return (tokenize_html(content, url) if is_html
            else tokenize_text(content))


def build_meta_list(url: str, content: str, *, is_html: bool = True,
                    siterank: int = 0, langid: int | None = None,
                    delete: bool = False, ts: float | None = None,
                    inlinks: list | None = None, site: str | None = None,
                    site_resolver=None, linkee_sites: dict | None = None,
                    tdoc: TokenizedDoc | None = None,
                    boiler_sections: list | None = None,
                    sect_of: dict[int, int] | None = None,
                    fields: dict | None = None) -> MetaList:
    """Compute every record one document contributes. ``delete=True``
    produces the same records as tombstones.

    ``inlinks`` is the harvested [(anchor text, linker siterank)] list
    (Msg25 LinkInfo): each anchor's words become HASHGROUP_INLINKTEXT
    postings with the linker's siterank in the wordspamrank slot; the
    list is stored in the TitleRec so the delete path regenerates the
    same postings. ``site`` overrides the url's site boundary (tagdb
    ``sitepathdepth``); ``site_resolver`` (normally ``Tagdb.site_of``)
    freezes each outlink's site boundary into the TitleRec, and
    ``linkee_sites`` replays a stored map on the tombstone path."""
    u = normalize(url)
    site = site or u.site
    docid = ghash.doc_id(u.full)
    if fields is None:
        fields = extract_fields(content)
    if tdoc is None:
        tdoc = _tokenize_doc(content, u.full, is_html)
    edges = resolve_links(tdoc.links, u.full)
    if linkee_sites is None:
        resolver = site_resolver or (lambda lu: lu.site)
        linkee_sites = {lk.full: resolver(lk) for lk, _ in edges}
    if sect_of is None:
        sect_of = doc_section_hashes(tdoc)
    boiler = set(boiler_sections or [])
    nat = tdoc.native
    doc_words = list(tdoc.words)
    if langid is None:
        langid = detect_language(doc_words, text=tdoc.text)

    # inlink anchor tokens: each anchor is its own sentence in its own
    # position neighborhood (gaps > 50 so words of different anchors
    # never look adjacent to pair scoring)
    inlinks = [(t, int(sr)) for t, sr in (inlinks or []) if t]
    il_words: list[str] = []
    il_wp: list[int] = []
    il_sent: list[int] = []
    il_spam: list[int] = []
    il_den: list[int] = []
    if inlinks:
        pos0 = (max(tdoc.wordpos) if tdoc.wordpos else 0) + 100
        sent0 = (max(tdoc.sentence_ids) if tdoc.sentence_ids else 0) + 1
        for j, (text, linker_sr) in enumerate(inlinks):
            aw = [w.lower() for w in _WORD_RE.findall(text)][:64]
            dr = min(max(posdb.MAXDENSITYRANK - (len(aw) - 1), 1),
                     posdb.MAXDENSITYRANK)
            for i, w in enumerate(aw):
                il_words.append(w)
                il_wp.append(min(pos0 + i, posdb.MAXWORDPOS))
                il_sent.append(sent0 + j)
                il_spam.append(min(max(linker_sr, 0),
                                   posdb.MAXWORDSPAMRANK))
                il_den.append(dr)
            pos0 += len(aw) + 100
    words = doc_words + il_words

    def _cat(a, b):
        return np.concatenate([np.asarray(a, dtype=np.uint64),
                               np.asarray(b, dtype=np.uint64)])

    wordpos = _cat(tdoc.wordpos if nat is None else nat.wordpos, il_wp)
    hashgroups = _cat(tdoc.hashgroups if nat is None else nat.hashgroup,
                      [posdb.HASHGROUP_INLINKTEXT] * len(il_words))
    sentences = _cat(tdoc.sentence_ids if nat is None else nat.sentence,
                     il_sent)
    delbit = 0 if delete else 1
    site_tid = ghash.term_id(site, prefix=SITE_PREFIX)
    content_hash = ghash.hash64(tdoc.text or content)
    chk_tid = ghash.term_id(f"{content_hash:x}", prefix=CONTENT_HASH_PREFIX)

    if words:
        if nat is not None:
            # termids, density and spam of the document's and the url's
            # words come from the native columns; the inlink block takes
            # the same formulas per anchor
            termids = _cat(nat.termid, [ghash.term_id(w) for w in il_words])
            density = _cat(nat.density, il_den)
            doc_spam = nat.spam
        else:
            termids = np.array([ghash.term_id(w) for w in words],
                               dtype=np.uint64)
            density = _density_ranks(hashgroups, sentences)
            doc_spam = _spam_ranks(doc_words)
        if boiler:
            if nat is not None:
                bmask = np.isin(nat.sect, np.array(
                    [p for p, ch in sect_of.items() if ch in boiler],
                    dtype=np.uint64))
            else:
                bmask = np.array([sect_of.get(sid) in boiler
                                  for sid in tdoc.section_ids], dtype=bool)
            doc_spam = np.where(bmask, np.minimum(doc_spam, BOILER_SPAMRANK),
                                doc_spam)
        spam = _cat(doc_spam, il_spam)
        # bigrams: consecutive words within a sentence and hashgroup get
        # a combined term at the first word's position (Phrases.cpp);
        # none from url words or meta tags
        bi = np.empty(0, np.int64)
        bids = np.empty(0, np.uint64)
        if nat is not None:
            # the document's bigrams come from the columns; pairs within
            # one anchor follow by the same rule
            bi_parts = [nat.b_src]
            bid_parts = [nat.b_termid]
            if len(il_words) > 1:
                ils = np.array(il_sent)
                pair = np.nonzero(ils[1:] == ils[:-1])[0]
                bi_parts.append(pair + len(nat.termid))
                bid_parts.append(np.array(
                    [ghash.bigram_id(il_words[i], il_words[i + 1])
                     for i in pair], dtype=np.uint64))
            bi = np.concatenate(bi_parts).astype(np.int64)
            bids = np.concatenate(bid_parts).astype(np.uint64)
        elif len(words) > 1:
            same_sent = sentences[1:] == sentences[:-1]
            same_hg = hashgroups[1:] == hashgroups[:-1]
            phrasable = (hashgroups[:-1] != posdb.HASHGROUP_INURL) & (
                hashgroups[:-1] != posdb.HASHGROUP_INMETATAG)
            bi = np.nonzero(same_sent & same_hg & phrasable)[0]
            if len(bi):
                bids = np.array(
                    [ghash.bigram_id(words[i], words[i + 1]) for i in bi],
                    dtype=np.uint64)
        # ONE pack per document: word keys + bigram keys + the site: and
        # checksum extra terms
        two0 = np.zeros(2, np.uint64)
        sbt = np.zeros(len(termids) + len(bids) + 2, np.uint64)
        sbt[-1] = 1  # checksum term shards by termid
        posdb_keys = posdb.pack(
            termid=np.concatenate(
                [termids, bids, np.array([site_tid, chk_tid], np.uint64)]),
            docid=docid,
            wordpos=np.concatenate([wordpos, wordpos[bi], two0]),
            densityrank=np.concatenate([density, density[bi], two0]),
            wordspamrank=np.concatenate(
                [spam, spam[bi],
                 np.full(2, posdb.MAXWORDSPAMRANK, np.uint64)]),
            siterank=siterank,
            hashgroup=np.concatenate(
                [hashgroups, hashgroups[bi],
                 np.full(2, posdb.HASHGROUP_INURL, np.uint64)]),
            langid=langid, delbit=delbit, shardbytermid=sbt)
    else:
        posdb_keys = posdb.pack(
            termid=[site_tid, chk_tid], docid=docid, wordpos=0,
            siterank=siterank, langid=langid,
            hashgroup=posdb.HASHGROUP_INURL, delbit=delbit,
            shardbytermid=[0, 1])

    # the built-in date resolves ONCE and is stored in the titlerec, so
    # the tombstone path regenerates identical fielddb records
    fields = dict(fields)
    dv = _parse_date(fields.get("date"))
    if dv is None:
        dv = _parse_date(tdoc.meta_date or None)
    fields["date"] = dv if dv is not None else float(
        ts if ts is not None else time.time())
    fdb_keys, fdb_blobs = fielddb_mod.make_records(
        docid, {f: v for f, v in fields.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)},
        delbit=delbit)

    if delete:
        title_rec = b""
    else:
        # first heading run → the h1 title-fallback source
        h1 = ""
        hg = nat.hashgroup if nat is not None else np.asarray(
            tdoc.hashgroups, dtype=np.uint64)
        hidx = np.nonzero(hg == posdb.HASHGROUP_HEADING)[0]
        if len(hidx):
            a = int(hidx[0])
            k = 0  # length of the contiguous first run, capped at 16
            while k < min(len(hidx), 16) and int(hidx[k]) == a + k:
                k += 1
            h1 = " ".join(tdoc.words[a:a + k])
        title_rec = titledb.make_title_rec(
            url=u.full, title=tdoc.title.strip(), text=tdoc.text,
            links=tdoc.links, site=site, langid=langid, siterank=siterank,
            content_hash=content_hash,
            ts=ts if ts is not None else time.time(),
            extra={"content": content, "is_html": is_html, "h1": h1,
                   "meta_description": tdoc.meta_description,
                   "inlinks": [[t, sr] for t, sr in inlinks],
                   "linkee_sites": linkee_sites,
                   "sections": sorted(set(sect_of.values())),
                   "boiler_sections": sorted(boiler),
                   "fields": fields})
    sitehash = ghash.hash64(site) & ((1 << clusterdb.SITEHASH_BITS) - 1)
    return MetaList(
        docid=docid, posdb_keys=posdb_keys,
        titledb_key=titledb.pack_key(docid, titledb.urlhash32(u.full),
                                     delbit),
        title_rec=title_rec,
        clusterdb_key=clusterdb.pack_key(docid, sitehash, langid, 0,
                                         delbit),
        langid=langid, site=site,
        sections=sorted(set(sect_of.values())),
        boiler_sections=sorted(boiler), fields=fields, words=doc_words,
        edges=edges, edge_sites=linkee_sites, links=tdoc.links,
        fielddb_keys=fdb_keys, fielddb_blobs=fdb_blobs)


def absolutize(base: str, href: str) -> str | None:
    """Resolve an outlink href against its page URL (skip non-http)."""
    from urllib.parse import urldefrag, urljoin
    if href.startswith(("javascript:", "mailto:", "#")):
        return None
    absu = urldefrag(urljoin(base, href))[0] or None
    if absu and not absu.startswith(("http://", "https://")):
        return None
    return absu


def resolve_links(links: list[tuple[str, str]], linker_url: str):
    """Normalized (linkee Url, anchor) pairs for raw hrefs: the linkdb
    records the meta list carries."""
    out = []
    for href, anchor in links:
        try:
            absu = absolutize(linker_url, href)
            if not absu:
                continue
            linkee = normalize(absu)
        except ValueError:  # junk hrefs abound
            continue
        out.append((linkee, anchor))
    return out


def needs_link_refresh(fresh: list, stored: list) -> bool:
    """Should a linkee reindex to pick up its changed anchor set?
    Removals and changes always refresh; growth refreshes while the set
    is small (under 8), then on doublings, bounding hub-page reindexes
    to O(log inlinkers)."""
    if sorted(fresh) == sorted(stored):
        return False
    if len(fresh) <= len(stored):
        return True
    if len(stored) < 8:
        return True
    return len(fresh) >= 2 * len(stored)


#: bound on anchor-refresh cascades along link chains
MAX_REFRESH_DEPTH = 8


def refresh_linkees(linkees, own_site: str, *, get_doc, linkdb_of,
                    reindex, max_depth: int = MAX_REFRESH_DEPTH,
                    site_of=None) -> None:
    """For each external linkee already indexed, compare its stored
    inlink snapshot with a fresh harvest and reindex it when stale.

    Breadth first over a worklist with a visited set and a depth cap:
    ``reindex(linkee, rec)`` performs a non-propagating reindex and
    returns its ``MetaList`` (or None), whose ``refresh_targets`` are
    the next wave. A page is refreshed at most once per propagation."""
    site_of = site_of or (lambda u: u.site)
    seen: set[str] = set()
    work = deque((lk, own_site, 0) for lk in linkees)
    while work:
        linkee, src_site, depth = work.popleft()
        lk_site = site_of(linkee)
        if lk_site == src_site or linkee.full in seen:
            continue
        seen.add(linkee.full)
        rec = get_doc(linkee)
        if rec is None:
            continue
        fresh = linkdb_of(lk_site).inlinks_for_url(lk_site, linkee.full)
        stored = [tuple(x) for x in rec.get("inlinks") or []]
        if needs_link_refresh(fresh, stored):
            ml = reindex(linkee, rec)
            if ml is not None and depth + 1 < max_depth:
                work.extend((l2, linkee.site, depth + 1)
                            for l2 in ml.refresh_targets)


def _write(coll: Collection, metas: list[MetaList]) -> None:
    """One batched add per Rdb."""
    coll.posdb.add(np.concatenate([ml.posdb_keys for ml in metas]))
    coll.titledb.add(
        np.concatenate([ml.titledb_key.reshape(1) for ml in metas]),
        [ml.title_rec for ml in metas])
    coll.clusterdb.add(
        np.concatenate([ml.clusterdb_key.reshape(1) for ml in metas]))
    withf = [ml for ml in metas
             if ml.fielddb_keys is not None and len(ml.fielddb_keys)]
    if withf:
        coll.fielddb.add(np.concatenate([ml.fielddb_keys for ml in withf]),
                         [b for ml in withf for b in ml.fielddb_blobs])


def _write_shedding(coll: Collection, metas: list[MetaList]) -> None:
    """:func:`_write` under the process memory budget (``docproc``
    label): a chunk whose key images and titlerecs the budget refuses is
    written as two halves, so the memtables can dump between them. A
    refused single document still writes."""
    pending = [metas]
    while pending:
        chunk = pending.pop(0)
        est = (sum(int(ml.posdb_keys.nbytes) + len(ml.title_rec)
                   for ml in chunk)
               + 64 * len(chunk))  # the small keys (title, cluster, field)
        granted = g_membudget.reserve("docproc", est)
        try:
            if not granted and len(chunk) > 1:
                mid = len(chunk) // 2
                log.warning("index_batch: %d-doc write over the memory "
                            "budget, writing halves", len(chunk))
                pending[:0] = [chunk[:mid], chunk[mid:]]
                continue
            _write(coll, chunk)
        finally:
            if granted:
                g_membudget.release("docproc", est)


def _prepare(coll: Collection, u, site: str, content: str, is_html: bool):
    """Reads before writes: the inlink harvest, the fields (with the
    site's catdb fields), tokenizing and the boilerplate vote."""
    inlinks = coll.linkdb.inlinks_for_url(site, u.full)
    flds = extract_fields(content)
    flds.update(coll.catdb.doc_fields(site))
    tdoc = _tokenize_doc(content, u.full, is_html)
    sect_of = doc_section_hashes(tdoc)
    boiler = coll.sectiondb.boiler_set(site, sect_of.values())
    return inlinks, tdoc, sect_of, boiler, flds


def _record_edges(coll: Collection, ml: MetaList, site: str, url: str,
                  siterank: int) -> None:
    """This page's outlink edges with anchor text (its siterank rides
    each edge as the linker rank)."""
    for linkee, anchor in ml.edges:
        coll.linkdb.add_link(
            ml.edge_sites.get(linkee.full, linkee.site), site, url,
            linkee_url=linkee.full, anchor_text=anchor,
            linker_siterank=siterank)


def _propagate(coll: Collection, targets, site: str) -> None:
    refresh_linkees(
        targets, site,
        get_doc=lambda lk: get_document(coll, url=lk.full),
        linkdb_of=lambda _site: coll.linkdb,
        reindex=lambda lk, _rec: reindex_document(coll, lk.full,
                                                  propagate=False),
        site_of=coll.tagdb.site_of)


def index_document(coll: Collection, url: str, content: str, *,
                   is_html: bool = True, siterank: int = 0,
                   langid: int | None = None,
                   propagate: bool = True) -> MetaList | None:
    """Index (or re-index) one document (``XmlDoc::indexDoc``): tombstone
    the old version if present, harvest this URL's inlink anchor text,
    add the new records, record the outlink edges, and re-index every
    indexed linkee whose anchor set changed (the old version's linkees
    included).

    Tagdb gates the flow: a ``manualban`` on a containing site drops any
    indexed version and returns None; ``sitepathdepth`` widens the site
    boundary; ``siterank`` pins the site's rank."""
    u = normalize(url)
    banned, site, sr_override = coll.tagdb.index_gate(u)
    if banned:
        remove_document(coll, url, propagate=propagate)
        log.info("tagdb manualban: %s not indexed", url)
        return None
    if sr_override is not None:
        siterank = sr_override
    old = remove_document(coll, url, _count=False, propagate=False)
    inlinks, tdoc, sect_of, boiler, flds = _prepare(coll, u, site, content,
                                                     is_html)
    ml = build_meta_list(url, content, is_html=is_html, siterank=siterank,
                         langid=langid, inlinks=inlinks, site=site,
                         site_resolver=coll.tagdb.site_of, tdoc=tdoc,
                         boiler_sections=boiler, sect_of=sect_of,
                         fields=flds)
    _write(coll, [ml])
    coll.sectiondb.add_page_sections(site, u.full, ml.sections)
    coll.titlerec_cache.pop(ml.docid, None)
    if ml.words:
        coll.speller.add_doc_words(ml.words)
    if old is None:
        coll.doc_added()
    _record_edges(coll, ml, site, u.full, siterank)
    ml.refresh_targets = [e[0] for e in ml.edges]
    if old is not None:
        ml.refresh_targets += old.refresh_targets
    if propagate:
        _propagate(coll, ml.refresh_targets, site)
    log.debug("indexed %s docid=%d keys=%d inlinks=%d", url, ml.docid,
              len(ml.posdb_keys), len(inlinks))
    return ml


def index_batch(coll: Collection, docs, *, is_html: bool = True,
                siterank: int = 0, langid: int | None = None,
                propagate: bool = True) -> list[MetaList | None]:
    """Bulk indexing: the same records as N ``index_document`` calls,
    with the tagdb gates and reads first, then pure compute, then one
    batched Rdb add per database, then the linkdb edges and the
    propagation. Re-adds and within-batch duplicate URLs take the
    sequential path after the batch is written. Returns one MetaList
    (None for a banned page or a URL that does not parse) per input, in
    order."""
    out: list[MetaList | None] = [None] * len(docs)
    seen: set[str] = set()
    leftovers: list[tuple[int, str, str]] = []
    work = []  # (i, u, url, content, site, siterank)
    for i, (url, content) in enumerate(docs):
        try:
            u = normalize(url)
        except ValueError:
            continue
        banned, site, sr_override = coll.tagdb.index_gate(u)
        if banned:
            remove_document(coll, url, propagate=propagate)
            log.info("tagdb manualban: %s not indexed", url)
            continue
        if u.full in seen or get_document(coll, url=u.full) is not None:
            leftovers.append((i, url, content))
            continue
        seen.add(u.full)
        work.append((i, u, url, content, site,
                     siterank if sr_override is None else sr_override))
    reads = [_prepare(coll, u, site, content, is_html)
             for _, u, _, content, site, _ in work]
    metas = []
    for (i, u, url, content, site, sr), \
            (inlinks, tdoc, sect_of, boiler, flds) in zip(work, reads):
        ml = build_meta_list(url, content, is_html=is_html, siterank=sr,
                             langid=langid, inlinks=inlinks, site=site,
                             site_resolver=coll.tagdb.site_of, tdoc=tdoc,
                             boiler_sections=boiler, sect_of=sect_of,
                             fields=flds)
        metas.append(ml)
        out[i] = ml
    if metas:
        _write_shedding(coll, metas)
        coll.doc_added(len(metas))
        for (i, u, url, content, site, sr), ml in zip(work, metas):
            coll.sectiondb.add_page_sections(site, u.full, ml.sections)
            coll.titlerec_cache.pop(ml.docid, None)
            if ml.words:
                coll.speller.add_doc_words(ml.words)
            _record_edges(coll, ml, site, u.full, sr)
            ml.refresh_targets = [e[0] for e in ml.edges]
        if propagate:
            for (i, u, url, content, site, sr), ml in zip(work, metas):
                if ml.refresh_targets:
                    _propagate(coll, ml.refresh_targets, site)
    for i, url, content in leftovers:
        out[i] = index_document(coll, url, content, is_html=is_html,
                                siterank=siterank, langid=langid,
                                propagate=propagate)
    return out


def reindex_document(coll: Collection, url: str, *,
                     propagate: bool = True) -> MetaList | None:
    """Re-index a document from its stored content, with a fresh inlink
    harvest and a recomputed link-derived siterank."""
    rec = get_document(coll, url=url)
    if rec is None:
        return None
    return index_document(
        coll, url, rec.get("content", rec["text"]),
        is_html=rec.get("is_html", True),
        siterank=linkdb_mod.site_rank(coll.linkdb.site_num_inlinks(
            coll.tagdb.site_of(normalize(url)))),
        langid=rec.get("langid"), propagate=propagate)


def tombstone_meta_list(rec: dict) -> MetaList:
    """Regenerate a stored document's records as tombstones."""
    return build_meta_list(rec["url"], rec.get("content", rec["text"]),
                           is_html=rec.get("is_html", True),
                           siterank=rec.get("siterank", 0),
                           langid=rec.get("langid"), delete=True,
                           ts=rec.get("ts"),
                           inlinks=[tuple(x) for x in
                                    rec.get("inlinks") or []],
                           site=rec.get("site"),
                           linkee_sites=rec.get("linkee_sites"),
                           boiler_sections=rec.get("boiler_sections"),
                           fields=rec.get("fields"))


def remove_document(coll: Collection, url: str, _count: bool = True,
                    propagate: bool = True) -> MetaList | None:
    """Delete a document: regenerate its records from the stored TitleRec
    and add them as tombstones, tombstone its outlink edges, and refresh
    the linkees that lose its anchor. Returns the tombstone meta list, or
    None when the URL is not indexed."""
    u = normalize(url)
    docid = ghash.doc_id(u.full)
    existing = coll.titledb.get_list(titledb.start_key(docid),
                                     titledb.end_key(docid))
    # discriminate 38-bit docid collisions by the urlhash in the key
    want = titledb.urlhash32(u.full)
    match = np.nonzero(
        titledb.unpack_key(existing.keys)["urlhash32"] == np.uint64(want)
    )[0] if len(existing) else np.empty(0, dtype=np.int64)
    if not len(match):
        return None
    rec = titledb.read_title_rec(existing.payload(int(match[-1])))
    ml = tombstone_meta_list(rec)
    coll.posdb.add(ml.posdb_keys)
    coll.titledb.add(ml.titledb_key.reshape(1), [b""])
    coll.clusterdb.add(ml.clusterdb_key.reshape(1))
    if ml.fielddb_keys is not None and len(ml.fielddb_keys):
        coll.fielddb.add(ml.fielddb_keys, ml.fielddb_blobs)
    coll.sectiondb.remove_page_sections(ml.site, u.full,
                                        rec.get("sections") or [])
    coll.titlerec_cache.pop(ml.docid, None)
    # tombstone this page's outlink edges under the boundary frozen at
    # add time (records without the map fall back to tagdb)
    for linkee, _anchor in ml.edges:
        lk_site = ml.edge_sites.get(linkee.full) \
            or coll.tagdb.site_of(linkee)
        if lk_site == ml.site:
            continue
        coll.linkdb.rdb.delete(linkdb_mod.pack_key(
            lk_site, linkee.full, ml.site, u.full).reshape(1))
    if ml.words:
        coll.speller.remove_doc_words(ml.words)
    if _count:
        coll.doc_removed()
    ml.refresh_targets = [e[0] for e in ml.edges]
    if propagate:
        _propagate(coll, ml.refresh_targets, ml.site)
    return ml


def get_document(coll: Collection, url: str | None = None,
                 docid: int | None = None) -> dict | None:
    """TitleRec lookup by url or docid. By docid it is
    :func:`get_documents` of one, behind the collection's parsed titlerec
    cache; by url the docid's records are told apart by url hash."""
    if docid is not None:
        return get_documents(coll, [docid])[0][int(docid)]
    full = normalize(url).full
    docid = ghash.doc_id(full)
    lst = coll.titledb.get_list(titledb.start_key(docid),
                                titledb.end_key(docid))
    # docid-collision discrimination
    match = np.nonzero(titledb.unpack_key(lst.keys)["urlhash32"]
                       == np.uint64(titledb.urlhash32(full)))[0]
    if not len(match):
        return None
    payload = lst.payload(int(match[-1]))
    return titledb.read_title_rec(payload) if payload else None


def get_documents(coll: Collection, docids) -> tuple[dict, int]:
    """TitleRecs by docid: those in the collection's parsed titlerec
    cache from it, the others with one sorted titledb read
    (``Rdb.get_ranges``: one search of each run and memtable segment,
    the merge rules of ``get_list``), each docid's last record parsed
    once and put in the cache. Returns ({docid: record or None}, the
    number of docids read from titledb)."""
    cache = coll.titlerec_cache
    out: dict[int, dict | None] = {}
    miss = []
    for d in docids:
        d = int(d)
        if d in cache:
            out[d] = cache[d]
        else:
            miss.append(d)
    if not miss:
        return out, 0
    want = np.unique(np.array(miss, np.uint64))
    lst = coll.titledb.get_ranges(titledb.start_key(want),
                                  titledb.end_key(want))
    got = np.ascontiguousarray(lst.keys["n1"])
    # each docid's last record
    last = np.searchsorted(got, want, side="right") - 1
    for d, i in zip(want.tolist(), last.tolist()):
        rec = None
        if i >= 0 and int(got[i]) == d:
            payload = lst.payload(i)
            rec = titledb.read_title_rec(payload) if payload else None
        if len(cache) >= coll.titlerec_cache_max:
            cache.clear()
        cache[d] = rec
        out[d] = rec
    return out, len(want)

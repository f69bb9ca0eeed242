"""Document indexer — tokens → database records (the XmlDoc equivalent).

Reference: ``XmlDoc::indexDoc`` (``XmlDoc.cpp:2455``) → ``getMetaList``
(``XmlDoc.cpp:23825``) assembles every database's records for one
document: posdb postings via ``hashAll`` (``XmlDoc.cpp:28957``), the
compressed TitleRec (``XmlDoc.cpp:5385``) and the clusterdb record;
deletion/reindex regenerates the *old* document's meta list with
tombstone keys.

Rank semantics (kept faithful so scoring matches):

* density rank = ``MAXDENSITYRANK - (alnum words in sentence - 1)``,
  clamped to ≥1; whole-group count for title/meta groups
  (``getDensityRanks``, ``XmlDoc.cpp:41733``).
* word spam rank: 15 = no spam; a repetition heuristic lowers it, and
  tokens of a section repeated across the site (sectiondb votes) are
  docked to ``BOILER_SPAMRANK``.
* diversity rank is stored as MAXDIVERSITYRANK (its weights are all 1.0).
* a content-checksum term sharded by termid is emitted for duplicate
  detection.

This copy has no tagdb (the site comes from the URL, no siterank
override), no linkdb (no inlink anchor postings, no outlink edges), and
no catdb or fielddb records. Structured (JSON) documents still index
their string fields as text, and every field is kept in the TitleRec.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..index import clusterdb, posdb, titledb
from ..index.collection import Collection
from ..index.sectiondb import BOILER_SPAMRANK, MIN_SECTION_WORDS
from ..utils import ghash
from ..utils.lang import detect_language
from ..utils.log import get_logger
from ..utils.url import normalize
from .tokenizer import TokenizedDoc, tokenize_html, tokenize_text

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
    fields: dict = field(default_factory=dict)
    #: the page's words: the speller's popularity counts follow them
    words: list = field(default_factory=list)


def doc_section_hashes(tdoc: TokenizedDoc) -> dict[int, int]:
    """section id → 32-bit content hash of its words (sections under
    MIN_SECTION_WORDS words are skipped)."""
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
                    tdoc: TokenizedDoc | None = None,
                    boiler_sections: list | None = None,
                    sect_of: dict[int, int] | None = None,
                    fields: dict | None = None) -> MetaList:
    """Compute every record one document contributes. ``delete=True``
    produces the same records as tombstones."""
    u = normalize(url)
    site = u.site
    docid = ghash.doc_id(u.full)
    if fields is None:
        fields = extract_fields(content)
    if tdoc is None:
        tdoc = _tokenize_doc(content, u.full, is_html)
    if sect_of is None:
        sect_of = doc_section_hashes(tdoc)
    boiler = set(boiler_sections or [])
    words = list(tdoc.words)
    if langid is None:
        langid = detect_language(words, text=tdoc.text)
    wordpos = np.asarray(tdoc.wordpos, dtype=np.uint64)
    hashgroups = np.asarray(tdoc.hashgroups, dtype=np.uint64)
    sentences = np.asarray(tdoc.sentence_ids, dtype=np.uint64)
    delbit = 0 if delete else 1
    site_tid = ghash.term_id(site, prefix=SITE_PREFIX)
    content_hash = ghash.hash64(tdoc.text or content)
    chk_tid = ghash.term_id(f"{content_hash:x}", prefix=CONTENT_HASH_PREFIX)

    if words:
        termids = np.array([ghash.term_id(w) for w in words],
                           dtype=np.uint64)
        density = _density_ranks(hashgroups, sentences)
        spam = _spam_ranks(words)
        if boiler:
            bmask = np.array([sect_of.get(sid) in boiler
                              for sid in tdoc.section_ids], dtype=bool)
            spam = np.where(bmask, np.minimum(spam, BOILER_SPAMRANK), spam)
        # bigrams: consecutive words within a sentence and hashgroup get
        # a combined term at the first word's position (Phrases.cpp);
        # none from url words or meta tags
        bi = np.empty(0, np.int64)
        bids = np.empty(0, np.uint64)
        if len(words) > 1:
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
    # the tombstone path regenerates identical records
    fields = dict(fields)
    dv = _parse_date(fields.get("date"))
    if dv is None:
        dv = _parse_date(tdoc.meta_date or None)
    fields["date"] = dv if dv is not None else float(
        ts if ts is not None else time.time())

    if delete:
        title_rec = b""
    else:
        # first heading run → the h1 title-fallback source
        h1 = ""
        hidx = np.nonzero(hashgroups == posdb.HASHGROUP_HEADING)[0]
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
                   "inlinks": [],
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
        boiler_sections=sorted(boiler), fields=fields,
        words=list(tdoc.words))


def _write(coll: Collection, metas: list[MetaList]) -> None:
    """One batched add per Rdb, then the per-doc bookkeeping."""
    coll.posdb.add(np.concatenate([ml.posdb_keys for ml in metas]))
    coll.titledb.add(
        np.concatenate([ml.titledb_key.reshape(1) for ml in metas]),
        [ml.title_rec for ml in metas])
    coll.clusterdb.add(
        np.concatenate([ml.clusterdb_key.reshape(1) for ml in metas]))


def _prepare(coll: Collection, url: str, content: str, is_html: bool):
    """Reads before writes: tokenize, then the boilerplate vote."""
    u = normalize(url)
    tdoc = _tokenize_doc(content, u.full, is_html)
    sect_of = doc_section_hashes(tdoc)
    boiler = coll.sectiondb.boiler_set(u.site, sect_of.values())
    return u, tdoc, sect_of, boiler


def index_document(coll: Collection, url: str, content: str, *,
                   is_html: bool = True, siterank: int = 0,
                   langid: int | None = None) -> MetaList:
    """Index (or re-index) one document: tombstone the old version if
    present, then add the new records (``XmlDoc::indexDoc``)."""
    old = remove_document(coll, url, _count=False)
    u, tdoc, sect_of, boiler = _prepare(coll, url, content, is_html)
    ml = build_meta_list(url, content, is_html=is_html, siterank=siterank,
                         langid=langid, tdoc=tdoc, boiler_sections=boiler,
                         sect_of=sect_of)
    _write(coll, [ml])
    coll.sectiondb.add_page_sections(ml.site, u.full, ml.sections)
    coll.titlerec_cache.pop(ml.docid, None)
    if ml.words:
        coll.speller.add_doc_words(ml.words)
    if old is None:
        coll.doc_added()
    log.debug("indexed %s docid=%d keys=%d", url, ml.docid,
              len(ml.posdb_keys))
    return ml


def index_batch(coll: Collection, docs, *, is_html: bool = True,
                siterank: int = 0, langid: int | None = None
                ) -> list[MetaList | None]:
    """Bulk indexing: the same records as N ``index_document`` calls,
    with reads first, then pure compute, then one batched Rdb add per
    database. Re-adds and within-batch duplicate URLs take the
    sequential path after the batch is written. Returns one MetaList
    (None for a URL that does not parse) per input, in order."""
    out: list[MetaList | None] = [None] * len(docs)
    seen: set[str] = set()
    leftovers: list[tuple[int, str, str]] = []
    work = []
    for i, (url, content) in enumerate(docs):
        try:
            full = normalize(url).full
        except ValueError:
            continue
        if full in seen or get_document(coll, url=full) is not None:
            leftovers.append((i, url, content))
            continue
        seen.add(full)
        work.append((i, url, content,
                     _prepare(coll, url, content, is_html)))
    metas = []
    for i, url, content, (u, tdoc, sect_of, boiler) in work:
        ml = build_meta_list(url, content, is_html=is_html,
                             siterank=siterank, langid=langid, tdoc=tdoc,
                             boiler_sections=boiler, sect_of=sect_of)
        metas.append(ml)
        out[i] = ml
    if metas:
        _write(coll, metas)
        for (i, url, content, (u, *_)), ml in zip(work, metas):
            coll.sectiondb.add_page_sections(ml.site, u.full, ml.sections)
            coll.titlerec_cache.pop(ml.docid, None)
            if ml.words:
                coll.speller.add_doc_words(ml.words)
            coll.doc_added()
    for i, url, content in leftovers:
        out[i] = index_document(coll, url, content, is_html=is_html,
                                siterank=siterank, langid=langid)
    return out


def tombstone_meta_list(rec: dict) -> MetaList:
    """Regenerate a stored document's records as tombstones."""
    return build_meta_list(rec["url"], rec.get("content", rec["text"]),
                           is_html=rec.get("is_html", True),
                           siterank=rec.get("siterank", 0),
                           langid=rec.get("langid"), delete=True,
                           ts=rec.get("ts"),
                           boiler_sections=rec.get("boiler_sections"),
                           fields=rec.get("fields"))


def remove_document(coll: Collection, url: str,
                    _count: bool = True) -> MetaList | None:
    """Delete a document: regenerate its records from the stored TitleRec
    and add them as tombstones. Returns the tombstone meta list, or None
    when the URL is not indexed."""
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
    coll.sectiondb.remove_page_sections(ml.site, u.full,
                                        rec.get("sections") or [])
    coll.titlerec_cache.pop(ml.docid, None)
    if ml.words:
        coll.speller.remove_doc_words(ml.words)
    if _count:
        coll.doc_removed()
    return ml


def get_document(coll: Collection, url: str | None = None,
                 docid: int | None = None) -> dict | None:
    """TitleRec lookup by url or docid, behind the collection's parsed
    titlerec cache (docid lookups only)."""
    want = None
    if docid is None:
        assert url is not None
        full = normalize(url).full
        docid = ghash.doc_id(full)
        want = titledb.urlhash32(full)
    elif docid in coll.titlerec_cache:
        return coll.titlerec_cache[docid]
    lst = coll.titledb.get_list(titledb.start_key(docid),
                                titledb.end_key(docid))
    rec = None
    if len(lst):
        idx = len(lst) - 1
        if want is not None:  # docid-collision discrimination
            match = np.nonzero(
                titledb.unpack_key(lst.keys)["urlhash32"]
                == np.uint64(want))[0]
            idx = int(match[-1]) if len(match) else -1
        if idx >= 0:
            payload = lst.payload(idx)
            rec = titledb.read_title_rec(payload) if payload else None
    if want is None:
        if len(coll.titlerec_cache) >= coll.titlerec_cache_max:
            coll.titlerec_cache.clear()
        coll.titlerec_cache[docid] = rec
    return rec

"""The port's batched page build against the JAX package's row-by-row
walk, on the CPU.

``engine.build_pages`` resolves a device batch's rows at once: their
clusterdb sitehashes in one search, the titlerecs the walks will read in
one sorted titledb lookup (``docproc.get_documents`` over
``Rdb.get_ranges``), and every page row's summary in one
``summary.make_summaries`` pass. Each case hands the same rows to it and
to the JAX package's ``engine.build_results`` + ``finish_page`` (its
``get_document`` a titledb read per row, its sitehash and langid the
JAX collection's own clusterdb), and the two must agree on the rows and
their order, ``clustered``, and every title, URL, site and summary.

The rows are the port's device index's answers to random batches of
1-3 word and long queries, and the same rows shuffled with foreign and
zero-score rows among them; with and without summaries, at offsets 0 and
10, with the post-query rerank on and off. The pages hold copies of
other pages (content dedup), pages whose only match is in the title
(the summary's fallbacks, with and without a meta description) and
non-ASCII text. Both packages index the same pages under one fixed
clock, into two titledb runs and the memtable; the ``written`` cases run
after inject, re-inject and delete writes that sit in the memtable over
those runs, so that the batched read's newest-wins and tombstone rules
are held to ``get_list``'s.

The summary cases hold ``make_summaries`` (over a whole batch, and a row
alone) to the JAX package's ``make_summary`` byte for byte on hand-made
texts.

The module keeps the collector off (``tests/jax_gc.quiet()``), as the
port's other test files that build JAX-package collections do.
"""

from __future__ import annotations

import json
import random
import types
import zlib

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index import clusterdb as jclusterdb
from open_source_search_engine_tpu.index import titledb as jtitledb
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu.query import summary as jsummary
from open_source_search_engine_tpu.query.compiler import \
    compile_query as jcompile
from open_source_search_engine_tpu_torch import native
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import gen_docs, make_queries
from open_source_search_engine_tpu_torch.index import titledb
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine, summary
from open_source_search_engine_tpu_torch.query.compiler import compile_query
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex
from open_source_search_engine_tpu_torch.utils import ghash
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from open_source_search_engine_tpu_torch.utils.url import normalize
from tests import jax_gc

torch.set_num_threads(1)

N_DOCS = 2400
#: pages indexed before each of the two titledb dumps, then the rest
#: stays in the memtable
DUMPS = (1000, 2000)
N_DUPES = 60
N_TITLED = 24

NON_ASCII = ("Η ΟΔΟΣ ΤΟΥ ΣΟΦΟΣ έργο ἀρχή. Straße İstanbul café naïve "
             "Ærø x_1 42abc foo_bar9. Übermäßig ÇAĞ ΣΙΣΥΦΟΣ δρόμος")


#: (page, its copy) URLs
_COPIES: list[tuple[str, str]] = []


def _docid(url: str) -> int:
    return ghash.doc_id(normalize(url).full)


def _pages():
    """The base pages, copies of some of them on other sites, and pages
    matched by a title word that their body lacks (half with a meta
    description that holds it)."""
    docs = list(gen_docs(N_DOCS))
    _COPIES.clear()
    rng = random.Random(5)
    for k in range(N_DUPES):
        url, html = docs[rng.randrange(N_DOCS)]
        docs.append((f"http://copy{k % 7}.dupes.test/page{k}", html))
        _COPIES.append((url, docs[-1][0]))
    for k in range(N_TITLED):
        desc = (f'<meta name="description" content="All about zeta{k} '
                f'and {NON_ASCII[:20]}.">' if k % 2 else "")
        docs.append((
            f"http://titled{k % 5}.zeta.test/z{k}",
            f"<html><head><title>zeta{k} ΟΔΟΣ notes</title>{desc}</head>"
            f"<body><p>{NON_ASCII}. word{k} word{k + 1} word0 word3. "
            f"Closing line of page {k}.</p></body></html>"))
    rng.shuffle(docs)
    return docs


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    with jax_gc.quiet():
        yield


@pytest.fixture(scope="module")
def fixed_clock():
    """Both indexers stamp a page's titlerec and its default date with
    the wall clock: one fixed clock makes their records byte-equal."""
    import time
    clock = types.SimpleNamespace(time=lambda: 1.7e9,
                                  strptime=time.strptime)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(docproc, "time", clock)
        mp.setattr(jdocproc, "time", clock)
        yield


def _index_pair(base, docs):
    """The same pages into a port and a JAX collection: two titledb runs
    and the memtable."""
    tc = Collection("pb", base / "torch", device="cpu")
    jc = JCollection("pb", base / "jax")
    lo = 0
    for hi in DUMPS + (len(docs),):
        for c, dp in ((tc, docproc), (jc, jdocproc)):
            for i in range(lo, hi, 250):
                dp.index_batch(c, docs[i:min(i + 250, hi)])
            if hi != len(docs):
                c.dump_all()
        lo = hi
    assert len(tc.titledb.runs) == len(jc.titledb.runs) == 2
    assert len(tc.titledb.mem) > 0
    return tc, jc


def _write(tc, jc, docs):
    """Inject, re-inject (new text at a URL that sits in a run) and
    delete (pages of both runs and of the memtable), in both packages:
    the records and tombstones sit in the memtable."""
    rng = random.Random(9)
    gone = [docs[i][0] for i in rng.sample(range(len(docs)), 40)]
    changed = [docs[i] for i in rng.sample(range(DUMPS[1]), 30)
               if docs[i][0] not in gone]
    fresh = [(f"http://fresh{k % 3}.new.test/n{k}",
              docs[rng.randrange(len(docs))][1].replace("word1 ", "word7 "))
             for k in range(30)]
    # a second titlerec under a few docids (another url hash, as a
    # docid collision leaves): a read takes the docid's last record
    twins = [(_docid(docs[i][0]), rng.randrange(1 << 31))
             for i in rng.sample(range(len(docs)), 6)
             if docs[i][0] not in gone]
    for c, tdb in ((tc, titledb), (jc, jtitledb)):
        for d, h in twins:
            lst = c.titledb.get_list(tdb.start_key(d), tdb.end_key(d))
            if len(lst):
                rec = dict(tdb.read_title_rec(lst.payload(len(lst) - 1)),
                           title=f"twin of {d}")
                c.titledb.add(tdb.pack_key(d, h).reshape(1),
                              [zlib.compress(json.dumps(rec).encode())])
    for c, dp in ((tc, docproc), (jc, jdocproc)):
        for url, html in changed:
            dp.index_document(c, url, html.replace("</p>", " word9 "
                                                   "revised.</p>"))
        for url, html in fresh:
            dp.index_document(c, url, html)
        for url in gone:
            dp.remove_document(c, url)
    return gone


def _state(base, written):
    docs = _pages()
    tc, jc = _index_pair(base, docs)
    gone = _write(tc, jc, docs) if written else []
    di = DeviceIndex(tc, device="cpu")
    cl = jc.clusterdb.get_all()
    f = jclusterdb.unpack_key(cl.keys)
    return types.SimpleNamespace(
        tc=tc, jc=jc, di=di, docs=docs, gone=gone,
        site={int(d): int(s) for d, s in zip(f["docid"], f["sitehash"])},
        lang={int(d): int(g) for d, g in zip(f["docid"], f["langid"])},
        titled=[f"zeta{k}" for k in range(N_TITLED)], rows={},
        copies=[(_docid(a), _docid(b)) for a, b in _COPIES
                if a not in gone and b not in gone])


@pytest.fixture(scope="module")
def clean(tmp_path_factory, fixed_clock):
    return _state(tmp_path_factory.mktemp("pb_clean"), written=False)


@pytest.fixture(scope="module")
def written(tmp_path_factory, fixed_clock):
    return _state(tmp_path_factory.mktemp("pb_written"), written=True)


def _long_queries(st, rng, n):
    """9-16 words of a random page's body."""
    out = []
    for _ in range(n):
        _, html = st.docs[rng.randrange(len(st.docs))]
        body = html.split("<body><p>", 1)[1].split("</p>", 1)[0]
        words = body.replace(".", " ").split()
        k = rng.randint(9, 16)
        at = rng.randrange(max(1, len(words) - k))
        out.append(" ".join(words[at:at + k]))
    return out


def _device_rows(st, kind):
    """Random batches of 1-8 queries and the port's device index's rows
    for each, once per state. A long query takes the rows of a query of
    three of its words: the pages that hold them, which its summary
    then reads (a query of 9-16 words takes F1 at T = 16, whose plain
    version runs for minutes on the CPU)."""
    if kind in st.rows:
        return st.rows[kind]
    rng = random.Random(11)
    if kind == "short":
        qs = make_queries(30, seed=11) + rng.sample(st.titled, 6)
        rng.shuffle(qs)
    else:
        qs = _long_queries(st, rng, 12)
    out = []
    while qs:
        k = rng.randint(1, 8)
        batch, qs = qs[:k], qs[k:]
        ranked = batch if kind == "short" else \
            [" ".join(q.split()[:3]) for q in batch]
        out.append((batch, st.di.search_batch(
            [compile_query(q, lang=0) for q in ranked], topk=64)))
    st.rows[kind] = out
    return out


def _shuffled(raw, st, rng):
    """The same rows in another order, with rows of other queries, rows
    of deleted and unknown docids and zero scores among them, scores
    sorted down again, and a page and its copy first: the copy is
    deduped, so the walk reads one row past the predicted ones."""
    every = np.concatenate([d for d, _, _ in raw] or [np.zeros(0)])
    known = np.array(list(st.site), np.uint64)
    out = []
    for docids, scores, n in raw:
        extra = [rng.choice(every.tolist()) for _ in range(8)] if \
            len(every) else []
        extra += [int(x) for x in rng.sample(known.tolist(), 24)]
        extra += [_docid(u) for u in st.gone[:4]]
        extra += [(1 << 37) + rng.randrange(1000)]
        d = np.array(list(docids) + extra, np.uint64)
        d = d[np.array(rng.sample(range(len(d)), len(d)))]
        # one docid once: the device never returns a docid twice
        _, first = np.unique(d, return_index=True)
        d = d[np.sort(first)]
        s = np.array([rng.choice((0.0, rng.uniform(0.1, 9.0)))
                      if rng.random() < 0.1 else rng.uniform(0.1, 9.0)
                      for _ in d], np.float32)
        order = np.argsort(-s, kind="stable")
        a, b = st.copies[rng.randrange(len(st.copies))]
        keep = (d[order] != a) & (d[order] != b)
        out.append((np.concatenate([np.array([a, b], np.uint64),
                                    d[order][keep]]),
                    np.concatenate([np.array([10.0, 9.5], np.float32),
                                    s[order][keep]]), n))
    return out


def _reference(st, queries, raw, *, topk, offset, with_snippets,
               site_cluster=True):
    """The JAX package's walk over the same rows, one row at a time."""
    jc = st.jc

    def get_doc(d):
        return jdocproc.get_document(jc, docid=int(d))
    out = []
    for q, (docids, scores, n) in zip(queries, raw):
        plan = jcompile(q, lang=0)
        results, clustered = jengine.build_results(
            get_doc, docids, scores, plan,
            topk=max(topk + offset, jengine.PQR_SCAN), with_snippets=False,
            site_cluster=site_cluster,
            site_of=lambda d: st.site.get(int(d), 0),
            page=(offset, topk))
        page = jengine.finish_page(
            results, offset=offset, topk=topk, conf=jc.conf,
            qlang=plan.lang, langid_of=lambda d: st.lang.get(int(d), 0),
            get_doc=get_doc, words=plan.match_words(),
            with_snippets=with_snippets)
        out.append((n, clustered, _rows(page)))
    return out


def _rows(page):
    return [(int(r.docid), float(r.score), r.url, r.title, r.site,
             r.snippet) for r in page]


def _check(st, kind, rows, *, offset, with_snippets, pqr, seed):
    st.tc.conf.pqr_enabled = st.jc.conf.pqr_enabled = pqr
    rng = random.Random(seed)
    counts = {}
    for queries, raw in _device_rows(st, kind):
        plans = [compile_query(q, lang=0) for q in queries]
        if rows == "shuffled":
            raw = _shuffled(raw, st, rng)
        st.tc.titlerec_cache.clear()
        before = dict(g_stats.snapshot()["counters"])
        got = engine.build_pages(st.tc, st.di, plans, raw, topk=10,
                                 offset=offset, with_snippets=with_snippets)
        after = g_stats.snapshot()["counters"]
        for k in ("page.rows", "page.doc_reads", "page.doc_fallback",
                  "page.doc_cache_hits"):
            counts[k] = counts.get(k, 0) + after.get(k, 0) \
                - before.get(k, 0)
        want = _reference(st, queries, raw, topk=10, offset=offset,
                          with_snippets=with_snippets)
        assert [(p.total_matches, p.clustered, _rows(p.results))
                for p in got] == want, queries
    assert counts["page.rows"] > 0 and counts["page.doc_reads"] > 0
    return counts


@pytest.mark.parametrize("pqr", [False, True], ids=["nopqr", "pqr"])
@pytest.mark.parametrize("offset", [0, 10])
@pytest.mark.parametrize("with_snippets", [True, False],
                         ids=["summaries", "nosummaries"])
@pytest.mark.parametrize("kind", ["short", "long"])
def test_page_build_matches_row_walk(clean, kind, with_snippets, offset,
                                     pqr):
    _check(clean, kind, "device", offset=offset,
           with_snippets=with_snippets, pqr=pqr, seed=11 + offset)


@pytest.mark.parametrize("offset", [0, 10])
@pytest.mark.parametrize("kind", ["short", "long"])
def test_page_build_matches_row_walk_shuffled(clean, kind, offset):
    """Foreign, duplicate-content and zero-score rows: content dedup
    and clustering push walks past the predicted rows, which are read
    one at a time."""
    counts = _check(clean, kind, "shuffled", offset=offset,
                    with_snippets=True, pqr=False, seed=23 + offset)
    assert counts["page.doc_fallback"] > 0


@pytest.mark.parametrize("rows", ["device", "shuffled"])
@pytest.mark.parametrize("offset", [0, 10])
@pytest.mark.parametrize("kind", ["short", "long"])
def test_page_build_after_writes(written, kind, offset, rows):
    """Inject, re-inject and delete writes in the memtable over two
    titledb runs."""
    _check(written, kind, rows, offset=offset, with_snippets=True,
           pqr=offset == 10, seed=37 + offset)


@pytest.mark.parametrize("search", ["native", "numpy"])
@pytest.mark.parametrize("state", ["clean", "written"])
def test_batched_read_matches_get_list(request, monkeypatch, state, search):
    """``get_documents`` over every docid, deleted and unknown ones
    among them, equals ``get_document`` (one ``get_list`` a docid) with
    an empty cache, and fills the cache with the same records; with the
    key search in the native core and in numpy."""
    st = request.getfixturevalue(state)
    if search == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    tit = st.tc.titledb.get_all()
    docids = sorted(set(int(d) for d in tit.keys["n1"])
                    | {_docid(u) for u in st.gone}
                    | {(1 << 37) + k for k in range(5)})
    st.tc.titlerec_cache.clear()
    got, n_read = docproc.get_documents(st.tc, docids)
    assert n_read == len(docids)
    cached = dict(st.tc.titlerec_cache)
    st.tc.titlerec_cache.clear()
    want = {d: docproc.get_document(st.tc, docid=d) for d in docids}
    assert got == want == cached
    assert {d: jdocproc.get_document(st.jc, docid=d) for d in docids} \
        == want
    if state == "written":
        assert all(want[_docid(u)] is None for u in st.gone)
    # a second read comes from the cache
    again, n_read = docproc.get_documents(st.tc, docids[:50])
    assert n_read == 0 and again == {d: want[d] for d in docids[:50]}


@pytest.mark.parametrize("search", ["native", "numpy"])
def test_get_ranges_matches_get_list(written, monkeypatch, search):
    """``Rdb.get_ranges`` over many docids' ranges is the reference's
    ``get_list`` reads of each concatenated, record for record (keys,
    delbits and payloads): the newest version of a record, a tombstoned
    one gone."""
    if search == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    tdb = written.tc.titledb
    docids = sorted({int(d) for d in tdb.get_all().keys["n1"][::7]}
                    | {_docid(u) for u in written.gone}
                    | {_docid(written.docs[0][0]), 1 << 37})
    got = tdb.get_ranges(titledb.start_key(docids), titledb.end_key(docids))
    want = [written.jc.titledb.get_list(jtitledb.start_key(d),
                                        jtitledb.end_key(d))
            for d in docids]
    assert got.keys.tobytes() == b"".join(w.keys.tobytes() for w in want)
    assert got.payloads() == [p for w in want for p in w.payloads()]
    assert len(got) > len(docids) // 2


def test_device_batch_counts_and_equals_pages(clean):
    """``search_device_batch`` is ``build_pages`` over its device rows:
    the same pages, and the page counters once per batch."""
    queries = make_queries(6, seed=3)
    plans = [compile_query(q, lang=0) for q in queries]
    clean.tc.conf.pqr_enabled = False
    clean.tc._device_index = clean.di
    try:
        clean.tc.titlerec_cache.clear()
        before = dict(g_stats.snapshot()["counters"])
        got = engine.search_device_batch(clean.tc, queries, topk=10)
        after = g_stats.snapshot()["counters"]
        raw = clean.di.search_batch(plans, topk=64)
        clean.tc.titlerec_cache.clear()
        want = engine.build_pages(clean.tc, clean.di, plans, raw, topk=10)
    finally:
        clean.tc._device_index = None
    assert [_rows(p.results) for p in got] == \
        [_rows(p.results) for p in want]
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("page.rows", "page.doc_reads", "page.doc_cache_hits",
                       "page.doc_fallback")}
    assert delta["page.rows"] >= sum(len(p.results) for p in got)
    assert delta["page.doc_reads"] > 0


TEXTS = {
    "greek_final_sigma": ("Η ΟΔΟΣ ΤΟΥ ΣΟΦΟΣ. Ο σοφός δρόμος ΣΙΣΥΦΟΣ και "
                          "οδός. ΟΔΟΣ ΟΔΟΣ end", ["οδος", "σισυφος"], ""),
    "greek_upper_query": ("ΟΔΟΣ ΣΟΦΟΣ ἀρχή Übermäßig", ["ΟΔΟΣ", "ἀρχή"], ""),
    "greek_sigma_mid": ("ΣΟΦΟΣΣ ΣΣ Σ σ ς ΟΔΟΣ.", ["σ", "ς", "σς"], ""),
    # an apostrophe lets case pass: the text lowered whole reads the
    # sigma before it as no final one, each word lowered alone does
    "greek_sigma_apostrophe": ("Η ΟΔΟΣ'Α και ΣΟΦΟΣ·ΒΙΟΣ τέλος.",
                               ["οδος", "σοφος", "βιος"], ""),
    "non_ascii": ("Straße İstanbul café naïve Ærø ÇAĞ. İİ ǅemal ʰa",
                  ["strasse", "café", "i̇stanbul", "ǆemal", "çağ"], ""),
    "underscore_digits": ("the x_1 value is 42abc and foo_bar9 or 7 x 1.",
                          ["x_1", "42abc", "foo", "7"], ""),
    "no_hit_with_description": ("a body that never says it. Two lines.",
                                ["zebra"], "All about the Zebra herd."),
    "no_hit_description_misses": ("a body that never says it.",
                                  ["zebra"], "Nothing here."),
    "no_hit_no_description": ("a body that never says it. " * 30,
                              ["zebra"], ""),
    "empty_text": ("", ["zebra"], ""),
    "empty_text_description": ("", ["zebra"], "No zebra, a gnu."),
    "empty_text_no_query": ("", [], "just a description"),
    "no_query_words": ("some text here. " * 40, ["", ""], ""),
    "hit_first_word": ("Zebra " + "filler words go on. " * 20,
                       ["zebra"], ""),
    "hit_last_word": ("filler words go on. " * 20 + "the end zebra",
                      ["zebra"], ""),
    "shorter_than_window": ("one zebra two three.", ["zebra", "three"], ""),
    "one_word": ("zebra", ["zebra"], ""),
    "punctuation_only": (".,;! ?", ["zebra"], "a zebra"),
    "two_fragments": ("alpha " * 30 + "beta. " + "gamma " * 40 + "alpha "
                      "beta gamma delta. " + "tail " * 30,
                      ["alpha", "beta", "delta"], ""),
    "long_sentences": ("word " * 300 + "needle " + "word " * 300 + "hay.",
                       ["needle", "hay"], ""),
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_summary_matches_reference(name):
    text, words, desc = TEXTS[name]
    want = jsummary.make_summary(text, words, description=desc)
    assert summary.make_summary(text, words, description=desc) == want
    # the same row inside a batch of all the others
    items = [TEXTS[k] for k in sorted(TEXTS)]
    got = summary.make_summaries(items)
    assert got[sorted(TEXTS).index(name)] == want


def _random_items(seed, n, ascii_only):
    """Random texts of 0-300 words and queries of 0-90 words (more than
    64 distinct terms in some), the words drawn from a small vocabulary
    so that queries hit; ASCII only, or with non-ASCII words."""
    rng = random.Random(seed)
    vocab = ["alpha", "Beta", "GAMMA", "x_1", "42", "foo_bar", "a", "end",
             "K"] + [f"w{i}" for i in range(90)]
    if not ascii_only:
        vocab += ["délta", "ΟΔΟΣ", "οδος", "σ", "Σ", "İstanbul", "straße",
                  "ʰa"]
    seps = [" ", ", ", ". ", "! ", "? ", "\n", " - ", "'", "...", ".\t",
            "—" if not ascii_only else "--", "", "\x00"]

    def text():
        out = []
        for _ in range(rng.choice([0, 1, 3, 23, 24, 25, 60, 300])):
            out += [rng.choice(seps), rng.choice(vocab)]
        return "".join(out)
    return [(text(), [rng.choice(vocab + ["zzz", "", "don't", "Straße"])
                      for _ in range(rng.choice([0, 1, 2, 3, 70, 90]))],
             text() if rng.random() < 0.3 else "") for _ in range(n)]


@pytest.mark.parametrize("ascii_only", [True, False],
                         ids=["ascii", "unicode"])
@pytest.mark.parametrize("seed", [1, 2])
def test_summaries_match_reference_random(seed, ascii_only):
    items = _random_items(seed, 500, ascii_only)
    for kw in ({}, {"window": 5, "max_fragments": 3, "max_chars": 60}):
        want = [jsummary.make_summary(t, w, description=d, **kw)
                for t, w, d in items]
        assert summary.make_summaries(items, **kw) == want
        # in batches of 7, as the page build hands them over
        assert [s for i in range(0, len(items), 7)
                for s in summary.make_summaries(items[i:i + 7], **kw)] \
            == want

"""Synthetic data for the port's checks, shared by the tests and
``chip_smoke.py``: the benchmark corpus and query stream (the same
generators as the repository's ``bench.py``: a deterministic
zipf-vocabulary HTML corpus over 97 sites, and unique 1-3 term zipf
queries), wider queries of the same terms for the larger term-group
buckets, the route-exercise corpus, random inputs for the scoring
kernels, and the tie-run comparison of two result lists."""

from __future__ import annotations

import numpy as np

VOCAB = 2000
P = 16


def gen_docs(n_docs: int):
    """Yield ``(url, html)`` for ``n_docs`` documents of 60-220 words."""
    rng = np.random.default_rng(42)
    varr = np.array([f"word{i}" for i in range(VOCAB)])
    for d in range(n_docs):
        n_words = int(rng.integers(60, 220))
        idx = rng.zipf(1.35, size=n_words) % VOCAB
        words = varr[idx]
        title = " ".join(words[:4])
        sents = [" ".join(words[s:s + 12]) + "." for s in
                 range(0, n_words, 12)]
        yield (f"http://site{d % 97}.bench.test/doc{d}",
               f"<html><head><title>{title}</title></head><body><p>"
               + " ".join(sents) + "</p></body></html>")


def long_queries() -> list[str]:
    """Long queries over the body words of the first doc of 65 words or
    more, which each of them matches, one per term-group bucket above
    16: a quoted phrase of 9 words (9 word groups plus 8 bigram gates,
    so T = 32) and 17, 33 and 65 plain words (T = 32, 64 and 128)."""
    for _, html in gen_docs(1 << 10):
        body = html.split("<body><p>", 1)[1].split("</p>", 1)[0]
        words = body.replace(".", " ").split()
        if len(words) >= 65:
            break
    return ['"' + " ".join(words[:9]) + '"'] \
        + [" ".join(words[:n]) for n in (17, 33, 65)]


def make_queries(n: int, seed: int) -> list[str]:
    """``n`` UNIQUE 1-3 term zipf queries."""
    rng = np.random.default_rng(seed)
    seen: set[str] = set()
    out: list[str] = []
    while len(out) < n:
        n_terms = int(rng.integers(1, 4))
        terms = rng.zipf(1.3, size=n_terms) % VOCAB
        q = " ".join(f"word{t}" for t in terms)
        if q not in seen:
            seen.add(q)
            out.append(q)
    return out


def wide_queries(n: int, seed: int, lo: int, hi: int,
                 top: int = VOCAB) -> list[str]:
    """``n`` UNIQUE queries of ``lo`` to ``hi`` distinct zipf terms, each
    term drawn as :func:`make_queries` draws its terms, and redrawn until
    it is one of the ``top`` commonest words: 5-8 terms fill the T = 8
    bucket and 9-16 the T = 16 one, which the 1-3 term stream never
    reaches."""
    rng = np.random.default_rng(seed)
    seen: set[str] = set()
    out: list[str] = []
    while len(out) < n:
        n_terms = int(rng.integers(lo, hi + 1))
        terms: list[int] = []
        while len(terms) < n_terms:
            t = int(rng.zipf(1.3)) % VOCAB
            if 0 < t < top and t not in terms:
                terms.append(t)
        q = " ".join(f"word{t}" for t in terms)
        if q not in seen:
            seen.add(q)
            out.append(q)
    return out


#: the route-exercise corpus (the reference package's
#: ``parallel/routecheck.py``): with the dense/cube thresholds scaled down
#: by ROUTE_ENV, on ``route_docs(48)`` as one index, ``zeta`` takes F1,
#: ``alpha`` F1 with an escalation, ``alpha beta`` FD, and ``boxes dogs``
#: (the box/boxe conjugates and the bigram: three variants of quota 2,
#: not quarter-aligned) the generic F2
ROUTE_QUERIES = {
    "zeta": "f1",
    "alpha": "f1",
    "alpha beta": "fd",
    "boxes dogs": "f2",
}

#: env values that scale the dense/cube row thresholds to tiny corpora
ROUTE_ENV = {"OSSE_DENSE_MIN_DF": "8", "OSSE_CUBE_MIN_DF": "4"}


def route_docs(n: int, host_prefix: str = "mesh"):
    """The n-doc route-exercise corpus, ``(url, html)`` pairs over 23
    distinct registrable domains."""
    out = []
    for i in range(n):
        extra = ["boxes dogs box boxe"]
        if i % 2 == 0:
            extra.append("gamma")
        if i % 13 == 0:
            extra.append("zeta")
        body = f"alpha beta {' '.join(extra)} token{i} words here."
        out.append((f"http://{host_prefix}{i % 23}.test/doc{i}",
                    f"<html><head><title>Doc {i} alpha</title></head>"
                    f"<body><p>{body}</p></body></html>"))
    return out


def rand_cube(rng, T: int, D: int, density: float = 0.25,
              inlink_frac: float = 0.1) -> np.ndarray:
    """Random payload cube ``[T, P, D]`` uint32 (validity = payload ≠ 0),
    drawn as the reference package's kernel tests draw theirs."""
    wordpos = rng.integers(0, 200000, (T, P, D)).astype(np.uint32)
    hg = rng.integers(0, 11, (T, P, D)).astype(np.uint32)
    hg = np.where(rng.random((T, P, D)) < inlink_frac, 5, hg)
    den = rng.integers(1, 32, (T, P, D)).astype(np.uint32)
    spam = rng.integers(0, 16, (T, P, D)).astype(np.uint32)
    syn = rng.integers(0, 2, (T, P, D)).astype(np.uint32)
    payload = (wordpos | (hg << 18) | (den << 22) | (spam << 27)
               | (syn << 31))
    pv = rng.random((T, P, D)) < density
    return np.where(pv, payload, 0).astype(np.uint32)


def fd_inputs(rng, T: int, D: int, tail: bool, B: int = 4, Vc: int = 8):
    """Random inputs of the FD scoring kernel as numpy, in
    ``fd_scores``'s argument order: quarter indices ``[B, T·4]`` int32
    (every third on the all-zero last slot), synonym flags ``[B, T·4]``
    int32, the resident cube ``[Vc·P·D]`` as an int32 view (synonym bit
    clear: the flags carry it), ~10% dead docs ``[D]`` bool, weights
    ``[B, T]`` float32, counted groups ``[B, T]`` bool, and, with
    ``tail``, a sparse tail ``[B, T, P, D]`` as an int32 view that fills
    only slots the live resident quarters leave empty (as the slot plan
    keeps them apart), else None."""
    cube = rand_cube(rng, Vc, D) & np.uint32(0x7FFFFFFF)
    cube[Vc - 1] = 0
    gq = rng.integers(0, 4 * Vc, (B, T * 4)).astype(np.int32)
    gq[:, ::3] = 4 * (Vc - 1) + rng.integers(0, 4, gq[:, ::3].shape)
    gs = (rng.random((B, T * 4)) < 0.3).astype(np.int32)
    dead = rng.random(D) < 0.1
    fw = (rng.random((B, T)) * 0.5 + 0.5).astype(np.float32)
    counts = rng.random((B, T)) < 0.8
    counts[:, 0] = True
    tl = None
    if tail:
        tl = rand_cube(rng, B * T, D, density=0.03).reshape(B, T, P, D)
        res = cube.reshape(-1, P // 4, D)[gq].reshape(B, T, P, D)
        tl = np.where((res != 0) & ~dead, 0, tl).astype(np.uint32)
        tl = tl.view(np.int32)
    return (gq, gs, cube.reshape(-1).view(np.int32), dead, fw, counts, tl)


def assert_tie_run_parity(got, want, label, rtol: float = 1e-5) -> None:
    """Two ``search_batch`` tuples ``(docids, scores, n_matched)``: the
    match count exact, scores within ``rtol``, and the docid sets equal
    over every complete equal-score run of ``want`` (tie order inside a
    run depends on the selection, and a run cut by the page may hold
    another subset), as the reference's
    ``parallel/routecheck.assert_tie_run_parity`` compares pages."""
    gd, gs, gn = got
    wd, ws, wn = want
    assert gn == wn, (label, gn, wn)
    assert len(gs) == len(ws), (label, len(gs), len(ws))
    np.testing.assert_allclose(gs, ws, rtol=rtol, err_msg=str(label))
    i, n = 0, len(ws)
    while i < n:
        j = i
        while j < n and ws[j] == ws[i]:
            j += 1
        if j < n or wn <= n:
            assert set(gd[i:j].tolist()) == set(wd[i:j].tolist()), \
                (label, i, j)
        i = j


def assert_clustered_page_parity(page: str, flat_page, flat_all, label,
                                 rtol: float = 1e-5) -> None:
    """A ``/search`` JSON body (site clustering on, as the server answers)
    against the flat path over the same records: ``flat_page`` is
    ``engine.search(coll, q, topk=n)`` (clustered) and ``flat_all`` the
    same query unclustered to a deeper ``topk``.

    Which docs of a tie run survive the 2-per-site clustering depends on
    the route's order inside the run, so the page is held to what the
    order cannot change: the total exact; the score sequence within
    ``rtol`` (each site keeps its top scores whatever the tie order); and
    per site, the docs shown equal ``flat_all``'s best of that site by
    complete tie runs (:func:`assert_tie_run_parity`), each with the flat
    path's url. The collection's post-query rerank must be off (its
    demotions depend on which docs share the page)."""
    import json
    a = json.loads(page)
    res = a["results"]
    assert a["totalMatches"] == flat_page.total_matches, \
        (label, a["totalMatches"], flat_page.total_matches)
    assert len(res) == len(flat_page.results), \
        (label, len(res), len(flat_page.results))
    np.testing.assert_allclose([r["score"] for r in res],
                               [r.score for r in flat_page.results],
                               rtol=rtol, err_msg=str(label))
    cut = len(flat_all.results) < flat_all.total_matches
    url_of = {int(r.docid): r.url for r in flat_all.results}
    by_site: dict = {}
    for r in flat_all.results:
        by_site.setdefault(r.site, []).append(r)
    shown: dict = {}
    for r in res:
        assert int(r["docId"]) in url_of, (label, r["docId"])
        assert r["url"] == url_of[int(r["docId"])], (label, r)
        shown.setdefault(r["site"], []).append(r)
    for site, rows in shown.items():
        want = by_site[site]
        k = len(rows)
        assert_tie_run_parity(
            (np.array([r["docId"] for r in rows], np.uint64),
             np.array([r["score"] for r in rows]), len(want) + cut),
            (np.array([r.docid for r in want[:k]], np.uint64),
             np.array([r.score for r in want[:k]]), len(want) + cut),
            (label, site), rtol=rtol)


def assert_pages_match(got: str, want: str, label) -> None:
    """Two ``/search`` JSON bodies (``render_results(..., "json")``):
    ``query``, ``totalMatches``, ``clustered``, ``suggestion`` and
    ``facets`` exact, scores within rtol=1e-5 and docids by complete tie
    runs (:func:`assert_tie_run_parity`), and each result's url, title,
    snippet and site exact, matched by docid (tie order inside a run is
    free; a docid absent from ``want`` can only sit in a run the page
    cut)."""
    import json
    a, b = json.loads(got), json.loads(want)
    for k in ("query", "totalMatches", "clustered", "suggestion",
              "facets"):
        assert a[k] == b[k], (label, k, a[k], b[k])
    ra, rb = a["results"], b["results"]
    assert_tie_run_parity(
        (np.array([r["docId"] for r in ra], np.uint64),
         np.array([r["score"] for r in ra]), a["totalMatches"]),
        (np.array([r["docId"] for r in rb], np.uint64),
         np.array([r["score"] for r in rb]), b["totalMatches"]), label)
    by_docid = {r["docId"]: r for r in rb}
    for r in ra:
        if r["docId"] in by_docid:
            for f in ("url", "title", "snippet", "site"):
                assert r[f] == by_docid[r["docId"]][f], (label, f, r)

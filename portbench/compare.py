"""The comparison that decides ``correct``: the pages the timed path
returned against the plain reference's answers to the same queries.

Two numbers, each against its limit (the configuration's ``correct``
section):

* ``page_faults``: sampled queries whose page breaks an exact rule:
  the match count, the page length, a row that is not a matching page
  of the reference, a row's URL or title, more than two rows of a site
  or two of one text, or a row that a complete tie run does not allow
  (two pages of its site score above it);
* ``score_gap``: the widest relative gap, over the sampled pages, of a
  row's score from the reference's score at that rank and from the
  reference's score of that page.

Tie order inside a run of equal scores is free (the device route and the
merge may order a run otherwise than docid order), so a row is held to
what no tie order can change.
"""

from __future__ import annotations

import numpy as np

from . import reference
from .reference import PER_SITE, Answer, Index


def check_page(ix: Index, got_total: int, got_rows: list, ref: Answer,
               tol: float):
    """(fault or None, widest relative score gap) of one page.
    ``got_rows``: (docid, score, url, title) per row."""
    gap = 0.0
    if got_total != ref.total:
        return f"total {got_total} != {ref.total}", gap
    if len(got_rows) != len(ref.page):
        return f"{len(got_rows)} rows != {len(ref.page)}", gap
    for (_, s, *_), (_, rs) in zip(got_rows, ref.page):
        gap = max(gap, abs(s - rs) / abs(rs))
    idx = np.searchsorted(ix.docid, np.array([r[0] for r in got_rows],
                                             np.uint64))
    idx = np.minimum(idx, len(ix.docid) - 1)
    per_site: dict = {}
    texts = set()
    for (docid, s, url, title), i in zip(got_rows, idx):
        i = int(i)
        rs = ref.score_of(i)
        if int(ix.docid[i]) != docid or rs is None:
            return f"docid {docid} is no matching page", gap
        gap = max(gap, abs(s - rs) / abs(rs))
        if url != ix.url[i] or title != ix.title[i]:
            return f"docid {docid}: url/title {url!r} {title!r}", gap
        site = int(ix.site[i])
        per_site[site] = per_site.get(site, 0) + 1
        key = int(ix.text_key[i])
        if per_site[site] > PER_SITE or key in texts:
            return f"docid {docid}: site or text shown again", gap
        texts.add(key)
        above = int(np.count_nonzero(
            (ref.cand_scores > rs * (1.0 + tol))
            & (ix.site[ref.cand] == site)))
        if above >= PER_SITE:
            return f"docid {docid}: {above} pages of its site above it", gap
    return None, gap


def compare(ix: Index, got: dict, refs: dict, tol: float) -> dict:
    """``got``: query → (total, rows); ``refs``: query → Answer. Returns
    the numbers compared and the first faults found."""
    faults, gap, first = 0, 0.0, []
    for q, (total, rows) in got.items():
        fault, g = check_page(ix, total, rows, refs[q], tol)
        gap = max(gap, g)
        if fault is not None:
            faults += 1
            if len(first) < 3:
                first.append(f"{q!r}: {fault}")
    return {"page_faults": faults, "score_gap": gap, "first": first,
            "queries": len(got)}


def judge(ix: Index, cfg: dict, got: dict, device):
    """Hold pages (query -> (total, rows)) to the float32 reference on
    ``device`` under the configuration's limits. Returns (the numbers
    compared, each with its limit; correct; the first faults)."""
    lim = cfg["correct"]
    tol = float(lim["score_gap"])
    refs = {q: reference.answer(ix, q, **reference.setting(ix, cfg, device))
            for q in got}
    cmp = compare(ix, got, refs, tol)
    checks = {"page_faults": [cmp["page_faults"], int(lim["page_faults"])],
              "score_gap": [cmp["score_gap"], tol],
              "pages": [len(got), len(got)]}
    correct = (len(got) > 0
               and cmp["page_faults"] <= int(lim["page_faults"])
               and cmp["score_gap"] <= tol)
    return checks, correct, cmp["first"]

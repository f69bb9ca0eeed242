"""The plain summary reference: the excerpt shown under each result,
written out in plain Python from the rule, importing nothing of the
program.

It takes a page's visible body text, re-derived from the generated HTML
as ``reference.py`` derives it for ranking, and the query's words, and
returns the summary by the rule of Gigablast's ``Summary::set2`` /
``getBestWindow`` as the port documents it (``query/summary.py``):

* the text's words are its runs of word characters, compared in lower
  case;
* every window of 24 consecutive words (the whole text when shorter)
  scores its query-word occurrences plus 4 x the square of the distinct
  query words in it;
* the best window is taken (the first of equal scores), the windows
  that overlap it are ruled out, and again: at most 2 fragments, shown
  in text order;
* a fragment's ends move out to the nearest sentence bounds (the text's
  ends and the ends of a ``.``, ``!`` or ``?`` followed by a space) when
  these lie at most 80 characters away, else the fragment is cut at its
  words and marked with an ellipsis on that side;
* fragments are joined by a space until one would pass 320 characters
  (the first is always kept), and the summary is cut at 360;
* a text without a query word shows its first 320 characters.

Departures from the port's rule, none of which this benchmark's pages
can show:

* the query's words are its own words; the port also lights up each
  word's conjugate forms (``word12s``, ``word12ing``), which no page of
  the generated corpus holds, since every token is ``word<n>``;
* no meta-description fallback: the generated pages have no
  description, so the port's fallback is the text's head, as here.
"""

from __future__ import annotations

import re
from urllib.parse import urlsplit

from .reference import parse_page

WINDOW = 24
DISTINCT_BONUS = 4
FRAGMENTS = 2
MAX_CHARS = 320
#: a fragment's end moves to a sentence bound at most this far away
SNAP = 80
ELLIPSIS = "…"

_WORD = re.compile(r"\w+")
_SENT_END = re.compile(r"[.!?]\s")
_DOC = re.compile(r"/doc(\d+)\Z")


def summary(text: str, query_words) -> str:
    """The summary of ``text`` for the query's words."""
    q = {w.lower() for w in query_words if w}
    words = [(m.group(0).lower(), m.start(), m.end())
             for m in _WORD.finditer(text)]
    if not q or not any(w in q for w, _, _ in words):
        return text[:MAX_CHARS].strip()
    n = len(words)
    win = min(WINDOW, n)
    scores = []
    for s in range(n - win + 1):
        hits = [w for w, _, _ in words[s:s + win] if w in q]
        scores.append(len(hits) + DISTINCT_BONUS * len(set(hits)) ** 2)
    frags = []
    for _ in range(FRAGMENTS):
        best = max(range(len(scores)), key=lambda s: (scores[s], -s))
        if scores[best] <= 0:
            break
        frags.append((best, min(best + win, n)))
        for s in range(max(0, best - win + 1), min(best + win,
                                                  len(scores))):
            scores[s] = -1
    bounds = [0] + [m.end() for m in _SENT_END.finditer(text)] \
        + [len(text)]
    parts: list[str] = []
    used = 0
    for lo, hi in sorted(frags):
        start, end = words[lo][1], words[hi - 1][2]
        head = max(b for b in bounds if b <= start)
        tail = min(b for b in bounds if b >= end)
        frag = text[head if start - head <= SNAP else start:
                    tail if tail - end <= SNAP else end].strip()
        if start - head > SNAP:
            frag = ELLIPSIS + frag
        if tail - end > SNAP:
            frag += ELLIPSIS
        if parts and used + len(frag) > MAX_CHARS:
            break
        parts.append(frag)
        used += len(frag)
    return " ".join(parts)[:MAX_CHARS + 40]


def page_text(corpus, url: str) -> str:
    """The visible body text of the generated page at ``url`` (a
    ``gen.Corpus``'s page, found by the page number in its path)."""
    m = _DOC.search(urlsplit(url).path)
    if m is None:
        raise ValueError(f"{url}: not a page of the corpus")
    d = int(m[1])
    return parse_page(corpus.url(d), corpus.html(d))[3]


def check(corpus, pages: dict) -> dict:
    """Hold each row's summary to the reference's. ``pages``: query ->
    rows of (url, snippet). Returns the rows compared, the rows whose
    summary differs, and the first such rows."""
    rows = bad = 0
    first = []
    for q, page in pages.items():
        words = _WORD.findall(q)
        for url, snippet in page:
            rows += 1
            want = summary(page_text(corpus, url), words)
            if snippet != want:
                bad += 1
                if len(first) < 3:
                    first.append({"query": q, "url": url, "got": snippet,
                                  "want": want})
    return {"rows": rows, "mismatches": bad, "first": first}

"""Query-biased summaries and titles (the Msg20 content plane).

Reference: ``Summary.cpp/h`` — ``Summary::set2`` picks the best excerpt
windows via ``getBestWindow`` (``Summary.h:194``): score a window of words
around each query-term match by summing matched terms' weights, favoring
windows containing *more distinct* query terms, trimmed toward sentence
boundaries; up to ``maxNumLines`` fragments are concatenated. ``Title.cpp``
falls back through title sources; ``Highlight.cpp`` wraps matched words.
``Matches.cpp`` locates term hits in the stored document.

Vectorized rather than pointer-walked: term-match positions become numpy
masks; window scores come from a convolution over the match indicator.
"""

from __future__ import annotations

import re

import numpy as np

from ..utils import trace

_WORD_RE = re.compile(r"\w+", re.UNICODE)

#: window width in words (reference summary excerpt length ~ a sentence)
WINDOW_WORDS = 24
#: distinct-term bonus: a window with k distinct query terms scores
#: k²·this on top of raw match counts (getBestWindow favors diversity)
DISTINCT_BONUS = 4.0


def _tokenize_with_spans(text: str) -> tuple[list[str], list[tuple[int, int]]]:
    words, spans = [], []
    for m in _WORD_RE.finditer(text):
        words.append(m.group(0).lower())
        spans.append(m.span())
    return words, spans


_SENT_BOUND_RE = re.compile(r"[.!?]\s")


def choose_title(rec: dict, max_len: int = 80) -> str:
    """Title fallback chain (``Title.cpp``): stored <title> → first
    heading (h1) → best inlink anchor text → url-derived words. Never
    returns empty for a doc with a url."""
    for cand in (rec.get("title"), rec.get("h1")):
        if cand and cand.strip():
            return cand.strip()[:max_len]
    # longest anchor text under the cap (Title.cpp scores link texts)
    anchors = sorted((t for t, _sr in (rec.get("inlinks") or []) if t),
                     key=len, reverse=True)
    for a in anchors:
        if a.strip():
            return a.strip()[:max_len]
    url = rec.get("url", "")
    if url:
        from ..utils.url import normalize
        try:
            u = normalize(url)
            tail = [s for s in u.path.split("/") if s]
            seg = tail[-1] if tail else ""
            base, dot, ext = seg.rpartition(".")
            if dot and base and len(ext) <= 5:
                seg = base  # drop the file extension from the title
            # [^\W_]: url slugs separate words with _ as often as -
            words = re.findall(r"[^\W_]+", seg)
            if words:
                return " ".join(words)[:max_len]
            return u.host[:max_len]
        except Exception:  # noqa: BLE001 — junk urls
            return url[:max_len]
    return ""


def make_summary(text: str, query_words: list[str], *,
                 max_fragments: int = 2, window: int = WINDOW_WORDS,
                 max_chars: int = 320, description: str = "") -> str:
    """Trace-wrapped :func:`_make_summary` — one ``summary.make`` span
    per excerpt built (no-op outside a sampled trace)."""
    with trace.span("summary.make", chars=len(text or "")):
        return _make_summary(text, query_words,
                             max_fragments=max_fragments, window=window,
                             max_chars=max_chars, description=description)


def _make_summary(text: str, query_words: list[str], *,
                  max_fragments: int = 2, window: int = WINDOW_WORDS,
                  max_chars: int = 320, description: str = "") -> str:
    """Pick the best-scoring excerpt windows for these query words.

    Fallback order when the body has no match (Summary.cpp's source
    chain): the meta description if IT matches, else the text head,
    else the description itself."""
    if not text and not description:
        return ""
    qset = {w.lower() for w in query_words if w}
    if not qset:
        return (text or description)[:max_chars].strip()
    words, spans = _tokenize_with_spans(text)

    def _fallback() -> str:
        if description:
            dwords = {m.group(0).lower()
                      for m in _WORD_RE.finditer(description)}
            if dwords & qset or not text:
                return description[:max_chars].strip()
        return (text or description)[:max_chars].strip()

    if not words:
        return _fallback()
    n = len(words)
    warr = np.array(words)
    hit = np.isin(warr, list(qset))
    if not hit.any():
        return _fallback()

    # term ids for distinct-term counting inside windows
    qlist = sorted(qset)
    qid = {w: i for i, w in enumerate(qlist)}
    ids = np.array([qid.get(w, -1) for w in words], dtype=np.int32)

    win = min(window, n)
    # windowed match count via cumulative sum
    csum = np.concatenate([[0], np.cumsum(hit)])
    counts = csum[win:] - csum[:-win]                    # [n-win+1]
    # distinct terms per window: one-hot over query ids, windowed any()
    onehot = np.zeros((n, len(qlist)), dtype=np.int32)
    rows = np.nonzero(ids >= 0)[0]
    onehot[rows, ids[rows]] = 1
    oc = np.vstack([np.zeros(len(qlist), np.int32),
                    np.cumsum(onehot, axis=0)])
    distinct = ((oc[win:] - oc[:-win]) > 0).sum(axis=1)  # [n-win+1]
    scores = counts + DISTINCT_BONUS * distinct * distinct

    frags: list[tuple[int, int]] = []  # word-index ranges
    sc = scores.astype(np.float64).copy()
    for _ in range(max_fragments):
        best = int(np.argmax(sc))
        if sc[best] <= 0:
            break
        lo, hi = best, min(best + win, n)
        frags.append((lo, hi))
        # suppress overlapping windows for the next fragment
        s = max(0, best - win + 1)
        sc[s:best + win] = -1.0
    frags.sort()

    # sentence boundaries computed once: fragments snap to REAL
    # sentence bounds (within a slack) instead of raw window edges
    bounds = [0] + [m.end() for m in _SENT_BOUND_RE.finditer(text)] \
        + [len(text)]
    barr = np.array(bounds)

    parts = []
    used = 0
    for lo, hi in frags:
        clo, chi = spans[lo][0], spans[hi - 1][1]
        # nearest sentence start at/before clo (slack-capped so one
        # run-on sentence can't balloon the fragment)
        i = int(np.searchsorted(barr, clo, side="right")) - 1
        head = int(barr[max(i, 0)])
        snap_head = clo - head <= 80
        clo2 = head if snap_head else clo
        j = int(np.searchsorted(barr, chi, side="left"))
        tail = int(barr[min(j, len(bounds) - 1)])
        snap_tail = tail - chi <= 80
        chi2 = tail if snap_tail else chi
        frag = text[clo2:chi2].strip()
        if clo2 > 0 and not snap_head:
            frag = "…" + frag
        if chi2 < len(text) and not snap_tail:
            frag += "…"
        if used + len(frag) > max_chars and parts:
            break
        parts.append(frag)
        used += len(frag)
    return " ".join(parts)[: max_chars + 40]


def highlight(text: str, query_words: list[str],
              pre: str = "<b>", post: str = "</b>") -> str:
    """Wrap query-word matches (``Highlight.cpp`` front-tag/back-tag)."""
    qset = {w.lower() for w in query_words if w}
    if not qset:
        return text
    out, last = [], 0
    for m in _WORD_RE.finditer(text):
        if m.group(0).lower() in qset:
            out.append(text[last:m.start()])
            out.append(pre + m.group(0) + post)
            last = m.end()
    out.append(text[last:])
    return "".join(out)

"""Query-biased summaries and titles (the Msg20 content plane).

Reference: ``Summary.cpp/h`` — ``Summary::set2`` picks the best excerpt
windows via ``getBestWindow`` (``Summary.h:194``): score a window of words
around each query-term match by summing matched terms' weights, favoring
windows containing *more distinct* query terms, trimmed toward sentence
boundaries; up to ``maxNumLines`` fragments are concatenated. ``Title.cpp``
falls back through title sources; ``Highlight.cpp`` wraps matched words.
``Matches.cpp`` locates term hits in the stored document.

Vectorized rather than pointer-walked, a batch of rows at a time: the
rows' words form one token array, and each window's match count and
distinct terms come from the cumulative sum of its one-hot term hits.
"""

from __future__ import annotations

import re

import numpy as np

_WORD_RE = re.compile(r"\w+", re.UNICODE)

#: window width in words (reference summary excerpt length ~ a sentence)
WINDOW_WORDS = 24
#: distinct-term bonus: a window with k distinct query terms scores
#: k²·this on top of raw match counts (getBestWindow favors diversity)
DISTINCT_BONUS = 4.0


#: the same words with the gaps between them kept: ``split`` returns
#: gap, word, gap, ..., word, gap
_SPLIT_RE = re.compile(r"(\w+)", re.UNICODE)


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
    """One row's summary: :func:`make_summaries` of a batch of one."""
    return make_summaries([(text, query_words, description)],
                          max_fragments=max_fragments, window=window,
                          max_chars=max_chars)[0]


def _fallback(text: str, description: str, qset: set,
              max_chars: int) -> str:
    """No body match (Summary.cpp's source chain): the meta description
    if IT matches, else the text head, else the description itself."""
    if description:
        dwords = {m.group(0).lower()
                  for m in _WORD_RE.finditer(description)}
        if dwords & qset or not text:
            return description[:max_chars].strip()
    return (text or description)[:max_chars].strip()


def _words(text: str, qset: set, qid: dict):
    """A text's words by ``re.split``: (the split's pieces, word count,
    hit word indices, their term ids), or None without a hit. The words
    are lowercased in one ``str.lower`` over them joined by NUL, which
    no word holds and which neither is cased nor lets case pass, so
    Greek final sigma reads each word alone, as a word's own ``lower``
    does."""
    pieces = _SPLIT_RE.split(text)  # gap, word, gap, ..., word, gap
    words = "\0".join(pieces[1::2]).lower().split("\0")
    pos = [i for i, w in enumerate(words) if w in qset]
    if not pos:
        return None
    return pieces, len(words), pos, [qid[words[p]] for p in pos]


def _span(pieces: list[str], lo: int, hi: int) -> tuple[int, int]:
    """The characters of words ``[lo, hi)`` of a text split into
    ``pieces`` (gap, word, gap, ...): from the first's start to the
    last's end."""
    start = sum(map(len, pieces[:2 * lo + 1]))
    return start, start + sum(map(len, pieces[2 * lo + 1:2 * hi]))


def make_summaries(items, *, max_fragments: int = 2,
                   window: int = WINDOW_WORDS,
                   max_chars: int = 320) -> list[str]:
    """The summaries of a batch of rows, ``items`` = ``(text,
    query_words, description)`` each: per row, the best-scoring excerpt
    windows for its query words.

    Each text is tokenized by ``re.split`` (:func:`_words`); the windows
    of every row with a match are scored together over one token array
    with row offsets, and only the chosen fragments' characters are
    found (:func:`_span`)."""
    out = [""] * len(items)
    rows, parts = [], []
    nq = 0
    for i, (text, query_words, description) in enumerate(items):
        if not text and not description:
            continue
        qset = {w.lower() for w in query_words if w}
        if not qset:
            out[i] = (text or description)[:max_chars].strip()
            continue
        qid = {w: j for j, w in enumerate(sorted(qset))}
        t = _words(text, qset, qid)
        if t is None:
            out[i] = _fallback(text, description, qset, max_chars)
            continue
        rows.append(i)
        parts.append(t)
        nq = max(nq, len(qid))
    if not rows:
        return out

    n = np.array([p[1] for p in parts], np.int64)
    off = np.concatenate([[0], np.cumsum(n)[:-1]])
    hitpos = np.concatenate([np.asarray(p[2]) + o
                             for p, o in zip(parts, off.tolist())])
    ids = np.concatenate([p[3] for p in parts])

    # every row's windows: start s (row-local) over [0, n - win]
    win = np.minimum(window, n)
    nwin = n - win + 1
    row_of = np.repeat(np.arange(len(rows)), nwin)
    first = np.concatenate([[0], np.cumsum(nwin)[:-1]])
    local = np.arange(int(nwin.sum())) - first[row_of]
    lo = off[row_of] + local
    hi = lo + win[row_of]
    # each window's hits of each term from the one-hot cumulative sum
    # over the token array: match count and distinct terms
    oc = np.zeros((int(n.sum()) + 1, nq), np.int32)
    oc[hitpos + 1, ids] = 1
    np.cumsum(oc, axis=0, out=oc)
    inwin = oc[hi] - oc[lo]
    distinct = (inwin > 0).sum(axis=1)
    sc = (inwin.sum(axis=1) + DISTINCT_BONUS * distinct * distinct
          ).astype(np.float64)

    # greedy fragments: each row's first best window, then the best
    # window that does not overlap it, while one scores above 0
    frags: list[list[tuple[int, int]]] = [[] for _ in rows]
    big = np.int64(len(sc))
    at = np.arange(len(sc))
    for _ in range(max_fragments):
        best_sc = np.maximum.reduceat(sc, first)
        best = np.minimum.reduceat(
            np.where(sc == best_sc[row_of], at, big), first) - first
        live = best_sc > 0
        if not live.any():
            break
        for r in np.flatnonzero(live).tolist():
            b = int(best[r])
            frags[r].append((b, min(b + int(win[r]), int(n[r]))))
        bl = best[row_of]
        w = win[row_of]
        sc[live[row_of] & (local >= bl - w + 1) & (local < bl + w)] = -1.0

    for i, p, fr in zip(rows, parts, frags):
        out[i] = _assemble(items[i][0],
                           [_span(p[0], lo, hi) for lo, hi in sorted(fr)],
                           max_chars)
    return out


#: fragments snap to a sentence bound within this many characters
SNAP_CHARS = 80


def _assemble(text: str, frags: list[tuple[int, int]],
              max_chars: int) -> str:
    """The chosen fragments' character ranges as text: each snapped to
    the sentence bounds around it (the text's ends, and the end of each
    ``[.!?]`` and a space) when one lies within SNAP_CHARS, joined under
    ``max_chars``. Only the bounds that near a fragment are looked for:
    a bound is two characters, so no other can hide one."""
    parts = []
    used = 0
    for clo, chi in frags:
        # nearest sentence start at/before clo (slack-capped so one
        # run-on sentence can't balloon the fragment)
        head = 0 if clo <= SNAP_CHARS else None
        for m in _SENT_BOUND_RE.finditer(text, max(0, clo - SNAP_CHARS - 2),
                                         clo):
            head = m.end()
        snap_head = head is not None
        clo2 = head if snap_head else clo
        # nearest sentence end at/after chi (a bound ending past chi
        # starts at chi or later: chi ends a word)
        m = _SENT_BOUND_RE.search(text, chi, chi + SNAP_CHARS)
        tail = m.end() if m else (
            len(text) if len(text) - chi <= SNAP_CHARS else None)
        snap_tail = tail is not None
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

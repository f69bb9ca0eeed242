"""Speller — "did you mean" suggestions from corpus word popularity.

A copy of ``open_source_search_engine_tpu/query/speller.py``; the port imports
nothing of that package.

Reference: ``Speller.{h,cpp}`` — dictionary files + word popularity
(built by ``gb gendict``, ``main.cpp:2719``); query terms with no/low
results get replaced by the most popular near-neighbor. Here the
dictionary IS the corpus: each collection keeps word → document-frequency
counts (fed by the indexer, persisted beside the collection), and
suggestions pick the most frequent word within Damerau-ish edit distance
≤ 2, requiring the suggestion to be strictly more popular than the typo.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path


def _edit_distance_le2(a: str, b: str) -> int | None:
    """Edit distance if ≤ 2 else None (banded DP, early exit)."""
    la, lb = len(a), len(b)
    if abs(la - lb) > 2:
        return None
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        row_min = i
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            row_min = min(row_min, cur[j])
        if row_min > 2:
            return None
        prev = cur
    return prev[lb] if prev[lb] <= 2 else None


class Speller:
    """Per-collection popularity dictionary + suggestion engine."""

    def __init__(self, directory: str | Path):
        self.path = Path(directory) / "speller.json"
        self.counts: dict[str, int] = defaultdict(int)
        self._len_index: dict[int, set[str]] | None = None
        if self.path.exists():
            self.counts = defaultdict(
                int, json.loads(self.path.read_text()))

    # --- dictionary maintenance (gendict, incremental) ---

    def add_doc_words(self, words) -> None:
        for w in set(words):
            if w.isalpha() and 2 < len(w) < 32:
                self.counts[w] += 1
        self._len_index = None

    def remove_doc_words(self, words) -> None:
        for w in set(words):
            if self.counts.get(w, 0) > 0:
                self.counts[w] -= 1
                if not self.counts[w]:
                    del self.counts[w]
        self._len_index = None

    def save(self) -> None:
        self.path.write_text(json.dumps(dict(self.counts)))

    # --- suggestion (Speller::getRecommendation flow) ---

    def _by_len(self) -> dict[int, set[str]]:
        # read once, build into a local, publish once: a concurrent
        # add_doc_words() invalidation can no longer land between the
        # None check and a re-read (we'd return None); worst case two
        # threads build identical indexes and one wins
        ix = self._len_index
        if ix is None:
            ix = defaultdict(set)
            for w in self.counts:
                ix[len(w)].add(w)
            self._len_index = ix
        return ix

    def suggest_word(self, word: str) -> str | None:
        word = word.lower()
        base_pop = self.counts.get(word, 0)
        ix = self._by_len()
        best, best_pop = None, base_pop
        for ln in range(max(1, len(word) - 2), len(word) + 3):
            for cand in ix.get(ln, ()):
                pop = self.counts[cand]
                if pop <= best_pop or cand == word:
                    continue
                d = _edit_distance_le2(word, cand)
                if d is not None and d > 0:
                    best, best_pop = cand, pop
        return best

    def suggest_query(self, words: list[str]) -> str | None:
        """Suggestion for a whole query: replace unknown/rare words;
        None when nothing improves."""
        out, changed = [], False
        for w in words:
            s = self.suggest_word(w)
            if s is not None and self.counts.get(w.lower(), 0) == 0:
                out.append(s)
                changed = True
            else:
                out.append(w)
        return " ".join(out) if changed else None


def merged(spellers: list[Speller]) -> Speller:
    """Read-only merged view over per-shard dictionaries: popularity
    counts summed, so cluster-wide suggestions see the whole corpus
    (used by the sharded zero-result fallback). Not saveable."""
    m = Speller.__new__(Speller)
    m.path = None
    m.counts = defaultdict(int)
    for s in spellers:
        for w, c in s.counts.items():
            m.counts[w] += c
    m._len_index = None
    return m

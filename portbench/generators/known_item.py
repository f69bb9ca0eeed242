"""Known-item queries (Azzopardi, de Rijke and Balog, "Building
simulated queries for known-item topics", SIGIR 2007): each query picks
a page of the collection uniformly and draws its words from that page's
own words, the commoner in the page the likelier ("popular" term
selection), so every query matches its page at least and its words
follow the collection's term statistics.

A query's length runs through ``lo`` .. ``hi`` in turn, so every seed
asks the same mix of lengths; the pages and words differ by seed. (A
run draws its cell's fixed pool with the traffic's pool seed:
``run.query_stream``.)
"""

from __future__ import annotations

import numpy as np

from portbench.gen import Corpus


def stream(seed: int, corpus: Corpus, *, lo: int, hi: int):
    """Unique queries of ``lo`` to ``hi`` distinct words, without end."""
    rng = np.random.default_rng(seed % (1 << 63))
    seen: set[str] = set()
    i = 0
    while True:
        n = lo + i % (hi - lo + 1)
        words = corpus.page_words(int(rng.integers(corpus.n_docs)))
        # the page's tokens in a random order, first occurrences kept:
        # distinct words drawn by their count in the page
        order = words[rng.permutation(len(words))]
        _, first = np.unique(order, return_index=True)
        picked = order[np.sort(first)][:n]
        if len(picked) < n:
            continue
        q = " ".join(f"word{w}" for w in picked)
        if q not in seen:
            seen.add(q)
            i += 1
            yield q

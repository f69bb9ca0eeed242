"""The benchmark's page collection, generated from published term
statistics and fixed by the configuration; ``--seed`` only draws queries
(``portbench/generators/``).

The statistics are Reuters-RCV1's as Manning, Raghavan and Schuetze,
*Introduction to Information Retrieval* (2008), give them
(https://nlp.stanford.edu/IR-book/):

* Table 4.2: 200 tokens a document on average (``tokens_per_doc``);
* section 5.1.1, Heaps' law: a collection of T tokens has
  M = k * T**b terms, k = 44 and b = 0.49 fitted on RCV1 (``heaps_k``,
  ``heaps_b``), so the vocabulary follows the collection's size;
* section 5.1.2, Zipf's law: the i-th commonest term's collection
  frequency is proportional to 1 / i (``zipf_s`` = 1).

A page's tokens are drawn from that finite Zipf law over the M terms;
the word of rank i (0-based) is ``word<i>``. What the book does not give
is the configuration's ``assumed`` list: the spread of page lengths
around their mean, the title's length, the sentence length and the
number of sites.

Each page draws from its own generator, seeded by (corpus seed, page
number), so a query generator can regenerate any page alone.
"""

from __future__ import annotations

import numpy as np


def vocab_size(corpus: dict) -> int:
    """Heaps' law's term count for the collection's expected tokens."""
    tokens = int(corpus["n_docs"]) * float(corpus["tokens_per_doc"])
    return int(round(float(corpus["heaps_k"])
                     * tokens ** float(corpus["heaps_b"])))


class Corpus:
    """The collection a configuration's ``corpus`` section describes."""

    def __init__(self, corpus: dict):
        self.n_docs = int(corpus["n_docs"])
        self.seed = int(corpus["seed"])
        self.vocab = vocab_size(corpus)
        self.sites = int(corpus["sites"])
        self.lengths = tuple(int(x) for x in corpus["page_tokens"])
        self.title = int(corpus["title_tokens"])
        self.sentence = int(corpus["sentence_tokens"])
        w = np.arange(1, self.vocab + 1, dtype=np.float64) \
            ** -float(corpus["zipf_s"])
        self._cdf = np.cumsum(w / w.sum())
        self._cdf[-1] = 1.0

    def page_words(self, d: int) -> np.ndarray:
        """The word ranks of page ``d``, in page order."""
        rng = np.random.default_rng((self.seed, d))
        n = int(rng.integers(self.lengths[0], self.lengths[1] + 1))
        return np.searchsorted(self._cdf, rng.random(n), side="right")

    def url(self, d: int) -> str:
        return f"http://site{d % self.sites}.bench.test/doc{d}"

    def html(self, d: int) -> str:
        """Page ``d``: its first ``title`` words as the title, the rest in
        sentences of ``sentence`` words in one paragraph."""
        ws = [f"word{i}" for i in self.page_words(d)]
        title = " ".join(ws[:self.title])
        body = ws[self.title:]
        sents = [" ".join(body[s:s + self.sentence]) + "." for s in
                 range(0, len(body), self.sentence)]
        return ("<html><head><title>" + title + "</title></head><body><p>"
                + " ".join(sents) + "</p></body></html>")

    def docs(self):
        """Every page as ``(url, html)``, in page order."""
        for d in range(self.n_docs):
            yield self.url(d), self.html(d)

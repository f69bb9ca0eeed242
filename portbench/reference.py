"""The plain reference: the search semantics the benchmark holds the
program to, written out in NumPy and plain PyTorch, importing nothing of
the program.

It re-derives the index from the generated pages themselves (the HTML
text, parsed here) and answers a query the way the Gigablast design
defines it, with the constants of its published scoring
(``Posdb.cpp``/``Posdb.h``):

* positions (``Pos.cpp``): a word takes the next position; a sentence
  break adds 2, a block tag (``<title>``, ``<p>``) 4 and starts a new
  sentence; the URL's words sit at position 0 in their own group;
* ranks (``XmlDoc::getDensityRanks``, the word-spam heuristic): density
  ``31 - (words in the sentence - 1)`` in the body and ``31 - (words in
  the group - 1)`` in the title; spam 15, docked to ``max(2,
  int(15·(1 - f)·0.8))`` for a word that fills a share ``f`` > 1/8 of a
  page of 40 words or more;
* a query word is a term group of the word and its bigram with the next
  query word (the bigram posting sits at the first word's position);
  a group keeps at most 16 positions a page: the first 16 of the word,
  or the first 8 and the first 4 of the bigram where the bigram occurs
  in the collection;
* the min-score (``Posdb.cpp:5437``): per position ``posw = hashgroup ×
  density × spam weight``; single-term score the sum over the mapped
  hashgroups of the best ``100·posw²``, times ``fw²``; pair score the
  best ``100·posw_i·posw_j / (dist + 1)`` over the two groups' positions
  (groups at most 4 apart in the query), times ``fw_i·fw_j``; a page's
  score is the least of them, times the siterank and language
  multipliers (siterank 0, any language: ×20); ``fw = 0.5 + min(df/N,
  0.5)`` from the collection-wide document frequency;
* the page: every page that has every query word matches; rows by score,
  ties by the lower docid, over the top 64; at most 2 rows a site and
  no two rows of the same text (``Msg51``); 10 rows.

The arithmetic runs in a chosen floating-point type, float32 as the
configuration states or bfloat16 for the control, in the order the
formulas above are written, on a chosen torch device.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from pathlib import Path
from urllib.parse import urlsplit, urlunsplit

import numpy as np
import torch

from . import gen

# ------------------------------------------------------------ hashing
# 64-bit FNV-1a with a murmur finalizer (hash.cpp's hash64 for short
# keys): the docid is its low 38 bits over the normalized URL
# (Titledb.h getProbableDocId).

_M64 = 0xFFFFFFFFFFFFFFFF


def hash64(data: str) -> int:
    h = 0xCBF29CE484222325
    for b in data.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & _M64
    return _finalize(h)


def _finalize(h: int) -> int:
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _M64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _M64
    h ^= h >> 33
    return h


def doc_id(url: str) -> int:
    return hash64(url) & ((1 << 38) - 1)


def normalize_url(raw: str) -> tuple[str, str]:
    """(normalized URL, site) of an absolute http URL: scheme and host in
    lower case, the path "/" when empty; the site is the host."""
    p = urlsplit(raw.strip())
    host = (p.hostname or "").lower()
    return urlunsplit(((p.scheme or "http").lower(), host, p.path or "/",
                       p.query, "")), host


# ------------------------------------------------------------ constants

HG_BODY, HG_TITLE = 0, 1
MAX_DENSITY, MAX_SPAM = 31, 15
BLOCK_GAP, SENT_GAP = 4, 2
P = 16
BASE = 100.0
FIXED_DISTANCE = 400.0
NONBODY_CAP = 50.0
QDIST = 2.0
PAIR_SPAN = 4
LANG_WEIGHT = 20.0
SITERANK_MULT = 0.33333333
#: hashgroup weights of the body and the title (Posdb.cpp:1105-1197)
HG_WEIGHT = {HG_BODY: 1.0, HG_TITLE: 8.0}
#: min(0.35·1.03445^rank, 1) per density rank, each the float32 value of
#: the closed form min(0.35·exp(rank·log 1.03445), 1)
DENSITY_WEIGHT = np.array([
    0.3499999940395355, 0.36205750703811646, 0.3745303750038147,
    0.38743293285369873, 0.4007800221443176, 0.4145868718624115,
    0.42886942625045776, 0.4436439573764801, 0.4589274823665619,
    0.4747375249862671, 0.4910922646522522, 0.5080103874206543,
    0.5255113244056702, 0.5436152219772339, 0.5623427033424377,
    0.58171546459198, 0.6017555594444275, 0.6224860548973083,
    0.6439306735992432, 0.666114091873169, 0.6890617609024048,
    0.7127999067306519, 0.7373558282852173, 0.7627577781677246,
    0.7890347242355347, 0.8162170052528381, 0.8443357348442078,
    0.8734230399131775, 0.9035124778747559, 0.9346385598182678,
    0.9668368697166443, 1.0], dtype=np.float32)

#: rows the page is built from
TOP_ROWS = 64
PAGE_ROWS, PER_SITE = 10, 2

_PAGE_RE = re.compile(
    r"<html><head><title>(?P<title>[^<]*)</title></head><body><p>"
    r"(?P<body>[^<]*)</p></body></html>\Z")
_WORD_RE = re.compile(r"\w+")
_SENT_RE = re.compile(r"[.!?;:]+")
_VOCAB_RE = re.compile(r"word(\d+)\Z")


# ------------------------------------------------------------ the index

@dataclass
class Index:
    """The collection as the reference sees it. Pages are in docid
    order; tokens (title and body words) in page order, then position
    order, as flat columns."""

    n_docs: int
    docid: np.ndarray      # uint64 [N], ascending
    url: np.ndarray        # str [N]
    site: np.ndarray       # int32 [N], index into sites
    sites: np.ndarray      # str [S]
    title: np.ndarray      # str [N]
    text_key: np.ndarray   # uint64 [N], digest of the visible body text
    start: np.ndarray      # int64 [N + 1], token offsets
    word: np.ndarray       # int32 [M], vocabulary id
    pos: np.ndarray        # int32 [M]
    hg: np.ndarray         # int8 [M]
    den: np.ndarray        # int8 [M]
    spam: np.ndarray       # int8 [M]
    sent: np.ndarray       # int32 [M]
    doc: np.ndarray        # int32 [M], page index
    nxt: np.ndarray        # int32 [M], the next word of the sentence, -1
    by_word: np.ndarray    # int64 [M], token indices grouped by word
    post_doc: np.ndarray   # int32 [M], the page of each of them
    word_start: np.ndarray  # int64 [V + 1]
    word_docs: np.ndarray  # int32, the pages holding each word, grouped
    word_docs_start: np.ndarray  # int64 [V + 1]
    df: np.ndarray         # int64 [V], pages holding the word

    def postings(self, w: int) -> np.ndarray:
        return self.by_word[self.word_start[w]:self.word_start[w + 1]]


def _emit(text: str, hg: int, pos: int, sent: int, out: list):
    """Words of a text node with their positions: consecutive words take
    consecutive positions, a sentence break adds SENT_GAP and a new
    sentence. Returns the next (position, sentence)."""
    chunks = _SENT_RE.split(text)
    for chunk in chunks:
        for w in _WORD_RE.findall(chunk):
            out.append((w.lower(), pos, hg, sent))
            pos += 1
        pos += SENT_GAP
        sent += 1
    return pos - SENT_GAP, sent - 1


def parse_page(url: str, html: str):
    """(normalized url, site, title, body text, tokens, url words) of a
    generated page; tokens are (word, position, hashgroup, sentence)."""
    m = _PAGE_RE.match(html)
    if m is None:
        raise ValueError(f"{url}: a page shape the reference does not read")
    full, site = normalize_url(url)
    toks: list = []
    pos, sent = BLOCK_GAP, 1                      # <title>
    pos, sent = _emit(m["title"], HG_TITLE, pos, sent, toks)
    pos, sent = pos + 2 * BLOCK_GAP, sent + 2     # </title>, <p>
    _emit(m["body"], HG_BODY, pos, sent, toks)
    body = re.sub(r"\s+", " ", m["body"]).strip()
    return full, site, m["title"].strip(), body, toks, \
        _WORD_RE.findall(full.lower())


def _ranks(toks: list, n_url_words: int):
    """(density, spam) per token."""
    hg = np.array([t[2] for t in toks])
    sent = np.array([t[3] for t in toks])
    den = np.empty(len(toks), np.int64)
    body = hg == HG_BODY
    _, inv, cnt = np.unique(sent[body], return_inverse=True,
                            return_counts=True)
    den[body] = np.clip(MAX_DENSITY - (cnt[inv] - 1), 1, MAX_DENSITY)
    n_title = int((~body).sum())
    den[~body] = np.clip(MAX_DENSITY - (n_title - 1), 1, MAX_DENSITY)
    n = len(toks) + n_url_words
    spam = np.full(len(toks), MAX_SPAM, np.int64)
    if n >= 40:
        _, inv, cnt = np.unique(np.array([t[0] for t in toks]),
                                return_inverse=True, return_counts=True)
        frac = cnt[inv] / n
        docked = np.maximum(2, (MAX_SPAM * (1.0 - frac) * 0.8)
                            .astype(np.int64))
        spam = np.where(frac > 0.125, docked, spam)
    return den, spam


def build_index(corpus: dict) -> Index:
    """Index the configuration's pages (``corpus`` as in the
    configuration file)."""
    vocab = gen.vocab_size(corpus)
    rows = []
    for url, html in gen.Corpus(corpus).docs():
        full, site, title, body, toks, url_words = parse_page(url, html)
        den, spam = _ranks(toks, len(url_words))
        ids = []
        for w, *_ in toks:
            m = _VOCAB_RE.match(w)
            if m is None or int(m[1]) >= vocab:
                raise ValueError(f"{url}: word {w!r} outside the vocabulary")
            ids.append(int(m[1]))
        key = int.from_bytes(hashlib.blake2b(
            body.encode(), digest_size=8).digest(), "little")
        rows.append((doc_id(full), full, site, title, key,
                     np.array(ids, np.int32),
                     np.array([t[1] for t in toks], np.int32),
                     np.array([t[2] for t in toks], np.int8),
                     den.astype(np.int8), spam.astype(np.int8),
                     np.array([t[3] for t in toks], np.int32)))
    rows.sort(key=lambda r: r[0])
    sites, site_idx = np.unique(np.array([r[2] for r in rows]),
                                return_inverse=True)
    lens = np.array([len(r[5]) for r in rows], np.int64)
    start = np.concatenate([[0], np.cumsum(lens)])
    word = np.concatenate([r[5] for r in rows])
    sent = np.concatenate([r[10] for r in rows])
    doc = np.repeat(np.arange(len(rows), dtype=np.int32), lens)
    nxt = np.full(len(word), -1, np.int32)
    same = (doc[1:] == doc[:-1]) & (sent[1:] == sent[:-1])
    nxt[:-1][same] = word[1:][same]
    by_word = np.argsort(word, kind="stable")
    wsorted = word[by_word]
    word_start = np.searchsorted(wsorted, np.arange(vocab + 1))
    post_doc = doc[by_word]
    first = np.ones(len(by_word), bool)
    first[1:] = (wsorted[1:] != wsorted[:-1]) | (post_doc[1:] != post_doc[:-1])
    word_docs = post_doc[first]
    word_docs_start = np.searchsorted(wsorted[first], np.arange(vocab + 1))
    df = np.diff(word_docs_start).astype(np.int64)
    return Index(
        n_docs=len(rows),
        docid=np.array([r[0] for r in rows], np.uint64),
        url=np.array([r[1] for r in rows]), site=site_idx.astype(np.int32),
        sites=sites, title=np.array([r[3] for r in rows]),
        text_key=np.array([r[4] for r in rows], np.uint64), start=start,
        word=word, pos=np.concatenate([r[6] for r in rows]),
        hg=np.concatenate([r[7] for r in rows]),
        den=np.concatenate([r[8] for r in rows]),
        spam=np.concatenate([r[9] for r in rows]), sent=sent, doc=doc,
        nxt=nxt, by_word=by_word, post_doc=post_doc, word_start=word_start,
        word_docs=word_docs, word_docs_start=word_docs_start, df=df)


def load_index(corpus: dict, cache_dir: Path | None) -> Index:
    """The index, from ``cache_dir`` when it holds one built from the same
    corpus settings (the file name carries their digest), else built and
    saved there."""
    if cache_dir is None:
        return build_index(corpus)
    key = hashlib.sha256(repr(sorted(corpus.items())).encode()
                         + Path(__file__).read_bytes()
                         + Path(gen.__file__).read_bytes()).hexdigest()[:16]
    path = Path(cache_dir) / f"refindex-{key}.npz"
    if path.exists():
        with np.load(path, allow_pickle=False) as z:
            return Index(n_docs=int(z["n_docs"]),
                         **{f: z[f] for f in z.files if f != "n_docs"})
    ix = build_index(corpus)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **{k: v for k, v in vars(ix).items()})
    tmp.replace(path)
    return ix


# ------------------------------------------------------------ queries

def query_words(q: str, vocab: int) -> list[int]:
    """Vocabulary ids of a plain query's words, in query order."""
    out = []
    for w in _WORD_RE.findall(q.lower()):
        m = _VOCAB_RE.match(w)
        if m is None or int(m[1]) >= vocab:
            raise ValueError(f"query word {w!r} outside the vocabulary")
        out.append(int(m[1]))
    return out


def score_query(ix: Index, words: list[int], *, dtype=torch.float32,
                device="cpu", chunk: int | None = None):
    """(page indices, scores) of every page that matches the query, in
    page (docid) order."""
    df, n_total = ix.df, ix.n_docs
    T = len(words)
    cand = None
    for w in words:
        d = ix.word_docs[ix.word_docs_start[w]:ix.word_docs_start[w + 1]]
        cand = d if cand is None else \
            cand[np.isin(cand, d, assume_unique=True)]
    D = 0 if cand is None else len(cand)
    if D == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)

    # the slot cube [T, P, D]: position, hashgroup, density, spam, valid
    pos = np.zeros((T, P, D), np.int32)
    hg = np.zeros((T, P, D), np.int8)
    den = np.zeros((T, P, D), np.int8)
    spam = np.zeros((T, P, D), np.int8)
    valid = np.zeros((T, P, D), bool)

    def place(i, t, tdoc, base, quota):
        # the first ``quota`` tokens of each candidate page, in slots
        # base.. (tokens in page, then position order)
        lo = np.searchsorted(tdoc, cand, "left")
        hi = np.searchsorted(tdoc, cand, "right")
        for r in range(quota):
            m = lo + r < hi
            if not m.any():
                break
            c = np.nonzero(m)[0]
            tk = t[lo[c] + r]
            pos[i, base + r, c] = ix.pos[tk]
            hg[i, base + r, c] = ix.hg[tk]
            den[i, base + r, c] = ix.den[tk]
            spam[i, base + r, c] = ix.spam[tk]
            valid[i, base + r, c] = True

    for i, w in enumerate(words):
        a, b = ix.word_start[w], ix.word_start[w + 1]
        t, tdoc = ix.by_word[a:b], ix.post_doc[a:b]
        bi = bdoc = None
        if i + 1 < T:
            # the bigram "w next": w followed by the next query word in
            # the same sentence, at w's position
            m = ix.nxt[t] == words[i + 1]
            bi, bdoc = t[m], tdoc[m]
        if bi is not None and len(bi):
            place(i, t, tdoc, 0, P // 2)
            place(i, bi, bdoc, P // 2, P // 4)
        else:
            place(i, t, tdoc, 0, P)

    dev = torch.device(device)
    chunk = chunk or (65536 if dev.type == "cuda" else 8192)

    def tt(a, dt=None):
        return torch.as_tensor(a, device=dev, dtype=dt)

    fw32 = (np.float32(0.5) + np.minimum(
        np.asarray([df[w] for w in words], np.float32)
        / np.float32(max(float(n_total), 1.0)), np.float32(0.5))
    ).astype(np.float32)
    fw = tt(fw32).to(dtype)
    hgw_tab = torch.zeros(16, dtype=dtype, device=dev)
    for g, v in HG_WEIGHT.items():
        hgw_tab[g] = float(np.float32(v))
    den_tab = tt(DENSITY_WEIGHT).to(dtype)
    out = np.empty(D, np.float32)
    for c0 in range(0, D, chunk):
        sl = slice(c0, min(D, c0 + chunk))
        v = tt(valid[:, :, sl])
        g = tt(hg[:, :, sl].astype(np.int64))
        spamf = tt(spam[:, :, sl]).to(dtype)
        posw = (hgw_tab[g] * den_tab[tt(den[:, :, sl].astype(np.int64))]
                * ((spamf + 1.0) * (1.0 / 16.0)))
        posscore = BASE * posw * posw * v
        # single-term scores: the best position of each mapped hashgroup,
        # summed ascending, times fw²
        best = torch.stack([torch.where(g == h, posscore,
                                        torch.zeros((), dtype=dtype,
                                                    device=dev))
                            .amax(dim=1) for h in (HG_BODY, HG_TITLE)])
        lo, hi = torch.minimum(best[0], best[1]), torch.maximum(best[0],
                                                                best[1])
        single = (lo + hi) * (fw * fw)[:, None]
        score = single.amin(dim=0)
        wp = tt(pos[:, :, sl])
        body = g == HG_BODY
        for i in range(T):
            for j in range(i + 1, min(i + 1 + PAIR_SPAN, T)):
                delta = (wp[j][None, :, :] - wp[i][:, None, :]).to(dtype)
                d = torch.clamp(delta.abs(), min=2.0)
                mixed = body[i][:, None, :] != body[j][None, :, :]
                nb = ~body[i][:, None, :] & ~body[j][None, :, :]
                d = torch.where(nb & (d > NONBODY_CAP),
                                torch.tensor(FIXED_DISTANCE, dtype=dtype,
                                             device=dev), d)
                d = torch.where(d >= QDIST, d - QDIST, d) + (delta < 0)
                d = torch.where(mixed, torch.tensor(
                    FIXED_DISTANCE, dtype=dtype, device=dev), d)
                ps = (BASE * posw[i][:, None, :] * posw[j][None, :, :]
                      / (d + 1.0)) * (v[i][:, None, :] & v[j][None, :, :])
                pair = ps.amax(dim=(0, 1)) * fw[i] * fw[j]
                score = torch.minimum(score, pair)
        mult = (torch.zeros((), dtype=dtype, device=dev) * SITERANK_MULT
                + 1.0) * LANG_WEIGHT
        out[sl] = (score * mult).float().cpu().numpy()
    return cand, out


def _walk(ix: Index, rows: np.ndarray, scores: np.ndarray):
    """Msg51 over rows already in page order: at most PER_SITE rows a
    site and one row per text; the first PAGE_ROWS kept rows."""
    per_site: dict = {}
    seen: set = set()
    page = []
    for r, s in zip(rows, scores):
        if len(page) >= PAGE_ROWS or s <= 0.0:
            break
        site = int(ix.site[r])
        if per_site.get(site, 0) >= PER_SITE:
            continue
        key = int(ix.text_key[r])
        if key in seen:
            continue
        seen.add(key)
        per_site[site] = per_site.get(site, 0) + 1
        page.append((int(r), float(s)))
    return page


def _top(cand: np.ndarray, scores: np.ndarray, k: int):
    order = np.argsort(-scores, kind="stable")[:k]
    return cand[order], scores[order]


@dataclass
class Answer:
    """A query's reference answer: the match count, the page as (page
    index, score) rows, and every matching page (ascending page indices)
    with its score."""

    total: int
    page: list
    cand: np.ndarray
    cand_scores: np.ndarray

    def score_of(self, i: int) -> float | None:
        k = int(np.searchsorted(self.cand, i))
        if k < len(self.cand) and self.cand[k] == i:
            return float(self.cand_scores[k])
        return None


def answer(ix: Index, q: str, *, vocab: int, dtype=torch.float32,
           device="cpu") -> Answer:
    """The reference answer to ``q`` on the collection."""
    cand, sc = score_query(ix, query_words(q, vocab), dtype=dtype,
                           device=device)
    rows, rs = _top(cand, sc, TOP_ROWS)
    return Answer(len(cand), _walk(ix, rows, rs), cand, sc)


def setting(ix: Index, cfg: dict, device) -> dict:
    """:func:`answer`'s settings for a configuration."""
    return {"vocab": gen.vocab_size(cfg["corpus"]), "device": device}

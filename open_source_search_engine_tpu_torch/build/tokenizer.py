"""HTML tokenizer → positioned, hashgroup-tagged word stream.

Reference: ``Xml.cpp``/``XmlNode.cpp`` (tag/text node tokenizer),
``Words.cpp`` (word segmentation), ``Pos.cpp`` (word position counting:
~+1 per alnum word, +2 at sentence punctuation), ``Sections.cpp`` (section
tree — we keep a flat sentence model), and the hashgroup assignment done in
``XmlDoc::hashAll`` (``XmlDoc.cpp:28957``): body/title/heading/list/menu/
meta/url tokens are hashed into distinct HASHGROUP_* spaces (``Posdb.h:74``).

Output is columnar: parallel lists of (word, wordpos, hashgroup,
sentence_id) ready for vectorized rank computation and key packing.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from functools import lru_cache
from html.parser import HTMLParser

from ..index.posdb import (
    HASHGROUP_BODY, HASHGROUP_HEADING, HASHGROUP_INLIST, HASHGROUP_INMENU,
    HASHGROUP_INMETATAG, HASHGROUP_INTAG, HASHGROUP_INURL, HASHGROUP_TITLE,
    MAXWORDPOS,
)

_WORD_RE = re.compile(r"\w+", re.UNICODE)
_SENT_SPLIT_RE = re.compile(r"[.!?;:]+")

@lru_cache(maxsize=1 << 18)
def _sect_hash(parent_hash: int, tag: str, ordinal: int) -> int:
    """Section path hash, memoized — page structures repeat across a
    crawl, so the same (parent, tag, ordinal) triples hash constantly."""
    from ..utils import ghash
    return ghash.hash64(f"{parent_hash}:{tag}:{ordinal}")


_HEADING_TAGS = {"h1", "h2", "h3", "h4", "h5", "h6"}
_SKIP_TAGS = {"script", "style", "noscript", "template", "svg"}
_LIST_TAGS = {"li", "dd", "dt"}
_MENU_TAGS = {"nav", "menu"}
_BLOCK_TAGS = {
    "p", "div", "br", "tr", "td", "table", "ul", "ol", "section", "article",
    "header", "footer", "blockquote", "pre", "h1", "h2", "h3", "h4", "h5",
    "h6", "li", "title",
}

#: extra position gap at sentence punctuation (Pos.cpp adds 2)
SENT_GAP = 2
#: extra position gap at block-tag boundaries (section breaks)
BLOCK_GAP = 4


@dataclass
class Token:
    word: str
    wordpos: int
    hashgroup: int
    sentence_id: int
    #: tag-path section hash (Sections.cpp tree, flattened to the
    #: SECOND-level container: wrapper <div>s collapse to their
    #: children, so header/nav/main/footer blocks — the boilerplate
    #: granularity — each get a stable cross-page id). 0 = no section.
    section_id: int = 0


#: tags that open a section scope (containers with matching end tags;
#: void tags like <br>/<meta> never push)
_SECTION_TAGS = {
    "div", "section", "article", "header", "footer", "aside", "nav",
    "menu", "table", "ul", "ol", "dl", "form", "blockquote", "p",
    "li", "tr", "td", "th", "dd", "dt", "pre",
    "h1", "h2", "h3", "h4", "h5", "h6",
}


@dataclass
class TokenizedDoc:
    """The parse product consumed by the indexer (docproc).

    Columnar: parallel lists (word, wordpos, hashgroup, sentence id,
    section id) — the indexer consumes columns directly instead of
    attribute-walking 10⁵ Token objects per batch. ``tokens`` stays as
    a materializing compatibility view."""

    words: list[str] = field(default_factory=list)
    wordpos: list[int] = field(default_factory=list)
    hashgroups: list[int] = field(default_factory=list)
    sentence_ids: list[int] = field(default_factory=list)
    section_ids: list[int] = field(default_factory=list)
    title: str = ""
    meta_description: str = ""
    #: page date from <meta> (article:published_time / date / pubdate),
    #: raw string — build_meta_list parses it into the date field
    meta_date: str = ""
    links: list[tuple[str, str]] = field(default_factory=list)  # (href, anchor text)
    text: str = ""  # visible text, for titlerec/snippets
    #: the native core's columns (``native.NativeDocCols``) when it
    #: tokenized the document, else None
    native: object = field(default=None, compare=False, repr=False)

    @property
    def tokens(self) -> list[Token]:
        return [Token(w, p, h, s, sid) for w, p, h, s, sid in
                zip(self.words, self.wordpos, self.hashgroups,
                    self.sentence_ids, self.section_ids)]


class _HtmlTok(HTMLParser):
    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.doc = TokenizedDoc()
        self._pos = 0
        self._sent = 0
        self._skip_depth = 0
        self._title_depth = 0
        self._heading_depth = 0
        self._list_depth = 0
        self._menu_depth = 0
        self._anchor_href: str | None = None
        self._anchor_words: list[str] = []
        self._text_parts: list[str] = []
        #: section stack: (tag, pathhash, child-ordinal counters)
        self._sect_stack: list[tuple[str, int, dict]] = []
        self._root_ordinals: dict = {}

    def _sect_push(self, tag: str) -> None:
        if self._sect_stack:
            parent_hash = self._sect_stack[-1][1]
            counters = self._sect_stack[-1][2]
        else:
            parent_hash = 0
            counters = self._root_ordinals
        ordinal = counters.get(tag, 0)
        counters[tag] = ordinal + 1
        self._sect_stack.append((tag, _sect_hash(parent_hash, tag,
                                                 ordinal), {}))

    def _sect_pop(self, tag: str) -> None:
        # pop to the nearest matching open tag (HTML is messy; an
        # unmatched end tag pops nothing)
        for i in range(len(self._sect_stack) - 1, -1, -1):
            if self._sect_stack[i][0] == tag:
                del self._sect_stack[i:]
                return

    @property
    def _section_id(self) -> int:
        if not self._sect_stack:
            return 0
        return self._sect_stack[min(1, len(self._sect_stack) - 1)][1]

    # -- tag events --

    def handle_starttag(self, tag, attrs):
        if tag in _SKIP_TAGS:
            self._skip_depth += 1
            return
        if self._skip_depth:  # no bookkeeping inside <noscript>/<svg>/...
            return
        if tag == "title":
            self._title_depth += 1
        elif tag in _HEADING_TAGS:
            self._heading_depth += 1
        elif tag in _LIST_TAGS:
            self._list_depth += 1
        elif tag in _MENU_TAGS:
            self._menu_depth += 1
        elif tag == "a":
            d = dict(attrs)
            self._anchor_href = d.get("href")
            self._anchor_words = []
        elif tag == "meta":
            d = dict(attrs)
            name = (d.get("name") or d.get("property") or "").lower()
            content = d.get("content") or ""
            if content and name in ("article:published_time", "date",
                                    "pubdate", "og:published_time",
                                    "dc.date"):
                if not self.doc.meta_date:
                    self.doc.meta_date = content
            if name in ("description", "keywords") and content:
                if name == "description":
                    self.doc.meta_description = content
                # each meta tag is its own sentence so words from different
                # tags never look adjacent (no cross-tag bigrams)
                self._sent += 1
                self._emit_words(content, HASHGROUP_INMETATAG)
                self._sent += 1
        if tag in _SECTION_TAGS:
            self._sect_push(tag)
        if tag in _BLOCK_TAGS:
            self._pos += BLOCK_GAP
            self._sent += 1

    def handle_endtag(self, tag):
        if tag in _SKIP_TAGS:
            self._skip_depth = max(0, self._skip_depth - 1)
            return
        if self._skip_depth:
            return
        if tag in _SECTION_TAGS:
            self._sect_pop(tag)
        if tag == "title":
            self._title_depth = max(0, self._title_depth - 1)
        elif tag in _HEADING_TAGS:
            self._heading_depth = max(0, self._heading_depth - 1)
        elif tag in _LIST_TAGS:
            self._list_depth = max(0, self._list_depth - 1)
        elif tag in _MENU_TAGS:
            self._menu_depth = max(0, self._menu_depth - 1)
        elif tag == "a" and self._anchor_href is not None:
            self.doc.links.append(
                (self._anchor_href, " ".join(self._anchor_words))
            )
            self._anchor_href = None
            self._anchor_words = []
        if tag in _BLOCK_TAGS:
            self._pos += BLOCK_GAP
            self._sent += 1

    # -- text events --

    def handle_data(self, data):
        if self._skip_depth:
            return
        if self._title_depth:
            self.doc.title += data
            self._emit_words(data, HASHGROUP_TITLE)
            return
        hg = HASHGROUP_BODY
        if self._heading_depth:
            hg = HASHGROUP_HEADING
        elif self._list_depth:
            hg = HASHGROUP_INLIST
        elif self._menu_depth:
            hg = HASHGROUP_INMENU
        if self._anchor_href is not None:
            self._anchor_words.extend(
                w.lower() for w in _WORD_RE.findall(data)
            )
        self._text_parts.append(data)
        self._emit_words(data, hg)

    # -- word emission with Pos.cpp-style position advance --

    def _emit_words(self, data: str, hashgroup: int) -> None:
        sid = self._section_id
        doc = self.doc
        words, wpos = doc.words, doc.wordpos
        hgs, sents, sids = (doc.hashgroups, doc.sentence_ids,
                            doc.section_ids)
        for chunk in _SENT_SPLIT_RE.split(data):
            found = _WORD_RE.findall(chunk)
            if found:
                pos = self._pos
                for w in found:
                    words.append(w.lower())
                    wpos.append(pos if pos < MAXWORDPOS else MAXWORDPOS)
                    pos += 1
                self._pos = pos
                n = len(found)
                hgs.extend([hashgroup] * n)
                sents.extend([self._sent] * n)
                sids.extend([sid] * n)
            self._pos += SENT_GAP
            self._sent += 1
        # undo the trailing split's gap when data had no sentence break
        self._pos -= SENT_GAP
        self._sent -= 1


def _native_tdoc(content: str, url: str | None,
                 is_html: bool) -> TokenizedDoc | None:
    """The document through the native core (``native/doccore.cpp``):
    the TokenizedDoc's lists, with the columns attached as ``.native`` so
    that docproc hashes and ranks no word in Python. None when the
    library is unavailable, faults, or hands the document back (an entity
    outside its table)."""
    from .. import native
    try:
        cols = native.tokenize_native(content, url, is_html)
    except Exception:  # noqa: BLE001 — any native fault: the Python path
        return None
    if cols is None:
        return None
    return TokenizedDoc(
        words=list(cols.words), wordpos=cols.wordpos.tolist(),
        hashgroups=cols.hashgroup.tolist(),
        sentence_ids=cols.sentence.tolist(),
        section_ids=cols.sect.tolist(), title=cols.title,
        meta_description=cols.desc, meta_date=cols.date,
        links=list(cols.links), text=cols.text, native=cols)


def tokenize_html(html: str, url: str | None = None) -> TokenizedDoc:
    """Tokenize an HTML document; URL path words are added to
    HASHGROUP_INURL (reference hashes the url into its own group,
    ``XmlDoc.cpp`` ``hashUrl``). The native core takes the document when
    it is built (bit-identical to this Python path, which stays the
    fallback). Input is NFC-normalized first (UCNormalizer.cpp role) so
    composed and decomposed forms index as one term on both paths."""
    from ..utils.unicodenorm import nfc
    html = nfc(html)
    doc = _native_tdoc(html, url, True)
    if doc is not None:
        return doc
    p = _HtmlTok()
    p.feed(html)
    p.close()
    doc = p.doc
    doc.text = re.sub(r"\s+", " ", " ".join(p._text_parts)).strip()
    if url:
        for m in _WORD_RE.finditer(url.lower()):
            doc.words.append(m.group(0))
            doc.wordpos.append(0)
            doc.hashgroups.append(HASHGROUP_INURL)
            doc.sentence_ids.append(0)
            doc.section_ids.append(0)
    return doc


def tokenize_text(text: str, hashgroup: int = HASHGROUP_BODY) -> TokenizedDoc:
    """Tokenize plain text (injection of non-HTML content; reference doc
    converters produce plain text fed through the same path)."""
    from ..utils.unicodenorm import nfc
    text = nfc(text)
    if hashgroup == HASHGROUP_BODY:
        doc = _native_tdoc(text, None, False)
        if doc is not None:
            return doc
    p = _HtmlTok()
    p._emit_words(text, hashgroup)
    doc = p.doc
    doc.text = re.sub(r"\s+", " ", text).strip()
    return doc

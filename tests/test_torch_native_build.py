"""The port's native build plane (``native/doccore.cpp``) held to the
cases of the reference's ``tests/test_native_build.py``: the native
tokenizer, hash and meta lists are bitwise equal to the port's Python
path, and both to the JAX package's output for the same pages.

The Python path is selected in-process, as ``chip_smoke.py`` selects it:
``native.get_doccore`` and ``native.available`` report no library."""

import contextlib

import numpy as np
import pytest

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.build import tokenizer as jtok
from open_source_search_engine_tpu_torch import native
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.build import tokenizer as T
from open_source_search_engine_tpu_torch.utils import ghash

GNARLY = """<html><head><title>Tiger &amp; Friends: a Story</title>
<meta name="description" content="All about tigers; and lions.">
<meta property="article:published_time" content="2021-03-04T10:00:00">
<meta name="keywords" content="tiger lion habitat">
</head><body>
<nav><ul><li><a href="/home">Home page</a></li>
<li><a href="/about?x=1&amp;y=2">About us</a></li></ul></nav>
<h1>Tiger Habitat</h1>
<div class="main"><p>Tigers live in forests. They hunt deer, boar; and fish!
Are tigers endangered? Yes: very much so...</p>
<p>Second paragraph with <b>bold text</b> and
<a href="http://x.test/z">an external link</a>.</p></div>
<script>var x = "<p>ignored</p>";</script>
<style>.c { color: red; }</style>
<!-- a comment with <p>tags</p> inside -->
<table><tr><td>cell one</td><td>cell two</td></tr></table>
<footer><p>Copyright 2021 Tiger Site. All rights reserved.</p></footer>
<br/>trailing text
</body></html>"""

URL = "http://example.com/tigers-page_1"

_COLUMNS = ("words", "wordpos", "hashgroups", "sentence_ids", "section_ids")
_STRINGS = ("title", "meta_description", "meta_date", "text", "links")


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.get_doccore() is not None, "g++ builds libdoccore here"


@pytest.fixture
def python_path(monkeypatch):
    """A context in which the port reports no native library."""
    @contextlib.contextmanager
    def off():
        with monkeypatch.context() as m:
            m.setattr(native, "get_doccore", lambda: None)
            m.setattr(native, "available", lambda: False)
            yield
    return off


def _both(python_path, fn, *a, **kw):
    with python_path():
        py = fn(*a, **kw)
    return py, fn(*a, **kw)


def _same(a, b, names, ctx=""):
    for f in names:
        assert getattr(a, f) == getattr(b, f), (f, ctx)


class TestTokenizerParity:
    def test_columns_and_strings_identical(self, python_path):
        py, nat = _both(python_path, T.tokenize_html, GNARLY, URL)
        assert py.native is None and nat.native is not None
        _same(py, nat, _COLUMNS + _STRINGS)
        _same(jtok.tokenize_html(GNARLY, URL), nat, _COLUMNS + _STRINGS)

    def test_termids_match_ghash(self, python_path):
        _, nat = _both(python_path, T.tokenize_html, GNARLY, URL)
        with python_path():
            tids = np.array([ghash.term_id(w) for w in nat.words],
                            np.uint64)
        assert (tids == nat.native.termid).all()

    @pytest.mark.parametrize("frag", ["a.b", "...x", "x...", "a.!?b", "",
                                      ".", "one two. three"])
    def test_punctuation_edges(self, python_path, frag):
        py, nat = _both(python_path, T.tokenize_html, f"<p>{frag}</p>", None)
        _same(py, nat, ("words", "wordpos", "sentence_ids"), frag)
        _same(jtok.tokenize_html(f"<p>{frag}</p>", None), nat,
              ("words", "wordpos", "sentence_ids"), frag)

    @pytest.mark.parametrize("html", [
        "<p>1 < 2 > 3 and a<b</p>",
        "<p>caf&eacute; and 5&times;3</p>",
        "<p>a&nbsp;b</p>",
        "<p>hello \x00 world this is text</p>",
        "<p>x&#65 y</p>",
        "<p>AT&T and &ampx</p>",                 # legacy prefix: handed back
        "<p>x &hellip; y &frobnicate; z</p>",    # unknown: handed back
    ])
    def test_edge_cases_parity(self, python_path, html):
        # stray '<' as data, entities, NUL bytes, unicode whitespace,
        # charrefs without ';': a document the native table cannot take
        # goes to the Python tokenizer, it never diverges
        py, nat = _both(python_path, T.tokenize_html, html, None)
        names = ("words", "wordpos", "text", "sentence_ids")
        _same(py, nat, names, html)
        _same(jtok.tokenize_html(html, None), nat, names, html)

    def test_unknown_entity_is_handed_back(self):
        assert native.tokenize_native("<p>x &frobnicate; z</p>", None,
                                      True) is None
        assert T.tokenize_html("<p>x &frobnicate; z</p>").native is None
        assert T.tokenize_html("<p>x &amp; z</p>").native is not None

    @pytest.mark.parametrize("frag", [
        "<a href=foo/>anchor text</a> tail",     # '/' in the value
        "<a href=foo />anchor</a>",              # a real self-close
        '<a href="foo"/>anchor</a>',             # quoted, then '/'
        "<a href=/>anchor</a>",                  # a bare-slash value
        "<a checked/>anchor</a>",                # a boolean attribute
        "<a href=a/ b=c/>anchor</a>",            # '/' mid-list
    ])
    def test_unquoted_attr_trailing_slash_not_selfclose(self, python_path,
                                                        frag):
        # html.parser reads the '/' of <a href=foo/> as the tail of the
        # unquoted value (href="foo/"), not as a self-closing slash
        html = f"<html><body>{frag}</body></html>"
        py, nat = _both(python_path, T.tokenize_html, html, URL)
        names = ("words", "links", "hashgroups", "wordpos")
        _same(py, nat, names, frag)
        _same(jtok.tokenize_html(html, URL), nat, names, frag)

    def test_unquoted_slash_stays_in_the_value(self, python_path):
        py, nat = _both(python_path, T.tokenize_html,
                        "<html><body><a href=foo/>anchor text</a>"
                        "</body></html>", URL)
        assert ("foo/", "anchor text") in py.links
        assert py.links == nat.links

    def test_plain_text_parity(self, python_path):
        text = "Plain text. With sentences! And words"
        py, nat = _both(python_path, T.tokenize_text, text)
        assert py.native is None and nat.native is not None
        _same(py, nat, ("words", "wordpos", "sentence_ids", "text"))
        _same(jtok.tokenize_text(text), nat,
              ("words", "wordpos", "sentence_ids", "text"))


class TestHashParity:
    @pytest.mark.parametrize("s", [b"tiger", b"a", b"", b"word123",
                                   b"x" * 1024])
    def test_hash64(self, python_path, s):
        h = ghash._FNV_OFFSET
        for b in s:
            h ^= b
            h = (h * ghash._FNV_PRIME) & ghash._MASK64
        h ^= h >> 33
        h = (h * 0xFF51AFD7ED558CCD) & ghash._MASK64
        h ^= h >> 33
        h = (h * 0xC4CEB9FE1A85EC53) & ghash._MASK64
        h ^= h >> 33
        assert native.hash64_native(s) == h
        with python_path():
            assert native.hash64_native(s) is None
            assert ghash.hash64(s) == h
        assert ghash.hash64(s) == h
        assert ghash.hash64(s, seed=7) == native.hash64_native(s, 7)

    def test_hash64_returns_to_the_library_after_a_switched_off_call(
            self, python_path, monkeypatch):
        """A first hash64 made while the library is switched off does not
        keep the process on the Python loop once it is back."""
        monkeypatch.setattr(ghash, "_native_hash", None)
        with python_path():
            h = ghash.hash64(b"first call")
        real, asked = native.get_doccore, []

        def counting():
            asked.append(1)
            return real()

        monkeypatch.setattr(native, "get_doccore", counting)
        assert ghash.hash64(b"first call") == h
        assert asked, "hash64 did not ask the library again"


def _sorted_keys(ml):
    return np.sort(ml.posdb_keys, order=("n2", "n1", "n0"))


class TestMetaListParity:
    def test_posdb_keys_identical(self, python_path):
        inl = [("big tiger story", 5), ("tiger", 3)]
        kw = dict(siterank=3, inlinks=inl, ts=1.0e9)
        a, b = _both(python_path, docproc.build_meta_list, URL, GNARLY,
                     **kw)
        j = jdocproc.build_meta_list(URL, GNARLY, **kw)
        for other in (a, j):
            ka, kb = _sorted_keys(other), _sorted_keys(b)
            assert len(ka) == len(kb)
            assert ka.tobytes() == kb.tobytes()
            assert other.sections == b.sections
            assert other.langid == b.langid
            assert other.docid == b.docid
            assert other.title_rec == b.title_rec
            assert other.titledb_key.tobytes() == b.titledb_key.tobytes()
            assert other.clusterdb_key.tobytes() == \
                b.clusterdb_key.tobytes()
            assert other.fielddb_keys.tobytes() == b.fielddb_keys.tobytes()

    def test_boiler_demotion_parity(self, python_path):
        # one section demoted through an explicit boilerplate set
        with python_path():
            sect_py = docproc.doc_section_hashes(
                T.tokenize_html(GNARLY, URL))
            boiler = list(sect_py.values())[:1]
            a = docproc.build_meta_list(URL, GNARLY, boiler_sections=boiler,
                                        ts=1.0e9)
        sect_nat = docproc.doc_section_hashes(T.tokenize_html(GNARLY, URL))
        assert sect_py == sect_nat
        assert sect_nat == jdocproc.doc_section_hashes(
            jtok.tokenize_html(GNARLY, URL))
        b = docproc.build_meta_list(URL, GNARLY, boiler_sections=boiler,
                                    ts=1.0e9)
        j = jdocproc.build_meta_list(URL, GNARLY, boiler_sections=boiler,
                                     ts=1.0e9)
        assert _sorted_keys(a).tobytes() == _sorted_keys(b).tobytes()
        assert _sorted_keys(j).tobytes() == _sorted_keys(b).tobytes()
        # non-vacuous: the demotion changed some spam rank
        plain = docproc.build_meta_list(URL, GNARLY, ts=1.0e9)
        assert _sorted_keys(plain).tobytes() != _sorted_keys(b).tobytes()

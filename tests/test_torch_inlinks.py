"""Inlink anchor text and the link graph: the port against the JAX
package (CPU).

The scenarios of ``tests/test_build.py::TestInlinkText`` that need no
mesh, each run on both packages with the same pages in the same order:
posdb and linkdb keys bitwise equal after every step, and the pages of
every search equal (totals, docids, scores rtol=1e-6, urls); the anchor
ranking the reference pins holds in the port; the device route's page
equals the flat path's. Then the linkdb codec and its reads."""

import numpy as np
import pytest

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu.spider import linkdb as jlinkdb
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.spider import linkdb

LINKEE = "http://target.example.com/widgets"
LINKEE_HTML = ("<html><head><title>Products</title></head><body>"
               "<p>our catalog page lists many products.</p></body></html>")
DECOY = "http://decoy.example.com/frob"
DECOY_HTML = ("<html><head><title>Frobnicator</title></head><body>"
              "<p>frobnicator mentioned once in passing text body "
              "somewhere deep.</p></body></html>")
LINKER = "http://blog.example.org/post"
LINKER_HTML = ("<html><head><title>Blog</title></head><body>"
               "<p>check out this <a href=\"http://target.example.com/"
               "widgets\">frobnicator deluxe</a> thing.</p></body></html>")
UNLINKED = ("<html><head><title>Blog</title></head><body>"
            "<p>nothing linked here any more.</p></body></html>")


class Pair:
    """The same steps on a JAX collection and a port collection (CPU)."""

    def __init__(self, tmp_path):
        self.j = JCollection("il", tmp_path / "j")
        self.t = Collection("il", tmp_path / "t", device="cpu")

    def index(self, url, html, **kw):
        jdocproc.index_document(self.j, url, html, **kw)
        docproc.index_document(self.t, url, html, **kw)
        self.check_keys()

    def remove(self, url):
        jdocproc.remove_document(self.j, url)
        docproc.remove_document(self.t, url)
        self.check_keys()

    def check_keys(self):
        for name in ("posdb", "linkdb", "titledb", "fielddb"):
            a = self.t.rdbs()[name].get_all().keys
            b = self.j.rdbs()[name].get_all().keys
            assert a.tobytes() == b.tobytes(), name

    def search(self, q, **kw):
        a = engine.search(self.t, q, **kw)
        b = jengine.search(self.j, q, **kw)
        assert a.total_matches == b.total_matches, q
        assert [(r.docid, r.url) for r in a.results] == \
            [(r.docid, r.url) for r in b.results], q
        np.testing.assert_allclose([r.score for r in a.results],
                                   [r.score for r in b.results], rtol=1e-6)
        return a


def test_anchor_only_term_ranks_first(tmp_path):
    """The linkee holds 'frobnicator' only in its inlink anchor, indexed
    before its linker (the linker's add reindexes it)."""
    p = Pair(tmp_path)
    p.index(LINKEE, LINKEE_HTML)
    p.index(DECOY, DECOY_HTML)
    p.index(LINKER, LINKER_HTML, siterank=8)
    res = p.search("frobnicator", site_cluster=False)
    assert res.results[0].url == LINKEE and res.total_matches >= 2
    rec = docproc.get_document(p.t, url=LINKEE)
    assert rec["inlinks"] == [["frobnicator deluxe", 8]]
    dev = engine.search_device(p.t, "frobnicator", site_cluster=False)
    key = lambda r: (-round(r.score, 3), r.docid)
    assert dev.total_matches == res.total_matches
    assert sorted(map(key, dev.results)) == sorted(map(key, res.results))


def test_linker_first_order_independence(tmp_path):
    p = Pair(tmp_path)
    p.index(LINKER, LINKER_HTML, siterank=8)
    p.index(DECOY, DECOY_HTML)
    p.index(LINKEE, LINKEE_HTML)
    assert p.search("frobnicator", site_cluster=False).results[0].url == \
        LINKEE


@pytest.mark.parametrize("how", ["delete", "recrawl"])
def test_losing_the_link_removes_the_anchor_signal(tmp_path, how):
    """Deleting the linker, or re-indexing it without the link,
    tombstones its edge, and the linkee reindexes without the anchor."""
    p = Pair(tmp_path)
    p.index(LINKEE, LINKEE_HTML)
    p.index(LINKER, LINKER_HTML)
    assert p.search("frobnicator").results[0].url == LINKEE
    if how == "delete":
        p.remove(LINKER)
    else:
        p.index(LINKER, UNLINKED)
    assert not any(r.url == LINKEE
                   for r in p.search("frobnicator").results)
    assert p.t.linkdb.inlinks_for_url("target.example.com", LINKEE) == []


def test_linkdb_codec_and_reads_match_reference(tmp_path):
    rng = np.random.default_rng(5)
    sites = [f"s{i}.test" for i in range(6)]
    edges = [(sites[a], sites[b], f"http://{sites[b]}/p{c}", int(sr))
             for a, b, c, sr in rng.integers(0, 6, (40, 4))]
    dbs = [linkdb.Linkdb(tmp_path / "t"), jlinkdb.Linkdb(tmp_path / "j")]
    for db in dbs:
        for linkee, linker, lurl, sr in edges:
            db.add_link(linkee, linker, lurl,
                        linkee_url=f"http://{linkee}/", anchor_text=f"a{sr}",
                        linker_siterank=sr)
    assert dbs[0].rdb.get_all().keys.tobytes() == \
        dbs[1].rdb.get_all().keys.tobytes()
    for s in sites:
        assert dbs[0].site_num_inlinks(s) == dbs[1].site_num_inlinks(s)
        assert dbs[0].inlinks_for_url(s, f"http://{s}/") == \
            dbs[1].inlinks_for_url(s, f"http://{s}/")
    keys = dbs[0].rdb.get_all().keys
    assert np.array_equal(linkdb.shard_of_keys(keys, 4),
                          jlinkdb.shard_of_keys(keys, 4))
    assert [linkdb.site_rank(n) for n in range(0, 12000, 37)] == \
        [jlinkdb.site_rank(n) for n in range(0, 12000, 37)]

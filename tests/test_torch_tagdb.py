"""The port's tagdb and catdb against the JAX package (CPU).

The scenarios of ``tests/test_tagdb.py`` that need neither the mesh, the
cluster nor the spider, and ``TestCatdb`` of ``tests/test_oddments.py``,
each run on both packages with the same inputs: the same answers, the
Rdb keys bitwise equal, and the pages of every search equal (totals,
docids, scores rtol=1e-6, urls, clustered counts). Then the port's
server answers a banned ``/inject`` with 403."""

import numpy as np
import pytest

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index import tagdb as jtagdb
from open_source_search_engine_tpu.index.catdb import Catdb as JCatdb
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu.utils.url import normalize as jnormalize
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index import posdb, tagdb
from open_source_search_engine_tpu_torch.index.catdb import Catdb
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.serve.server import SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils.url import normalize


def _both(tmp_path, name="t"):
    """[(collection, docproc, engine)] of the JAX package, then the
    port's (CPU)."""
    return [(JCollection(name, tmp_path / "j"), jdocproc, jengine),
            (Collection(name, tmp_path / "t", device="cpu"), docproc,
             engine)]


def _view(res):
    return (res.total_matches, res.clustered,
            [(r.docid, r.url) for r in res.results],
            [r.score for r in res.results])


def _same_search(pairs, q, **kw):
    (jc, _, je), (tc, _, te) = pairs
    a, b = _view(te.search(tc, q, **kw)), _view(je.search(jc, q, **kw))
    assert a[:3] == b[:3], (q, a, b)
    np.testing.assert_allclose(a[3], b[3], rtol=1e-6)
    return te.search(tc, q, **kw)


def _same_rdbs(pairs, names=("posdb", "clusterdb", "tagdb", "fielddb",
                             "linkdb", "catdb")):
    (jc, *_), (tc, *_) = pairs
    for n in names:
        assert tc.rdbs()[n].get_all().keys.tobytes() == \
            jc.rdbs()[n].get_all().keys.tobytes(), n


@pytest.mark.parametrize("mod", [jtagdb, tagdb], ids=["jax", "torch"])
def test_set_get_remove_and_container_walk(tmp_path, mod):
    td = mod.Tagdb(tmp_path)
    assert td.empty
    td.set_tag("example.com", "note", "seed site")
    assert not td.empty
    assert td.tags_for_site("example.com") == {"note": "seed site"}
    td.set_tag("example.com", "note", "updated")  # newest wins
    assert td.tags_for_site("example.com")["note"] == "updated"
    td.remove_tag("example.com", "note")
    assert td.tags_for_site("example.com") == {}
    td.set_tag("example.co.uk", "a", "domain")
    td.set_tag("www.example.co.uk", "a", "host")
    td.set_tag("www.example.co.uk", "b", "host-only")
    assert td.get_tag("http://www.example.co.uk/x", "a") == "host"
    assert td.get_tag("http://other.example.co.uk/x", "a") == "domain"
    assert td.tag_rec("http://www.example.co.uk/p") == \
        {"a": "host", "b": "host-only"}
    deep = "host.test/a/b/c/d/"
    td.set_tag(deep, mod.TAG_MANUAL_BAN, True)
    assert td.get_tag(deep, mod.TAG_MANUAL_BAN) is True
    assert td.is_banned("http://host.test/a/b/c/d/page.html")
    assert not td.is_banned("http://host.test/a/b/c/other.html")


def test_keys_and_site_boundaries_match_reference(tmp_path):
    for site, name, delbit in (("example.com", "a", 1),
                               ("users.test/~u/", "siterank", 0)):
        k = tagdb.pack_key(site, name, delbit)
        assert k.tobytes() == jtagdb.pack_key(site, name, delbit).tobytes()
    assert int(tagdb.pack_key("example.com", "a")["n1"]) == \
        int(tagdb.pack_key("example.com", "b")["n1"])
    tds = [tagdb.Tagdb(tmp_path / "t"), jtagdb.Tagdb(tmp_path / "j")]
    urls = ["http://users.example.com/~alice/page.html",
            "http://users.example.com/~bob/", "http://users.example.com/",
            "http://users.example.com/page.html",
            "http://users.example.com/a/b/c/d/e/f.html"]
    for step in range(2):
        if step:
            for td in tds:
                td.set_tag("users.example.com", "sitepathdepth", 1)
                td.set_tag("example.com", "siterank", 6)
        for u in urls:
            assert tds[0].site_of(u) == tds[1].site_of(u), u
            assert tds[0].index_gate(normalize(u)) == \
                tds[1].index_gate(jnormalize(u)), u
    assert tds[0].site_of(urls[0]) == "users.example.com/~alice/"
    assert tds[0].index_gate(normalize(urls[0])) == \
        (False, "users.example.com/~alice/", 6)


def test_persistence_through_save(tmp_path):
    """Tags survive the collection's ``save()`` (a dump in the port)."""
    for c, *_ in _both(tmp_path):
        c.tagdb.set_tag("example.com", "manualban", 1)
        c.catdb.assign("phys.test", 2)
        c.save()
        c2 = type(c)("t", c.dir.parent.parent, **(
            {"device": "cpu"} if isinstance(c, Collection) else {}))
        assert c2.tagdb.is_banned("http://spam.example.com/page")
        assert not c2.tagdb.is_banned("http://clean.org/")
        assert c2.catdb.categories_of("phys.test") == [2]


def test_manualban_blocks_indexing_and_removes(tmp_path):
    pairs = _both(tmp_path)
    html = "<html><title>spam</title><body>buy pills now</body></html>"
    for c, dp, _ in pairs:
        assert dp.index_document(c, "http://spam.test/p", html) is not None
        c.tagdb.set_tag("spam.test", "manualban", 1)
        # re-injection is refused and the indexed doc is dropped
        assert dp.index_document(c, "http://spam.test/p", html) is None
        assert dp.index_batch(c, [("http://spam.test/q", html)]) == [None]
        assert c.num_docs == 0
        assert dp.get_document(c, url="http://spam.test/p") is None
    assert _same_search(pairs, "pills").total_matches == 0
    _same_rdbs(pairs)


def test_siterank_override(tmp_path):
    pairs = _both(tmp_path)
    for c, dp, _ in pairs:
        c.tagdb.set_tag("boosted.test", "siterank", 9)
        ml = dp.index_document(
            c, "http://boosted.test/p",
            "<html><title>t</title><body>boosted words</body></html>")
        assert (posdb.unpack(ml.posdb_keys)["siterank"] == 9).all()
    _same_rdbs(pairs)
    _same_search(pairs, "boosted")


def test_sitepathdepth_clusters_user_dirs_separately(tmp_path):
    pairs = _both(tmp_path)
    for c, dp, _ in pairs:
        c.tagdb.set_tag("users.test", "sitepathdepth", 1)
        sites = set()
        for user in ("alice", "bob"):
            for i in range(3):
                sites.add(dp.index_document(
                    c, f"http://users.test/~{user}/p{i}",
                    f"<html><title>{user} {i}</title><body><p>shared topic"
                    f" words plus {user} page number{i}.</p></body>"
                    "</html>").site)
        assert sites == {"users.test/~alice/", "users.test/~bob/"}
    _same_rdbs(pairs)
    r = _same_search(pairs, "site:users.test/~alice/ topic")
    assert r.total_matches == 3 and len(r.results) == 2 and r.clustered == 1
    assert len(_same_search(pairs, "shared topic").results) == 4
    for c, dp, _ in pairs:
        dp.remove_document(c, "http://users.test/~alice/p0")
    r3 = _same_search(pairs, "site:users.test/~alice/ topic")
    assert {x.url for x in r3.results} == {
        f"http://users.test/~alice/p{i}" for i in (1, 2)}
    _same_rdbs(pairs)


TREE = "1\t0\tScience\n2\t1\tScience/Physics\n3\t0\tArts\n"


@pytest.mark.parametrize("cls", [JCatdb, Catdb], ids=["jax", "torch"])
def test_catdb_tree_and_assignment(tmp_path, cls):
    c = cls(tmp_path)
    assert c.load_tree(TREE) == 3
    c.assign("phys.test", 2)
    assert c.categories_of("phys.test") == [2]
    assert c.ancestors(2) == [2, 1]
    assert c.catid_of_path("science/physics") == 2
    assert c.doc_fields("phys.test") == {
        "catid": 2.0, "catid_top": 1.0, "category": "Science/Physics",
        "category_top": "Science"}
    c.save_tree()
    assert cls(tmp_path).tree == c.tree
    c.unassign("phys.test", 2)
    assert c.categories_of("phys.test") == []


def test_directory_restricted_search(tmp_path):
    pairs = _both(tmp_path, "c")
    for c, dp, _ in pairs:
        c.catdb.load_tree(TREE)
        c.catdb.assign("phys.test", 2)
        dp.index_document(c, "http://phys.test/a",
                          "<html><body><p>quantum electrodynamics paper "
                          "about muons</p></body></html>")
        dp.index_document(c, "http://other.test/b",
                          "<html><body><p>muons appear in this unfiled "
                          "page too</p></body></html>")
    _same_rdbs(pairs)
    assert _same_search(pairs, "muons", topk=5).total_matches == 2
    for q in ("muons gbmin:catid:2 gbmax:catid:2",
              "muons gbmin:catid_top:1 gbmax:catid_top:1"):
        res = _same_search(pairs, q, topk=5)
        assert res.total_matches == 1 and "phys.test" in res.results[0].url
        dev = engine.search_device(pairs[1][0], q, topk=5)
        assert _view(dev)[:3] == _view(res)[:3], q


def test_server_answers_banned_inject_with_403(tmp_path):
    srv = SearchHTTPServer(tmp_path, port=0, device="cpu")
    try:
        coll = srv.colldb.get("main")
        coll.tagdb.set_tag("spam.test", "manualban", 1)
        code, body, _ = srv.handle(
            "POST", "/inject", {"u": "http://spam.test/p"},
            b"<html><body>junk pills</body></html>", client_ip="9.9.9.9")
        assert code == 403 and "banned by tagdb" in body
        code, _, _ = srv.handle(
            "POST", "/inject", {"u": "http://ok.test/p"},
            b"<html><body>fine words</body></html>", client_ip="9.9.9.9")
        assert code == 200 and coll.num_docs == 1
    finally:
        srv.stop()
        g_residency.reset()

"""PyTorch port search, end to end on the CPU.

Every golden query runs through the port's ``engine.search`` against
``tests/golden/expected.json`` under the golden suite's contract; the
port and the JAX ``engine.search`` must agree on the same records (the
JAX package's index carried over with ``collection_from_arrays``)."""

import numpy as np
import pytest

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu_torch.__main__ import main as cli_main
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import (gen_docs, long_queries,
                                                        make_queries)
from open_source_search_engine_tpu_torch.index.carry import \
    collection_from_arrays
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from tests.golden.corpus import GOLDEN_QUERIES, golden_docs
from tests.test_golden import _check

BENCH_QUERIES = make_queries(16, seed=1234)


@pytest.fixture(scope="module")
def golden_coll(tmp_path_factory):
    c = Collection("golden", tmp_path_factory.mktemp("tgolden"),
                   device="cpu")
    c.conf.pqr_enabled = False
    for url, html in golden_docs().items():
        docproc.index_document(c, url, html)
    return c


def _carry(jc, base):
    tit = jc.titledb.get_all()
    return collection_from_arrays(
        jc.name, base, jc.posdb.get_all().keys, tit.keys, tit.payloads(),
        jc.clusterdb.get_all().keys, jc.sectiondb.rdb.get_all().keys,
        jc.num_docs, device="cpu")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """corpus → (JAX collection, port collection over its records)."""
    out = {}
    jg = JCollection("golden", tmp_path_factory.mktemp("jgolden"))
    for url, html in golden_docs().items():
        jdocproc.index_document(jg, url, html)
    out["golden"] = (jg, _carry(jg, tmp_path_factory.mktemp("cgolden")))
    jb = JCollection("bench", tmp_path_factory.mktemp("jbench"))
    docs = list(gen_docs(400))
    for i in range(0, len(docs), 200):
        jdocproc.index_batch(jb, docs[i:i + 200])
    out["bench"] = (jb, _carry(jb, tmp_path_factory.mktemp("cbench")))
    return out


@pytest.mark.parametrize("q", GOLDEN_QUERIES)
def test_golden_flat_path(golden_coll, q):
    res = engine.search(golden_coll, q, topk=10, site_cluster=False,
                        with_snippets=False)
    _check(q, res.total_matches,
           [(r.docid, r.score) for r in res.results], "torch-flat")


def _same(a, b):
    assert a.total_matches == b.total_matches
    assert [r.docid for r in a.results] == [r.docid for r in b.results]
    np.testing.assert_allclose([r.score for r in a.results],
                               [r.score for r in b.results], rtol=1e-6)
    assert [r.url for r in a.results] == [r.url for r in b.results]
    assert [r.snippet for r in a.results] == [r.snippet for r in b.results]
    assert a.clustered == b.clustered


@pytest.mark.parametrize("q", GOLDEN_QUERIES)
def test_matches_jax_engine_golden(pairs, q):
    jc, tc = pairs["golden"]
    _same(engine.search(tc, q, topk=10), jengine.search(jc, q, topk=10))


@pytest.mark.parametrize("q", BENCH_QUERIES)
def test_matches_jax_engine_bench(pairs, q):
    jc, tc = pairs["bench"]
    _same(engine.search(tc, q, topk=10, with_snippets=False),
          jengine.search(jc, q, topk=10, with_snippets=False))


# the 64-word query took 86.44 s under six workers, over a third of the
# default limit
@pytest.mark.time_limit(300)
@pytest.mark.parametrize("q", long_queries())
def test_matches_jax_engine_long_query(pairs, q):
    """More than 16 term groups: the 32-, 64- and 128-group buckets."""
    jc, tc = pairs["bench"]
    _same(engine.search(tc, q, topk=10, with_snippets=False),
          jengine.search(jc, q, topk=10, with_snippets=False))


def test_multipass_matches_single_pass(pairs):
    """Docid-range multipass merges to the single-pass answer."""
    _, tc = pairs["bench"]
    q = BENCH_QUERIES[0]
    one = engine.search(tc, q, topk=20, with_snippets=False)
    many = engine.search(tc, q, topk=20, with_snippets=False,
                         max_docs_per_pass=64)
    assert many.passes > one.passes
    assert many.total_matches == one.total_matches
    assert [r.docid for r in many.results] == [r.docid for r in one.results]


def test_cli_inject_then_search(tmp_path, capsys):
    import json
    page = tmp_path / "p.html"
    page.write_text("<html><title>Kilo lima</title><p>kilo lima report.</p>"
                    "</html>")
    assert cli_main(["inject", "--dir", str(tmp_path), "--torch-device",
                     "cpu", "http://a.test/p", str(page)]) == 0
    assert json.loads(capsys.readouterr().out)["docs"] == 1
    assert cli_main(["search", "--dir", str(tmp_path), "--torch-device",
                     "cpu", "--json", "kilo"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["total"] == 1
    assert out["results"][0]["url"] == "http://a.test/p"

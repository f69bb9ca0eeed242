"""The port's host memory budget sheds load as the reference's does, and
its log lines carry the trace id.

* The scenarios of the reference's
  ``tests/test_guardrail.py::TestBuildAndPackDegrade``: under a tiny
  ``max_mem`` the bulk indexer writes its records in smaller chunks
  (``membudget.reject.docproc``) and the flat query packs smaller passes
  (``membudget.reject.pack``), with the same records and the same pages
  as without a limit. The JAX package runs the same scenarios beside the
  port and must count and answer alike.
* A log line written inside a trace carries `` [<id>]`` (sampled or
  not), a line outside one keeps the plain format, and the port's line
  and the reference's line for one trace id carry it alike.
"""

import io
import logging
import re
import time
import types

import pytest

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu.utils import log as jlog
from open_source_search_engine_tpu.utils import trace as jtrace
from open_source_search_engine_tpu.utils.membudget import \
    g_membudget as j_membudget
from open_source_search_engine_tpu.utils.stats import g_stats as j_stats
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.utils import log as plog
from open_source_search_engine_tpu_torch.utils import trace
from open_source_search_engine_tpu_torch.utils.membudget import g_membudget
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from open_source_search_engine_tpu_torch.utils.trace import g_tracer

from tests import jax_gc


@pytest.fixture(scope="module", autouse=True)
def _collector_off_around_the_jax_package():
    with jax_gc.quiet():
        yield


@pytest.fixture(autouse=True)
def _budgets_restored():
    """The budgets are process singletons: a tiny limit must not leak
    into the next test."""
    limits = (g_membudget.limit, j_membudget.limit)
    yield
    g_membudget.set_limit(limits[0])
    j_membudget.set_limit(limits[1])


def _docs(n):
    return [(f"http://site{i}.test/p",
             f"<html><head><title>budget doc {i}</title></head><body>"
             f"<p>guardrail memory governor test words {i} tpu kernels"
             "</p></body></html>") for i in range(n)]


def _rdb_image(coll):
    """Every Rdb's records, memtable and runs merged: key bytes and
    payloads."""
    out = {}
    for name, rdb in coll.rdbs().items():
        b = rdb.get_all()
        out[name] = (b.keys.tobytes(),
                     [b.payload(i) for i in range(len(b))]
                     if b.has_data else None)
    return out


def _rejects(stats, label):
    return stats.snapshot()["counters"].get(f"membudget.reject.{label}", 0)


class TestBuildAndPackDegrade:
    def test_index_batch_sheds_but_indexes_everything(self, tmp_path,
                                                      monkeypatch):
        # both indexers stamp a page's titlerec with the wall clock: one
        # fixed clock makes the two packages' titlerecs byte-equal
        clock = types.SimpleNamespace(time=lambda: 1.7e9,
                                      strptime=time.strptime)
        monkeypatch.setattr(docproc, "time", clock)
        monkeypatch.setattr(jdocproc, "time", clock)
        coll = Collection("main", tmp_path / "port", device="cpu")
        jcoll = JCollection("main", tmp_path / "jax")
        before = _rejects(g_stats, "docproc")
        jbefore = _rejects(j_stats, "docproc")
        g_membudget.set_limit(256)  # every phase-C reserve refused
        j_membudget.set_limit(256)
        out = docproc.index_batch(coll, _docs(12))
        jout = jdocproc.index_batch(jcoll, _docs(12))
        assert sum(1 for v in out if v is not None) == 12
        assert coll.num_docs == 12 == jcoll.num_docs
        shed = _rejects(g_stats, "docproc") - before
        assert shed > 0
        assert shed == _rejects(j_stats, "docproc") - jbefore
        # the same records, written in chunks: what reached each Rdb,
        # bitwise, beside the JAX collection's
        for a, b in zip(out, jout):
            assert a.posdb_keys.tobytes() == b.posdb_keys.tobytes()
        got, want = _rdb_image(coll), _rdb_image(jcoll)
        assert len(coll.posdb.get_all()) == \
            sum(len(ml.posdb_keys) for ml in out) > 0
        assert len(coll.titledb.get_all()) == 12
        for name in ("posdb", "titledb", "clusterdb", "fielddb"):
            assert got[name] == want[name], name

    def test_search_correct_under_tiny_budget(self, tmp_path):
        coll = Collection("main", tmp_path / "port", device="cpu")
        jcoll = JCollection("main", tmp_path / "jax")
        docproc.index_batch(coll, _docs(8))
        jdocproc.index_batch(jcoll, _docs(8))
        want = engine.search(coll, "guardrail governor", topk=8,
                             with_snippets=False)
        before = _rejects(g_stats, "pack")
        jbefore = _rejects(j_stats, "pack")
        g_membudget.set_limit(1)  # pack shrinks to 1-doc passes
        j_membudget.set_limit(1)
        got = engine.search(coll, "guardrail governor", topk=8,
                            with_snippets=False)
        jgot = jengine.search(jcoll, "guardrail governor", topk=8,
                              with_snippets=False)
        shed = _rejects(g_stats, "pack") - before
        assert shed > 0
        assert shed == _rejects(j_stats, "pack") - jbefore
        assert got.passes > want.passes
        assert got.total_matches == want.total_matches == 8
        assert [r.docid for r in got.results] == \
            [r.docid for r in want.results]
        assert [r.score for r in got.results] == \
            [r.score for r in want.results]
        # the JAX package under the same limit: the same pages and
        # scores, and (above) the same count of refused packs, so the
        # same passes
        assert got.total_matches == jgot.total_matches
        assert [r.docid for r in got.results] == \
            [r.docid for r in jgot.results]
        assert [r.score for r in got.results] == \
            [r.score for r in jgot.results]


# --- trace ids on log lines ------------------------------------------------


@pytest.fixture
def captured():
    """The lines the port's and the reference's handlers write, captured
    through their own formatters and trace-id filters."""
    out = {}
    saved = []
    for name, mod, root in (("port", plog, "osse_torch"),
                            ("jax", jlog, "osse")):
        mod.get_logger("query")
        (handler,) = [h for h in logging.getLogger(root).handlers
                      if isinstance(h, logging.StreamHandler)]
        buf = io.StringIO()
        saved.append((handler, handler.setStream(buf)))
        out[name] = buf
    yield out
    for handler, stream in saved:
        handler.setStream(stream)


@pytest.fixture
def tracer_restored():
    saved = (g_tracer.sample_n, g_tracer.slow_ms,
             jtrace.g_tracer.sample_n, jtrace.g_tracer.slow_ms)
    yield
    g_tracer.configure(sample_n=saved[0], slow_ms=saved[1])
    jtrace.g_tracer.configure(sample_n=saved[2], slow_ms=saved[3])


_LINE = re.compile(r"^\S+ \S+ (\S+) (\w)(?P<tid> \[[0-9a-f]+\])? (?P<msg>.*)$")


def _parse(buf):
    return [_LINE.match(ln).groupdict()
            for ln in buf.getvalue().splitlines()]


@pytest.mark.parametrize("sampled", [True, False])
def test_a_line_inside_a_trace_carries_its_id(captured, tracer_restored,
                                              sampled):
    g_tracer.configure(sample_n=1 if sampled else 10 ** 9, slow_ms=1e9)
    log = plog.get_logger("query")
    with g_tracer.start("q", sampled=sampled) as t:
        assert trace.current_trace_id() == t.trace_id
        assert (trace.current_span() is not None) is sampled
        log.warning("inside")
    log.warning("outside")
    assert trace.current_trace_id() is None
    inside, outside = _parse(captured["port"])
    assert inside["tid"] == f" [{t.trace_id}]" and inside["msg"] == "inside"
    assert outside["tid"] is None and outside["msg"] == "outside"
    assert "] outside" not in captured["port"].getvalue()


def test_the_id_follows_an_attached_span_into_a_thread(captured,
                                                       tracer_restored):
    g_tracer.configure(sample_n=1, slow_ms=1e9)
    log = plog.get_logger("query")
    with g_tracer.start("q", sampled=True) as t:
        leg = trace.begin("leg", parent=t.root)
    seen = []

    def worker():
        seen.append(trace.current_trace_id())
        with trace.attach(leg):
            seen.append(trace.current_trace_id())
            log.warning("in the worker")
        seen.append(trace.current_trace_id())

    from open_source_search_engine_tpu_torch.utils import threads
    threads.spawn("trace-worker", worker).join(10)
    assert seen == [None, t.trace_id, None]
    (line,) = _parse(captured["port"])
    assert line["tid"] == f" [{t.trace_id}]"


def test_port_and_reference_lines_carry_the_same_id(captured,
                                                    tracer_restored):
    g_tracer.configure(sample_n=1, slow_ms=1e9)
    jtrace.g_tracer.configure(sample_n=1, slow_ms=1e9)
    with g_tracer.start("q", trace_id="00c0ffee12345678", sampled=True):
        plog.get_logger("query").warning("one query")
    with jtrace.g_tracer.start("q", trace_id="00c0ffee12345678",
                               sampled=True):
        jlog.get_logger("query").warning("one query")
    (p,), (j,) = _parse(captured["port"]), _parse(captured["jax"])
    assert p["tid"] == j["tid"] == " [00c0ffee12345678]"
    assert p["msg"] == j["msg"]


def test_log_types_switch_at_run_time():
    log = plog.get_logger("speller")
    try:
        plog.set_log_type_enabled("speller", True)
        assert log.isEnabledFor(logging.DEBUG)
        plog.set_log_type_enabled("speller", False)
        assert not log.isEnabledFor(logging.INFO)
        assert log.isEnabledFor(logging.WARNING)
    finally:
        log.setLevel(logging.NOTSET)

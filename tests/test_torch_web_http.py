"""The benchmark's web front end (``gb-rcv1-100k-web.web-http``) on the
CPU at 2,000 pages: a real ``SearchHTTPServer`` opened through the
harness's ``http_search`` entry, 64 queries of the cell's own traffic
sent from 16 threads over HTTP, every page held to the plain ranking
reference (``portbench/reference.py`` by ``compare.judge``) and every
summary to the plain summary reference
(``portbench/reference_summary.py``); an altered summary and an altered
score are each caught; the serve plane's spans reach the stage totals;
the shared collection is left as it was; the batcher holds its queue
while both of its workers are busy; and the summary reference imports
nothing of the port or of JAX.

The port's dense and cube thresholds are scaled down to the small
collection, as the harness's own tests do (``pb_small.ROUTE_ENV``).
Of this traffic, the queries of common words take FD; none takes F2, at
2,000 pages as at 100,000 (every word common enough sits in the cube,
and its bigrams' scatter tail stays within FD's bound). So that the
served F2 route is held to both references too, FD here takes no
scatter tail at all: a query with a sublist outside the cube goes to F2.
"""

from __future__ import annotations

import copy
import hashlib
import itertools
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from open_source_search_engine_tpu_torch.query import devindex
from open_source_search_engine_tpu_torch.serve.server import QueryBatcher
from open_source_search_engine_tpu_torch.utils import trace
from open_source_search_engine_tpu_torch.utils.slo import g_slo
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from portbench import (compare, control, gen, reference, reference_summary,
                       run, system)
from portbench.tests import pb_small

from .polling import wait_until

CELL = "gb-rcv1-100k-web.web-http"
SEED = 2**33 + 1877
N_QUERIES = 64
SPANS = ("serve.batch_wait", "serve.render", "query.summary")


def _digest(path: Path) -> str:
    h = hashlib.sha256()
    for f in sorted(path.rglob("*")):
        if f.is_file():
            h.update(f.relative_to(path).as_posix().encode())
            h.update(f.read_bytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The cell's queries served over HTTP once for the module: the
    pages, the stage totals, the routes taken and the collection's
    digest before and after."""
    mp = pytest.MonkeyPatch()
    mp.setattr(system, "CACHE", tmp_path_factory.mktemp("webcache"))
    for k, v in pb_small.ROUTE_ENV.items():
        mp.setenv(k, v)
    mp.setattr(devindex, "FD_SCATTER_MAX_ROWS", 0)
    objectives = dict(g_slo.objectives)
    try:
        cell, cfg, traffic = pb_small.small(CELL)
        traffic = dict(traffic, pool=dict(traffic["pool"], size=1024))
        corpus = gen.Corpus(cfg["corpus"])
        g = traffic["queries"]
        warm = list(itertools.islice(run._module(
            "generators", g["generator"]).stream(
                int(traffic["warmup_seed"]), corpus, **g["args"]),
            int(traffic["submitters"])))
        queries = list(itertools.islice(
            run.query_stream(traffic, SEED, corpus, avoid=warm),
            N_QUERIES))
        path = system.build_collection(cfg, "cpu", lambda m: None)
        before = _digest(path)
        node = system.System(cfg, "cpu", lambda m: None)
        try:
            run.drive(node, run._batcher(warm, 1), len(warm), None,
                      record=False)
            trace.reset()
            routes0 = node.route_counts()
            _, _, done = run.drive(node, run._batcher(queries, 1),
                                   int(traffic["submitters"]), None)
            totals = {k: tuple(v) for k, v in trace.totals.items()}
            routes = {k: v - routes0.get(k, 0)
                      for k, v in node.route_counts().items()}
        finally:
            node.close()
        yield {"cfg": cfg, "traffic": traffic, "corpus": corpus,
               "queries": queries,
               "pages": {q: p for _, _, qs, ps, _ in done
                         for q, p in zip(qs, ps)},
               "totals": totals, "routes": routes, "before": before,
               "after": _digest(path),
               "ix": reference.load_index(cfg["corpus"], system.CACHE)}
    finally:
        mp.undo()
        # the server declares its latency objective, which 16 clients
        # at a time on the CPU burn: leave the process's degrade signal
        # and the latencies behind it as the module found them
        g_slo.objectives.clear()
        g_slo.objectives.update(objectives)
        g_stats.reset()
        g_slo.evaluate()


def _rows(pages: dict) -> dict:
    return {q: (p.total_matches,
                [(r.docid, r.score, r.url, r.title) for r in p.results])
            for q, p in pages.items()}


def _summaries(pages: dict) -> dict:
    return {q: [(r.url, r.snippet) for r in p.results]
            for q, p in pages.items()}


def test_every_query_answered_over_http(served):
    assert sorted(served["pages"]) == sorted(served["queries"])
    lens = {len(q.split()) for q in served["queries"]}
    assert lens == {1, 2, 3}


def test_pages_held_to_the_ranking_reference(served):
    checks, correct, faults = compare.judge(
        served["ix"], served["cfg"], _rows(served["pages"]), "cpu")
    assert correct, (checks, faults)
    assert checks["page_faults"][0] == 0
    assert checks["score_gap"][0] <= 1e-3
    assert checks["pages"][0] == N_QUERIES


def test_summaries_equal_the_summary_reference(served):
    got = reference_summary.check(served["corpus"],
                                  _summaries(served["pages"]))
    assert got["mismatches"] == 0, got["first"]
    assert got["rows"] >= 5 * N_QUERIES


def _alter_summary(pages):
    q = next(q for q, p in sorted(pages.items()) if p.results)
    pages[q].results[0].snippet += " word1"


def _alter_score(pages):
    q = next(q for q, p in sorted(pages.items()) if p.results)
    pages[q].results[0].score *= 1.01


@pytest.mark.parametrize("alter", [_alter_summary, _alter_score],
                         ids=["summary", "score"])
def test_an_altered_page_is_caught(served, alter):
    pages = copy.deepcopy(served["pages"])
    alter(pages)
    snips = reference_summary.check(served["corpus"], _summaries(pages))
    _, correct, _ = compare.judge(served["ix"], served["cfg"],
                                  _rows(pages), "cpu")
    if alter is _alter_summary:
        assert snips["mismatches"] == 1 and correct
    else:
        assert snips["mismatches"] == 0 and not correct


def test_common_words_take_f2(served):
    assert served["routes"]["f2"] >= 1, served["routes"]
    assert served["routes"]["f1"] >= 1, served["routes"]


@pytest.mark.parametrize("span", SPANS)
def test_serve_plane_spans_reach_the_totals(served, span):
    calls, seconds = served["totals"][span]
    # one a request; the summaries one a batch's page build, where all
    # of the batch's are made in one pass
    want = served["totals"]["query.results_batch"][0] \
        if span == "query.summary" else N_QUERIES
    assert calls == want and seconds > 0.0


def test_batcher_holds_its_queue_while_both_workers_are_busy():
    """Requests that arrive while both workers run a batch wait in the
    queue and ride one batch when a worker frees, each woken with its
    own answer."""
    release = threading.Event()
    sizes: list[int] = []

    def run_batch(key, qs):
        sizes.append(len(qs))
        release.wait(10)
        return [q.upper() for q in qs]

    b = QueryBatcher(run_batch)
    out: dict = {}

    def ask(q):
        out[q] = b.search(("main", 10, 0), q)

    threads = []
    try:
        for n, q in enumerate(("a", "b")):
            threads.append(threading.Thread(target=ask, args=(q,)))
            threads[-1].start()
            wait_until(lambda: len(sizes) == n + 1, desc=f"batch {n}")
        # each arrives after the collect window of the last has closed
        later = [f"q{i}" for i in range(6)]
        for n, q in enumerate(later):
            threads.append(threading.Thread(target=ask, args=(q,)))
            threads[-1].start()
            wait_until(lambda: len(b._queue) + b.batched_queries >= n + 3,
                       desc=f"request {q} arrived")
            time.sleep(5 * QueryBatcher.WINDOW_S)
        wait_until(lambda: len(b._queue) == len(later),
                   desc="the later requests held in the queue")
        assert sizes == [1, 1]
        release.set()
        for t in threads:
            t.join(10)
        assert sizes == [1, 1, len(later)]
        assert out == {q: q.upper() for q in ("a", "b", *later)}
    finally:
        release.set()
        b.stop()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_the_limits(served, seed):
    """The plain reference in bfloat16 in the program's place, held to
    the float32 reference on a sample of the cell's queries, is not
    correct."""
    traffic = dict(served["traffic"],
                   pool=dict(served["traffic"]["pool"], size=4096))
    r = control.control(served["cfg"], traffic, seed, "cpu", None,
                        ix=served["ix"])
    assert not r["passed"], r


def test_shared_collection_left_as_it_was(served):
    assert served["after"] == served["before"]


_SUMMARY_ONLY = r"""
import sys
sys.path.insert(0, {root!r})
from portbench import gen, reference_summary
from portbench.tests import pb_small
_, cfg, _ = pb_small.small({cell!r})
c = gen.Corpus(cfg["corpus"])
text = reference_summary.page_text(c, c.url(3))
reference_summary.summary(text, text.split()[5:7])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_summary_reference_loads_no_jax_and_none_of_the_port():
    out = subprocess.run(
        [sys.executable, "-c", _SUMMARY_ONLY.format(root=str(run.ROOT),
                                                    cell=CELL)],
        capture_output=True, text=True, timeout=120, cwd=run.ROOT,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in mods
    assert not mods & set(run.FORBIDDEN), mods & set(run.FORBIDDEN)
    assert "open_source_search_engine_tpu_torch" not in mods

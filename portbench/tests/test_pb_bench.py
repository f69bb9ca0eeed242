"""The benchmark harness's own tests, on the CPU at 2,000 pages: the
collection's term statistics and the known-item queries, the frozen
work models against the port's, every name of ``BENCHMARK.json`` found,
each cell run end to end and held to the plain reference, the faults and
the control that the comparison must catch, the window's rate, the cache
key, and what the harness and the reference import.
The one test that needs the card is marked ``cuda`` and skips here.

Run: ``python -m pytest portbench/tests -q`` (on the card:
``python -m pytest --noconftest portbench/tests -m cuda -q``).
"""

from __future__ import annotations

import copy
import itertools
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import compare, control, gen, reference, run, system, workmodel
from portbench.tests import pb_small

CELLS = ["gb-rcv1-100k.question-batch", "gb-rcv1-100k.long-batch"]
SEED = 2**33 + 977


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """One benchmark cache for the module (the built collections and the
    reference's index are reused across tests)."""
    d = tmp_path_factory.mktemp("pbcache")
    saved = system.CACHE
    system.CACHE = d
    yield d
    system.CACHE = saved


@pytest.fixture
def routes(monkeypatch):
    pb_small.set_route_env(monkeypatch)


def _metrics(cell_name, trace):
    return run.cell_metrics(pb_small.bench(), cell_name, trace)


def _run(cell_name, cache, trace=False, fault=None, seconds=8.0):
    cell, cfg, traffic = pb_small.small(cell_name)
    metrics = _metrics(cell_name, trace)
    return run.run_cell(cell, cfg, traffic, SEED, seconds, trace, metrics,
                        device="cpu", ref_cache=cache, fault=fault)


#: pages whose words the statistics test counts
N_STATS = 2000


def _corpus(n_docs=N_STATS):
    _, cfg, _ = pb_small.small(CELLS[0])
    return gen.Corpus(dict(cfg["corpus"], n_docs=n_docs))


def test_collection_follows_its_published_statistics():
    c = _corpus()
    full = run.cell_spec(pb_small.bench(), CELLS[0])[2]["corpus"]
    # Heaps' law at the configured size: 44 * (100,000 * 200) ** 0.49
    assert gen.vocab_size(full) == 166325
    assert c.vocab == round(44 * (N_STATS * 200) ** 0.49)
    counts = np.zeros(c.vocab, np.int64)
    lens = []
    for d in range(N_STATS):
        w = c.page_words(d)
        lens.append(len(w))
        np.add.at(counts, w, 1)
    assert abs(np.mean(lens) - 200) < 3
    assert min(lens) >= 100 and max(lens) <= 300
    # Zipf's law with exponent 1: rank i's share is 1 / (i H_M)
    h = np.sum(1.0 / np.arange(1, c.vocab + 1))
    share = counts / counts.sum()
    for r in (0, 1, 9, 99):
        assert abs(share[r] * (r + 1) * h - 1.0) < 0.15, r
    # each page stands alone: the same words whatever was drawn before
    assert np.array_equal(c.page_words(7), _corpus().page_words(7))
    url, html = next(iter(c.docs()))
    assert url == "http://site0.bench.test/doc0" and "<title>" in html


@pytest.mark.parametrize("cell_name", CELLS)
def test_known_item_queries_match_their_pages(cell_name, cache):
    cell, cfg, traffic = pb_small.small(cell_name)
    c = gen.Corpus(cfg["corpus"])
    g = traffic["queries"]
    lo, hi = (g["args"][k] for k in ("lo", "hi"))
    stream = run._module("generators", g["generator"]).stream
    qs = list(itertools.islice(stream(SEED, c, **g["args"]), 40))
    again = list(itertools.islice(stream(SEED, c, **g["args"]), 40))
    assert qs == again and len(set(qs)) == len(qs)
    lens = [len(q.split()) for q in qs]
    # every seed asks the same mix of lengths
    assert lens[:hi - lo + 1] == list(range(lo, hi + 1))
    assert all(len(set(q.split())) == n for q, n in zip(qs, lens))
    ix = reference.load_index(cfg["corpus"], cache)
    kw = reference.setting(ix, cfg, "cpu")
    for q in qs[:12]:
        assert reference.answer(ix, q, **kw).total >= 1, q


@pytest.mark.parametrize("cell_name", CELLS)
def test_every_seed_asks_the_same_work(cell_name):
    cell, cfg, traffic = pb_small.small(cell_name)
    c = gen.Corpus(cfg["corpus"])
    g, n = traffic["queries"], traffic["pool"]["size"]
    warm = list(itertools.islice(run._module(
        "generators", g["generator"]).stream(
            traffic["warmup_seed"], c, **g["args"]), 8))

    def passes(seed, k=3):
        return list(itertools.islice(
            run.query_stream(traffic, seed, c, avoid=warm), k * n))

    def term_sets(qs):
        return sorted(tuple(sorted(q.split())) for q in qs)
    a, b = passes(SEED), passes(SEED + 1)
    assert a == passes(SEED)
    # no string comes twice, within a seed's stream or across passes
    assert len(set(a)) == len(a) and len(set(b)) == len(b)
    # each pass of each seed holds the pool's queries, in its own order
    for k in range(3):
        assert term_sets(a[k * n:(k + 1) * n]) == term_sets(a[:n])
        assert term_sets(b[k * n:(k + 1) * n]) == term_sets(a[:n])
    assert a[:n] != b[:n] and a[:n] != a[n:2 * n]
    # the warm-up's queries are not in the pool
    assert not ({frozenset(q.split()) for q in warm}
                & {frozenset(q.split()) for q in a})


def test_every_name_loads():
    bench = pb_small.bench()
    for c in bench["configs"]:
        cfg = json.loads((run.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(cfg["correct"]) == {"page_faults", "score_gap"}
    for w in bench["workloads"]:
        cell, _, cfg, traffic = run.cell_spec(bench, w["name"])
        assert callable(run._module("generators",
                                    traffic["queries"]["generator"]).stream)
        assert callable(system.load_entry(cfg["entry"]).open)
        for trace in (False, True):
            ms = run.cell_metrics(bench, w["name"], trace)
            assert ms
            for m in ms:
                assert callable(run.load_reader(m["name"]))
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert {"qps", "setup_s"} <= names


@pytest.mark.parametrize("cell_name,trace", [(CELLS[0], True),
                                             (CELLS[1], False)])
def test_cell_runs_correct_on_cpu(cell_name, trace, cache, routes):
    out = _run(cell_name, cache, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    # the collection's build, when the run made it, is reported apart
    assert out["build_s"] >= 0.0
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert out["checks"]["page_faults"][0] == 0
    assert out["checks"]["score_gap"][0] == 0.0
    want = {m["name"] for m in _metrics(cell_name, trace)}
    # on the CPU nothing reads the device: those metrics stay out
    device_only = {"device_idle_pct", "k1_roofline", "k2_roofline"}
    assert set(out["metrics"]) == want - device_only
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


def _alter_answers(node):
    search = node.search

    def altered(qs):
        pages = search(qs)
        for p in pages:
            if p.results:
                p.results[0].score *= 1.01
        return pages
    node.search = altered


def _half_batch(node):
    search = node.search

    def half(qs):
        from open_source_search_engine_tpu_torch.query.engine import \
            SearchResults
        h = len(qs) // 2
        return search(qs[:h]) + [SearchResults(query=q, total_matches=0)
                                 for q in qs[h:]]
    node.search = half


def _state_unchanged(node):
    """Every batch answered with the first batch's pages."""
    search = node.search
    first = []

    def stale(qs):
        if not first:
            first.extend(search(qs))
        return [copy.copy(p) for p in first[:len(qs)]]
    node.search = stale


@pytest.mark.parametrize("cell_name,fault", [
    (CELLS[0], _alter_answers), (CELLS[0], _half_batch),
    (CELLS[1], _state_unchanged)],
    ids=["answer-altered", "half-batch-left-out", "state-unchanged"])
def test_broken_timed_path_is_not_correct(cell_name, fault, cache, routes):
    out = _run(cell_name, cache, fault=fault)
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_the_limits(cell_name, cache):
    cell, cfg, traffic = pb_small.small(cell_name)
    for seed in (11, 12, 13):
        r = control.control(cfg, traffic, seed, "cpu", cache)
        assert not r["passed"], r


def test_stale_cache_key_forces_a_rebuild(cache, tmp_path, monkeypatch):
    cell, cfg, _ = pb_small.small(CELLS[0])
    old = system.build_collection(cfg, "cpu", lambda m: None)
    other = copy.deepcopy(cfg)
    other["corpus"]["seed"] = 43
    assert system.collection_key(other) != system.collection_key(cfg)
    other = copy.deepcopy(cfg)
    other["corpus"]["zipf_s"] = 1.1
    assert system.collection_key(other) != system.collection_key(cfg)
    # a change to the port's indexing sources moves the key
    root = tmp_path / "root"
    for d in ("build", "index", "native"):
        shutil.copytree(system.ROOT / system.PORT / d,
                        root / system.PORT / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(system, "ROOT", root)
    before = system.collection_key(cfg)
    (root / system.PORT / "build" / "docproc.py").open("a").write("\n")
    assert system.collection_key(cfg) != before
    new = system.build_collection(cfg, "cpu", lambda m: None)
    assert new != old and new.exists() and old.exists()


def test_work_models_equal_the_ports():
    from open_source_search_engine_tpu_torch import corpus
    from open_source_search_engine_tpu_torch.query import (
        fd_scores_kernel, min_scores_kernel)
    rng = np.random.default_rng(5)
    for T, D in ((4, 256), (8, 512), (16, 128)):
        cube = torch.from_numpy(corpus.rand_cube(rng, T, D).view(np.int32))
        counts = torch.from_numpy(rng.random(T) < 0.8)
        assert workmodel.k1_work(cube, counts) == \
            min_scores_kernel.work(cube, counts)
    for T, tail in ((4, True), (8, False)):
        gq, gs, cube, dead, fw, counts, tl = corpus.fd_inputs(rng, T, 256,
                                                              tail)
        args = [torch.from_numpy(a) if a is not None else None
                for a in (gq, gs, cube, dead, fw, counts, tl)]
        assert workmodel.k2_work(*args) == fd_scores_kernel.work(
            *args[:4], args[5], args[6])


def test_rooflines_count_no_launch_above_its_device_time():
    """A launch's bound over inputs whose every slot holds a posting is
    the most it can be; it stays under the time the bytes alone take."""
    cube = torch.ones((1, 4, 16, 1024), dtype=torch.int32)
    counts = torch.ones((1, 4), dtype=torch.bool)
    nbytes, ops = workmodel.k1_work(cube, counts)
    assert nbytes >= cube.numel() * 4
    pk = workmodel.peaks("NVIDIA H100 80GB HBM3")
    assert workmodel.bound_s(nbytes, ops, pk) == max(nbytes / pk[0],
                                                     ops / pk[1])
    assert workmodel.peaks("cpu") is None


_ISOLATION = r"""
import os, sys
sys.path.insert(0, {root!r})
os.environ.update({env!r})
from pathlib import Path
from portbench import run, system
from portbench.tests import pb_small
system.CACHE = Path({cache!r})
cell, cfg, traffic = pb_small.small({cell!r})
run.run_cell(cell, cfg, traffic, 7, 2.0, False,
             run.cell_metrics(pb_small.bench(), {cell!r}, False),
             device="cpu", ref_cache=system.CACHE)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

_REFERENCE_ONLY = r"""
import sys
sys.path.insert(0, {root!r})
from portbench import reference
from portbench.tests import pb_small
_, cfg, _ = pb_small.small({cell!r})
cfg["corpus"]["n_docs"] = 200
ix = reference.build_index(cfg["corpus"])
reference.answer(ix, "word1 word2 word3", **reference.setting(ix, cfg, "cpu"))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax_and_the_reference_none_of_the_port(cache):
    mods = _top_level(_ISOLATION.format(
        root=str(run.ROOT), env=pb_small.ROUTE_ENV, cache=str(cache),
        cell=CELLS[1]))
    assert "open_source_search_engine_tpu_torch" in mods
    assert not mods & set(run.FORBIDDEN), mods & set(run.FORBIDDEN)
    mods = _top_level(_REFERENCE_ONLY.format(root=str(run.ROOT),
                                             cell=CELLS[0]))
    assert not mods & set(run.FORBIDDEN)
    assert "open_source_search_engine_tpu_torch" not in mods


def test_comparison_names_each_fault(cache):
    _, cfg, _ = pb_small.small(CELLS[0])
    ix = reference.load_index(cfg["corpus"], cache)
    q = "word1 word2 word3 word5 word8"
    a = reference.answer(ix, q, **reference.setting(ix, cfg, "cpu"))
    rows = [(int(ix.docid[i]), s, str(ix.url[i]), str(ix.title[i]))
            for i, s in a.page]
    assert compare.check_page(ix, a.total, rows, a, 1e-4) == (None, 0.0)
    assert "total" in compare.check_page(ix, a.total + 1, rows, a, 1e-4)[0]
    assert "rows" in compare.check_page(ix, a.total, rows[:-1], a, 1e-4)[0]
    bad = [rows[0][:2] + ("http://x/", rows[0][3])] + rows[1:]
    assert "url" in compare.check_page(ix, a.total, bad, a, 1e-4)[0]
    twice = [rows[0]] + rows[:-1]
    assert compare.check_page(ix, a.total, twice, a, 1e-4)[0] is not None


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    pb_small.set_route_env(monkeypatch)
    monkeypatch.setattr(system, "CACHE", tmp_path)
    for cell_name in CELLS:
        cell, cfg, traffic = pb_small.small(cell_name)
        out = run.run_cell(cell, cfg, traffic, SEED, 3.0, True,
                           _metrics(cell_name, True), device="cuda",
                           ref_cache=tmp_path)
        assert out["correct"], out["checks"]
        assert out["device"]["busy_s"] > 0


def test_capture_keeps_a_systematic_sample(monkeypatch):
    """Past its byte budget the capture thins to every step-th launch,
    so what it holds still spans the whole window."""
    monkeypatch.setattr(run, "CAPTURE_BYTES", 10)
    cap = run.Capture()
    cap.on = True
    for i in range(100):
        cap._keep("k2", (i,), 3)
    held = [i for i, _, _ in cap.kept["k2"]]
    step = cap.step["k2"]
    assert cap.launches["k2"] == 100 and cap.held <= 10
    assert held and all(i % step == 0 for i in held)
    assert held[-1] >= 100 - step


def test_rate_counts_each_submitter_to_its_last_completion():
    """A batch in flight at the close leaves neither its queries nor its
    time in the rate."""
    t0 = 100.0
    batches = [(t0, t0 + 2.0, ["q"] * 64, None, 0),
               (t0 + 2.0, t0 + 4.0, ["q"] * 64, None, 0),
               (t0, t0 + 3.0, ["q"] * 64, None, 1)]
    assert run.completed_rate(batches, t0) == pytest.approx(
        128 / 4.0 + 64 / 3.0)
    assert run.completed_rate([], t0) is None

#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (one NVIDIA GPU).

Run from the repository root::

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. probe the card (``torch.cuda.is_available()`` must hold) and print
   its name and power limit as ``nvidia-smi`` reports them;
2. build every kernel of the query paths from the sources in this
   checkout, in parallel (K1: ``csrc/min_scores.cu``, K2:
   ``csrc/fd_scores.cu``);
3. hold K1 against its plain PyTorch version on the card: random cubes
   (T in {4, 8}, P = 16, D in {1000, 1024, 65536}; T in {16, 32, 64,
   128} at D = 1000) and an all-zero cube, rtol=1e-5, atol=1e-7; hold
   K2 against its plain version: both variants (with and without a
   posting tail), T in {4, 8}, D in {1024, 131072}, B = 4, random
   resident cubes with some quarters on the zero slot and some docs
   dead;
4. the flat path: index the synthetic benchmark corpus (N_DOCS docs)
   through ``docproc.index_batch`` in chunks of 512, then answer
   N_QUERIES unique queries through ``engine.search`` with the kernel
   counters reset just before; every scoring pass must launch K1 and
   none may take the plain version. 16 of the queries and the long
   queries (17 to 65 term groups) run again on ``device="cpu"`` over the
   same records: totals and docids equal, scores within rtol=1e-5. K1 is
   timed beside its plain version and its bound on the largest cube;
5. the device-resident route (the main path): build the DeviceIndex
   over the same collection (timed), answer the N_QUERIES queries as one
   ``engine.search_device_batch`` batch with every counter reset just
   before (every FD wave launches K2, K1 runs on the F1 and F2 waves, no
   plain version runs), then each query alone for p50 / max latency.
   Every query's total, scores (rtol=1e-5) and docids (by complete tie
   runs) must equal the flat path's. The device idle share over one
   batch comes from the profiler; K2 on the largest FD wave of the
   batch, and K1 on the largest cube the route gave it, are held against
   their plain versions and timed (L2 cold) beside their bounds. The
   route corpus (``route_docs(48)`` under ``ROUTE_ENV``) then serves F1,
   FD and F2 queries on the card with results equal to the same index on
   ``device="cpu"`` (escalation counts are compared on the CPU only: the
   card's float32 scatter-add sums in no fixed order);
6. run the golden QA suite (``tests/golden``) on the card through the
   flat path and through ``search_device``, against
   ``tests/golden/expected.json``;
7. print the kernels line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 FLOP/s
#: outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

P = 16
TOL = dict(rtol=1e-5, atol=1e-7)

#: the main path's corpus (bench.py's N_DOCS) and unique queries. At
#: 65,536 docs or more the commonest terms fill a whole scoring pass, so
#: K1 runs at full width.
N_DOCS = 100_000
N_QUERIES = 64
assert N_DOCS >= 65_536


def log(msg: str) -> None:
    print(msg, flush=True)


_l2_flush = None


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median per-call milliseconds of ``fn`` on the current stream, by
    CUDA events around each call, with L2 cold: a 256 MiB write before
    each call evicts the H100's 50 MB L2, so inputs come from HBM and
    the time is comparable with a bound at the HBM rate."""
    import torch
    global _l2_flush
    if _l2_flush is None:
        _l2_flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _l2_flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def report_profile(label: str, prof, wall_s: float):
    """Log the device busy and idle share of a profiled window (device-side
    events only: a host op's own entry would count its kernels' time a
    second time) and its six largest device events. Returns the idle
    share, or None when the profiler saw no device time."""
    evs = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")
           and getattr(e, "self_device_time_total", 0) > 0]
    dev_us = sum(e.self_device_time_total for e in evs)
    if dev_us <= 0:
        log(f"[profile] {label}: device time not measured (profiler saw "
            "none)")
        return None
    idle = 1 - dev_us / 1e6 / wall_s
    log(f"[profile] {label}: wall {wall_s * 1e3:.1f} ms, device busy "
        f"{dev_us / 1e3:.2f} ms ({dev_us / 1e6 / wall_s:.2%}), idle "
        f"{idle:.2%}")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   {e.key[:60]}: "
            f"{e.self_device_time_total / 1e3:.3f} ms, {e.count} calls")
    return idle


def as_raw(res):
    """A SearchResults page as a ``search_batch`` tuple."""
    import numpy as np
    return (np.array([r.docid for r in res.results], np.uint64),
            np.array([r.score for r in res.results]), res.total_matches)


def k1_bound(cube, counts):
    """Least time (ms) the card could take for K1 on these inputs, and
    what bounds it. Bytes: the cube, freq_weight and counts read once,
    min_score written once. Operations (fp32, counted for what these
    inputs need): 6 per valid slot of a counted term (weights, squared
    score), 330 per present counted term-doc (the top-10 knock-out over
    32 candidates and its sum), and 15 per valid position pair of a
    counted term pair within MAX_PAIR_SPAN (distance rules, product,
    one division, max)."""
    import torch
    from open_source_search_engine_tpu_torch.query.min_scores_kernel import \
        MAX_PAIR_SPAN
    T, _, D = cube.shape
    nbytes = cube.numel() * 4 + T * 4 + T + D * 4
    nv = (cube != 0).sum(dim=1).to(torch.float64)          # [T, D]
    live = counts[:, None] & (nv > 0)
    nv = torch.where(live, nv, torch.zeros_like(nv))
    pair_evals = 0.0
    for i in range(T):
        for j in range(i + 1, min(i + 1 + MAX_PAIR_SPAN, T)):
            pair_evals += float((nv[i] * nv[j]).sum())
    ops = 6 * float(nv.sum()) + 330 * float(live.sum()) + 15 * pair_evals
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def k2_bound(g_quarter, g_qsyn, cube, dead, counts, tail):
    """Least time (ms) the card could take for K2 on these inputs, and
    what bounds it. Bytes: each distinct quarter row the wave gathers
    read once (4 slots of D words: padded groups and the quarters a term
    leaves empty all point at the one zero slot), the tail when there is
    one, the dead mask, the small per-query arrays, and min_score and
    the bitmask written once. Operations: k1_bound's count over each
    query's assembled cube."""
    import torch
    from open_source_search_engine_tpu_torch.query import \
        fd_scores_kernel as fdk
    B, TQ = g_quarter.shape
    T, D = TQ // 4, dead.shape[0]
    n_quarters = int(torch.unique(g_quarter).numel())
    nbytes = (n_quarters * 4 * D * 4
              + (tail.numel() * 4 if tail is not None else 0)
              + D + B * TQ * 8 + B * T * 5 + B * D * 8)
    ops = 0.0
    for b in range(B):
        c = fdk.assemble(g_quarter, g_qsyn, cube, dead, tail, b)
        ops += k1_bound(c, counts[b])[3]
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def to_card(arrays):
    """numpy arrays (or None) → the same as tensors on the card."""
    import numpy as np
    import torch
    return tuple(None if a is None else
                 torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                 for a in arrays)


def check_golden(q, total, results, expected):
    """The golden suite's contract (tests/test_golden.py::_check): exact
    total, exact 2-decimal score sequence, each docid inside the golden
    tie group of its score, page size, no duplicates."""
    exp = expected[q]
    assert total == exp["total"], f"{q!r}: total {total} != {exp['total']}"
    got = [round(s, 2) for _, s in results]
    want = [s for _, s in exp["results"]][: len(got)]
    assert got == want, f"{q!r}: scores {got} != {want}"
    assert len(results) == min(10, len(exp["results"])), \
        f"{q!r}: page size {len(results)}"
    by_score: dict = {}
    for d, s in exp["results"]:
        by_score.setdefault(round(s, 2), set()).add(int(d))
    for d, s in results:
        assert int(d) in by_score.get(round(s, 2), set()), \
            f"{q!r}: docid {d} not in golden set at {round(s, 2)}"
    assert len({d for d, _ in results}) == len(results), \
        f"{q!r}: duplicate docids"


def main() -> int:
    t_start = time.perf_counter()

    # ---- 1. probe ----
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from open_source_search_engine_tpu_torch.build import docproc
    from open_source_search_engine_tpu_torch.corpus import (
        assert_tie_run_parity, fd_inputs, gen_docs, long_queries,
        make_queries, rand_cube)
    from open_source_search_engine_tpu_torch.index.carry import \
        collection_from_arrays
    from open_source_search_engine_tpu_torch.index.collection import \
        Collection
    from open_source_search_engine_tpu_torch.query import (engine, packer,
                                                           scorer)
    from open_source_search_engine_tpu_torch.query import \
        fd_scores_kernel as fdk
    from open_source_search_engine_tpu_torch.query import \
        min_scores_kernel as msk
    from open_source_search_engine_tpu_torch.query.compiler import \
        compile_query
    from open_source_search_engine_tpu_torch.query.scorer import (
        scatter_cube, to_device)
    from open_source_search_engine_tpu_torch.utils import trace

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind!r} count {torch.cuda.device_count()} "
        f"nvidia-smi: {smi}")

    # ---- 2. build: one nvcc per source, all started together ----
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        builds = list(ex.map(lambda m: m.build(), (msk, fdk)))
    log(f"[build] {', '.join(so.name for so, _ in builds)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for _, report in builds:
        for line in report.splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                log(f"[build]   {line.strip()}")

    # ---- 3. K1 against its plain version on the card ----
    max_err = 0.0
    rng = np.random.default_rng(0)
    shapes = [(T, D) for T in (4, 8) for D in (1000, 1024, 65536)] \
        + [(T, 1000) for T in (16, 32, 64, 128)]
    random_times = []
    for T, D in shapes + [("zero", 1024)]:
        if T == "zero":
            T = 4
            cube_np = np.zeros((T, P, D), np.uint32)
        else:
            cube_np = rand_cube(rng, T, D)
        fw = torch.tensor((rng.random(T) * 0.5 + 0.2).astype(np.float32),
                          device=dev)
        counts = torch.tensor(rng.random(T) < 0.7, device=dev)
        counts[0] = True
        cube = torch.from_numpy(cube_np.view(np.int32)).to(dev)
        got = msk.min_scores_fused(cube, fw, counts)
        want = msk.min_scores_plain(cube, cube != 0, fw, counts)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        line = (f"[k1] T={T} D={D} max_abs_err={err:.3g} "
                f"bitwise={bool(torch.equal(got, want))}")
        if D == 65536:
            ms = cuda_ms(lambda: msk.min_scores_fused(cube, fw, counts))
            pms = cuda_ms(lambda: msk.min_scores_plain(
                cube, cube != 0, fw, counts), reps=5, warmup=1)
            bms, by, nb, ops = k1_bound(cube, counts)
            random_times.append(dict(T=T, D=D, ms=ms, plain_ms=pms,
                                     bound_ms=bms, bound_by=by))
            line += (f" ms={ms:.4f} plain_ms={pms:.3f} bound_ms={bms:.4f}"
                     f" ({by}; {nb} B, {ops:.3g} ops)")
        log(line)

    # ---- 3b. K2 against its plain version on the card ----
    k2_err = 0.0
    for T in (4, 8):
        for D in (1024, 131072):
            for tail in (False, True):
                args = to_card(fd_inputs(rng, T, D, tail))
                ms_k, pres_k = fdk.fd_scores(*args)
                ms_p, pres_p = fdk.fd_scores_plain(*args)
                torch.cuda.synchronize()
                torch.testing.assert_close(ms_k, ms_p, **TOL)
                assert torch.equal(pres_k, pres_p), (T, D, tail)
                err = float((ms_k - ms_p).abs().max())
                k2_err = max(k2_err, err)
                log(f"[k2] T={T} D={D} B=4 tail={tail} max_abs_err="
                    f"{err:.3g} presence_equal=True bitwise="
                    f"{bool(torch.equal(ms_k, ms_p))}")
                del args, ms_k, pres_k, ms_p, pres_p

    # ---- 4. the flat path at full size ----
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    coll = Collection("bench", work / "cuda", device="cuda")
    # both routes score the kernel ranking, as bench.py measures it: no
    # PostQueryRerank, no site clustering (tie order decides clustering)
    coll.conf.pqr_enabled = False
    SC = dict(topk=10, with_snippets=False, site_cluster=False)
    t0 = time.perf_counter()
    chunk: list = []
    for doc in gen_docs(N_DOCS):
        chunk.append(doc)
        if len(chunk) == 512:
            docproc.index_batch(coll, chunk)
            chunk = []
    if chunk:
        docproc.index_batch(coll, chunk)
    coll.dump_all()
    t_index = time.perf_counter() - t0
    log(f"[index] {coll.num_docs} docs in {t_index:.1f} s "
        f"({coll.num_docs / t_index:.1f} docs/s)")
    assert coll.num_docs == N_DOCS, coll.num_docs

    queries = make_queries(N_QUERIES, seed=1234)
    trace.reset()
    msk.launches = 0
    msk.plain_calls = 0
    lat, passes, cuda_res = [], 0, {}
    t0 = time.perf_counter()
    for q in queries:
        t1 = time.perf_counter()
        res = engine.search(coll, q, **SC)
        lat.append((time.perf_counter() - t1) * 1e3)
        passes += res.passes
        cuda_res[q] = res
    wall = time.perf_counter() - t0
    flat_launches, plain_calls = msk.launches, msk.plain_calls
    log(f"[search] {len(queries)} queries: p50 {statistics.median(lat):.2f}"
        f" ms, p99-ish max {max(lat):.2f} ms, {len(queries) / wall:.2f} qps;"
        f" passes {passes}, K1 launches {flat_launches}, plain calls "
        f"{plain_calls}")
    for name, (calls, secs) in sorted(trace.totals.items(),
                                      key=lambda kv: -kv[1][1]):
        log(f"[search]   {name}: {calls} calls, {secs:.3f} s, "
            f"{secs / wall:.1%} of wall")
    assert flat_launches > 0 and flat_launches >= passes, (flat_launches,
                                                          passes)
    assert plain_calls == 0, plain_calls
    for q, res in cuda_res.items():
        for r in res.results:
            assert np.isfinite(r.score) and r.score > 0, (q, r)
        assert len(res.results) <= 10

    # device busy share over 8 queries, from the profiler's device times
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in queries[:8]:
            engine.search(coll, q, **SC)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    report_profile("8 flat queries", prof, prof_wall)

    # the largest cube the main path built: K1 against plain, timed
    big_q = max(queries, key=lambda q: len(packer.prepare_query(
        coll, compile_query(q)).cand))
    pq = packer.pack_pass(packer.prepare_query(coll, compile_query(big_q)),
                          max_docs=1 << 16)
    t = to_device(pq, dev)
    cube, _ = scatter_cube(t[0], t[1], t[2], t[3], len(pq.siterank), P)
    fw, counts = t[4], t[8]
    got = msk.min_scores_fused(cube, fw, counts)
    want = msk.min_scores_plain(cube, cube != 0, fw, counts)
    torch.testing.assert_close(got, want, **TOL)
    max_err = max(max_err, float((got - want).abs().max()))
    k_ms = cuda_ms(lambda: msk.min_scores_fused(cube, fw, counts))
    p_ms = cuda_ms(lambda: msk.min_scores_plain(cube, cube != 0, fw,
                                                counts), reps=5, warmup=1)
    b_ms, b_by, nb, ops = k1_bound(cube, counts)
    log(f"[k1] main-path cube {tuple(cube.shape)} ({big_q!r}): "
        f"ms={k_ms:.4f} plain_ms={p_ms:.3f} bound_ms={b_ms:.5f} ({b_by};"
        f" {nb} B, {ops:.3g} ops) bitwise={bool(torch.equal(got, want))}")

    # CUDA vs CPU over the same records
    t0 = time.perf_counter()
    pos = coll.posdb.get_all()
    tit = coll.titledb.get_all()
    cpu = collection_from_arrays(
        "bench_cpu", work / "cpu", pos.keys, tit.keys, tit.payloads(),
        coll.clusterdb.get_all().keys, coll.sectiondb.rdb.get_all().keys,
        coll.num_docs, device="cpu")
    cpu.conf.pqr_enabled = False
    long_launches = msk.launches
    for q in queries[:16] + long_queries():
        a = cuda_res.get(q) or engine.search(coll, q, **SC)
        b = engine.search(cpu, q, **SC)
        if q not in cuda_res:   # a long query: 17 to 65 term groups
            assert a.total_matches >= 1, (q, a.total_matches)
            assert msk.launches - long_launches >= a.passes, q
            long_launches = msk.launches
        assert a.total_matches == b.total_matches, (q, a.total_matches,
                                                    b.total_matches)
        assert [r.docid for r in a.results] == \
            [r.docid for r in b.results], q
        np.testing.assert_allclose([r.score for r in a.results],
                                   [r.score for r in b.results], rtol=1e-5)
    log(f"[parity] 16 queries and {len(long_queries())} long queries "
        f"CUDA == CPU ({time.perf_counter() - t0:.1f} s)")
    del cpu, pos, tit

    # ---- 5. the device-resident route (the main path) ----
    from open_source_search_engine_tpu_torch.corpus import (ROUTE_ENV,
                                                            ROUTE_QUERIES,
                                                            route_docs)
    from open_source_search_engine_tpu_torch.query.devindex import \
        DeviceIndex
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    di = engine.get_device_index(coll)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"[devindex] built in {t_build:.1f} s: {di.n_docs} docs, D_cap "
        f"{di.D_cap}, {len(di.dense_slot_of)} dense rows (V="
        f"{di.d_dense_imp.shape[0]}), {len(di.cube_slot_of)} cube rows (Vc="
        f"{di.Vc}), {di.Nb} posting slots; resident "
        f"{di.resident_bytes() / 2**30:.3f} GiB, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # the batch, with every counter set to 0 just before; the largest FD
    # wave's inputs and the largest cube K1 scores on the route (F1 phase
    # 2, F2) are kept for checking and timing the kernels below. The
    # wrappers pass the arguments on untouched; nothing on the route
    # writes to them after the call.
    big_fd: list = []
    big_k1: list = []
    fd_scores = fdk.fd_scores
    ms_fused = scorer.min_scores_fused

    def wave_words(args):  # words the wave reads: quarter rows + tail
        return args[0].numel() * (1 if args[-1] is None else 2)

    def keep_largest(*args):
        if not big_fd or wave_words(args) > wave_words(big_fd[0]):
            big_fd[:] = [args]
        return fd_scores(*args)

    def keep_largest_cube(cube, freq_weight, counts, pvalid=None):
        if not big_k1 or cube.numel() > big_k1[0][0].numel():
            big_k1[:] = [(cube, freq_weight, counts, pvalid)]
        return ms_fused(cube, freq_weight, counts, pvalid)
    fdk.fd_scores = keep_largest
    scorer.min_scores_fused = keep_largest_cube
    routes0, esc0 = dict(di.route_counts), di.escalations
    trace.reset()
    torch.cuda.reset_peak_memory_stats()
    msk.launches = msk.plain_calls = 0
    fdk.launches_tail = fdk.launches_notail = fdk.plain_calls = 0
    try:
        t0 = time.perf_counter()
        batch = engine.search_device_batch(coll, queries, **SC)
        t_batch = time.perf_counter() - t0
    finally:
        fdk.fd_scores = fd_scores
        scorer.min_scores_fused = ms_fused
    k1_dev = msk.launches
    k2_launches = fdk.launches_tail + fdk.launches_notail
    k2_split = (fdk.launches_tail, fdk.launches_notail)
    plain_dev = msk.plain_calls + fdk.plain_calls
    routes = {k: di.route_counts[k] - routes0[k] for k in routes0}
    escalations = di.escalations - esc0
    log(f"[device] batch of {len(queries)}: {t_batch * 1e3:.1f} ms "
        f"({len(queries) / t_batch:.2f} qps); routes {routes}, escalations "
        f"{escalations}; K1 launches {k1_dev}, K2 launches {k2_launches} "
        f"(tail {k2_split[0]}, no tail {k2_split[1]}), plain calls "
        f"{plain_dev}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, (calls, secs) in sorted(trace.totals.items(),
                                      key=lambda kv: -kv[1][1]):
        log(f"[device]   {name}: {calls} calls, {secs:.3f} s, "
            f"{secs / t_batch:.1%} of the batch")
    assert sum(routes.values()) == len(queries), routes
    assert routes["fd"] > 0 and k2_launches > 0, (routes, k2_launches)
    assert routes["f1"] + routes["f2"] > 0 and k1_dev > 0 and big_k1, \
        (routes, k1_dev)
    assert plain_dev == 0, plain_dev
    for q, res in zip(queries, batch):
        assert_tie_run_parity(as_raw(res), as_raw(cuda_res[q]), q)
    log(f"[device] {len(queries)} queries match the flat path (totals, "
        "scores rtol=1e-5, docids by complete tie runs)")

    # the same batch again, warm (allocator pools, library handles and the
    # pinned fetch buffer exist now): the steady-state batch time
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.search_device_batch(coll, queries, **SC)
        warm.append(time.perf_counter() - t0)
    t_warm = statistics.median(warm)
    log(f"[device] warm batch of {len(queries)}, median of 3: "
        f"{t_warm * 1e3:.1f} ms ({len(queries) / t_warm:.2f} qps)")

    lat_dev = []
    for q in queries:
        t1 = time.perf_counter()
        engine.search_device(coll, q, **SC)
        lat_dev.append((time.perf_counter() - t1) * 1e3)
    log(f"[device] one query at a time: p50 {statistics.median(lat_dev):.2f}"
        f" ms, max {max(lat_dev):.2f} ms")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search_device_batch(coll, queries, **SC)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev_idle = report_profile(f"device batch of {len(queries)}", prof,
                              prof_wall)

    # K2 on the largest FD wave of the batch: against plain, timed
    args = big_fd[0]
    ms_k, pres_k = fdk.fd_scores(*args)
    ms_p, pres_p = fdk.fd_scores_plain(*args)
    torch.testing.assert_close(ms_k, ms_p, **TOL)
    assert torch.equal(pres_k, pres_p)
    k2_err = max(k2_err, float((ms_k - ms_p).abs().max()))
    k2_ms = cuda_ms(lambda: fdk.fd_scores(*args))
    k2_plain_ms = cuda_ms(lambda: fdk.fd_scores_plain(*args), reps=3,
                          warmup=1)
    k2_b_ms, k2_by, k2_nb, k2_ops = k2_bound(args[0], args[1], args[2],
                                             args[3], args[5], args[6])
    k2_shape = dict(B=args[0].shape[0], T=args[0].shape[1] // 4,
                    D=args[3].shape[0], tail=args[6] is not None)
    log(f"[k2] main-path wave {k2_shape}: ms={k2_ms:.4f} plain_ms="
        f"{k2_plain_ms:.3f} bound_ms={k2_b_ms:.5f} ({k2_by}; {k2_nb} B, "
        f"{k2_ops:.3g} ops) bitwise={bool(torch.equal(ms_k, ms_p))}")

    # K1 on the largest cube the device route gave it: against plain,
    # timed
    k1d_cube, k1d_fw, k1d_counts, k1d_pv = big_k1[0]
    if k1d_pv is None:
        k1d_pv = k1d_cube != 0
    got = msk.min_scores_fused(k1d_cube, k1d_fw, k1d_counts)
    want = msk.min_scores_plain(k1d_cube, k1d_pv, k1d_fw, k1d_counts)
    torch.testing.assert_close(got, want, **TOL)
    max_err = max(max_err, float((got - want).abs().max()))
    k1d_ms = cuda_ms(lambda: msk.min_scores_fused(k1d_cube, k1d_fw,
                                                  k1d_counts))
    k1d_plain_ms = cuda_ms(lambda: msk.min_scores_plain(
        k1d_cube, k1d_pv, k1d_fw, k1d_counts), reps=5, warmup=1)
    k1d_b_ms, k1d_by, nb, ops = k1_bound(k1d_cube, k1d_counts)
    k1d_shape = list(k1d_cube.shape)
    log(f"[k1] device-route cube {tuple(k1d_shape)}: ms={k1d_ms:.4f} "
        f"plain_ms={k1d_plain_ms:.3f} bound_ms={k1d_b_ms:.5f} ({k1d_by}; "
        f"{nb} B, {ops:.3g} ops) bitwise={bool(torch.equal(got, want))}")
    del args, big_fd, ms_k, pres_k, ms_p, pres_p, big_k1, k1d_cube, \
        k1d_fw, k1d_counts, k1d_pv, got, want, di
    coll._device_index = None

    # the route corpus: F1, FD and F2 each serve a query, on the card as
    # on the CPU
    saved = {k: os.environ.get(k) for k in ROUTE_ENV}
    os.environ.update(ROUTE_ENV)
    try:
        rc = Collection("route", work / "route", device="cuda")
        docproc.index_batch(rc, route_docs(48))
        rc.posdb.dump()
        rc.titledb.dump()
        rq = list(ROUTE_QUERIES) + ["alpha gamma", "alpha beta gamma"]
        on_card, on_cpu = DeviceIndex(rc), DeviceIndex(rc, device="cpu")
        got, want = on_card.search_batch(rq, topk=64), \
            on_cpu.search_batch(rq, topk=64)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert on_card.route_counts == on_cpu.route_counts, \
        (on_card.route_counts, on_cpu.route_counts)
    assert min(on_card.route_counts.values()) >= 1, on_card.route_counts
    # F1's float32 bound scatter-add takes atomics on the card, so its sum
    # order (and, at a last-bit tie, an escalation) may vary from run to
    # run: escalation counts are compared on the CPU only (the tests)
    assert on_card.escalations >= 1, on_card.escalations
    for q, a, b in zip(rq, got, want):
        assert_tie_run_parity(a, b, q)
    log(f"[route] route_docs(48): routes {on_card.route_counts}, "
        f"escalations {on_card.escalations} (CPU {on_cpu.escalations}); "
        "CUDA == CPU")
    del on_card, on_cpu

    # ---- 6. golden QA on the card ----
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "golden_corpus", ROOT / "tests" / "golden" / "corpus.py")
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    expected = json.loads(
        (ROOT / "tests" / "golden" / "expected.json").read_text())
    gold = Collection("golden", work / "golden", device="cuda")
    gold.conf.pqr_enabled = False
    for url, html in golden.golden_docs().items():
        docproc.index_document(gold, url, html)
    for q in golden.GOLDEN_QUERIES:
        for search in (engine.search, engine.search_device):
            res = search(gold, q, topk=10, site_cluster=False,
                         with_snippets=False)
            check_golden(q, res.total_matches,
                         [(r.docid, r.score) for r in res.results], expected)
    log(f"[golden] {len(golden.GOLDEN_QUERIES)} queries match expected.json"
        " on the flat path and on the device route")
    shutil.rmtree(work, ignore_errors=True)

    # ---- 7. report ----
    kernels = {"kernels": [{
        "name": "min_scores", "route": "cuda",
        "source": "open_source_search_engine_tpu_torch/csrc/min_scores.cu",
        "replaces": "open_source_search_engine_tpu/query/pallas_scores.py"
                    ":173",
        "launches": k1_dev, "max_abs_err": max_err,
        "ms": k1d_ms, "plain_ms": k1d_plain_ms, "bound_ms": k1d_b_ms,
        "bound_by": k1d_by, "library_ms": None, "parity": "pass",
        "shape": k1d_shape,
        "launches_flat_path": flat_launches, "ms_flat_path": k_ms,
        "plain_ms_flat_path": p_ms, "bound_ms_flat_path": b_ms,
        "bound_by_flat_path": b_by, "shape_flat_path": list(cube.shape),
        "random_cubes": random_times,
    }, {
        "name": "fd_scores", "route": "cuda",
        "source": "open_source_search_engine_tpu_torch/csrc/fd_scores.cu",
        "replaces": "open_source_search_engine_tpu/query/pallas_scores.py"
                    ":226",
        "launches": k2_launches, "launches_tail_notail": list(k2_split),
        "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_b_ms, "bound_by": k2_by, "library_ms": None,
        "parity": "pass", "shape": k2_shape,
    }], "device_route": {
        "build_s": t_build, "batch_ms": t_batch * 1e3,
        "batch_qps": len(queries) / t_batch,
        "warm_batch_ms": t_warm * 1e3, "warm_batch_qps": len(queries) / t_warm,
        "single_p50_ms": statistics.median(lat_dev),
        "single_max_ms": max(lat_dev), "routes": routes,
        "escalations": escalations, "device_idle": dev_idle}}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (one NVIDIA GPU).

Run from the repository root::

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (another checkout of the port, e.g. an unpacked
``git archive`` of the parent commit) also builds that checkout's K1 and
K2 and times them, with the same timer, on every input this script
times, after checking them bitwise against this checkout's.

Phases, each fatal on failure (non-zero exit, no result line):

0. the port's doctor (``utils/devdoctor.py``): torch and CUDA versions,
   the card's name, count, capability and free memory, and both kernels
   built and loaded; any verdict but ``ok`` fails the run. The card's
   peaks for every bound come from devwatch's table (``GPU_PEAKS``);
1. probe the card (``torch.cuda.is_available()`` must hold) and print
   its name and power limit as ``nvidia-smi`` reports them;
2. build every kernel of the query paths from the sources in this
   checkout, in parallel (K1: ``csrc/min_scores.cu``, K2:
   ``csrc/fd_scores.cu``), and read each instantiation's registers and
   static shared memory from the ``-Xptxas=-v`` report; the native host
   core's two libraries (``native/doccore.cpp``, ``native/rdbcore.cpp``)
   build with ``g++`` beside them;
3. hold K1 bitwise against its plain PyTorch version on the card: random
   cubes (T in {4, 8}, P = 16, D in {1000, 1001, 1024, 65536}; T in {16,
   32, 64, 128} at D = 1000), batched waves of B = 3 at D = 1001 (rows
   that are not 16-byte aligned, a ragged last tile; T in {4, 8, 16,
   32}) and an all-zero cube; hold K2 bitwise against its plain version:
   both variants (with and without a posting tail), T in {4, 8}, D in
   {1001, 1024, 131072}, B = 4, random resident cubes with some quarters
   on the zero slot and some docs dead;
4. the flat path: index the synthetic benchmark corpus (N_DOCS docs)
   through ``docproc.index_batch`` in chunks of 512, through the native
   host core (the run fails if either library did not load: no quiet
   fall back to the Python path), with its docs/s beside the card's
   name and power limit; then [native]: the first NATIVE_SLICE pages
   indexed into two fresh collections, natively and through the Python
   path (``native.get_doccore`` and ``native.available`` report no
   library, in process), both force-merged, every Rdb's runs and the
   titlerecs bitwise equal, both rates and merge times printed; then
   answer
   N_QUERIES unique queries through ``engine.search`` with the kernel
   counters reset just before; every scoring pass must launch K1 and
   none may take the plain version. 4 of the queries and the long
   queries (17 to 65 term groups) run again on ``device="cpu"`` over the
   same records: totals and docids equal, scores within rtol=1e-5. K1 is
   timed beside its plain version and its bound on the largest cube, and
   on the largest real cubes of 5-8 and 9-16 word queries (T = 8, 16);
5. the device-resident route (the main path):

   (5a) build the DeviceIndex over the same collection through the
   device ingest plane (``build/devbuild.py``), timed, with the spans of
   its stages (host staging, upload, the base program, the directory
   fetch, dense rows, doc meta, cube rows) and the peak allocated
   memory; then build it again through the host oracle
   (``OSSE_DEVBUILD=0``, timed) and hold every column and directory
   table bitwise equal; the oracle writes the run set's disk base cache;
   the collection's parked tenant cold-starts through the device build
   (timed), and a DeviceIndex built with the device build off reads the
   cache (timed, bitwise equal again); each later phase prints which of
   the three sources built its base;

   answer the N_QUERIES queries as one ``engine.search_device_batch``
   batch with every counter reset just before (every FD wave launches
   K2; K1 makes one launch per F1 wave call and one per F2 query, and
   the script counts both; no plain version runs), then each query
   alone for p50 / max latency. Every query's total, scores (rtol=1e-5)
   and docids (by complete tie runs) must equal the flat path's. The
   device busy time and idle share over one warm batch, and K2's share
   of it, come from the profiler; K2 on the largest FD wave of the
   batch, and K1 on the largest batched F1 call ``[B, T, 16, κ2]``, are
   held bitwise against their plain versions and timed (L2 cold) beside
   their bounds. A batch of 16 queries of 5-8 words (T = 8) must equal
   the flat path too, and K2 is checked and timed on its largest wave;

   (5b) resident serving, the counters reset just before: the batch
   through ``search_device_batch(resident=True)`` (the collection's
   ResidentLoop, owned by the tenant plane) must equal the one-shot
   batch bitwise (totals, docids, scores), with K1 and K2 launched and
   no plain call; then 4 client threads each send their 16 queries one
   at a time, concurrently, and each must get its own results: qps, per
   query p50 / max, the loop's waves, and the device busy time and idle
   share over the run (profiler);

   (5c) freshness and the background rebuild: 8 new pages written to
   the memtable are served by the next resident answer (its generation
   moved); after ``dump_all()`` ``get_device_index`` returns the old
   index while the rebuild runs (the flag is asserted), a batch is
   served meanwhile, and after the swap the resident answers equal a
   DeviceIndex built from scratch (columns bitwise); at the default
   process budget no merge was refused and no Rdb holds more than
   ``max_runs`` runs;

   (5d) served over HTTP, the node's entry point: ``SearchHTTPServer``
   over the same collection (the bench collection lives in the port's
   ``CollectionDb`` from phase 4 on), the 64 queries as 4 clients x 16
   and as 16 clients x 4, result cache off, each counted from 0 just
   before: every page equals ``render_results`` of an in-process
   ``search_device_batch(resident=True)`` with the server's defaults
   (snippets and clustering on: scores rtol=1e-5, docids by complete
   tie runs, every other field exact), K1 and K2 launch, no plain
   version runs, ``serve.device_error`` stays 0; qps, per-request p50 /
   max, the batcher's batches and mean size, the loop's waves, the wall
   split between the ``serve.search`` and device-batch spans, and the
   device busy time and idle share of each pass run again under the
   profiler. Then the 64 with the result cache on, filled and read back
   byte-identical with no kernel launched; a POST /inject whose fresh
   word the next /search finds (and a cached query misses after it);
   and with ``checkify`` on, the 64 trip nothing while an injected fault
   trips, is counted and answers 500;

   (5j) the telemetry plane (``telemetry``, after (5d)): devwatch armed
   and the tenant rebuilt, its HBM ledger equal to ``resident_bytes()``
   column by column, no other index alive, the allocator's live bytes
   within ``ALLOC_SLACK`` (1 GiB) of the ledger, ``reconcile()`` printed
   (allocated, peak, free, fragmentation); one armed window of the resident batch of 64 and 4
   resident clients x 16 in which the flight recorder's waves equal the
   loop's, the rounds' escalations the index's, and the ``min_scores``
   and ``fd_scores`` roofline dispatches the wrappers' launches; the
   armed overhead (off and armed alternated, 3 pairs, medians, printed
   and not gated); each roofline entry's bytes, operations, intensity
   and verdict against the card's ridge; jitwatch armed over a warm
   batch (compiles, transfers by site, off-boundary transfers and
   syncs); ``/admin/hbm``, ``/admin/device``, ``/admin/jit``,
   ``/admin/profiler`` (start, stop) and ``/admin/graph`` answering 200
   and ``/metrics``' ``osse_hbm_bytes`` equal to the ledger;

   (5e) the numeric operators over the same collection (every page has
   a ``date`` fielddb record): 16 of the queries plain, with a date
   range (the 25th to 75th percentile), with ``gbsortby:date`` and with
   ``gbsortbyrev:date``, through the flat path, the one-shot device
   route, the resident loop and ``/search`` (16 clients, mixed specs
   coalesced): every page equal to the flat path's, every date in range
   and in order, filtered totals equal to a host count, K1 and K2
   launched on the filtered and sorted waves, which take F1 and FD;

   (5f) the route corpus (``route_docs(48)`` under ``ROUTE_ENV``, with a
   tagdb siterank override, a ``sitepathdepth`` site, catdb categories
   and two pages linking to each other) serves plain, filtered and
   sorted F1, FD and F2 queries on the card with results and escalation
   counts equal to the same index on ``device="cpu"``;

   (5k) a crawled corpus on the card (``crawled_corpus``, after (5f)):
   the first CRAWL_DOCS pages of the corpus served over HTTP in this
   process by :class:`CrawlSite` (one listener per site on its own
   loopback address, each page with a link block, every site's
   ``robots.txt`` disallowing ``/private``), crawled by a crawlbot job
   created through ``SearchHTTPServer``'s ``/crawlbot`` with the real
   Fetcher: every allowed page indexed, every ``/private/`` link
   robots-blocked, no error, the seconds, pages/s and the frontier
   journal's fsyncs (count and seconds, timed here) printed beside the
   card; the 64 queries to ``/search?c=crawl_bench`` with the counters
   reset just before, each page equal to the flat path's ``engine.search``
   on the card (totals, scores rtol=1e-5, docids by tie runs, site
   clustering on), K1 launched, no plain version, no device error; then
   the job deleted with devwatch armed (no tenant, no ledger bytes, no
   directory) and a job of the same name crawling one site afresh;

   (5g) the durable node over the same collection (``durability``), at
   the default process budget: a ``save_all()`` adds no run and empties no memtable (run counts and
   memtable records printed before and after); the collection reopened
   in process (runs verified with their CRCs, the checkpoint loaded,
   the journal replayed) answers the queries bitwise as before the save,
   its open and first batch timed; a forced daily merge of every Rdb
   while 4 resident clients send the queries (posdb's runs merged in one
   call of the native core's ``merge_runs``, counted), every page equal
   to the page before it, the merge's seconds and the seconds to the
   rebuilt base's swap printed, and the swapped index equal to one
   built from scratch; then a child ``serve`` node on the card takes 16 POST
   /inject, each answered 200, and is killed with SIGKILL: the restarted
   node finds each of the 16 and answers all 80 pages as before the
   kill, its spawn-to-first-page seconds printed. Every wait there has a
   deadline and the child is killed on any failure;

   (5h) the mesh at full width on one card (``mesh``, run before (5g)):
   the bench collection, saved, is presented as shard 0 of a 1-shard
   grid and resharded 1 -> 4 by ``control.rebalance.rebalance`` (timed);
   ``engine.get_mesh_resident`` builds the four per-shard bases on
   ``cuda:0`` (doc counts, base bytes, peak allocated; the memory check
   releases the flat tenant only if four bases at the per-index budget
   would not fit beside it). The host merge (``MeshResident.search_batch``,
   site clustering off) answers the 64 queries equal to the flat device
   route (totals, scores rtol=1e-5, docids by complete tie runs), with
   its routes per shard, escalations and K1 and K2 launches, K2 held
   bitwise on its largest per-shard FD wave; the in-program merge
   (``serve_batch``, 2-per-site dedup) and ``sharded_search`` answer 16
   queries each, equal to the host merge with clustering on
   (``clustered`` exact), K1 launching once per wave and held bitwise
   against its plain version on the largest stacked ``[S·B, T, 16, D]``
   cube, timed beside its bound, with the host packing's share, the
   merge's time and the escalations; 4 resident clients over the mesh
   loop (qps, p50, max, waves); ``SearchHTTPServer(sharded=...)`` with
   ``serve_mesh`` on and off, 4 clients x 4 queries, every page equal to
   the in-process page, ``/admin/hosts`` reporting 4 shards and their
   doc counts, no device error;

   (5i) the cluster on the card (``cluster_fleet``, after (5h)): (5h)'s
   saved 4-shard grid, copied, served by four node processes of the
   ``node`` verb on the device route (``FleetManager``), each its own
   CUDA context on the one card. Before the spawn, each shard directory's
   legs and their merge are computed in this process and its bases
   released. Each node's spawn-to-ready seconds, doc count and card
   memory (``nvidia-smi --query-compute-apps``); the queries through
   ``ClusterClient.search_batch`` cold and warm (site clustering off):
   each node's legs bitwise equal to the in-process device route over
   its shard, every merged page equal to the in-process merge, every
   total equal to the flat device route's; each node's K1 and K2
   launches over ``/rpc/stats`` (> 0 in sum; 0 plain calls, 0 device
   errors); 4 clients x 16 through ``ClusterClient.search`` (qps, p50,
   max); the ``proxy`` path (``SearchHTTPServer(cluster=...)``) serving 4
   HTTP clients x 16, every page equal to the client's, with
   ``/admin/hosts`` (4 live shards), ``/admin/transport`` (each node's
   new connections bounded by the client's in-flight bound, most RPCs on
   a reused connection) and ``/admin/perf`` (every node's ``node.search``
   merged); 8 POST /inject through the proxy, each on its owning shard
   and found; a SIGKILL of one node, a degraded answer while it is down,
   its respawn by the supervisor with its journal replayed, the 8 pages
   found and the queries answered as before the kill; a teardown that
   leaves no process. The nodes run with ``OSSE_DEVWATCH=1``: each
   node's ``hbm.devindex.bytes`` (over ``/rpc/stats``) equals the
   ``resident_bytes()`` of the base built in process over its shard;
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

#: the card's peaks (HBM bytes/s, fp32 FLOP/s outside the tensor cores),
#: read once the card is known from devwatch's table (``GPU_PEAKS``: the
#: NVIDIA data sheet's H100 SXM and PCIe figures), the one copy
PEAK_BYTES_S: float | None = None
PEAK_FP32_S: float | None = None

P = 16

#: the main path's corpus (bench.py's N_DOCS) and unique queries. At
#: 65,536 docs or more the commonest terms fill a whole scoring pass, so
#: K1 runs at full width.
N_DOCS = 100_000
N_QUERIES = 64
assert N_DOCS >= 65_536

#: (5j): the most the allocator's live bytes may exceed the HBM ledger by
ALLOC_SLACK = 1 << 30

#: [native]: the first pages of the main path's corpus, indexed through
#: both host paths
NATIVE_SLICE = 2048

#: (5k): the first pages of the main path's corpus, served over HTTP on
#: one loopback address per site and crawled through /crawlbot. Cut from
#: 4,096: on the H100 machine's host those took 147.7 s to crawl (28.4
#: pages/s, each page indexed alone with its inlink propagation), past
#: the 60 s the crawl may take of the run
CRAWL_DOCS = 2048
#: (5k): every CRAWL_PRIVATE_EVERY-th site's root page links to its
#: robots-disallowed /private/ page
CRAWL_PRIVATE_EVERY = 8


def log(msg: str) -> None:
    print(msg, flush=True)


_l2_flush = None


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median per-call milliseconds of ``fn`` on the current stream, by
    CUDA events around each call, with L2 cold: a 256 MiB write before
    each call evicts the H100's 50 MB L2, so inputs come from HBM and
    the time is comparable with a bound at the HBM rate. A ~1 ms spin
    kernel after the write keeps the card busy while the host enqueues
    the first event and ``fn``'s launches, so the time is the device's
    alone, not the host's launch overhead (tens of microseconds a
    wrapper call, as much as a small kernel takes)."""
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
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def report_profile(label: str, prof, wall_s: float):
    """Log the device busy and idle share of a profiled window (device-side
    events only: a host op's own entry would count its kernels' time a
    second time) and its six largest device events. Returns (idle share,
    device busy ms, {kernel: (ms, calls)} for K1's and K2's kernels), or
    None when the profiler saw no device time."""
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
    ours = {}
    for name in ("min_scores", "fd_scores"):
        mine = [e for e in evs if f"{name}_" in e.key]
        ours[name] = (sum(e.self_device_time_total for e in mine) / 1e3,
                      sum(e.count for e in mine))
        log(f"[profile]   {name} kernels: {ours[name][0]:.3f} ms "
            f"({ours[name][0] * 1e3 / dev_us:.1%} of busy), "
            f"{ours[name][1]} calls")
    return idle, dev_us / 1e3, ours


def ptxas_usage(report: str) -> dict:
    """{entry: (registers, static shared bytes)} from an ``nvcc
    -Xptxas=-v`` report."""
    import re
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry] = (int(m.group(1)), int(smem.group(1)) if smem else 0)
            entry = None
    return out


def usage_of(usage: dict, fragment: str):
    """(registers, static shared bytes) of the one entry whose mangled
    name holds ``fragment``, e.g. ``fd_scores_kernelILi4ELb1E`` for
    ``fd_scores_kernel<4, true>``; (None, None) when the report has no
    such entry (a library loaded from an earlier build without one)."""
    hits = [v for k, v in usage.items() if fragment in k]
    if len(hits) != 1:
        log(f"[build] no single ptxas entry for {fragment}: {len(hits)}")
        return None, None
    return hits[0]


def tile_docs(T: int) -> int:
    """Docs per block of a staged kernel at T term groups (stage.cuh)."""
    return 128 if T <= 4 else (64 if T <= 8 else 32)


def k1_smem(T: int) -> int:
    """K1's dynamic shared memory per block: the [T·16, TD] tile of the
    staged instantiations (T <= 16), none for the direct-load ones."""
    return T * P * tile_docs(T) * 4 if T <= 16 else 0


def k2_smem(T: int, tail: bool) -> int:
    """K2's dynamic shared memory per block: the tile, plus one group's
    tail rows [16, TD] with a tail."""
    return (T + int(tail)) * P * tile_docs(T) * 4


def load_parent(root: Path):
    """The kernel wrappers (K1, K2) of another checkout of the port, such
    as the parent commit's, imported under the package name
    ``parent_port`` so that they sit beside this checkout's."""
    import importlib
    import importlib.util
    pkg = root / "open_source_search_engine_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("parent_port.query.min_scores_kernel"),
            importlib.import_module("parent_port.query.fd_scores_kernel"))


def as_raw(res):
    """A SearchResults page as a ``search_batch`` tuple."""
    import numpy as np
    return (np.array([r.docid for r in res.results], np.uint64),
            np.array([r.score for r in res.results]), res.total_matches)


def k1_bound(cube, counts):
    """Least time (ms) the card could take for K1 on these inputs (one
    query's [T, P, D] cube or a wave's [B, T, P, D]), and what bounds it:
    the larger of the bytes over the HBM rate and the fp32 operations
    over the peak, both counted by ``min_scores_kernel.work`` (what these
    inputs need). Returns (ms, "bytes" | "operations", bytes, ops)."""
    from open_source_search_engine_tpu_torch.query.min_scores_kernel import \
        work
    nbytes, ops = work(cube, counts)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def k2_bound(g_quarter, g_qsyn, cube, dead, counts, tail):
    """Least time (ms) the card could take for K2 on these inputs, and
    what bounds it, from ``fd_scores_kernel.work``: each distinct quarter
    row read once, the tail, the dead mask, the small per-query arrays and
    the outputs; K1's operation count over each query's assembled cube."""
    from open_source_search_engine_tpu_torch.query.fd_scores_kernel import \
        work
    nbytes, ops = work(g_quarter, g_qsyn, cube, dead, counts, tail)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def k1_plain(msk, cube, pvalid, freq_weight, counts):
    """K1's plain version on one query's [T, P, D] cube or, query by
    query, on a wave's [B, T, P, D]."""
    import torch
    if cube.dim() == 3:
        return msk.min_scores_plain(cube, pvalid, freq_weight, counts)
    return torch.stack([msk.min_scores_plain(cube[b], pvalid[b],
                                             freq_weight[b], counts[b])
                        for b in range(cube.shape[0])])


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


def http_get(base: str, path: str, params: dict):
    """(status, body) of one GET; an HTTP error status is returned, not
    raised."""
    import urllib.error
    import urllib.parse
    import urllib.request
    url = f"{base}{path}?{urllib.parse.urlencode(params)}"
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def http_post(base: str, path: str, params: dict, body: str):
    """(status, body) of one POST; an HTTP error status is returned."""
    import urllib.error
    import urllib.parse
    import urllib.request
    req = urllib.request.Request(
        f"{base}{path}?{urllib.parse.urlencode(params)}",
        data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def http_clients(base: str, queries, n_clients: int, coll: str):
    """``n_clients`` threads, each sending its share of ``queries`` one
    request at a time (``/search?c=<coll>&format=json&n=10``). Returns the wall
    seconds, the per-request milliseconds and {query: body}; every
    answer must be 200."""
    import threading
    lat, pages, errors = [], {}, []
    start = threading.Barrier(n_clients)

    def client(c):
        try:
            start.wait(timeout=60)
            for q in queries[c::n_clients]:
                t1 = time.perf_counter()
                code, body = http_get(base, "/search", {
                    "q": q, "c": coll, "format": "json", "n": 10})
                lat.append((time.perf_counter() - t1) * 1e3)
                assert code == 200, (q, code, body[:300])
                pages[q] = body
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append((c, repr(exc)))

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in clients), "a client hung"
    assert not errors, errors
    assert len(lat) == len(queries)
    return wall, lat, pages


def serve_over_http(colldb, coll, queries, work, reset_counts, profile_fn):
    """(5d) the node's HTTP entry point on the card: SearchHTTPServer
    over the bench collection, the 64 queries as 4 clients x 16 and as 16
    clients x 4 (result cache off), each page equal to ``render_results``
    of an in-process ``search_device_batch(resident=True)`` with the
    server's defaults (snippets and site clustering on); K1 and K2 launch,
    no plain version runs and no device batch fails. Then the cached pass
    (byte-identical, no launch), a write through POST /inject (found by
    the next /search, and the cache misses), and the guardrails (the 64
    trip nothing; an injected fault trips, is counted and answers 500).
    Returns the phase's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from open_source_search_engine_tpu_torch.corpus import assert_pages_match
    from open_source_search_engine_tpu_torch.query import devcheck, engine
    from open_source_search_engine_tpu_torch.query import \
        fd_scores_kernel as fdk
    from open_source_search_engine_tpu_torch.query import \
        min_scores_kernel as msk
    from open_source_search_engine_tpu_torch.serve.server import (
        SearchHTTPServer, render_results)
    from open_source_search_engine_tpu_torch.utils.stats import g_stats

    t_phase = time.perf_counter()
    coll.conf.result_cache_ttl = 0
    # a query's first answer on a fresh index escalates, and its cached
    # plan keeps the wider floor (as in the reference): the repeats order
    # equal scores from that floor, which can change the page inside a
    # tie run and its clustered count. One warming batch first, so the
    # reference and the served pages both come from the learned plans.
    engine.search_device_batch(coll, queries, topk=10, resident=True)
    ref = {q: render_results(r, "json")[0] for q, r in zip(
        queries, engine.search_device_batch(coll, queries, topk=10,
                                            resident=True))}
    loop = engine.get_resident_loop(coll)
    srv = SearchHTTPServer(work / "cuda", port=0, device="cuda",
                           colldb=colldb)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    out = {}
    try:
        http_clients(base, queries[:8], 4, coll.name)   # connections, threads warm
        for n_clients in (4, 16):
            g_stats.reset()
            reset_counts()
            b0 = (srv._batcher.batches, srv._batcher.batched_queries)
            w0 = loop.waves_issued
            wall, lat, pages = http_clients(base, queries, n_clients, coll.name)
            kl = (msk.launches, fdk.launches_tail + fdk.launches_notail,
                  msk.plain_calls + fdk.plain_calls)
            nb = srv._batcher.batches - b0[0]
            nq = srv._batcher.batched_queries - b0[1]
            lats = g_stats.latencies
            split = {name: lats[name].total_ms for name in (
                "serve.search", "query.device_batch", "query.results_batch")
                if name in lats}
            errs = g_stats.counters.get("serve.device_error", 0)
            for q in queries:
                assert_pages_match(pages[q], ref[q], q)
            assert kl[0] > 0 and kl[1] > 0 and kl[2] == 0, kl
            assert errs == 0, errs
            r = dict(clients=n_clients, qps=len(queries) / wall,
                     p50_ms=statistics.median(lat), max_ms=max(lat),
                     batches=nb, mean_batch=nq / nb, waves=loop.waves_issued
                     - w0, k1_launches=kl[0], k2_launches=kl[1],
                     span_ms=split)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pwall = http_clients(base, queries, n_clients, coll.name)[0]
                torch.cuda.synchronize()
            prof_r = profile_fn(f"{n_clients} HTTP clients", prof, pwall)
            r["device_idle"], r["device_busy_ms"] = (
                prof_r[:2] if prof_r else (None, None))
            r["profiled_wall_ms"] = pwall * 1e3
            out[f"clients_{n_clients}"] = r
            log(f"[serve] {n_clients} clients x {len(queries) // n_clients}"
                f" over HTTP: {wall * 1e3:.1f} ms, {r['qps']:.2f} qps; per "
                f"request p50 {r['p50_ms']:.2f} ms, max {r['max_ms']:.2f} "
                f"ms; batcher {nb} batches (mean {r['mean_batch']:.2f} "
                f"queries), loop waves {r['waves']}; K1 launches {kl[0]}, K2"
                f" launches {kl[1]}, plain calls {kl[2]}, device errors "
                f"{errs}; every page equals the in-process resident batch")
            log(f"[serve]   wall split (sums over the pass): "
                + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
                + (f"; device batch / serve.search "
                   f"{split['query.device_batch'] / split['serve.search']:.1%}"
                   if "query.device_batch" in split else ""))
        # the result cache: a pass to fill it, then the 64 again: every
        # page byte-identical, no kernel launched
        coll.conf.result_cache_ttl = 60.0
        filled = http_clients(base, queries, 4, coll.name)[2]
        reset_counts()
        hits0 = srv.stats.get("result_cache_hits", 0)
        wall, lat, pages = http_clients(base, queries, 1, coll.name)
        kl = (msk.launches, fdk.launches_tail + fdk.launches_notail)
        assert all(pages[q] == filled[q] for q in queries)
        assert kl == (0, 0), kl
        assert srv.stats["result_cache_hits"] - hits0 == len(queries)
        out["cached_pass_ms"] = wall * 1e3
        out["cached_p50_ms"] = statistics.median(lat)
        log(f"[serve] cached pass of {len(queries)}: {wall * 1e3:.1f} ms "
            f"(p50 {out['cached_p50_ms']:.3f} ms), every page byte-identical"
            f" to the filling pass, K1/K2 launches {kl}")
        # a write: POST /inject, found by the next /search; a cached
        # query misses after it (the generation moved)
        import urllib.request
        word = "zqxvservedword"
        req = urllib.request.Request(
            f"{base}/inject?c={coll.name}&u=http://served-fresh.example.com/",
            data=(f"<html><title>{word}</title><body><p>{word}</p>"
                  "</body></html>").encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
        code, body = http_get(base, "/search", {"q": word,
                                                 "c": coll.name})
        assert code == 200 and json.loads(body)["totalMatches"] == 1, body
        reset_counts()
        hits0 = srv.stats["result_cache_hits"]
        code, body = http_get(base, "/search", {"q": queries[0],
                                                 "c": coll.name, "n": 10})
        assert code == 200 and srv.stats["result_cache_hits"] == hits0
        assert msk.launches + fdk.launches_tail + fdk.launches_notail > 0
        log(f"[serve] POST /inject: {word!r} found by the next /search; a "
            "cached query missed after the write and launched again")
        # the guardrails: the 64 trip nothing; a fault trips and answers 500
        coll.conf.result_cache_ttl = 0
        srv.conf.checkify = True
        g_stats.reset()
        wall = http_clients(base, queries, 4, coll.name)[0]
        assert not g_stats.counters.get("devcheck.trip"), g_stats.counters
        with devcheck.inject("nan"):
            code, body = http_get(base, "/search", {"q": queries[1],
                                                    "c": coll.name})
        assert code == 500 and "non-finite" in body, (code, body[:300])
        assert g_stats.counters.get("devcheck.trip") == 1
        assert g_stats.counters.get("serve.device_error") == 1
        srv.conf.checkify = False
        out["checkify_pass_ms"] = wall * 1e3
        log(f"[serve] checkify on: the 64 in {wall * 1e3:.1f} ms tripped "
            "nothing; an injected NaN tripped (devcheck.trip 1), was "
            "counted as a device error and answered 500")
    finally:
        srv.stop()
    out["k1_launches"] = out["clients_4"]["k1_launches"]
    out["k2_launches"] = out["clients_4"]["k2_launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[serve] phase (5d) in {out['phase_s']:.1f} s")
    return out


def telemetry(colldb, coll, queries, work, card):
    """(5j) the telemetry plane on the card, over the bench collection:
    devwatch armed, the tenant is rebuilt so that its columns register
    in the HBM ledger (``collection_bytes`` equals ``resident_bytes()``
    exactly, column by column), no other index is alive, the allocator's
    live bytes exceed the ledger by at most ``ALLOC_SLACK``, and
    ``reconcile()`` is printed; one window
    of the resident batch of 64 and 4 resident clients x 16, armed, in
    which the flight recorder's waves equal the loop's, its rounds'
    escalations add up to the index's, and the ``min_scores`` and
    ``fd_scores`` roofline dispatches equal the wrappers' launches; the
    armed overhead (the batch and the clients, devwatch off and armed,
    alternated for 3 pairs: median wall and qps of each, the overhead in
    %, printed and not gated); each roofline entry's bytes, operations,
    intensity and verdict against the card's ridge; jitwatch armed over a
    warm resident batch (compiles, transfers by site, off-boundary
    transfers and syncs, printed and not gated); and the five pages and
    ``/metrics``' ``osse_hbm_bytes`` through a server with devwatch
    armed. Returns the phase's numbers."""
    import gc
    import threading
    import urllib.parse

    import torch
    from open_source_search_engine_tpu_torch.query import engine
    from open_source_search_engine_tpu_torch.query import \
        fd_scores_kernel as fdk
    from open_source_search_engine_tpu_torch.query import \
        min_scores_kernel as msk
    from open_source_search_engine_tpu_torch.serve.server import \
        SearchHTTPServer
    from open_source_search_engine_tpu_torch.serve.tenancy import \
        g_residency
    from open_source_search_engine_tpu_torch.utils import devwatch, jitwatch

    t_phase = time.perf_counter()
    SC = dict(topk=10, with_snippets=False, site_cluster=False)
    out = {"card": card}
    name = coll.name
    on_card = coll.device.type == "cuda"

    def batch():
        t0 = time.perf_counter()
        engine.search_device_batch(coll, queries, **SC, resident=True)
        return time.perf_counter() - t0

    def clients(n=4):
        errors: list = []
        start = threading.Barrier(n)

        def client(c):
            try:
                start.wait(timeout=60)
                for q in queries[c::n]:
                    engine.search_device_batch(coll, [q], **SC,
                                               resident=True)
            except BaseException as exc:  # noqa: BLE001 — reported below
                errors.append((c, repr(exc)))
        ts = [threading.Thread(target=client, args=(c,), daemon=True)
              for c in range(n)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        assert not any(t.is_alive() for t in ts), "a client hung"
        assert not errors, errors
        return wall

    def k_launches():
        return (msk.launches, fdk.launches_tail + fdk.launches_notail)

    # ---- the ledger: arm, then rebuild the tenant so its columns note
    g_residency.reset()
    coll._device_index = None
    devwatch.reset()
    devwatch.enable()
    try:
        loop = engine.get_resident_loop(coll)
        di = engine.get_device_index(coll)
        cols = {k: t.numel() * t.element_size()
                for k, t in di.columns().items()}
        led = devwatch.g_devwatch.ledger_snapshot()
        assert devwatch.collection_bytes(name) == di.resident_bytes(), (
            devwatch.collection_bytes(name), di.resident_bytes())
        assert led[name] == {"devindex": cols}, led
        assert "(ingest)" not in led, led
        rec = devwatch.reconcile()
        d0 = rec["devices"][0]
        out["ledger"] = dict(
            ledger_bytes=rec["ledger_bytes"],
            resident_bytes=di.resident_bytes(),
            allocated_bytes=d0["bytes_in_use"],
            peak_allocated_bytes=d0["peak_bytes_in_use"],
            free_bytes=d0["headroom"], card_bytes=d0["bytes_limit"],
            fragmentation=d0["fragmentation"])
        # no other index is left on the card: (5d)'s injected device
        # error once kept its wave's whole index alive, in a cycle, until
        # the collector's next full pass (ROADMAP §3)
        from open_source_search_engine_tpu_torch.query.devindex import \
            DeviceIndex as _DI
        others = [(x.base_source, x.n_docs, x.resident_bytes())
                  for x in gc.get_objects()
                  if isinstance(x, _DI) and x is not di]
        assert others == [], f"other DeviceIndex objects alive: {others}"
        # the allocator's live bytes beyond the ledger: the script's
        # 256 MiB L2-flush buffer and the waves' buffers (371,146,752 B at
        # 100,000 pages on an NVIDIA H100 80GB HBM3, 700.00 W; the leak
        # above was 5,847,252,992 B)
        if on_card:
            assert d0["bytes_in_use"] - rec["ledger_bytes"] <= \
                ALLOC_SLACK, (d0["bytes_in_use"], rec["ledger_bytes"])
        log(f"[telemetry] ledger: {name} devindex "
            f"{devwatch.collection_bytes(name)} B in {len(cols)} columns, "
            f"equal to resident_bytes() and to the columns' bytes name by "
            f"name; reconcile(): allocated {d0['bytes_in_use']} B, peak "
            f"{d0['peak_bytes_in_use']} B, free (mem_get_info) "
            f"{d0['headroom']} B of {d0['bytes_limit']} B, fragmentation "
            f"(allocated the ledger cannot name) {d0['fragmentation']}")

        # ---- one armed window: flight recorder and roofline dispatches
        snap0 = devwatch.snapshot()
        w0, l0, e0 = snap0["totals"]["waves"], loop.waves_issued, \
            di.escalations
        k0 = k_launches()
        d0_k = (devwatch.g_devwatch.dispatches("min_scores"),
                devwatch.g_devwatch.dispatches("fd_scores"))
        t_first = batch()
        t_first_clients = clients()
        snap = devwatch.snapshot()
        n_waves = snap["totals"]["waves"] - w0
        assert n_waves == loop.waves_issued - l0, (n_waves,
                                                  loop.waves_issued - l0)
        assert n_waves <= devwatch.RING, n_waves
        recent = snap["waves"][-n_waves:]
        assert all(w["source"] == "resident" and w["error"] is None
                   for w in recent)
        esc = sum(r.get("escalations", 0) for w in recent
                  for r in w["rounds"])
        assert esc == di.escalations - e0, (esc, di.escalations - e0)
        kl = k_launches()
        disp = (devwatch.g_devwatch.dispatches("min_scores") - d0_k[0],
                devwatch.g_devwatch.dispatches("fd_scores") - d0_k[1])
        assert disp[0] > 0 and disp[1] > 0, disp
        if on_card:  # the CPU's wrappers run the plain versions
            assert disp == (kl[0] - k0[0], kl[1] - k0[1]), (disp, kl, k0)
        split = {k: statistics.median(w[k] for w in recent) * 1e3
                 for k in ("issue_s", "wait_s", "collect_s", "total_s")}
        dev_s = sum(r["device_s"] for w in recent for r in w["rounds"])
        out["window"] = dict(
            waves=n_waves, escalations=esc, k1_dispatches=disp[0],
            k2_dispatches=disp[1], batch_ms=t_first * 1e3,
            clients_ms=t_first_clients * 1e3, median_split_ms=split,
            device_wait_s=dev_s, rounds=sum(len(w["rounds"])
                                            for w in recent))
        log(f"[telemetry] armed window (the batch of {len(queries)} and 4 "
            f"resident clients x {len(queries) // 4}, first dispatches "
            f"counted): {n_waves} waves recorded = the loop's "
            f"{loop.waves_issued - l0}; escalations in the rounds {esc} = "
            f"the index's delta; roofline dispatches K1 {disp[0]}, K2 "
            f"{disp[1]} = the wrappers' launches; median wave split ms "
            + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in split.items()))

        # ---- armed overhead: off / armed alternated, 3 pairs
        runs = {"off": [], "armed": []}
        for _ in range(3):
            for mode in ("off", "armed"):
                (devwatch.disable if mode == "off" else devwatch.enable)()
                runs[mode].append((batch(), clients()))
        devwatch.enable()
        oh = {}
        for mode, rs in runs.items():
            b = statistics.median(r[0] for r in rs)
            c = statistics.median(r[1] for r in rs)
            oh[mode] = dict(batch_ms=b * 1e3,
                            batch_qps=len(queries) / b,
                            clients_ms=c * 1e3,
                            clients_qps=len(queries) / c,
                            batch_runs_ms=[r[0] * 1e3 for r in rs],
                            clients_runs_ms=[r[1] * 1e3 for r in rs])
        for k in ("batch", "clients"):
            oh[f"{k}_overhead_pct"] = 100.0 * (
                oh["armed"][f"{k}_ms"] / oh["off"][f"{k}_ms"] - 1.0)
        out["overhead"] = oh
        log(f"[telemetry] armed overhead (median of 3, off / armed "
            f"alternated): batch of {len(queries)} "
            f"{oh['off']['batch_ms']:.2f} ms ({oh['off']['batch_qps']:.2f} "
            f"qps) off, {oh['armed']['batch_ms']:.2f} ms "
            f"({oh['armed']['batch_qps']:.2f} qps) armed, "
            f"{oh['batch_overhead_pct']:+.2f}%; 4 resident clients "
            f"{oh['off']['clients_ms']:.2f} ms "
            f"({oh['off']['clients_qps']:.2f} qps) off, "
            f"{oh['armed']['clients_ms']:.2f} ms "
            f"({oh['armed']['clients_qps']:.2f} qps) armed, "
            f"{oh['clients_overhead_pct']:+.2f}% (not gated; the "
            "reference's gate was 2%)")

        # ---- the roofline table
        snap = devwatch.snapshot()
        pk = snap["peaks"]
        assert pk["assumed"] is not on_card, pk
        roofs = []
        for e in snap["rooflines"]:
            roofs.append({k: e[k] for k in (
                "kernel", "bucket", "bytes", "flops", "intensity",
                "verdict", "dispatches", "modeled_bytes")})
            log(f"[roofline] {e['kernel']} {e['bucket']}: {e['bytes']:.6g}"
                f" B, {e['flops']:.6g} ops, intensity "
                f"{e['intensity']:.4g} ops/B against the ridge "
                f"{e['ridge']:.4g} ({pk['label']}): {e['verdict']}; "
                f"{e['dispatches']} dispatches"
                + (f"; modelled {e['modeled_bytes']} B"
                   if e["modeled_bytes"] else ""))
        out["rooflines"] = roofs
        out["peaks"] = pk

        # ---- jitwatch over a warm resident batch
        jitwatch.enable()
        jitwatch.reset()
        try:
            tripwire = jitwatch.g_jitwatch.tripwire
            t_jit = batch()
            js = jitwatch.snapshot()
        finally:
            jitwatch.disable()
        by_site: dict = {}
        offb: dict = {}
        for e in js["events"]:
            if e["kind"] != "transfer":
                continue
            key = f"{e['fn']}@{e['site']}"
            by_site[key] = by_site.get(key, 0) + e["count"]
            if not e["boundary"]:
                offb[key] = offb.get(key, 0) + e["count"]
        out["jit"] = dict(totals=js["totals"], transfers_by_site=by_site,
                          offboundary_by_site=offb,
                          tripwire=tripwire, batch_ms=t_jit * 1e3)
        log(f"[jit] armed over a warm resident batch of {len(queries)} "
            f"({t_jit * 1e3:.1f} ms with the watcher's own cost): totals "
            f"{js['totals']}; transfers by site {by_site}; off-boundary "
            f"transfers and syncs by site {offb or 'none'}")

        # ---- the pages, through a server with devwatch armed
        srv = SearchHTTPServer(work / "cuda", port=0, device=coll.device,
                               colldb=colldb)
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            for q in queries[:8]:
                code, body = http_get(base, "/search", {
                    "q": q, "c": name, "format": "json", "n": 10})
                assert code == 200, (q, code, body[:300])
            codes = {}
            for path, params in (("/admin/hbm", {"format": "json"}),
                                 ("/admin/hbm", {}),
                                 ("/admin/device", {"format": "json"}),
                                 ("/admin/device", {}),
                                 ("/admin/jit", {}),
                                 ("/admin/profiler", {"sample": "start"}),
                                 ("/admin/profiler", {"sample": "stop"}),
                                 ("/admin/graph", {})):
                code, body = http_get(base, path, params)
                codes[f"{path}?{urllib.parse.urlencode(params)}"] = code
                assert code == 200, (path, params, code, body[:300])
            hbm = json.loads(http_get(base, "/admin/hbm",
                                      {"format": "json"})[1])
            assert hbm["enabled"] and hbm["collections"][name] == \
                devwatch.collection_bytes(name)
            code, metrics = http_get(base, "/metrics", {})
            want = (f'osse_hbm_bytes{{collection="{name}",'
                    f'plane="devindex"}} '
                    f'{devwatch.collection_bytes(name)}')
            assert code == 200 and want in metrics.splitlines(), want
        finally:
            srv.stop()
        out["pages"] = codes
        log(f"[telemetry] pages through the server (devwatch armed): "
            f"{codes}; /metrics carries {want!r}, equal to the ledger")
    finally:
        devwatch.disable()
        devwatch.reset()
        jitwatch.disable()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[telemetry] phase (5j) in {out['phase_s']:.1f} s")
    return out


def numeric_operators(colldb, coll, queries, work, reset_counts, card):
    """(5e) the numeric operators over the bench collection, where every
    page carries a ``date`` fielddb record: 16 of the queries plain, with
    ``gbmin:date:<p25> gbmax:date:<p75>``, with ``gbsortby:date`` and
    with ``gbsortbyrev:date``, through the flat path, the one-shot device
    route (the filtered and the sorted queries as batches of their own,
    the counters reset just before each), the resident loop (one batch
    of the 64 mixed specs) and ``/search`` (the 64 from 16 clients, so
    the batcher coalesces mixed specs). Every device page equals the
    flat path's (totals exact, scores rtol=1e-5, docids by complete tie
    runs) and every served page the in-process resident page; every
    returned date lies in the range, sorted pages follow the date order,
    a filtered total equals the in-range count of the plain query's
    candidates counted on the host; the filtered and sorted queries take
    F1 and FD and launch K1 and K2 and no plain version. (A sorted F1
    query's bound is its exact key, so it escalates only where the
    top-8-per-block selection misses, as the reference's does.) Returns
    the phase's numbers; ``card`` is the ``nvidia-smi`` line printed
    beside them."""
    import numpy as np
    import torch
    from open_source_search_engine_tpu_torch.corpus import (
        assert_pages_match, assert_tie_run_parity)
    from open_source_search_engine_tpu_torch.query import engine
    from open_source_search_engine_tpu_torch.query import \
        fd_scores_kernel as fdk
    from open_source_search_engine_tpu_torch.query import \
        min_scores_kernel as msk
    from open_source_search_engine_tpu_torch.query.compiler import \
        compile_query
    from open_source_search_engine_tpu_torch.query.packer import \
        prepare_query
    from open_source_search_engine_tpu_torch.serve.server import (
        SearchHTTPServer, render_results)

    t_phase = time.perf_counter()
    on_card = coll.device.type == "cuda"
    SC = dict(topk=10, with_snippets=False, site_cluster=False)
    docids, dates = coll.fielddb.column("date")
    assert len(docids) == coll.num_docs, (len(docids), coll.num_docs)
    date_of = dict(zip(docids.tolist(), dates.tolist()))
    lo, hi = (float(x) for x in np.percentile(dates, [25, 75]))
    base = queries[:16]
    specs = {"plain": "", "range": f" gbmin:date:{lo!r} gbmax:date:{hi!r}",
             "sort": " gbsortby:date", "sortrev": " gbsortbyrev:date"}
    qs = {k: [q + s for q in base] for k, s in specs.items()}
    mixed = [q for k in specs for q in qs[k]]
    out = {"date_p25": lo, "date_p75": hi}

    def check(q, res):
        """The range and the date order of one page."""
        got = [date_of[int(d)] for d in res[0]]
        plan = compile_query(q)
        if plan.filters:
            assert all(lo <= d <= hi for d in got), q
        if plan.sortby is not None:
            assert got == sorted(got, reverse=plan.sortby[1]), q

    # the flat path (the recall oracle), timed per spec, and the host
    # count of each range
    flat, out["flat_ms"] = {}, {}
    for k in specs:
        t0 = time.perf_counter()
        for q in qs[k]:
            flat[q] = as_raw(engine.search(coll, q, **SC))
        out["flat_ms"][k] = (time.perf_counter() - t0) * 1e3
    for q, rq in zip(qs["plain"], qs["range"]):
        cand = prepare_query(coll, compile_query(q)).cand
        assert flat[q][2] == len(cand), (q, flat[q][2], len(cand))
        n_in = sum(lo <= date_of[int(d)] <= hi for d in cand.tolist())
        assert flat[rq][2] == n_in, (rq, flat[rq][2], n_in)
    for q in mixed:
        check(q, flat[q])

    # the one-shot device route: the filtered, then the sorted queries
    di = engine.get_device_index(coll)
    launches = {}
    for name, batch in (("range", qs["range"]),
                        ("sort", qs["sort"] + qs["sortrev"])):
        routes0, esc0 = dict(di.route_counts), di.escalations
        reset_counts()
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        pages = engine.search_device_batch(coll, batch, **SC)
        secs = time.perf_counter() - t0
        k1 = msk.launches if on_card else msk.plain_calls
        k2 = (fdk.launches_tail + fdk.launches_notail) if on_card \
            else fdk.plain_calls
        plain = (msk.plain_calls + fdk.plain_calls) if on_card else 0
        routes = {k: di.route_counts[k] - routes0[k] for k in routes0}
        esc = di.escalations - esc0
        for q, res in zip(batch, pages):
            assert_tie_run_parity(as_raw(res), flat[q], q)
        assert routes["f1"] > 0 and routes["fd"] > 0, (name, routes)
        assert k1 > 0 and k2 > 0 and plain == 0, (name, k1, k2, plain)
        launches[name] = (k1, k2)
        out[f"one_shot_{name}"] = dict(
            queries=len(batch), ms=secs * 1e3, routes=routes,
            escalations=esc, k1_launches=k1, k2_launches=k2)
        log(f"[numeric] one-shot batch of {len(batch)} {name} queries: "
            f"{secs * 1e3:.1f} ms; routes {routes}, escalations {esc}; K1 "
            f"launches {k1}, K2 launches {k2}, plain calls {plain}; every "
            f"page equals the flat path's ({card})")

    # the resident loop: one batch of the 64 mixed specs
    reset_counts()
    t0 = time.perf_counter()
    rpages = engine.search_device_batch(coll, mixed, resident=True, **SC)
    out["resident_mixed_ms"] = (time.perf_counter() - t0) * 1e3
    for q, res in zip(mixed, rpages):
        assert_tie_run_parity(as_raw(res), flat[q], q)
    out["resident_launches"] = (
        (msk.launches, fdk.launches_tail + fdk.launches_notail) if on_card
        else (msk.plain_calls, fdk.plain_calls))
    assert min(out["resident_launches"]) > 0, out["resident_launches"]

    # /search: the 64 mixed specs from 16 clients at once, each page equal
    # to the in-process resident page with the server's defaults
    coll.conf.result_cache_ttl = 0
    engine.search_device_batch(coll, mixed, topk=10, resident=True)
    ref = {q: render_results(r, "json")[0] for q, r in zip(
        mixed, engine.search_device_batch(coll, mixed, topk=10,
                                          resident=True))}
    srv = SearchHTTPServer(work / "cuda", port=0, device=coll.device,
                           colldb=colldb)
    srv.start()
    try:
        reset_counts()
        b0 = (srv._batcher.batches, srv._batcher.batched_queries)
        wall, lat, served = http_clients(f"http://127.0.0.1:{srv.port}",
                                         mixed, 16, coll.name)
        nb = srv._batcher.batches - b0[0]
        nq = srv._batcher.batched_queries - b0[1]
        kl = ((msk.launches, fdk.launches_tail + fdk.launches_notail)
              if on_card else (msk.plain_calls, fdk.plain_calls))
    finally:
        srv.stop()
    for q in mixed:
        assert_pages_match(served[q], ref[q], q)
        page = json.loads(served[q])
        check(q, (np.array([r["docId"] for r in page["results"]],
                           np.uint64),))
    assert min(kl) > 0, kl
    out["served"] = dict(qps=len(mixed) / wall, p50_ms=statistics.median(
        lat), max_ms=max(lat), batches=nb, mean_batch=nq / nb,
        k1_launches=kl[0], k2_launches=kl[1])
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[numeric] date range [{lo!r}, {hi!r}] (the 25th and 75th "
        f"percentiles of {len(dates)} dates); flat path ms per 16 "
        f"queries {out['flat_ms']}; resident batch of the "
        f"{len(mixed)} mixed specs {out['resident_mixed_ms']:.1f} ms (K1/K2"
        f" launches {out['resident_launches']}); /search from 16 clients "
        f"{out['served']['qps']:.2f} qps, p50 {out['served']['p50_ms']:.2f}"
        f" ms, {nb} batches (mean {nq / nb:.2f} queries), K1/K2 launches "
        f"{kl}; every page equal, every date in range and in order; phase"
        f" {out['phase_s']:.1f} s ({card})")
    return out


class CrawlSite:
    """(5k)'s web: the first ``n_docs`` pages of ``corpus.gen_docs``
    served over HTTP in this process, one listener per corpus site, each
    on its own loopback address (site ``s`` on ``127.0.0.{s + 2}``), so
    each site has its own first IP. A page keeps its body and gains a
    link block: its site's next page and two pages of other sites, drawn
    from a fixed seed. A site's root page links to all of its pages, and
    every ``CRAWL_PRIVATE_EVERY``-th root first links to ``/private/``,
    which every site's ``robots.txt`` disallows."""

    N_SITES = 97  # gen_docs' sites

    def __init__(self, n_docs: int):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        import numpy as np
        from open_source_search_engine_tpu_torch.corpus import gen_docs

        rng = np.random.default_rng(7)
        self.servers = []
        pages: dict = {}

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                key = (self.server.server_address[0], self.path)
                if self.path == "/robots.txt":
                    body, ctype = (b"User-agent: *\nDisallow: /private\n",
                                   "text/plain")
                elif key in pages:
                    body, ctype = pages[key], "text/html"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        try:
            for s in range(self.N_SITES):
                httpd = ThreadingHTTPServer((f"127.0.0.{s + 2}", 0), Handler)
                httpd.daemon_threads = True
                threading.Thread(target=httpd.serve_forever,
                                 name=f"crawl-site-{s}", daemon=True).start()
                self.servers.append(httpd)
        except BaseException:
            self.close()
            raise
        self.origins = [f"http://{h.server_address[0]}:"
                        f"{h.server_address[1]}" for h in self.servers]
        self.addresses = [h.server_address[0] for h in self.servers]
        docs = [html for _, html in gen_docs(n_docs)]
        self.by_site = by_site = [list(range(s, n_docs, self.N_SITES))
                                  for s in range(self.N_SITES)]
        for d, html in enumerate(docs):
            s = d % self.N_SITES
            mine = by_site[s]
            nxt = mine[(mine.index(d) + 1) % len(mine)]
            links = [f'<a href="/doc{nxt}">next page</a>']
            for e in rng.integers(0, n_docs, size=2):
                e = int(e) if int(e) % self.N_SITES != s \
                    else (int(e) + 1) % n_docs
                links.append(f'<a href="{self.origins[e % self.N_SITES]}'
                             f'/doc{e}">see also</a>')
            pages[(self.addresses[s], f"/doc{d}")] = html.replace(
                "</body>", "<p>" + " ".join(links) + "</p></body>").encode()
        self.private = []
        for s, addr in enumerate(self.addresses):
            links = [f'<a href="/doc{d}">page {d}</a>' for d in by_site[s]]
            if s % CRAWL_PRIVATE_EVERY == 0:
                links.insert(0, '<a href="/private/">staff only</a>')
                self.private.append(f"{self.origins[s]}/private/")
            pages[(addr, "/")] = (
                f"<html><head><title>site {s}</title></head><body><p>"
                + " ".join(links) + "</p></body></html>").encode()
        #: what robots.txt lets a crawler index: every root and page
        self.allowed = self.N_SITES + n_docs

    def close(self) -> None:
        """Stop every listener; the shutdowns run together (each waits up
        to a poll interval, 0.5 s)."""
        import threading
        stops = [threading.Thread(target=h.shutdown, daemon=True)
                 for h in self.servers]
        for t in stops:
            t.start()
        for t in stops:
            t.join(timeout=30)
        for httpd in self.servers:
            httpd.server_close()
        self.servers = []


def crawled_corpus(work, queries, reset_counts, card, device,
                   n_docs: int = CRAWL_DOCS):
    """(5k) a crawled corpus on the card: a :class:`CrawlSite` of
    ``n_docs`` pages, crawled through the server's entry point
    (``/crawlbot`` with the real Fetcher, admin-gated, hosts spanned,
    robots.txt and each IP's 0.25 s politeness honoured, the frontier's
    journal fsynced per record, timed here); every allowed page indexed,
    every /private/ link robots-blocked, no error; then the 64 queries to
    ``/search?c=crawl_bench`` (4 clients, the counters reset just before,
    the post-query rerank off through ``/admin/parms``) each equal to the
    flat path's ``engine.search`` over the collection on ``device``
    (:func:`corpus.assert_clustered_page_parity`), K1 launched, no plain
    version, no device error; then ``action=delete`` with devwatch armed:
    no tenant, no ledger bytes, no directory, and a job made again under
    the name starts from an empty frontier (one site, maxpages=8).
    Every wait has a deadline; the listeners, the jobs and the server go
    on any failure. Returns the phase's numbers."""
    from open_source_search_engine_tpu_torch.corpus import \
        assert_clustered_page_parity
    from open_source_search_engine_tpu_torch.query import engine
    from open_source_search_engine_tpu_torch.query import \
        fd_scores_kernel as fdk
    from open_source_search_engine_tpu_torch.query import \
        min_scores_kernel as msk
    from open_source_search_engine_tpu_torch.serve.server import \
        SearchHTTPServer
    from open_source_search_engine_tpu_torch.serve.tenancy import \
        g_residency
    from open_source_search_engine_tpu_torch.utils import devwatch
    from open_source_search_engine_tpu_torch.utils.stats import g_stats

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    out = {"card": card, "docs": n_docs}
    pwd = "crawlpw"
    site = CrawlSite(n_docs)
    # the Fetcher's urllib opener honours the environment's http_proxy:
    # these loopback addresses must be fetched directly
    proxy_env = {k: os.environ.get(k) for k in ("no_proxy", "NO_PROXY")}
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = ",".join(
        site.addresses + ["127.0.0.1", "localhost"])
    srv = SearchHTTPServer(work / "crawl", port=0, device=device)
    srv.conf.master_password = pwd
    real_fsync = os.fsync
    fsyncs = {"n": 0, "s": 0.0}

    def timed_fsync(fd):
        t0 = time.perf_counter()
        real_fsync(fd)
        fsyncs["s"] += time.perf_counter() - t0
        fsyncs["n"] += 1

    def job(name, deadline_s, **params):
        code, body = http_get(base, "/crawlbot", dict(
            pwd=pwd, name=name, **params))
        assert code == 200, (code, body[:300])
        deadline = time.perf_counter() + deadline_s
        while True:
            code, body = http_get(base, "/crawlbot", {"pwd": pwd,
                                                      "name": name})
            st = json.loads(body)
            assert code == 200, (code, body[:300])
            if st["done"]:
                return st
            assert time.perf_counter() < deadline, f"crawl {name}: {st}"
            time.sleep(0.1)

    devwatch.reset()
    devwatch.enable()
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        # ---- the crawl ----
        os.fsync = timed_fsync
        t0 = time.perf_counter()
        try:
            st = job("bench", 600, seeds=",".join(o + "/"
                                                  for o in site.origins),
                     maxpages=site.allowed, maxhops=3, spanhosts=1)
        finally:
            os.fsync = real_fsync
        t_crawl = time.perf_counter() - t0
        # "done" is set before the job's final save: let the save end
        runner = srv._crawlbot.get("bench").thread
        runner.join(timeout=120)
        assert not runner.is_alive(), "the crawl job's final save hung"
        assert st["jobError"] == "" and st["errors"] == 0, st
        assert st["indexed"] == site.allowed, (st, site.allowed)
        assert st["robots_blocked"] == len(site.private), st
        assert st["frontier"] == 0, st
        coll = srv.colldb.get("crawl_bench")
        cdir = coll.dir
        journal = cdir / "spider" / "spiderdb" / "addsinprogress.jsonl"
        n_records = len(journal.read_text().splitlines())
        # a request per URL queued (each fetched) and a reply per page
        # indexed, each fsynced once
        assert fsyncs["n"] == n_records == 2 * st["indexed"] \
            + st["robots_blocked"], (fsyncs, n_records, st)
        assert coll.num_docs == site.allowed
        out.update(crawl_s=t_crawl, pages_per_s=st["indexed"] / t_crawl,
                   indexed=st["indexed"], fetched=st["fetched"],
                   robots_blocked=st["robots_blocked"],
                   links_found=st["links_found"], fsyncs=fsyncs["n"],
                   fsync_s=fsyncs["s"])
        log(f"[crawl] /crawlbot over {site.N_SITES} sites x "
            f"{n_docs // site.N_SITES}+ pages: {st['indexed']} indexed "
            f"(every page robots.txt allows), {st['fetched']} fetched, "
            f"{st['robots_blocked']} robots-blocked (the /private/ links), "
            f"0 errors, {st['links_found']} links found in {t_crawl:.2f} s "
            f"= {out['pages_per_s']:.1f} pages/s; the frontier's journal: "
            f"{fsyncs['n']} fsyncs ({n_records} records) in "
            f"{fsyncs['s']:.3f} s; card {card}")

        # ---- the search, on the card ----
        code, body = http_get(base, "/admin/parms", {
            "pwd": pwd, "c": "crawl_bench", "pqr": "0"})
        assert code == 200 and json.loads(body)["updated"] == {"pqr": "0"}
        coll.conf.result_cache_ttl = 0
        http_clients(base, queries[:4], 4, "crawl_bench")  # the index, warm
        di = engine.get_device_index(coll)
        routes0 = dict(di.route_counts)
        g_stats.reset()
        reset_counts()
        wall, lat, pages = http_clients(base, queries, 4, "crawl_bench")
        kl = (msk.launches, fdk.launches_tail + fdk.launches_notail,
              msk.plain_calls + fdk.plain_calls)
        errs = g_stats.counters.get("serve.device_error", 0)
        routes = {k: v - routes0.get(k, 0)
                  for k, v in di.route_counts.items()}
        assert errs == 0, errs
        if on_card:
            assert kl[0] >= 1 and kl[2] == 0, kl
        totals = []
        t0 = time.perf_counter()
        for q in queries:
            flat = engine.search(coll, q, topk=10)
            deep = engine.search(coll, q, topk=max(10, min(
                flat.total_matches, 1024)), site_cluster=False,
                with_snippets=False)
            assert_clustered_page_parity(pages[q], flat, deep, q)
            totals.append(flat.total_matches)
        t_flat = time.perf_counter() - t0
        out.update(search_qps=len(queries) / wall, flat_compare_s=t_flat,
                   search_p50_ms=statistics.median(lat),
                   k1_launches=kl[0], k2_launches=kl[1], routes=routes,
                   base_source=di.base_source)
        log(f"[crawl] /search?c=crawl_bench, {len(queries)} queries from 4 "
            f"clients: {out['search_qps']:.2f} qps, p50 "
            f"{out['search_p50_ms']:.2f} ms; routes {routes}; K1 launches "
            f"{kl[0]}, K2 launches {kl[1]}, plain calls {kl[2]}, device "
            f"errors {errs}; every page equals the flat path on {device} "
            f"(totals {min(totals)}-{max(totals)}, scores rtol=1e-5, "
            f"docids by tie runs; the flat pages in {t_flat:.1f} s)")
        del di

        # ---- the delete ----
        ledger = devwatch.collection_bytes("crawl_bench")
        assert ledger > 0, "the crawled tenant is not in the HBM ledger"
        assert "crawl_bench" in g_residency.snapshot()["tenants"]
        code, body = http_get(base, "/crawlbot", {
            "pwd": pwd, "name": "bench", "action": "delete"})
        assert code == 200 and json.loads(body)["deleted"], body
        del coll
        assert "crawl_bench" not in g_residency.snapshot()["tenants"]
        assert devwatch.collection_bytes("crawl_bench") == 0
        assert not cdir.exists(), cdir
        again = job("bench", 120, seeds=site.origins[1] + "/", maxpages=8)
        assert again["indexed"] == min(8, 1 + len(site.by_site[1])) \
            and again["errors"] == 0, again
        code, body = http_get(base, "/crawlbot", {
            "pwd": pwd, "name": "bench", "action": "delete"})
        assert code == 200 and not cdir.exists()
        out.update(ledger_bytes_before_delete=ledger)
        log(f"[crawl] delete: the tenant, {ledger} ledger bytes and the "
            f"directory gone; the same name crawled one site afresh "
            f"({again['indexed']} pages)")
    finally:
        bot = srv._crawlbot
        for name in (list(bot.jobs) if bot is not None else []):
            bot.delete(name)
        srv.stop()
        site.close()
        devwatch.disable()
        devwatch.reset()
        g_residency.reset()
        for k, v in proxy_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[crawl] phase (5k) in {out['phase_s']:.1f} s")
    return out


def route_corpus(base, device):
    """(5f) the route corpus (``route_docs(48)`` under ``ROUTE_ENV``) with
    the collection's record set: a tagdb siterank override on one site,
    a ``sitepathdepth`` tag on a hosting host with two user directories,
    a catdb category on two sites, and two pages linking to each other
    (their anchor text reaches the device index as inlink postings).
    F1, FD and F2 each serve plain, filtered and sorted queries on
    ``device`` with results and escalation counts equal to the same
    index on ``device="cpu"``. Returns the routes and escalations."""
    from open_source_search_engine_tpu_torch.build import docproc
    from open_source_search_engine_tpu_torch.corpus import (
        ROUTE_ENV, ROUTE_QUERIES, assert_tie_run_parity, route_docs)
    from open_source_search_engine_tpu_torch.index.collection import \
        Collection
    from open_source_search_engine_tpu_torch.query.devindex import \
        DeviceIndex

    saved = {k: os.environ.get(k) for k in ROUTE_ENV}
    os.environ.update(ROUTE_ENV)
    try:
        rc = Collection("route", base, device=device)
        rc.tagdb.set_tag("mesh3.test", "siterank", 9)
        rc.tagdb.set_tag("users.test", "sitepathdepth", 1)
        rc.catdb.load_tree("1\t0\tTop\n2\t1\tTop/Sub\n")
        for site in ("mesh5.test", "mesh6.test"):
            rc.catdb.assign(site, 2)
        extra = [("http://users.test/~ann/p", "<p>alpha hosted ann</p>"),
                 ("http://users.test/~bo/p", "<p>alpha hosted bo</p>"),
                 ("http://linka.test/", '<p>alpha <a href="http://linkb.'
                  'test/">omega anchor</a></p>'),
                 ("http://linkb.test/", '<p>beta <a href="http://linka.'
                  'test/">omega return</a></p>')]
        docproc.index_batch(rc, route_docs(48) + extra)
        rc.posdb.dump()
        rc.titledb.dump()
        assert rc.linkdb.inlinks_for_url("linkb.test", "http://linkb.test/")
        rq = list(ROUTE_QUERIES) + [
            "alpha gamma", "alpha beta gamma", "omega", "anchor",
            "alpha gbmin:catid:2 gbmax:catid:2",
            "alpha beta gbmin:catid_top:1 gbmax:catid_top:1",
            "boxes dogs gbsortby:date", "zeta gbsortbyrev:date",
            "alpha beta gbsortby:date", "site:users.test/~ann/ alpha"]
        on_dev, on_cpu = DeviceIndex(rc), DeviceIndex(rc, device="cpu")
        got, want = on_dev.search_batch(rq, topk=64), \
            on_cpu.search_batch(rq, topk=64)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert on_dev.route_counts == on_cpu.route_counts, \
        (on_dev.route_counts, on_cpu.route_counts)
    assert min(on_dev.route_counts.values()) >= 1, on_dev.route_counts
    # F1's sparse sum folds its rows in a fixed order on every device, so
    # the card escalates exactly where the CPU does
    assert on_dev.escalations == on_cpu.escalations >= 1, \
        (on_dev.escalations, on_cpu.escalations)
    for q, a, b in zip(rq, got, want):
        assert_tie_run_parity(a, b, q)
    for q, n in (("omega", 2), ("anchor", 2),
                 ("alpha gbmin:catid:2 gbmax:catid:2", 4),
                 ("site:users.test/~ann/ alpha", 1)):
        assert want[rq.index(q)][2] == n, (q, want[rq.index(q)][2])
    log(f"[route] route_docs(48) + {len(extra)} pages with tagdb, catdb "
        f"and inlinks: routes {on_dev.route_counts}, escalations "
        f"{on_dev.escalations} (CPU {on_cpu.escalations}); "
        f"{device.upper()} == CPU")
    return {"routes": dict(on_dev.route_counts),
            "escalations": on_dev.escalations}


def mesh(colldb, coll, queries, work, reset_counts, card):
    """(5h) the mesh at full width on one card: the bench collection,
    saved, is presented as shard 0 of a 1-shard grid and resharded 1 -> 4
    by ``rebalance`` (timed); ``engine.get_mesh_resident`` builds the
    four per-shard bases on ``cuda:0`` (doc counts, base bytes, peak
    allocated). The host merge (``MeshResident.search_batch``, site
    clustering off) answers the 64 queries equal to the flat device
    route (totals, scores rtol=1e-5, docids by complete tie runs), with
    its routes per shard, escalations and K1 and K2 launches; K2 is held
    bitwise against its plain version on the largest per-shard FD wave.
    The in-program merge (``serve_batch``, 2-per-site dedup on) and
    ``sharded_search`` answer 16 of them each, equal to the host merge
    with clustering on (``clustered`` exact): K1 launches once per wave,
    and is held bitwise against its plain version on the largest stacked
    cube, timed beside its bound; the host packing's share, the merge's
    time and the escalations are printed. Then 4 resident clients over
    the mesh loop, and ``SearchHTTPServer(sharded=...)`` with
    ``serve_mesh`` on and off, 4 clients x 4 queries, every page equal
    to the in-process page, ``/admin/hosts`` reporting the 4 shards. No
    plain version runs on any path. Returns the phase's numbers."""
    import threading

    import numpy as np
    import torch
    from open_source_search_engine_tpu_torch.control.rebalance import \
        rebalance
    from open_source_search_engine_tpu_torch.corpus import (
        assert_pages_match, assert_tie_run_parity)
    from open_source_search_engine_tpu_torch.parallel import sharded_search
    from open_source_search_engine_tpu_torch.query import engine, scorer
    from open_source_search_engine_tpu_torch.query import \
        fd_scores_kernel as fdk
    from open_source_search_engine_tpu_torch.query.compiler import \
        compile_query
    from open_source_search_engine_tpu_torch.query import \
        min_scores_kernel as msk
    from open_source_search_engine_tpu_torch.query.devindex import \
        HBM_USABLE_BYTES
    from open_source_search_engine_tpu_torch.serve.server import (
        SearchHTTPServer, render_results)
    from open_source_search_engine_tpu_torch.serve.tenancy import \
        g_residency
    from open_source_search_engine_tpu_torch.utils import trace
    from open_source_search_engine_tpu_torch.utils.membudget import \
        g_membudget
    from open_source_search_engine_tpu_torch.utils.stats import g_stats

    t_phase = time.perf_counter()
    SC = dict(topk=10, with_snippets=False, site_cluster=False)
    out = {"card": card}
    q16 = queries[:16]
    # the flat device route's pages on the corpus as the earlier phases
    # left it
    flat = dict(zip(queries, engine.search_device_batch(coll, queries,
                                                        **SC)))
    flat_di = engine.get_device_index(coll)
    flat_bytes = flat_di.resident_bytes()

    def slot_plans(di, q):
        """Each group's position quotas on ``di``, from its own live
        dfs and presence, as ``DeviceIndex.plan`` draws them."""
        plans = []
        for g in compile_query(q).groups:
            runs, dfs = di._resolve(np.array(
                [sub.termid for sub in g.sublists], np.uint64))
            pres = [bool(r) and d > 0 for r, d in zip(runs, dfs)]
            plans.append(g.slot_plan(di.P, present=pres, df=dfs))
        return plans
    flat_plans = {q: slot_plans(flat_di, q) for q in queries}
    del flat_di

    # the grid: the saved collection directory as shard 0 of a 1-shard
    # grid, resharded 1 -> 4
    coll.save()
    grid1 = work / "grid1"
    grid1.mkdir()
    (grid1 / "shard_000").symlink_to(colldb.base_dir.resolve(),
                                     target_is_directory=True)
    t0 = time.perf_counter()
    sc = rebalance(coll.name, grid1, work / "grid4", 1, 4, device="cuda")
    out["rebalance_s"] = time.perf_counter() - t0
    for row in sc.grid:
        for c in row:
            c.conf.pqr_enabled = False
            # the bases build from runs: posdb's remainder under the
            # memtable bound goes to one (a no-op when the add dumped it)
            c.posdb.dump()
    assert sc.num_docs == coll.num_docs, (sc.num_docs, coll.num_docs)
    docs = [c.num_docs for c in sc.shards]
    log(f"[mesh] rebalance 1 -> 4 shards in {out['rebalance_s']:.1f} s: "
        f"{sc.num_docs} docs, per shard {docs}")

    # memory: each base is bounded by the resident budget of one index;
    # the flat tenant stays unless the four bounds do not fit beside it
    # (the allocator's cached blocks of the earlier phases go back first,
    # so the card's free bytes are what the bases can take)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    bound = 4 * HBM_USABLE_BYTES
    cap = g_membudget.label_cap("device")
    released = bound + (2 << 30) > free
    if released:
        g_residency.reset()
        coll._device_index = None
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
    log(f"[mesh] memory: the flat tenant holds {flat_bytes / 2**30:.3f} GiB;"
        f" four bases at most {bound / 2**30:.1f} GiB (4 x the per-index "
        f"resident budget); free {free / 2**30:.1f} of "
        f"{total / 2**30:.1f} GiB; membudget device cap {cap} (0 = "
        f"uncapped; the mesh's bases are not tenants); flat tenant "
        f"{'released' if released else 'kept'}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mr = engine.get_mesh_resident(sc)
    torch.cuda.synchronize()
    out["bases_s"] = time.perf_counter() - t0
    assert all(d == torch.device("cuda", 0) for d in mr.devices), \
        mr.devices
    out["shards"] = [dict(docs=di.n_docs, bytes=di.resident_bytes(),
                          source=di.base_source, D_cap=di.D_cap,
                          dense_rows=len(di.dense_slot_of),
                          cube_rows=len(di.cube_slot_of))
                     for di in mr.indexes]
    out["bases_peak_gib"] = (torch.cuda.max_memory_allocated()
                             - base0) / 2**30
    log(f"[mesh] four bases on cuda:0 in {out['bases_s']:.2f} s: "
        + "; ".join(f"shard {s} {x['docs']} docs, "
                    f"{x['bytes'] / 2**30:.3f} GiB ({x['dense_rows']} "
                    f"dense, {x['cube_rows']} cube rows, D_cap "
                    f"{x['D_cap']}, {x['source']})"
                    for s, x in enumerate(out["shards"]))
        + f"; peak allocated above the flat tenant "
        f"{out['bases_peak_gib']:.3f} GiB")
    assert all(x["source"] == "device" for x in out["shards"])

    # -- the host merge: the 64, every counter from 0 just before --
    big_fd: list = []
    fd_scores = fdk.fd_scores

    def keep_fd(*a):
        if not big_fd or a[0].numel() * a[3].numel() > \
                big_fd[0][0].numel() * big_fd[0][3].numel():
            big_fd[:] = [a]
        return fd_scores(*a)

    routes0 = [dict(di.route_counts) for di in mr.indexes]
    esc0 = [di.escalations for di in mr.indexes]
    reset_counts()
    fdk.fd_scores = keep_fd
    try:
        t0 = time.perf_counter()
        host = mr.search_batch(queries, **SC)
        t_host = time.perf_counter() - t0
    finally:
        fdk.fd_scores = fd_scores
    hk = (msk.launches, fdk.launches_tail + fdk.launches_notail,
          msk.plain_calls + fdk.plain_calls)
    routes = [{k: di.route_counts[k] - r0[k] for k in r0}
              for di, r0 in zip(mr.indexes, routes0)]
    esc = [di.escalations - e for di, e in zip(mr.indexes, esc0)]
    assert hk[0] > 0 and hk[1] > 0 and hk[2] == 0, hk
    # each shard funds a group's variants (synonyms, conjugates) by its
    # own live df and presence, as the reference does, so where that
    # differs from the whole corpus a page keeps other positions than
    # the flat path's and scores otherwise: totals are held for every
    # query, scores and tie runs where every shard draws the flat
    # index's slot plans (the rest are held against the host-packed
    # mesh paths below)
    same = [q for q in queries
            if all(slot_plans(di, q) == flat_plans[q] for di in mr.indexes)]
    for q, res in zip(queries, host):
        assert res.total_matches == flat[q].total_matches, q
        if q in same:
            assert_tie_run_parity(as_raw(res), as_raw(flat[q]),
                                  ("host", q))
    out["host_merge"] = dict(ms=t_host * 1e3, qps=len(queries) / t_host,
                             routes=routes, escalations=esc,
                             k1_launches=hk[0], k2_launches=hk[1],
                             flat_slot_plans=len(same))
    log(f"[mesh] host merge, {len(queries)} queries: {t_host * 1e3:.1f} ms "
        f"({len(queries) / t_host:.2f} qps); routes per shard {routes}, "
        f"escalations {esc}; K1 launches {hk[0]}, K2 launches {hk[1]}, "
        f"plain calls {hk[2]}; every total equals the flat device "
        f"route's, and every score and tie run of the {len(same)} queries "
        "whose slot plans are the flat index's on every shard")
    a = big_fd[0]
    got, want = fdk.fd_scores(*a), fdk.fd_scores_plain(*a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    k2 = dict(B=a[0].shape[0], T=a[0].shape[1] // 4, D=a[3].shape[0],
              tail=a[6] is not None, ms=cuda_ms(lambda: fdk.fd_scores(*a)),
              plain_ms=cuda_ms(lambda: fdk.fd_scores_plain(*a), reps=3,
                               warmup=1),
              max_abs_err=float((got[0] - want[0]).abs().max()))
    k2["bound_ms"], k2["bound_by"] = k2_bound(a[0], a[1], a[2], a[3],
                                              a[5], a[6])[:2]
    out["k2_shard_wave"] = k2
    log(f"[k2] largest per-shard FD wave of the host merge {k2}: "
        "bitwise=True")
    del big_fd, a, got, want

    # -- the in-program merge and sharded_search: 16 each --
    # The host merge orders a tie run by its shards' waves, the
    # host-packed paths by the stacked cube's positions (in the reference
    # too), so with site clustering on the two may keep other members of
    # a run and count other drops. So the chain is: sharded_search with
    # clustering off equals the host merge by tie runs (the stacked
    # scoring and the Msg3a merge), and the in-program merge with its
    # 2-per-site dedup equals sharded_search's host walk, clustered
    # counts included (the dedup).
    for q, a, b in zip(q16, [sharded_search(sc, q, **SC) for q in q16],
                       host):
        assert_tie_run_parity(as_raw(a), as_raw(b), ("unclustered", q))
    ref = None
    big_k1: list = []
    ms_fused = scorer.min_scores_fused

    def keep_k1(cube, freq_weight, counts, pvalid=None):
        if cube.dim() == 4 and (not big_k1
                                or cube.numel() > big_k1[0][0].numel()):
            big_k1[:] = [(cube, freq_weight, counts, pvalid)]
        return ms_fused(cube, freq_weight, counts, pvalid)

    def timed(label, fn):
        trace.reset()
        reset_counts()
        scorer.min_scores_fused = keep_k1
        try:
            t0 = time.perf_counter()
            pages = fn()
            wall = time.perf_counter() - t0
        finally:
            scorer.min_scores_fused = ms_fused
        spans = {k: v for k, v in trace.totals.items()
                 if k.startswith("mesh.")}
        kl = (msk.launches, fdk.launches_tail + fdk.launches_notail,
              msk.plain_calls + fdk.plain_calls)
        assert kl[0] > 0 and kl[2] == 0, (label, kl)
        for q, a, b in zip(q16, pages, ref or pages):
            assert a.clustered == b.clustered, (label, q, a.clustered,
                                                b.clustered)
            assert_tie_run_parity(as_raw(a), as_raw(b), (label, q))
        r = dict(ms=wall * 1e3, k1_launches=kl[0], k2_launches=kl[1],
                 pack_share=spans["mesh.pack"][1] / wall,
                 score_ms=spans["mesh.score"][1] * 1e3,
                 merge_ms=spans["mesh.merge"][1] * 1e3,
                 merge_calls=spans["mesh.merge"][0],
                 score_calls=spans["mesh.score"][0])
        return pages, r

    loop = mr.serve_loop()
    w0 = loop.waves_issued
    ref, inprog = timed("in-program", lambda: mr.serve_batch(
        q16, topk=10, with_snippets=False))
    msi = mr._serve_idx
    inprog["waves"] = loop.waves_issued - w0
    inprog["escalations"] = msi.escalations
    # one K1 launch per wave: every shard lives on cuda:0
    assert inprog["k1_launches"] == inprog["score_calls"] == msi.waves, \
        (inprog, msi.waves)
    out["in_program"] = inprog
    log(f"[mesh] in-program merge (serve_batch, 2-per-site dedup), "
        f"{len(q16)} queries: {inprog['ms']:.1f} ms in {inprog['waves']} "
        f"loop wave(s); host packing {inprog['pack_share']:.1%} of the "
        f"wall, scoring {inprog['score_ms']:.1f} ms, merge "
        f"{inprog['merge_ms']:.2f} ms in {inprog['merge_calls']} call(s), "
        f"escalations {inprog['escalations']}; K1 launches "
        f"{inprog['k1_launches']} (one per wave)")
    _, shs = timed("sharded_search", lambda: [
        sharded_search(sc, q, topk=10, with_snippets=False) for q in q16])
    shs["escalations"] = shs["merge_calls"] - shs["score_calls"]
    assert shs["k1_launches"] == shs["score_calls"] == len(q16), shs
    out["sharded_search"] = shs
    log(f"[mesh] sharded_search, {len(q16)} queries: {shs['ms']:.1f} ms; "
        f"host packing {shs['pack_share']:.1%} of the wall, scoring "
        f"{shs['score_ms']:.1f} ms, merge {shs['merge_ms']:.2f} ms, out_k "
        f"escalations {shs['escalations']}; K1 launches "
        f"{shs['k1_launches']} (one per query's wave); pages, clustered "
        "counts included, equal the in-program merge's, and with "
        "clustering off the host merge's by tie runs")
    cube, fw, counts, pvalid = big_k1[0]
    got = msk.min_scores_fused(cube, fw, counts)
    want = k1_plain(msk, cube, pvalid, fw, counts)
    assert torch.equal(got, want), float((got - want).abs().max())
    k1 = dict(shape=list(cube.shape),
              ms=cuda_ms(lambda: msk.min_scores_fused(cube, fw, counts)),
              plain_ms=cuda_ms(lambda: k1_plain(msk, cube, pvalid, fw,
                                                counts), reps=3, warmup=1),
              max_abs_err=float((got - want).abs().max()))
    k1["bound_ms"], k1["bound_by"] = k1_bound(cube, counts)[:2]
    out["k1_stacked"] = k1
    log(f"[k1] largest stacked mesh cube {tuple(cube.shape)} (shards x "
        f"queries, T, P, D): ms={k1['ms']:.4f} plain_ms="
        f"{k1['plain_ms']:.3f} bound_ms={k1['bound_ms']:.5f} "
        f"({k1['bound_by']}) bitwise=True")
    del big_k1, cube, fw, counts, pvalid, got, want

    # -- 4 resident clients over the mesh loop --
    want = dict(zip(q16, mr.serve_batch(q16, topk=10,
                                        with_snippets=False)))
    lat: list = []
    errors: list = []
    start = threading.Barrier(4)

    def client(c):
        try:
            start.wait(timeout=60)
            for q in q16[c::4]:
                t1 = time.perf_counter()
                page = mr.serve(q, topk=10, with_snippets=False)
                lat.append((time.perf_counter() - t1) * 1e3)
                assert page.clustered == want[q].clustered, q
                assert_tie_run_parity(as_raw(page), as_raw(want[q]), q)
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append((c, repr(exc)))

    w0, sw0 = loop.waves_issued, msi.waves
    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "a client hung"
    assert not errors, errors
    assert msk.launches == msi.waves - sw0 and msk.plain_calls == 0
    out["clients"] = dict(clients=4, qps=len(q16) / wall,
                          p50_ms=statistics.median(lat), max_ms=max(lat),
                          waves=loop.waves_issued - w0,
                          k1_launches=msk.launches)
    log(f"[mesh] 4 resident clients x 4 over the mesh loop: "
        f"{wall * 1e3:.1f} ms, {out['clients']['qps']:.2f} qps; per query "
        f"p50 {out['clients']['p50_ms']:.2f} ms, max "
        f"{out['clients']['max_ms']:.2f} ms; {out['clients']['waves']} "
        f"waves, K1 launches {msk.launches}; each client got its own pages")

    # -- over HTTP, serve_mesh on and off --
    srv = SearchHTTPServer(work / "meshsrv", port=0, device="cuda",
                           sharded=sc)
    srv.colldb.get("main").conf.result_cache_ttl = 0
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, body = http_get(base, "/admin/hosts", {})
        hosts = json.loads(body)
        assert code == 200 and hosts["shards"] == 4 and \
            hosts["docsPerShard"] == docs, (code, body)
        for serve_mesh in (True, False):
            srv.conf.serve_mesh = serve_mesh
            inproc = (mr.serve_batch(q16, topk=10) if serve_mesh else
                      [sharded_search(sc, q, topk=10) for q in q16])
            refp = {q: render_results(r, "json")[0]
                    for q, r in zip(q16, inproc)}
            g_stats.reset()
            reset_counts()
            wall, hl, pages = http_clients(base, q16, 4, "main")
            kl = (msk.launches, msk.plain_calls + fdk.plain_calls)
            for q in q16:
                assert_pages_match(pages[q], refp[q], (serve_mesh, q))
            errs = g_stats.counters.get("serve.device_error", 0)
            assert kl[0] > 0 and kl[1] == 0 and errs == 0, (kl, errs)
            key = "http_mesh" if serve_mesh else "http_sharded_search"
            out[key] = dict(qps=len(q16) / wall,
                            p50_ms=statistics.median(hl), max_ms=max(hl),
                            k1_launches=kl[0])
            log(f"[mesh] HTTP, serve_mesh={serve_mesh}, 4 clients x 4: "
                f"{wall * 1e3:.1f} ms, {out[key]['qps']:.2f} qps, p50 "
                f"{out[key]['p50_ms']:.2f} ms, max {out[key]['max_ms']:.2f}"
                f" ms; K1 launches {kl[0]}, plain calls {kl[1]}, device "
                f"errors {errs}; every page equals the in-process page")
        log(f"[mesh] /admin/hosts: {hosts}")
    finally:
        srv.stop()
        mr.stop()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh] phase (5h) in {out['phase_s']:.1f} s")
    # (5i) holds the cluster's totals against the flat route's on this
    # same corpus
    out["flat_totals"] = {q: r.total_matches for q, r in flat.items()}
    sc._mesh_resident = None
    del mr, sc
    torch.cuda.empty_cache()
    return out


def cluster_fleet(grid, name, queries, flat_totals, work, card, device):
    """(5i) the cluster on the card: (5h)'s saved 4-shard grid, copied so
    that the nodes write into the copy, served by four node processes
    (``FleetManager``, the device route on ``device``). Before the spawn
    each shard directory is opened in this process and its legs (the
    batched ``search_device_batch`` at the client's leg depth) and the
    merged pages (``cluster.merge_legs``) are computed, and the card is
    freed again. Then: each node's spawn-to-ready seconds, doc count and
    card memory; the queries through ``ClusterClient.search_batch`` (site
    clustering off) cold and warm; each node's legs bitwise equal to the
    in-process ones, every merged page equal to the in-process merge,
    every total equal to the flat device route's; each node's K1 and K2
    launches (> 0 in sum), plain calls and device errors (0) over
    ``/rpc/stats``; 4 clients x 16 queries through ``ClusterClient.search``
    (its caches off); ``SearchHTTPServer(cluster=...)`` (the ``proxy``)
    serving 4 HTTP clients x 16 queries, every page equal to the client's,
    with ``/admin/hosts``, ``/admin/transport`` (pooled reuse) and
    ``/admin/perf`` (every node's ``node.search`` merged); 8 POST /inject
    through the proxy, each on its owning shard and found; a SIGKILL of
    one node (a query meanwhile answers ``degraded``), its respawn by the
    supervisor, its journal replay, and its answers as before the kill;
    then a teardown that leaves no process. Every wait has a deadline,
    and any failure shuts the fleet down. Returns the phase's numbers."""
    import gc
    import threading

    import numpy as np
    import torch
    from open_source_search_engine_tpu_torch.build import docproc
    from open_source_search_engine_tpu_torch.corpus import assert_pages_match
    from open_source_search_engine_tpu_torch.index.collection import \
        Collection
    from open_source_search_engine_tpu_torch.parallel.cluster import (
        ClusterClient, leg_of, leg_topk, merge_legs)
    from open_source_search_engine_tpu_torch.parallel.fleet import \
        FleetManager
    from open_source_search_engine_tpu_torch.parallel.hostmap import HostMap
    from open_source_search_engine_tpu_torch.query import engine
    from open_source_search_engine_tpu_torch.serve.server import (
        SearchHTTPServer, render_results)
    from open_source_search_engine_tpu_torch.utils.stats import g_stats

    t_phase = time.perf_counter()
    n_shards = 4
    on_card = torch.device(device).type == "cuda"
    SC = dict(topk=10, site_cluster=False)
    out = {"card": card}
    hm = HostMap(n_shards)

    def page(res):
        return render_results(res, "json")[0]

    def deadline_wait(cond, secs, what):
        end = time.monotonic() + secs
        while True:
            v = cond()
            if v:
                return v
            assert time.monotonic() < end, f"timed out: {what}"
            time.sleep(0.05)

    # the fleet's directory: each shard's collection under the name a
    # node opens ("shard"), copied from the grid
    base = work / "fleet"
    for s in range(n_shards):
        shutil.copytree(grid / f"shard_{s:03d}" / "coll" / name,
                        base / f"shard_{s:03d}" / "coll" / "shard")

    # the in-process reference: each shard's legs and the merged pages,
    # computed before the spawn and released before it
    over = leg_topk(10)
    colls, legs, docs, base_bytes = [], [], [], []
    t0 = time.perf_counter()
    for s in range(n_shards):
        c = Collection("shard", base / f"shard_{s:03d}", device=device)
        c.conf.pqr_enabled = False   # as a node sets it
        legs.append([leg_of(r) for r in engine.search_device_batch(
            c, queries, topk=over, with_snippets=False, site_cluster=False)])
        base_bytes.append(engine.get_device_index(c).resident_bytes())
        engine.drop_device_index(c)
        colls.append(c)
        docs.append(c.num_docs)
    ref_pages = [merge_legs(
        q, [legs[s][i] for s in range(n_shards)],
        lambda d: docproc.get_document(
            colls[int(hm.shard_of_docid(d))], docid=int(d)), **SC)
        for i, q in enumerate(queries)]
    out["inprocess_s"] = time.perf_counter() - t0
    del colls
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log(f"[cluster] in-process legs of {len(queries)} queries at depth "
        f"{over} on each of the {n_shards} shard directories ({docs} docs),"
        f" and their merge, in {out['inprocess_s']:.1f} s; this process's "
        "bases released")

    fm = FleetManager(base, n_shards=n_shards, n_replicas=1, device=device,
                      use_device=True, supervise=True)
    srv = None
    clients: list = []
    # the nodes run with the HBM ledger on (a child inherits the
    # environment; its device layer arms devwatch at import)
    saved_dw = os.environ.get("OSSE_DEVWATCH")
    os.environ["OSSE_DEVWATCH"] = "1"
    try:
        t0 = time.perf_counter()
        fm.start_all()
        out["start_all_s"] = time.perf_counter() - t0
        pings = [fm.wait_ready(s, 0) for s in range(n_shards)]
        out["spawn_to_ready_s"] = [fm.ready_s[(s, 0)]
                                   for s in range(n_shards)]
        assert [p["docs"] for p in pings] == docs, (pings, docs)
        log(f"[cluster] {n_shards} node processes (device route, "
            f"--torch-device {device}) ready in {out['start_all_s']:.2f} s; "
            f"spawn to ready per node {[round(x, 2) for x in out['spawn_to_ready_s']]}"
            f" s; docs per node {[p['docs'] for p in pings]}; pids "
            f"{[p['pid'] for p in pings]}")

        # -- the queries, cold then warm, through the client --
        client = ClusterClient(fm.conf)
        clients.append(client)
        t0 = time.perf_counter()
        cold = client.search_batch(queries, **SC)
        out["cold_batch_s"] = time.perf_counter() - t0
        # the nodes' legs, while their result caches hold what they
        # answered the cold batch with
        node_legs = [fm.transport.request(
            fm.addr(s, 0), "/rpc/search",
            {"queries": queries, "topk": over, "lang": 0},
            timeout=120.0)["results"] for s in range(n_shards)]
        t0 = time.perf_counter()
        warm = client.search_batch(queries, **SC)
        out["warm_batch_s"] = time.perf_counter() - t0
        for s in range(n_shards):
            for q, a, b in zip(queries, node_legs[s], legs[s]):
                assert a["total"] == b["total"], (s, q)
                assert np.array_equal(a["docids"], b["docids"]), (s, q)
                assert np.array_equal(np.asarray(a["scores"]).view(np.int64),
                                      b["scores"].view(np.int64)), (s, q)
        for q, a, b, r in zip(queries, cold, warm, ref_pages):
            assert not a.degraded and a.total_matches == flat_totals[q], \
                (q, a.total_matches, flat_totals[q])
            assert page(a) == page(r) == page(b), q
        out["qps_cold"] = len(queries) / out["cold_batch_s"]
        out["qps_warm"] = len(queries) / out["warm_batch_s"]
        log(f"[cluster] search_batch of {len(queries)}: cold "
            f"{out['cold_batch_s'] * 1e3:.1f} ms ({out['qps_cold']:.2f} qps,"
            f" the nodes' bases built at their first wave), warm "
            f"{out['warm_batch_s'] * 1e3:.1f} ms ({out['qps_warm']:.2f} qps, "
            "the client's result cache); every node's legs bitwise equal "
            "to the in-process device route over its shard directory, "
            "every merged page equal to the in-process merge of those legs, "
            "every total equal to the flat device route's")

        # -- the nodes' counters and card memory --
        def node_stats():
            return [fm.transport.request(fm.addr(s, 0), "/rpc/stats", {},
                                         timeout=30.0)["stats"]
                    for s in range(n_shards)]
        st = node_stats()
        ctr = [w["counters"] for w in st]
        k1 = [c.get("kernel.min_scores.launches", 0) for c in ctr]
        k2 = [c.get("kernel.fd_scores.launches", 0) for c in ctr]
        plain = [c.get("kernel.min_scores.plain_calls", 0)
                 + c.get("kernel.fd_scores.plain_calls", 0) for c in ctr]
        errs = [c.get("node.device_error", 0) for c in ctr]
        assert sum(errs) == 0, errs
        if on_card:
            assert sum(k1) > 0 and sum(k2) > 0, (k1, k2)
            assert sum(plain) == 0, plain
        else:  # a rehearsal on the CPU runs the plain versions
            assert sum(plain) > 0, plain
        out.update(k1_launches=k1, k2_launches=k2)
        # each node's ledger: its devindex bytes (the hbm.devindex.bytes
        # gauge over /rpc/stats) equal the base built in this process
        # over the same shard directory
        hbm = [int(w["gauges"].get("hbm.devindex.bytes", -1)) for w in st]
        assert hbm == base_bytes, (hbm, base_bytes)
        out["node_hbm_devindex_bytes"] = hbm
        log(f"[cluster] each node's HBM ledger (OSSE_DEVWATCH=1, "
            f"hbm.devindex.bytes over /rpc/stats): {hbm} B, equal to the "
            "resident_bytes() of the bases built in this process over the "
            "same shard directories")
        # each node's allocator on the card (reserved, allocated GiB; its
        # CUDA context is not in them), and the whole card's used memory
        # as nvidia-smi reads it (every process, contexts included)
        mem = {}
        if on_card:
            mem = {f"s{s}": [round(w["gauges"][f"node.device_{k}_bytes"]
                                   / 2**30, 3)
                             for k in ("reserved", "allocated")]
                   for s, w in enumerate(st)}
            mem["card_used"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used,memory.total",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip()
            # the per-process view (empty where nvidia-smi cannot see
            # the processes, as in a container)
            mem["compute_apps"] = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip()
        out["card_memory"] = mem
        log(f"[cluster] node counters (/rpc/stats): K1 launches {k1}, K2 "
            f"launches {k2}, plain calls {plain}, device errors {errs}; "
            f"card memory per node [reserved, allocated] GiB and the "
            f"card's used / total {mem or 'not measured (no card)'}")

        # -- 4 clients x 16 through ClusterClient.search --
        lc = ClusterClient(fm.conf, use_cache=False)
        clients.append(lc)
        want = {q: page(r) for q, r in zip(queries, cold)}
        lat, errors = [], []
        start = threading.Barrier(4)

        def one_client(c):
            try:
                start.wait(timeout=60)
                for q in queries[c::4]:
                    t1 = time.perf_counter()
                    res = lc.search(q, **SC)
                    lat.append((time.perf_counter() - t1) * 1e3)
                    assert_pages_match(page(res), want[q], ("client", q))
            except BaseException as exc:  # noqa: BLE001 — reported below
                errors.append((c, repr(exc)))

        t0 = time.perf_counter()
        ths = [threading.Thread(target=one_client, args=(c,), daemon=True)
               for c in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        assert not any(t.is_alive() for t in ths), "a client hung"
        assert not errors, errors
        out["clients"] = dict(qps=len(queries) / wall,
                              p50_ms=statistics.median(lat), max_ms=max(lat))
        log(f"[cluster] 4 clients x {len(queries) // 4} through "
            f"ClusterClient.search (client caches off): {wall * 1e3:.1f} ms, "
            f"{out['clients']['qps']:.2f} qps, p50 "
            f"{out['clients']['p50_ms']:.2f} ms, max "
            f"{out['clients']['max_ms']:.2f} ms; every page equal to the "
            "cold batch's")

        # -- the proxy: SearchHTTPServer(cluster=...) --
        pc = ClusterClient(fm.conf)
        clients.append(pc)
        srv = SearchHTTPServer(work / "proxy", port=0, device=device,
                               cluster=pc)
        pconf = srv.colldb.get("main").conf
        pconf.result_cache_ttl = 0
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        ref = {q: page(lc.search(q, topk=10, conf=pconf)) for q in queries}
        acc0 = [fm.transport.request(fm.addr(s, 0), "/rpc/ping", {},
                                     timeout=10.0)["accepts"]
                for s in range(n_shards)]
        g_stats.reset()
        wall, hl, pages = http_clients(url, queries, 4, "main")
        for q in queries:
            assert_pages_match(pages[q], ref[q], ("proxy", q))
        acc1 = [fm.transport.request(fm.addr(s, 0), "/rpc/ping", {},
                                     timeout=10.0)["accepts"]
                for s in range(n_shards)]
        code, body = http_get(url, "/admin/hosts", {})
        hosts = json.loads(body)
        assert code == 200 and hosts["shards"] == n_shards and \
            hosts["alive"] == [[True]] * n_shards, body
        code, body = http_get(url, "/admin/transport", {})
        tp = json.loads(body)
        tc = tp["counters"]
        dials = [b - a for a, b in zip(acc0, acc1)]
        rpcs = tc.get("transport.rpc", 0)
        reuse = tc.get("transport.conn_reuse", 0)
        # a node's new connections are bounded by what the proxy's client
        # can have in flight at once, not by the RPCs it sent
        bound = pc.max_inflight
        assert code == 200 and max(dials) <= bound < rpcs, (dials, bound,
                                                            rpcs)
        assert reuse > rpcs / 2, tc
        code, body = http_get(url, "/admin/perf", {"format": "json"})
        perf = json.loads(body)
        ns = perf["fleet"]["latencies"]["node.search"]
        per_host = [h["node.search"]["count"]
                    for h in perf["hosts"].values() if h is not None]
        assert code == 200 and len(per_host) == n_shards and \
            ns["count"] == sum(per_host), (ns, per_host)
        out["proxy"] = dict(qps=len(queries) / wall,
                            p50_ms=statistics.median(hl), max_ms=max(hl),
                            node_dials=dials, rpcs=rpcs, conn_reuse=reuse,
                            conn_dial=tc.get("transport.conn_dial", 0),
                            node_search_p50_ms=ns["p50_ms"],
                            node_search_count=ns["count"])
        log(f"[cluster] proxy (SearchHTTPServer(cluster=...)), 4 HTTP "
            f"clients x {len(queries) // 4}: {wall * 1e3:.1f} ms, "
            f"{out['proxy']['qps']:.2f} qps, p50 "
            f"{out['proxy']['p50_ms']:.2f} ms, max {out['proxy']['max_ms']:.2f}"
            f" ms; every page equal to the client's; /admin/hosts {hosts}; "
            f"/admin/transport: {rpcs} RPCs, {reuse} on a reused connection, "
            f"{out['proxy']['conn_dial']} dials, new connections per node "
            f"{dials} (bound {bound}); /admin/perf: node.search merged over "
            f"{len(per_host)} nodes, {ns['count']} calls, p50 "
            f"{ns['p50_ms']:.2f} ms")

        # -- write, kill, recover --
        word = "zqxclusterinject"
        injected = []
        for i in range(8):
            u = f"http://inject{i}.cluster.example.com/p"
            status, body = http_post(url, "/inject", {"u": u},
                                     f"<html><title>inject {i}</title><body>"
                                     f"<p>{word} page {i}</p></body></html>")
            assert status == 200, (status, body)
            injected.append(json.loads(body)["docId"])
        owners = [int(hm.shard_of_docid(d)) for d in injected]
        after = [fm.transport.request(fm.addr(s, 0), "/rpc/ping", {},
                                      timeout=10.0)["docs"]
                 for s in range(n_shards)]
        assert [a - b for a, b in zip(after, docs)] == \
            [owners.count(s) for s in range(n_shards)], (after, owners)
        found = lc.search(word, topk=10, site_cluster=False)
        assert found.total_matches == 8 and not found.degraded
        assert sorted(r.docid for r in found.results) == sorted(injected)
        before = lc.search_batch(queries, **SC)
        victim = owners[0]
        deg0 = g_stats.counters.get("results.degraded", 0)
        t_kill = time.monotonic()
        fm.kill(victim, 0)
        deadline_wait(lambda: not fm.alive(victim, 0), 30, "the kill")
        down = lc.search(word, topk=10, site_cluster=False)
        assert down.degraded and down.total_matches == 8 - owners.count(
            victim), (down.degraded, down.total_matches)
        assert g_stats.counters.get("results.degraded", 0) > deg0
        back = deadline_wait(
            lambda: (lambda r: r if not r.degraded else None)(
                lc.search(word, topk=10, site_cluster=False)),
            240, "the respawned node's first answer")
        out["kill_to_first_answer_s"] = time.monotonic() - t_kill
        fm.wait_ready(victim, 0)
        out["respawn_to_ready_s"] = fm.ready_s[(victim, 0)]
        assert back.total_matches == 8
        assert sorted(r.docid for r in back.results) == sorted(injected)
        again = lc.search_batch(queries, **SC)
        for q, a, b in zip(queries, again, before):
            assert not a.degraded
            assert_pages_match(page(a), page(b), ("respawned", q))
        log(f"[cluster] 8 POST /inject through the proxy landed on their "
            f"owning shards {owners} and were found; node s{victim} killed "
            f"(SIGKILL): a query meanwhile answered degraded "
            f"({down.total_matches} of 8 found, results.degraded counted); "
            f"the supervisor respawned it, spawn to ready "
            f"{out['respawn_to_ready_s']:.2f} s, kill to its first answer "
            f"{out['kill_to_first_answer_s']:.2f} s; its journal replay kept "
            f"the 8 pages, and the {len(queries)} queries answer as before "
            "the kill")
    finally:
        if srv is not None:
            srv.stop()
        for c in clients:
            c.close()
        fm.shutdown()
        if saved_dw is None:
            os.environ.pop("OSSE_DEVWATCH", None)
        else:
            os.environ["OSSE_DEVWATCH"] = saved_dw
        # the proxy's start() armed this process's plane from the same
        # variable: the later phases run with it off
        from open_source_search_engine_tpu_torch.utils import devwatch
        devwatch.disable()
        devwatch.reset()
    assert fm.surviving_pids() == [], fm.surviving_pids()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[cluster] fleet down, no surviving process; phase (5i) in "
        f"{out['phase_s']:.1f} s ({card})")
    return out


def run_counts(coll) -> dict:
    """{rdb: (runs, memtable records)} of a collection."""
    return {n: (len(db.runs), len(db.mem)) for n, db in coll.rdbs().items()}


class Child:
    """One ``python -m open_source_search_engine_tpu_torch serve`` node on
    ``device`` over ``base``: its stdout is read by a thread (the first
    line names the port), its stderr goes to a file; every wait has a
    deadline, and ``close`` kills it if it still runs."""

    def __init__(self, base: Path, coll: str, device: str, log_path: Path):
        import queue
        import threading
        self._lines: queue.Queue = queue.Queue()
        self._err = open(log_path, "ab")  # noqa: SIM115 — closed in close()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "open_source_search_engine_tpu_torch",
             "serve", "--dir", str(base), "--coll", coll, "--port", "0",
             "--torch-device", device],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=self._err)
        threading.Thread(target=self._read, daemon=True).start()
        line = self.line(timeout=180)
        self.base = json.loads(line)["serving"].rstrip("/")

    def _read(self) -> None:
        for raw in self.proc.stdout:
            self._lines.put(raw.decode().strip())
        self._lines.put(None)

    def line(self, timeout: float) -> str:
        import queue
        try:
            line = self._lines.get(timeout=timeout)
        except queue.Empty:
            raise AssertionError(f"the child printed nothing in {timeout} s")
        assert line is not None, f"the child exited ({self.proc.poll()})"
        return line

    def get(self, path: str, params: dict, deadline: float):
        """GET until the node answers (connection refused is retried)."""
        while True:
            try:
                return http_get(self.base, path, params)
            except OSError:
                assert time.perf_counter() < deadline, f"{path} never answered"
                time.sleep(0.05)

    def kill9(self) -> None:
        import signal
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=60)

    def stop(self) -> None:
        import signal
        self.proc.send_signal(signal.SIGTERM)
        self.proc.wait(timeout=120)
        assert self.proc.returncode == 0, self.proc.returncode

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._err.close()


def durability(colldb, name, queries, work, reset_counts, device):
    """(5g) the durable node over the collection ``name`` of ``colldb``:

    * a save adds no run and empties no memtable;
    * the collection reopened in process (runs verified with their CRCs,
      the memtable checkpoint loaded, the journal replayed) answers the
      queries bitwise as before the save, with the open and the first
      batch timed;
    * a forced daily merge of every Rdb while 4 resident clients send the
      queries: every page equals the page from before it, and after the
      swap the serving index equals one built from scratch;
    * a child ``serve`` node on ``device`` takes 16 POST /inject (each
      answered 200) and is killed with SIGKILL; the restarted node finds
      each of the 16, and answers every page as before the kill.

    Returns the phase's numbers; the collection is released (its loop
    stopped, saved, dropped from ``colldb``) at the end."""
    import threading
    import urllib.request
    from datetime import datetime

    import torch
    from open_source_search_engine_tpu_torch import native
    from open_source_search_engine_tpu_torch.control.dailymerge import \
        DailyMerge
    from open_source_search_engine_tpu_torch.corpus import \
        assert_tie_run_parity
    from open_source_search_engine_tpu_torch.query import engine
    from open_source_search_engine_tpu_torch.query import \
        fd_scores_kernel as fdk
    from open_source_search_engine_tpu_torch.query import \
        min_scores_kernel as msk
    from open_source_search_engine_tpu_torch.query.devindex import \
        DeviceIndex
    from open_source_search_engine_tpu_torch.serve.tenancy import \
        g_residency
    from open_source_search_engine_tpu_torch.utils.membudget import \
        g_membudget
    from open_source_search_engine_tpu_torch.utils.parms import Conf
    from open_source_search_engine_tpu_torch.utils.stats import g_stats

    SC = dict(topk=10, with_snippets=False, site_cluster=False)
    t_phase = time.perf_counter()
    out: dict = {}

    def exact(pages):
        return [(p.total_matches, [(r.docid, r.score) for r in p.results])
                for p in pages]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def launches():
        return (msk.launches, fdk.launches_tail + fdk.launches_notail,
                msk.plain_calls + fdk.plain_calls)

    # the process budget stays at its default (max_mem, 4 GiB): the
    # resident index's device bytes (5.4 GiB) answer to the device cap,
    # not to it
    assert g_membudget.limit == 4 << 30, g_membudget.limit

    # ---- a save adds no run ----
    coll = colldb.get(name)
    g_residency.reset()
    coll._device_index = None
    ref = engine.search_device_batch(coll, queries, **SC)  # fresh index
    ref_source = coll._device_index.base_source
    before = run_counts(coll)
    t0 = time.perf_counter()
    colldb.save_all()
    out["save_s"] = time.perf_counter() - t0
    after = run_counts(coll)
    log(f"[durable] save_all() in {out['save_s']:.2f} s; (runs, memtable "
        f"records) per Rdb before {before}, after {after}")
    assert after == before, (before, after)
    assert (coll.posdb.dir / "saved").is_dir() or not before["posdb"][1]
    out["runs_before_save"] = before

    # ---- reopen in process ----
    g_residency.reset()
    coll._device_index = None
    colldb.drop(name)
    del coll
    t0 = time.perf_counter()
    coll = colldb.get(name)
    out["open_s"] = time.perf_counter() - t0
    coll.conf.pqr_enabled = False
    assert run_counts(coll) == before and not any(
        db.quarantined for db in coll.rdbs().values())
    reset_counts()
    t0 = time.perf_counter()
    pages = engine.search_device_batch(coll, queries, **SC)
    sync()
    out["reopen_first_batch_s"] = time.perf_counter() - t0
    out["reopen_base_source"] = coll._device_index.base_source
    out["reopen_launches"] = launches()
    assert exact(pages) == exact(ref), "reopened pages differ"
    if device == "cuda":   # K1 and K2 launched, no plain version ran
        assert min(out["reopen_launches"][:2]) > 0 and \
            out["reopen_launches"][2] == 0, out["reopen_launches"]
    log(f"[durable] reopened in {out['open_s']:.2f} s (runs verified with "
        f"their CRCs, checkpoint loaded, journal replayed); the first batch "
        f"of {len(queries)} in {out['reopen_first_batch_s']:.2f} s (base "
        f"built from: {out['reopen_base_source']}; before the save: "
        f"{ref_source}); every page bitwise equal to the pages before the "
        f"save; K1 / K2 launches {out['reopen_launches'][:2]}")

    # ---- a merge while 4 resident clients serve ----
    engine.search_device_batch(coll, queries, **SC, resident=True)
    learned = dict(zip(queries, engine.search_device_batch(
        coll, queries, **SC, resident=True)))
    first = dict(zip(queries, ref))
    old = coll._device_index
    runs0 = run_counts(coll)
    stop = threading.Event()
    served: list = []
    errors: list = []
    swapped = threading.Event()
    rounds_after = [0] * 4

    def client(c):
        try:
            while not stop.is_set():
                for q in queries[c::4]:
                    (page,) = engine.search_device_batch(coll, [q], **SC,
                                                         resident=True)
                    assert page.total_matches == learned[q].total_matches, q
                    assert_tie_run_parity(as_raw(page), as_raw(learned[q]), q)
                    served.append(exact([page]) in (exact([learned[q]]),
                                                    exact([first[q]])))
                if swapped.is_set():
                    rounds_after[c] += 1
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append((c, repr(exc)))

    swap_at: list = []

    def watch():   # the moment the rebuilt index replaces the old one
        while not stop.is_set():
            if coll._device_index is not old:
                swap_at.append(time.perf_counter())
                return
            time.sleep(0.002)

    reset_counts()
    clients = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(4)] + [threading.Thread(target=watch,
                                                      daemon=True)]
    for t in clients:
        t.start()
    conf = Conf()
    conf.merge_quiet_hours = "0-23"
    dm = DailyMerge([coll], conf)
    refused0 = g_stats.counters.get("membudget.reject.merge", 0)
    # the merge of every dataless Rdb (posdb among them) rides the native
    # core's merge_runs: its calls are counted
    merge_runs, merge_calls = native.merge_runs, []

    def counted_merge(*a, **kw):
        merge_calls.append(sum(len(k) for k in a[0]))
        return merge_runs(*a, **kw)

    posdb_keys = sum(len(r.keys) for r in coll.posdb.runs)
    native.merge_runs = counted_merge
    t0 = time.perf_counter()
    try:
        assert dm.tick(now=datetime(2026, 1, 1, 3, 0))
        out["merge_s"] = time.perf_counter() - t0
        native.merge_runs = merge_runs
        # the posdb run set moved (more than one run merged): the serving
        # index rebuilds its base in the background and swaps it in
        assert runs0["posdb"][0] > 1 or device != "cuda", runs0
        while runs0["posdb"][0] > 1 and (
                not swap_at or getattr(coll, "_di_rebuilding", False)):
            assert time.perf_counter() - t0 < 300, "no swap after the merge"
            assert not errors, errors
            time.sleep(0.01)
        out["swap_s"] = (swap_at[0] if swap_at else time.perf_counter()) - t0
        swapped.set()
        while min(rounds_after) < 1:
            assert time.perf_counter() - t0 < 600, "clients stalled"
            assert not errors, errors
            time.sleep(0.01)
    finally:
        native.merge_runs = merge_runs
        stop.set()
        for t in clients:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in clients), "a client hung"
    assert not errors, errors
    out["merge_runs_calls"] = len(merge_calls)
    out["merge_runs_keys"] = sum(merge_calls)
    # one call took every posdb run: the forced merge itself
    assert runs0["posdb"][0] < 2 or posdb_keys in merge_calls, (
        posdb_keys, merge_calls[:8])
    out["merge_launches"] = launches()
    if device == "cuda":
        assert min(out["merge_launches"][:2]) > 0 and \
            out["merge_launches"][2] == 0, out["merge_launches"]
    fresh = coll._device_index
    out["runs_after_merge"] = run_counts(coll)
    out["merge_base_source"] = fresh.base_source
    scratch = DeviceIndex(coll)
    for cname, a in scratch.columns().items():
        b = fresh.columns()[cname]
        if a.dtype == torch.float16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert a.shape == b.shape and torch.equal(a, b), cname
    del scratch, old
    log(f"[durable] daily merge (forced, every Rdb, posdb first) in "
        f"{out['merge_s']:.2f} s while 4 resident clients served "
        f"({out['merge_runs_calls']} native merge_runs calls over "
        f"{out['merge_runs_keys']} keys); the "
        f"rebuilt base swapped in {out['swap_s']:.2f} s after the merge "
        f"began (built from: "
        f"{out['merge_base_source']}); (runs, memtable records) before "
        f"{runs0}, after {out['runs_after_merge']}; {len(served)} pages "
        f"served, every one equal to the page before the merge (totals, "
        f"docids by tie runs, scores), {sum(served)} of them bitwise; the "
        f"swapped index equals one built from scratch (columns bitwise); "
        f"K1 / K2 launches {out['merge_launches'][:2]}")
    assert all(n <= 1 for n, _ in out["runs_after_merge"].values())
    assert g_stats.counters.get("membudget.reject.merge", 0) == refused0

    # ---- kill -9 of a child node ----
    g_residency.reset()
    coll._device_index = None
    coll.save()
    base = colldb.base_dir
    colldb.drop(name)
    del coll, fresh
    words = [f"zqxvdurable{i}" for i in range(16)]
    asked = list(queries) + words
    child = Child(base, name, device, work / "child.log")
    try:
        deadline = time.perf_counter() + 300
        code, _ = child.get("/admin/stats", {}, deadline)
        assert code == 200
        for i, w in enumerate(words):
            req = urllib.request.Request(
                f"{child.base}/inject?c={name}&u=http://durable{i}.example."
                f"com/p", data=(f"<html><title>durable {i}</title><body><p>"
                                f"{w} survives a kill</p></body></html>"
                                ).encode())
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
        pre = {}
        for q in asked:
            code, body = child.get("/search", {"q": q, "c": name,
                                               "format": "json", "n": 10},
                                   deadline)
            assert code == 200, (q, code, body[:300])
            pre[q] = body
        child.kill9()
        assert child.proc.returncode == -9, child.proc.returncode
        child.close()
        child = Child(base, name, device, work / "child.log")
        code, body = child.get("/search", {"q": asked[0], "c": name,
                                           "format": "json", "n": 10},
                               time.perf_counter() + 300)
        out["restart_to_first_page_s"] = time.perf_counter() - child.t0
        assert code == 200 and body == pre[asked[0]], asked[0]
        for q in asked[1:]:
            code, body = child.get("/search", {"q": q, "c": name,
                                               "format": "json", "n": 10},
                                   time.perf_counter() + 120)
            assert code == 200 and body == pre[q], q
        for w in words:
            assert json.loads(pre[w])["totalMatches"] == 1, w
        child.stop()
    finally:
        child.close()
    log(f"[durable] a child serve node took 16 POST /inject (each 200) and "
        f"was killed with SIGKILL; restarted, it answered /search "
        f"{out['restart_to_first_page_s']:.2f} s after its spawn; each of "
        f"the 16 found, and all {len(asked)} pages equal to the pages "
        f"before the kill")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[durable] phase (5g) in {out['phase_s']:.1f} s")
    return out


def native_parity(work: Path, n_docs: int, device: str) -> dict:
    """[native]: the first ``n_docs`` pages of ``gen_docs`` indexed twice,
    into two fresh collections: through the native host core, and through
    the Python path (``native.get_doccore`` and ``native.available``
    report no library, in process). Both dump every 512 pages, so every
    Rdb holds several runs, and both are then force-merged (natively,
    and through the numpy merge). Every Rdb's runs (keys, and the
    titlerecs and other payloads) must be bitwise equal between the two;
    one fixed clock stamps both collections' pages. Returns each path's
    docs/s and merge seconds."""
    import types

    import numpy as np

    from open_source_search_engine_tpu_torch import native
    from open_source_search_engine_tpu_torch.build import docproc
    from open_source_search_engine_tpu_torch.corpus import gen_docs
    from open_source_search_engine_tpu_torch.index.collection import \
        Collection

    docs = list(gen_docs(n_docs))
    calls = {"tokenize": 0, "merge": 0}
    tokenize, merge_runs = native.tokenize_native, native.merge_runs

    def counted_tokenize(*a, **kw):
        cols = tokenize(*a, **kw)
        calls["tokenize"] += cols is not None
        return cols

    def counted_merge(*a, **kw):
        calls["merge"] += 1
        return merge_runs(*a, **kw)

    saved = (docproc.time, native.get_doccore, native.available,
             native.tokenize_native, native.merge_runs)
    out: dict = {}
    images: dict = {}
    try:
        docproc.time = types.SimpleNamespace(time=lambda: 1.7e9,
                                             strptime=time.strptime)
        native.tokenize_native = counted_tokenize
        native.merge_runs = counted_merge
        for path in ("native", "python"):
            if path == "python":
                native.get_doccore = lambda: None
                native.available = lambda: False
            calls.update(tokenize=0, merge=0)
            coll = Collection(f"native_{path}", work / f"native_{path}",
                              device=device)
            t0 = time.perf_counter()
            for i in range(0, n_docs, 512):
                docproc.index_batch(coll, docs[i:i + 512])
                coll.dump_all()
            t_index = time.perf_counter() - t0
            assert coll.num_docs == n_docs, coll.num_docs
            runs = {n: len(r.runs) for n, r in coll.rdbs().items()}
            t0 = time.perf_counter()
            for rdb in coll.rdbs().values():
                rdb.attempt_merge(force=True)
            t_merge = time.perf_counter() - t0
            images[path] = {
                n: [tuple(bytes(np.ascontiguousarray(a).view(np.uint8))
                          for a in (run.keys, run.offsets, run.data)
                          if a is not None) for run in r.runs]
                for n, r in coll.rdbs().items()}
            out[path] = dict(rate=n_docs / t_index, index_s=t_index,
                             merge_s=t_merge, runs_before=runs,
                             tokenized=calls["tokenize"],
                             merges=calls["merge"])
            del coll
    finally:
        (docproc.time, native.get_doccore, native.available,
         native.tokenize_native, native.merge_runs) = saved
    # the native path tokenized every page and merged natively; the
    # Python path did neither
    assert out["native"]["tokenized"] == n_docs, out
    assert out["native"]["merges"] > 0, out
    assert out["python"]["tokenized"] == 0 == out["python"]["merges"], out
    assert out["native"]["runs_before"]["posdb"] > 1, out
    assert images["native"].keys() == images["python"].keys()
    out["bytes"] = 0
    for name, runs in images["native"].items():
        assert len(runs) <= 1, (name, len(runs))
        assert runs == images["python"][name], f"{name} differs"
        out["bytes"] += sum(len(b) for run in runs for b in run)
    out["rdbs"] = sorted(images["native"])
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout of the port (e.g. the parent "
                    "commit): its K1 and K2 are built too, and timed beside "
                    "this checkout's on every timed input")
    opts = ap.parse_args()
    t_start = time.perf_counter()

    # ---- 1. probe ----
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    # ---- 0. the port's doctor: torch, CUDA, the card, both kernels built
    # and loaded (in parallel; phase 2 then finds them built)
    global PEAK_BYTES_S, PEAK_FP32_S
    from open_source_search_engine_tpu_torch.utils import devdoctor, devwatch
    t0 = time.perf_counter()
    doctor = devdoctor.probe(expect_card=True)
    log(f"[doctor] {json.dumps(doctor)} in {time.perf_counter() - t0:.1f} s")
    if doctor["status"] != "ok":
        print(f"FAIL: devdoctor verdict {doctor['status']}: "
              f"{devdoctor.diagnose(doctor)}", file=sys.stderr)
        return 1
    peaks = devwatch.peaks_for(torch.cuda.get_device_name(0))
    if peaks["assumed"]:
        print(f"FAIL: no published peaks for {torch.cuda.get_device_name(0)!r}"
              " in devwatch.GPU_PEAKS", file=sys.stderr)
        return 1
    PEAK_BYTES_S, PEAK_FP32_S = peaks["bw"], peaks["flops"]
    log(f"[doctor] peaks ({peaks['label']}): {PEAK_BYTES_S:.4g} B/s, "
        f"{PEAK_FP32_S:.4g} fp32 FLOP/s, ridge {peaks['ridge']:.4g}")

    from open_source_search_engine_tpu_torch.build import docproc
    from open_source_search_engine_tpu_torch.corpus import (
        assert_tie_run_parity, fd_inputs, gen_docs, long_queries,
        make_queries, rand_cube, wide_queries)
    from open_source_search_engine_tpu_torch.index.carry import \
        collection_from_arrays
    from open_source_search_engine_tpu_torch.index.collection import (
        Collection, CollectionDb)
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

    # ---- 2. build: one nvcc per source and one g++ per host library,
    # all started together ----
    from concurrent.futures import ThreadPoolExecutor

    from open_source_search_engine_tpu_torch import native
    par_msk, par_fdk = load_parent(opts.parent) if opts.parent else (None,
                                                                     None)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as ex:
        host_libs = [ex.submit(native.get_doccore), ex.submit(native.get_lib)]
        builds = list(ex.map(lambda m: m.build(),
                             [m for m in (msk, fdk, par_msk, par_fdk) if m]))
        host_libs = [f.result() for f in host_libs]
    builds = builds[:2]   # the report is this checkout's
    log(f"[build] {', '.join(so.name for so, _ in builds)}, "
        f"{', '.join(Path(lib._name).name for lib in host_libs if lib)} in "
        f"{time.perf_counter() - t0:.1f} s")
    usage: dict = {}
    for _, report in builds:
        usage.update(ptxas_usage(report))
        for line in report.splitlines():
            if "spill" in line and " 0 bytes spill" not in line:
                log(f"[build]   {line.strip()}")
    for entry, (regs, smem) in sorted(usage.items()):
        log(f"[build]   {entry[:72]}: {regs} registers, {smem} B static "
            "shared memory")
    log(f"[build] dynamic shared memory per block: K1 by T "
        f"{ {T: k1_smem(T) for T in (4, 8, 16, 32)} }, K2 by (T, tail) "
        f"{ {(T, t): k2_smem(T, t) for T in (4, 8) for t in (0, 1)} }")

    def parent_k1(cube, fw, counts):
        """The parent's K1 on the same inputs (a wave query by query: its
        kernel has no batch axis), checked bitwise against this
        checkout's, and its time; None without --parent."""
        if par_msk is None:
            return None
        if cube.dim() == 3:
            def run():
                return par_msk.min_scores_fused(cube, fw, counts)
        else:
            def run():
                return torch.stack([par_msk.min_scores_fused(
                    cube[b], fw[b], counts[b]) for b in range(cube.shape[0])])
        assert torch.equal(run(), msk.min_scores_fused(cube, fw, counts))
        return cuda_ms(run)

    def parent_k2(args):
        """The parent's K2 on the same inputs, checked bitwise against
        this checkout's, and its time; None without --parent."""
        if par_fdk is None:
            return None
        a, b = par_fdk.fd_scores(*args), fdk.fd_scores(*args)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        return cuda_ms(lambda: par_fdk.fd_scores(*args))

    # ---- 3. K1 against its plain version on the card ----
    # the shapes of earlier slices draw from `rng` in their old order, so
    # their random cubes (and times) stay comparable; the ragged D = 1001
    # and batched shapes draw from `rng2`
    max_err = 0.0
    rng = np.random.default_rng(0)
    rng2 = np.random.default_rng(3)
    shapes = [(1, T, D) for T in (4, 8) for D in (1000, 1024, 65536)] \
        + [(1, T, 1000) for T in (16, 32, 64, 128)] + [(1, "zero", 1024)] \
        + [(1, T, 1001) for T in (4, 8)] \
        + [(3, T, 1001) for T in (4, 8, 16, 32)]
    random_times = []
    for B, T, D in shapes:
        r = rng2 if D == 1001 else rng
        if T == "zero":
            T = 4
            cube_np = np.zeros((T, P, D), np.uint32)
        else:
            cube_np = np.stack([rand_cube(r, T, D) for _ in range(B)])
        lead = (B,) if cube_np.ndim == 4 else ()
        fw = torch.tensor((r.random(lead + (T,)) * 0.5 + 0.2).astype(
            np.float32), device=dev)
        counts = torch.tensor(r.random(lead + (T,)) < 0.7, device=dev)
        counts[..., 0] = True
        if B == 1:
            cube_np, fw, counts = cube_np.reshape(T, P, D), fw.reshape(T), \
                counts.reshape(T)
        cube = torch.from_numpy(cube_np.view(np.int32)).to(dev)
        got = msk.min_scores_fused(cube, fw, counts)
        want = k1_plain(msk, cube, cube != 0, fw, counts)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (B, T, D,
                                        float((got - want).abs().max()))
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        line = f"[k1] B={B} T={T} D={D} max_abs_err={err:.3g} bitwise=True"
        if D == 65536:
            ms = cuda_ms(lambda: msk.min_scores_fused(cube, fw, counts))
            pms = cuda_ms(lambda: msk.min_scores_plain(
                cube, cube != 0, fw, counts), reps=5, warmup=1)
            bms, by, nb, ops = k1_bound(cube, counts)
            par = parent_k1(cube, fw, counts)
            random_times.append(dict(T=T, D=D, ms=ms, parent_ms=par,
                                     plain_ms=pms, bound_ms=bms,
                                     bound_by=by))
            line += (f" ms={ms:.4f} parent_ms={par} plain_ms={pms:.3f} "
                     f"bound_ms={bms:.4f} ({by}; {nb} B, {ops:.3g} ops)")
        log(line)

    # ---- 3b. K2 against its plain version on the card ----
    k2_err = 0.0
    k2_shapes = [(T, D, rng) for T in (4, 8) for D in (1024, 131072)] \
        + [(T, 1001, rng2) for T in (4, 8)]
    for T, D, r in k2_shapes:
        for tail in (False, True):
            args = to_card(fd_inputs(r, T, D, tail))
            ms_k, pres_k = fdk.fd_scores(*args)
            ms_p, pres_p = fdk.fd_scores_plain(*args)
            torch.cuda.synchronize()
            err = float((ms_k - ms_p).abs().max())
            k2_err = max(k2_err, err)
            assert torch.equal(ms_k, ms_p), (T, D, tail, err)
            assert torch.equal(pres_k, pres_p), (T, D, tail)
            log(f"[k2] T={T} D={D} B=4 tail={tail} max_abs_err={err:.3g} "
                "presence_equal=True bitwise=True")
            del args, ms_k, pres_k, ms_p, pres_p

    # ---- 4. the flat path at full size ----
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # the node's collection registry, so the server of (5d) serves this
    # same index
    colldb = CollectionDb(work / "cuda", device="cuda")
    coll = colldb.get("bench")
    # both routes score the kernel ranking, as bench.py measures it: no
    # PostQueryRerank, no site clustering (tie order decides clustering)
    coll.conf.pqr_enabled = False
    SC = dict(topk=10, with_snippets=False, site_cluster=False)
    # the host indexes through the native core (doccore, rdbcore): no
    # quiet fall back to the Python path on the card's host
    if native.get_doccore() is None or native.get_lib() is None:
        print("FAIL: the native host core did not build or load "
              f"(doccore {native.get_doccore()}, rdbcore "
              f"{native.get_lib()})", file=sys.stderr)
        return 1
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
    coll_rate = coll.num_docs / t_index
    log(f"[index] {coll.num_docs} docs in {t_index:.1f} s "
        f"({coll_rate:.1f} docs/s through the native host core, every "
        f"page with its date fielddb record, every write journaled; "
        f"{smi}); runs per Rdb "
        f"{ {n: r for n, (r, _) in run_counts(coll).items()} }")
    assert coll.num_docs == N_DOCS, coll.num_docs

    # ---- [native]: the first NATIVE_SLICE pages through both host paths
    nat = native_parity(work, NATIVE_SLICE, "cuda")
    log(f"[native] the first {NATIVE_SLICE} pages of the corpus, indexed "
        f"into two fresh collections (a dump every 512 pages) and "
        f"force-merged: native {nat['native']['rate']:.1f} docs/s, merge "
        f"{nat['native']['merge_s']:.3f} s ({nat['native']['merges']} "
        f"merge_runs calls); Python path {nat['python']['rate']:.1f} "
        f"docs/s, merge {nat['python']['merge_s']:.3f} s; runs before "
        f"the merge {nat['native']['runs_before']}; every Rdb's run "
        f"({', '.join(nat['rdbs'])}: {nat['bytes']} B of keys and "
        f"payloads, titlerecs included) bitwise equal; {smi}")

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
    assert torch.equal(got, want), float((got - want).abs().max())
    k_ms = cuda_ms(lambda: msk.min_scores_fused(cube, fw, counts))
    p_ms = cuda_ms(lambda: msk.min_scores_plain(cube, cube != 0, fw,
                                                counts), reps=5, warmup=1)
    b_ms, b_by, nb, ops = k1_bound(cube, counts)
    k_par = parent_k1(cube, fw, counts)
    log(f"[k1] main-path cube {tuple(cube.shape)} ({big_q!r}): "
        f"ms={k_ms:.4f} parent_ms={k_par} plain_ms={p_ms:.3f} bound_ms="
        f"{b_ms:.5f} ({b_by}; {nb} B, {ops:.3g} ops) "
        f"bitwise={bool(torch.equal(got, want))}")

    # the T = 8 and T = 16 buckets on real cubes: of eight queries of 5-8
    # words (of the 512 commonest) and of 9-16 words (of the 64
    # commonest), the one with the most candidates, first pass
    wide_k1 = []
    for lo, hi, top, seed in ((5, 8, 512, 77), (9, 16, 64, 78)):
        wq = max(wide_queries(8, seed, lo, hi, top), key=lambda q: len(
            packer.prepare_query(coll, compile_query(q)).cand))
        wpq = packer.pack_pass(packer.prepare_query(coll, compile_query(wq)),
                               max_docs=1 << 16)
        tw = to_device(wpq, dev)
        wcube, _ = scatter_cube(tw[0], tw[1], tw[2], tw[3],
                                len(wpq.siterank), P)
        wfw, wcounts = tw[4], tw[8]
        assert torch.equal(msk.min_scores_fused(wcube, wfw, wcounts),
                           msk.min_scores_plain(wcube, wcube != 0, wfw,
                                                wcounts)), wq
        w = dict(where="flat", shape=list(wcube.shape), query=wq,
                 ms=cuda_ms(lambda: msk.min_scores_fused(wcube, wfw,
                                                         wcounts)),
                 parent_ms=parent_k1(wcube, wfw, wcounts))
        w["bound_ms"], w["bound_by"] = k1_bound(wcube, wcounts)[:2]
        wide_k1.append(w)
        log(f"[k1] flat cube {tuple(wcube.shape)} ({wq!r}): ms={w['ms']:.4f}"
            f" parent_ms={w['parent_ms']} bound_ms={w['bound_ms']:.5f} "
            f"({w['bound_by']}) bitwise=True")

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
    for q in queries[:8] + long_queries():
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
    log(f"[parity] 8 queries and {len(long_queries())} long queries "
        f"CUDA == CPU ({time.perf_counter() - t0:.1f} s)")
    del cpu, pos, tit

    # ---- 5. the device-resident route (the main path) ----
    from open_source_search_engine_tpu_torch.corpus import (ROUTE_ENV,
                                                            ROUTE_QUERIES,
                                                            route_docs)
    from open_source_search_engine_tpu_torch.query.devindex import \
        DeviceIndex
    from open_source_search_engine_tpu_torch.serve.tenancy import \
        g_residency
    from open_source_search_engine_tpu_torch.utils.stats import g_stats

    # (5a) the device build (build/devbuild.py), spans and peak memory,
    # then every column and directory table against the host oracle
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    t0 = time.perf_counter()
    di = engine.get_device_index(coll)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    build_spans = {k: v[1] for k, v in trace.totals.items()
                   if k.startswith(("devbuild.", "devindex."))}
    assert g_stats.counters.get("build.device_base", 0) == 1, \
        g_stats.counters
    log(f"[devindex] device build in {t_build:.2f} s: {di.n_docs} docs, "
        f"D_cap {di.D_cap}, {len(di.dense_slot_of)} dense rows (V="
        f"{di.d_dense_imp.shape[0]}), {len(di.cube_slot_of)} cube rows (Vc="
        f"{di.Vc}), {di.Nb} posting slots; resident "
        f"{di.resident_bytes() / 2**30:.3f} GiB, peak allocated "
        f"{build_peak / 2**30:.3f} GiB")
    for name, secs in build_spans.items():
        log(f"[devindex]   {name}: {secs:.3f} s")
    log("[devindex]   (an earlier run's figure: the host-oracle build took "
        "35.3 s in PR 3's proof run on the same corpus)")
    saved_devbuild = os.environ.get("OSSE_DEVBUILD")
    os.environ["OSSE_DEVBUILD"] = "0"
    try:
        t0 = time.perf_counter()
        oracle = DeviceIndex(coll)
        torch.cuda.synchronize()
        t_oracle = time.perf_counter() - t0
    finally:
        if saved_devbuild is None:
            os.environ.pop("OSSE_DEVBUILD")
        else:
            os.environ["OSSE_DEVBUILD"] = saved_devbuild
    for name in ("dir_termids", "base_df", "dir_dstart", "dir_pstart",
                 "base_docids", "h_doc_col", "dir2_termids", "delta_df",
                 "dir2_dstart", "dir2_pstart", "all_docids", "tomb_df"):
        a, b = getattr(oracle, name), getattr(di, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("Nb", "Mb", "N2", "M2", "D_cap", "Vc", "dense_slot_of",
                 "cube_slot_of"):
        assert getattr(oracle, name) == getattr(di, name), name
    for name, a in oracle.columns().items():
        b = di.columns()[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float16:  # impacts: raw float16 bits
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), name
    log(f"[devindex] host-oracle build (OSSE_DEVBUILD=0) in {t_oracle:.2f} "
        f"s; every column ({len(di.columns())}) and directory table of the "
        "device build is bitwise equal to it")
    assert (di.base_source, oracle.base_source) == ("device", "host")
    del oracle, a, b
    # the oracle wrote the run set's disk base cache. On CUDA a parked
    # tenant's cold start (its loop included) takes the device build,
    # which is faster than the cache; the cache is read where the device
    # build is off (OSSE_DEVBUILD=0), bitwise equal to the device build.
    # Then the device-built index serves again
    coll._device_index = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.get_resident_loop(coll)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    assert coll._device_index.base_source == "device", \
        coll._device_index.base_source
    g_residency.reset()
    os.environ["OSSE_DEVBUILD"] = "0"
    try:
        t0 = time.perf_counter()
        cached = DeviceIndex(coll)
        torch.cuda.synchronize()
        t_cached = time.perf_counter() - t0
    finally:
        if saved_devbuild is None:
            os.environ.pop("OSSE_DEVBUILD")
        else:
            os.environ["OSSE_DEVBUILD"] = saved_devbuild
    assert cached.base_source == "cache", cached.base_source
    for name in ("dir_termids", "base_df", "dir_dstart", "dir_pstart",
                 "base_docids", "h_doc_col"):
        a, b = getattr(cached, name), getattr(di, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name, a in cached.columns().items():
        b = di.columns()[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), name
    log(f"[devindex] a parked tenant's cold start (loop included) took the "
        f"device build in {t_cold:.2f} s; the disk base cache, read with "
        f"the device build off, in {t_cached:.2f} s (device build "
        f"{t_build:.2f} s, host oracle {t_oracle:.2f} s in this run); every "
        "column of the cache bitwise equal to the device build")
    coll._device_index = di
    del cached, a, b

    def wave_words(a):  # words an FD wave reads: quarter rows + tail
        return a[0].numel() * (1 if a[-1] is None else 2)

    def route_batch(qs, **kw):
        """engine.search_device_batch over qs with the route's kernel
        calls and wave runners wrapped. Returns the pages, the batch's
        seconds, per T the largest FD wave's K2 arguments and the largest
        batched K1 call (an F1 wave's phase 2, [B, T, 16, κ2]), and the
        F1 wave calls and F2 queries. The wrappers pass the arguments on
        untouched; nothing on the route writes to them after the call."""
        fd, k1 = {}, {}
        waves = {"f1_calls": 0, "f2_queries": 0}
        fd_scores, ms_fused = fdk.fd_scores, scorer.min_scores_fused
        run_f1, run_f2 = di._run_batch, di._run_batch_f2

        def keep_fd(*a):
            T = a[0].shape[1] // 4
            if T not in fd or wave_words(a) > wave_words(fd[T]):
                fd[T] = a
            return fd_scores(*a)

        def keep_k1(cube, freq_weight, counts, pvalid=None):
            T = cube.shape[-3]
            if cube.dim() == 4 and (T not in k1
                                    or cube.numel() > k1[T][0].numel()):
                k1[T] = (cube, freq_weight, counts)
            return ms_fused(cube, freq_weight, counts, pvalid)

        def count_f1(plans, *a):
            waves["f1_calls"] += 1
            return run_f1(plans, *a)

        def count_f2(plans, *a):
            waves["f2_queries"] += len(plans)
            return run_f2(plans, *a)
        fdk.fd_scores, scorer.min_scores_fused = keep_fd, keep_k1
        di._run_batch, di._run_batch_f2 = count_f1, count_f2
        try:
            t0 = time.perf_counter()
            pages = engine.search_device_batch(coll, qs, **SC, **kw)
            secs = time.perf_counter() - t0
        finally:
            fdk.fd_scores, scorer.min_scores_fused = fd_scores, ms_fused
            del di._run_batch, di._run_batch_f2
        return pages, secs, fd, k1, waves

    def reset_counts():
        msk.launches = msk.plain_calls = 0
        fdk.launches_tail = fdk.launches_notail = fdk.plain_calls = 0

    # the batch, with every counter set to 0 just before
    routes0, esc0 = dict(di.route_counts), di.escalations
    trace.reset()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    batch, t_batch, fd_waves, k1_waves, waves = route_batch(queries)
    k1_dev = msk.launches
    k2_launches = fdk.launches_tail + fdk.launches_notail
    k2_split = (fdk.launches_tail, fdk.launches_notail)
    plain_dev = msk.plain_calls + fdk.plain_calls
    routes = {k: di.route_counts[k] - routes0[k] for k in routes0}
    escalations = di.escalations - esc0
    log(f"[device] batch of {len(queries)}: {t_batch * 1e3:.1f} ms "
        f"({len(queries) / t_batch:.2f} qps); routes {routes}, escalations "
        f"{escalations}; K1 launches {k1_dev} (F1 wave calls "
        f"{waves['f1_calls']}, F2 queries {waves['f2_queries']}), K2 "
        f"launches {k2_launches} "
        f"(tail {k2_split[0]}, no tail {k2_split[1]}), plain calls "
        f"{plain_dev}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, (calls, secs) in sorted(trace.totals.items(),
                                      key=lambda kv: -kv[1][1]):
        log(f"[device]   {name}: {calls} calls, {secs:.3f} s, "
            f"{secs / t_batch:.1%} of the batch")
    assert sum(routes.values()) == len(queries), routes
    assert routes["fd"] > 0 and k2_launches > 0, (routes, k2_launches)
    assert routes["f1"] + routes["f2"] > 0 and k1_dev > 0 and k1_waves, \
        (routes, k1_dev)
    # one K1 launch per F1 wave call (the whole wave) and per F2 query
    assert k1_dev == waves["f1_calls"] + waves["f2_queries"], (k1_dev, waves)
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
    prof_dev = report_profile(f"device batch of {len(queries)}", prof,
                              prof_wall)
    dev_idle, dev_busy_ms, prof_k = prof_dev or (None, None, {})

    # K2 on the largest FD wave of the batch: against plain, timed
    args = max(fd_waves.values(), key=wave_words)
    ms_k, pres_k = fdk.fd_scores(*args)
    ms_p, pres_p = fdk.fd_scores_plain(*args)
    k2_err = max(k2_err, float((ms_k - ms_p).abs().max()))
    assert torch.equal(ms_k, ms_p) and torch.equal(pres_k, pres_p), k2_err
    k2_ms = cuda_ms(lambda: fdk.fd_scores(*args))
    k2_plain_ms = cuda_ms(lambda: fdk.fd_scores_plain(*args), reps=3,
                          warmup=1)
    k2_b_ms, k2_by, k2_nb, k2_ops = k2_bound(args[0], args[1], args[2],
                                             args[3], args[5], args[6])
    k2_shape = dict(B=args[0].shape[0], T=args[0].shape[1] // 4,
                    D=args[3].shape[0], tail=args[6] is not None)
    k2_par = parent_k2(args)
    log(f"[k2] main-path wave {k2_shape}: ms={k2_ms:.4f} parent_ms="
        f"{k2_par} plain_ms={k2_plain_ms:.3f} bound_ms={k2_b_ms:.5f} "
        f"({k2_by}; {k2_nb} B, {k2_ops:.3g} ops) "
        f"bitwise={bool(torch.equal(ms_k, ms_p))}")
    # what sets K2's pace, two diagnostics on the same wave: no group
    # counted (the copies, gates and presence bits only: the body returns
    # at once), and the wave without its tail (half the shared memory)
    no_counts = torch.zeros_like(args[5])
    k2_stage_ms = cuda_ms(lambda: fdk.fd_scores(*args[:5], no_counts,
                                                args[6]))
    k2_notail_ms = (cuda_ms(lambda: fdk.fd_scores(*args[:6], None))
                    if args[6] is not None else None)
    log(f"[k2] main-path wave diagnostics: staging, gates and presence "
        f"only {k2_stage_ms:.4f} ms; without its tail {k2_notail_ms} ms")

    # K1 on the largest batched call of the route (an F1 wave's phase 2):
    # against plain, timed as one launch and, for comparison, as one
    # launch per query of the wave
    k1d_cube, k1d_fw, k1d_counts = max(k1_waves.values(),
                                       key=lambda a: a[0].numel())
    k1d_pv = k1d_cube != 0
    got = msk.min_scores_fused(k1d_cube, k1d_fw, k1d_counts)
    want = k1_plain(msk, k1d_cube, k1d_pv, k1d_fw, k1d_counts)
    assert torch.equal(got, want), float((got - want).abs().max())
    k1d_ms = cuda_ms(lambda: msk.min_scores_fused(k1d_cube, k1d_fw,
                                                  k1d_counts))

    def k1_per_query():
        for b in range(k1d_cube.shape[0]):
            msk.min_scores_fused(k1d_cube[b], k1d_fw[b], k1d_counts[b])
    k1d_perq_ms = cuda_ms(k1_per_query)
    k1d_plain_ms = cuda_ms(lambda: k1_plain(
        msk, k1d_cube, k1d_pv, k1d_fw, k1d_counts), reps=5, warmup=1)
    k1d_b_ms, k1d_by, nb, ops = k1_bound(k1d_cube, k1d_counts)
    k1d_shape = list(k1d_cube.shape)
    k1d_par = parent_k1(k1d_cube, k1d_fw, k1d_counts)
    log(f"[k1] largest F1 wave {tuple(k1d_shape)}: ms={k1d_ms:.4f} (one "
        f"launch per query: {k1d_perq_ms:.4f}) parent_ms={k1d_par} "
        f"plain_ms={k1d_plain_ms:.3f} bound_ms={k1d_b_ms:.5f} ({k1d_by}; "
        f"{nb} B, {ops:.3g} ops) bitwise=True")
    del args, fd_waves, ms_k, pres_k, ms_p, pres_p, k1_waves, k1d_cube, \
        k1d_fw, k1d_counts, k1d_pv, got, want

    # the T = 8 bucket on the route: 16 queries of 5-8 words (8 of the 64
    # commonest words and 8 of any), each page equal to the flat path's;
    # over this index all 16 go direct, so K2 is timed on the batch's
    # largest T = 8 wave (K1 at T = 8 is timed on the flat path's cube)
    wide = wide_queries(8, 79, 5, 8, 64) + wide_queries(8, 80, 5, 8)
    routes0 = dict(di.route_counts)
    reset_counts()
    wpages, t_wide, wfd, wk1, wwaves = route_batch(wide)
    wroutes = {k: di.route_counts[k] - routes0[k] for k in routes0}
    wl = (msk.launches, fdk.launches_tail + fdk.launches_notail)
    assert wl[0] == wwaves["f1_calls"] + wwaves["f2_queries"], (wl, wwaves)
    assert msk.plain_calls + fdk.plain_calls == 0
    for q, res in zip(wide, wpages):
        assert_tie_run_parity(as_raw(res),
                              as_raw(engine.search(coll, q, **SC)), q)
    log(f"[device] batch of {len(wide)} 5-8 word queries: "
        f"{t_wide * 1e3:.1f} ms; routes {wroutes}; K1 launches {wl[0]} "
        f"({wwaves}), K2 launches {wl[1]}; each page equals the flat "
        "path's")
    a = wfd[8]
    got, want = fdk.fd_scores(*a), fdk.fd_scores_plain(*a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    wide_k2 = dict(B=a[0].shape[0], T=8, D=a[3].shape[0],
                   tail=a[6] is not None,
                   ms=cuda_ms(lambda: fdk.fd_scores(*a)),
                   parent_ms=parent_k2(a))
    wide_k2["bound_ms"], wide_k2["bound_by"] = k2_bound(
        a[0], a[1], a[2], a[3], a[5], a[6])[:2]
    log(f"[k2] largest T = 8 FD wave {wide_k2}: bitwise=True")
    del wfd, wk1, a, got, want

    # (5b) resident serving: the batch through the collection's
    # ResidentLoop (owned by the tenant plane), every counter set to 0
    # just before; every total, docid and score equal to the one-shot
    # batch's on the same index
    reset_counts()
    rpages, t_res, _, _, rwaves = route_batch(queries, resident=True)
    res_k1 = msk.launches
    res_k2 = fdk.launches_tail + fdk.launches_notail
    res_plain = msk.plain_calls + fdk.plain_calls
    loop = engine.get_resident_loop(coll)
    assert loop is coll._resident_loop and loop.alive
    assert res_k1 > 0 and res_k2 > 0 and res_plain == 0, (res_k1, res_k2,
                                                          res_plain)
    assert res_k1 == rwaves["f1_calls"] + rwaves["f2_queries"], (res_k1,
                                                                 rwaves)
    for q, a, b in zip(queries, rpages, batch):
        assert a.total_matches == b.total_matches, q
        assert [(r.docid, r.score) for r in a.results] == \
            [(r.docid, r.score) for r in b.results], q
    log(f"[resident] batch of {len(queries)}: {t_res * 1e3:.1f} ms; K1 "
        f"launches {res_k1} ({rwaves}), K2 launches {res_k2}, plain calls "
        f"{res_plain}; every total, docid and score equals the one-shot "
        "batch's")

    # 4 clients, each sending its 16 queries one at a time, concurrently
    import threading
    want = dict(zip(queries, batch))
    n_clients = 4
    lat_res: list = []
    errors: list = []
    start = threading.Barrier(n_clients)

    def client(c):
        try:
            start.wait(timeout=60)
            for q in queries[c::n_clients]:
                t1 = time.perf_counter()
                (page,) = engine.search_device_batch(coll, [q], **SC,
                                                     resident=True)
                lat_res.append((time.perf_counter() - t1) * 1e3)
                assert_tie_run_parity(as_raw(page), as_raw(want[q]), q)
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append((c, repr(exc)))

    waves0 = loop.waves_issued
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(n_clients)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        torch.cuda.synchronize()
        t_clients = time.perf_counter() - t0
    assert not any(t.is_alive() for t in clients), "a client hung"
    assert not errors, errors
    assert len(lat_res) == len(queries)
    cl_k = (msk.launches, fdk.launches_tail + fdk.launches_notail,
            msk.plain_calls + fdk.plain_calls)
    assert cl_k[0] > 0 and cl_k[1] > 0 and cl_k[2] == 0, cl_k
    cl_waves = loop.waves_issued - waves0
    resident = dict(
        batch_ms=t_res * 1e3, batch_qps=len(queries) / t_res,
        clients=n_clients, clients_qps=len(queries) / t_clients,
        clients_p50_ms=statistics.median(lat_res),
        clients_max_ms=max(lat_res), clients_waves_issued=cl_waves,
        clients_k1_launches=cl_k[0], clients_k2_launches=cl_k[1])
    log(f"[resident] {n_clients} clients x {len(queries) // n_clients} "
        f"queries: {t_clients * 1e3:.1f} ms, {resident['clients_qps']:.2f} "
        f"qps; per query p50 {resident['clients_p50_ms']:.2f} ms, max "
        f"{resident['clients_max_ms']:.2f} ms; waves issued {cl_waves}; K1 "
        f"launches {cl_k[0]}, K2 launches {cl_k[1]}, plain calls {cl_k[2]};"
        " each client got its own results")
    prof_res = report_profile(f"{n_clients} resident clients", prof,
                              t_clients)
    resident["device_idle"], resident["device_busy_ms"] = (
        prof_res[:2] if prof_res else (None, None))

    # (5c) freshness: pages written to the memtable are served by the
    # next resident answer (a delta refresh moves the generation) ...
    fresh_word = "zqxvfreshpage"
    gen0 = di._built_version
    docproc.index_batch(coll, [(
        f"http://fresh{i}.example.com/p",
        f"<html><title>fresh {i}</title><body><p>{fresh_word} news "
        f"number {i}</p></body></html>") for i in range(8)])
    t = loop.submit([compile_query(fresh_word)], topk=64)
    ((_, fscores, fn),) = t.wait(timeout=120)
    assert fn == 8 and len(fscores) == 8, (fn, fscores)
    assert t.generation != gen0 and t.generation == coll.posdb.version
    assert t.di is di  # the delta folded into the serving index
    # ... and a dump rebuilds the base in the background: the old index
    # serves until the fresh one swaps in
    t0 = time.perf_counter()
    coll.dump_all()
    assert engine.get_device_index(coll) is di
    assert coll._di_rebuilding, "no background rebuild in flight"
    t1 = time.perf_counter()
    during = engine.search_device_batch(coll, queries[:16], **SC,
                                        resident=True)
    t_during = time.perf_counter() - t1
    assert all(p.total_matches >= 0 for p in during)
    while coll._di_rebuilding:
        assert time.perf_counter() - t0 < 300, "rebuild did not finish"
        time.sleep(0.01)
    t_rebuild = time.perf_counter() - t0
    fresh = engine.get_device_index(coll)
    assert fresh is not di and fresh._built_version == coll.posdb.version
    scratch = DeviceIndex(coll)
    for name, a in scratch.columns().items():
        b = fresh.columns()[name]
        if a.dtype == torch.float16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert a.shape == b.shape and torch.equal(a, b), name
    plans = [compile_query(q) for q in queries + [fresh_word]]
    t = loop.submit(plans, topk=64)
    after = t.wait(timeout=120)
    assert t.di is fresh
    for q, (ad, asc, an), (bd, bsc, bn) in zip(
            queries + [fresh_word], after, scratch.search_batch(plans,
                                                                topk=64)):
        assert an == bn and list(ad) == list(bd), q
        assert np.array_equal(asc.view(np.int32), bsc.view(np.int32)), q
    assert after[-1][2] == 8
    resident.update(rebuild_s=t_rebuild, batch_during_rebuild_ms=t_during
                    * 1e3)
    log(f"[rebuild] {fresh_word!r} served from the memtable (generation "
        f"{gen0} -> {t.generation}); after dump_all() the old index served "
        f"a batch of 16 in {t_during * 1e3:.1f} ms during the background "
        f"rebuild, which swapped in after {t_rebuild:.2f} s; {len(plans)} "
        "queries after the swap equal a DeviceIndex built from scratch "
        f"(columns bitwise); base built from: {fresh.base_source} (the "
        f"rebuild), {scratch.base_source} (from scratch); runs per Rdb "
        f"after the dump {run_counts(coll)}; merges refused by the budget "
        f"{g_stats.counters.get('membudget.reject.merge', 0)}")
    # the resident index's device bytes do not spend the host budget: the
    # dump's merge ran, and no Rdb holds more than max_runs runs
    assert all(len(db.runs) <= db.max_runs
               for db in coll.rdbs().values()), run_counts(coll)
    assert not g_stats.counters.get("membudget.reject.merge"), \
        g_stats.counters
    g_residency.reset()
    assert not loop.alive and loop.join(timeout=60)
    del di, fresh, scratch, after, during, t
    coll._device_index = None

    log(f"[serve] base built from: "
        f"{engine.get_device_index(coll).base_source}")
    served = serve_over_http(colldb, coll, queries, work, reset_counts,
                             report_profile)
    g_residency.reset()
    coll._device_index = None

    telem = telemetry(colldb, coll, queries, work, smi)
    g_residency.reset()
    coll._device_index = None

    log(f"[numeric] base built from: "
        f"{engine.get_device_index(coll).base_source}")
    numeric = numeric_operators(colldb, coll, queries, work, reset_counts,
                                smi)
    g_residency.reset()
    coll._device_index = None

    route = route_corpus(work / "route", "cuda")

    crawled = crawled_corpus(work, queries, reset_counts, smi, "cuda")

    meshed = mesh(colldb, coll, queries, work, reset_counts, smi)
    g_residency.reset()
    coll._device_index = None

    clustered = cluster_fleet(work / "grid4", coll.name, queries,
                              meshed.pop("flat_totals"), work, smi, "cuda")

    durable = durability(colldb, coll.name, queries, work, reset_counts,
                         "cuda")
    del coll

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
    # registers (ptxas) and shared memory (static + dynamic) of the
    # instantiations the main path's timed calls run
    k1_T = k1d_shape[1]
    k1_regs, k1_static = usage_of(
        usage, f"min_scores_stagedILi{k1_T}E" if k1_T in (4, 8, 16)
        else f"min_scores_directILi{k1_T if k1_T in (32, 64) else 0}E")
    k2_regs, k2_static = usage_of(
        usage, f"fd_scores_kernelILi{k2_shape['T']}ELb"
               f"{int(k2_shape['tail'])}E")
    kernels = {"kernels": [{
        "name": "min_scores", "route": "cuda",
        "source": "open_source_search_engine_tpu_torch/csrc/min_scores.cu",
        "replaces": "open_source_search_engine_tpu/query/pallas_scores.py"
                    ":173",
        "launches": res_k1, "launches_one_shot_batch": k1_dev,
        "launches_served": served["k1_launches"],
        "launches_numeric": {
            "one_shot_range": numeric["launches"]["range"][0],
            "one_shot_sorted": numeric["launches"]["sort"][0],
            "resident_mixed": numeric["resident_launches"][0],
            "served_mixed": numeric["served"]["k1_launches"]},
        "launches_durability": {
            "reopened_batch": durable["reopen_launches"][0],
            "clients_across_merge": durable["merge_launches"][0]},
        "launches_mesh": {
            "host_merge": meshed["host_merge"]["k1_launches"],
            "in_program": meshed["in_program"]["k1_launches"],
            "in_program_waves": meshed["in_program"]["waves"],
            "sharded_search": meshed["sharded_search"]["k1_launches"],
            "resident_clients": meshed["clients"]["k1_launches"],
            "http_mesh": meshed["http_mesh"]["k1_launches"],
            "http_sharded_search":
                meshed["http_sharded_search"]["k1_launches"]},
        "launches_cluster_nodes": clustered["k1_launches"],
        "launches_crawled": crawled["k1_launches"],
        "mesh_stacked_cube": meshed["k1_stacked"],
        "max_abs_err": max(max_err, meshed["k1_stacked"]["max_abs_err"]),
        "ms": k1d_ms, "parent_ms": k1d_par, "plain_ms": k1d_plain_ms,
        "bound_ms": k1d_b_ms,
        "bound_by": k1d_by, "library_ms": None, "parity": "pass",
        "shape": k1d_shape, "regs": k1_regs,
        "smem_bytes": (None if k1_static is None
                       else k1_static + k1_smem(k1_T)),
        "f1_wave_calls": waves["f1_calls"],
        "f2_queries": waves["f2_queries"],
        "ms_one_launch_per_query": k1d_perq_ms,
        "device_ms_in_profiled_batch": prof_k.get("min_scores", (None,))[0],
        "launches_flat_path": flat_launches, "ms_flat_path": k_ms,
        "parent_ms_flat_path": k_par,
        "plain_ms_flat_path": p_ms, "bound_ms_flat_path": b_ms,
        "bound_by_flat_path": b_by, "shape_flat_path": list(cube.shape),
        "random_cubes": random_times, "wide_cubes": wide_k1,
    }, {
        "name": "fd_scores", "route": "cuda",
        "source": "open_source_search_engine_tpu_torch/csrc/fd_scores.cu",
        "replaces": "open_source_search_engine_tpu/query/pallas_scores.py"
                    ":226",
        "launches": res_k2, "launches_one_shot_batch": k2_launches,
        "launches_served": served["k2_launches"],
        "launches_numeric": {
            "one_shot_range": numeric["launches"]["range"][1],
            "one_shot_sorted": numeric["launches"]["sort"][1],
            "resident_mixed": numeric["resident_launches"][1],
            "served_mixed": numeric["served"]["k2_launches"]},
        "launches_durability": {
            "reopened_batch": durable["reopen_launches"][1],
            "clients_across_merge": durable["merge_launches"][1]},
        "launches_mesh": {
            "host_merge": meshed["host_merge"]["k2_launches"]},
        "launches_cluster_nodes": clustered["k2_launches"],
        "launches_crawled": crawled["k2_launches"],
        "mesh_shard_wave": meshed["k2_shard_wave"],
        "launches_tail_notail": list(k2_split),
        "max_abs_err": max(k2_err, meshed["k2_shard_wave"]["max_abs_err"]), "ms": k2_ms, "parent_ms": k2_par,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_b_ms, "bound_by": k2_by, "library_ms": None,
        "parity": "pass", "shape": k2_shape, "regs": k2_regs,
        "smem_bytes": (None if k2_static is None else k2_static
                       + k2_smem(k2_shape["T"], k2_shape["tail"])),
        "device_ms_in_profiled_batch": prof_k.get("fd_scores", (None,))[0],
        "ms_staging_only": k2_stage_ms,
        "ms_same_wave_without_tail": k2_notail_ms,
        "wide_wave_t8": wide_k2,
    }], "device_route": {
        "build_s": t_build, "batch_ms": t_batch * 1e3,
        "batch_qps": len(queries) / t_batch,
        "warm_batch_ms": t_warm * 1e3, "warm_batch_qps": len(queries) / t_warm,
        "single_p50_ms": statistics.median(lat_dev),
        "single_max_ms": max(lat_dev), "routes": routes,
        "escalations": escalations, "wide_batch_routes": wroutes,
        "device_idle": dev_idle,
        "device_busy_ms": dev_busy_ms,
        "k2_share_of_busy": (prof_k["fd_scores"][0] / dev_busy_ms
                             if dev_busy_ms else None),
        "oracle_build_s": t_oracle,
        "device_build_peak_gib": build_peak / 2**30,
        "device_build_spans_s": build_spans, "resident": resident,
        "served": served, "telemetry": telem, "doctor": doctor,
        "numeric": numeric, "route_corpus": route,
        "cold_start_s": t_cold, "cache_read_s": t_cached,
        "durability": durable, "mesh": meshed, "cluster": clustered,
        "crawl": crawled,
        "index_docs_s": coll_rate}}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

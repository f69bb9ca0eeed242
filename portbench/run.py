"""Run one cell of the port's benchmark once.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found
by name from ``BENCHMARK.json`` at the root of the checkout: a
configuration is ``portbench/configs/<config>.json``, which names its
entry into the program (``portbench/entries/<entry>.py``); a traffic mix
is ``portbench/traffic/<traffic>.json``, which names its query generator
(``portbench/generators/<generator>.py``); a metric is
``portbench/metrics/<metric>.py`` (a ``read(run)`` that returns a number,
or None where the run gave it nothing to read).

The run opens the configuration's node (building its collection into
``portbench/cache/`` on the first run in a checkout, a build timed apart
from ``setup_s``), warms it up with one batch a submitter of the cell's
own traffic, then drives it closed-loop for ``--seconds``: each
submitter sends its next batch of unique queries when the last
returns. With ``--trace 0`` it reports the cell's end-to-end metrics;
with ``--trace 1`` it profiles the window and reports the per-layer
ones. After the window it frees the node and holds a sample of the
window's pages, drawn from the seed, to the plain reference
(``reference.py``, ``compare.py``). The last line of standard output is
one JSON object; the numbers compared end standard error and the line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import itertools
import json
import math
import os
import random
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "open_source_search_engine_tpu")
#: pages held to the reference a run, besides the query with most terms
SAMPLE = 64
#: device bytes of kernel inputs a traced run may hold for its rooflines
CAPTURE_BYTES = 4 << 30


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _process_start() -> float:
    """Wall-clock time this process started (Linux), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text()
                    .rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()


def _bytes_written() -> dict:
    """This process's written bytes: ``wchar`` (every write call) and
    ``write_bytes`` (what reached the block layer), where Linux has
    them."""
    try:
        return {k: int(v) for k, v in (
            line.split(": ") for line in
            Path("/proc/self/io").read_text().splitlines())
            if k in ("wchar", "write_bytes")}
    except OSError:
        return {}


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, workload: str):
    """(cell, configuration entry, configuration, traffic) by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    centry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / centry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, centry, cfg, traffic


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]


def _module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded by its path."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    return _module("metrics", name).read


def query_stream(traffic: dict, seed: int, corpus, avoid=()):
    """The cell's queries for ``seed`` over the collection ``corpus`` (a
    ``gen.Corpus``), without end.

    Every seed asks the same work: the traffic's ``pool`` is a fixed set
    of ``pool.size`` queries, drawn by the traffic's generator with
    ``pool.seed`` (leaving out any whose set of words is in ``avoid``),
    and the stream passes through it again and again, each pass in an
    order drawn from ``seed``. Each query's words are put in an order
    drawn anew each time, so that no string comes twice and no cache of
    the program keyed on a query's text serves one: a window that ends
    part way through a pass is all that differs from seed to seed."""
    g, pool = traffic["queries"], traffic["pool"]
    avoid = {frozenset(q.split()) for q in avoid}
    gen_ = _module("generators", g["generator"]).stream(
        int(pool["seed"]), corpus, **g["args"])
    words = [q.split() for q in itertools.islice(
        (q for q in gen_ if frozenset(q.split()) not in avoid),
        int(pool["size"]))]
    rng = random.Random(seed)
    seen: set[str] = set()
    while True:
        for i in rng.sample(range(len(words)), len(words)):
            w = list(words[i])
            for _ in range(64):
                rng.shuffle(w)
                q = " ".join(w)
                if q not in seen:
                    break
            else:
                raise RuntimeError(f"no unused order of {words[i]}: the "
                                   "pool is too small for the window")
            seen.add(q)
            yield q


# ------------------------------------------------------------ the window

class Capture:
    """The inputs of K1 and K2 launches in a traced window, held by
    reference (no device work) until the window has closed: every
    ``step``-th launch of each kernel, the step doubling (and every other
    held launch let go) whenever the held tensors, which the program
    would have freed, pass CAPTURE_BYTES. ``kept[k]`` holds (launch
    index, arguments), ``launches[k]`` counts every launch."""

    def __init__(self):
        self.kept = {"k1": [], "k2": []}
        self.launches = {"k1": 0, "k2": 0}
        self.step = {"k1": 1, "k2": 1}
        self.held = 0
        self.on = False
        self._saved = None

    def install(self):
        from open_source_search_engine_tpu_torch.query import (
            fd_scores_kernel, scorer)
        k1, k2 = scorer.min_scores_fused, fd_scores_kernel.fd_scores

        def k1_entry(cube, freq_weight, counts, pvalid=None):
            self._keep("k1", (cube, counts), cube.numel() * 4)
            return k1(cube, freq_weight, counts, pvalid)

        def k2_entry(*args):
            tail = args[6] if len(args) > 6 else None
            self._keep("k2", args, 0 if tail is None
                       else tail.numel() * 4)
            return k2(*args)

        self._saved = (scorer, fd_scores_kernel, k1, k2)
        scorer.min_scores_fused = k1_entry
        fd_scores_kernel.fd_scores = k2_entry

    def _keep(self, k, args, nbytes):
        if not self.on:
            return
        i = self.launches[k]
        self.launches[k] += 1
        if i % self.step[k]:
            return
        self.kept[k].append((i, args, nbytes))
        self.held += nbytes
        while self.held > CAPTURE_BYTES and self.step[k] < (1 << 30):
            self.step[k] *= 2
            self.kept[k] = [x for x in self.kept[k]
                            if x[0] % self.step[k] == 0]
            self.held = sum(x[2] for v in self.kept.values() for x in v)

    def uninstall(self):
        scorer, fdk, k1, k2 = self._saved
        scorer.min_scores_fused = k1
        fdk.fd_scores = k2


class Spans:
    """The program's spans in a traced window, as intervals: each stage
    total the program adds (``utils/trace._total``, called as a span
    ends) is noted with its end on the host clock."""

    def __init__(self):
        self.got: list = []
        self._saved = None

    def install(self):
        from open_source_search_engine_tpu_torch.utils import trace
        total = trace._total

        def noted(name, dt, tags):
            t1 = time.perf_counter()
            self.got.append((name, t1 - dt, t1))
            return total(name, dt, tags)

        self._saved = (trace, total)
        trace._total = noted

    def uninstall(self):
        trace, total = self._saved
        trace._total = total


def drive(system, batches_of, submitters: int, seconds: float | None,
          record: bool = True):
    """Closed loop: ``submitters`` threads, each sending its next batch
    (``batches_of()``, None when the stream is spent) when the last
    returns, until ``seconds`` have passed (an error if the stream runs
    out first), or with ``seconds`` None until the stream is spent;
    in-flight batches finish. Returns (window start, window end, [(t0,
    t1, queries, pages, submitter)])."""
    out: list = []
    errors: list = []
    lock = threading.Lock()
    t_start = time.perf_counter()
    t_end = t_start + (math.inf if seconds is None else seconds)

    def loop(sub):
        try:
            while time.perf_counter() < t_end:
                with lock:
                    qs = batches_of()
                if qs is None:
                    if seconds is None:
                        return
                    raise RuntimeError("the query stream ran out")
                t0 = time.perf_counter()
                pages = system.search(qs)
                t1 = time.perf_counter()
                if record:
                    with lock:
                        out.append((t0, t1, qs, pages, sub))
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
            raise

    threads = [threading.Thread(target=loop, args=(i,),
                                name=f"submitter{i}")
               for i in range(submitters)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return t_start, t_end, out


def _batcher(queries, size: int):
    """Batches of ``size`` from an iterable of queries; None when it
    cannot fill one."""
    it = iter(queries)

    def nxt():
        qs = list(itertools.islice(it, size))
        return qs if len(qs) == size else None
    return nxt


def run_cell(cell: dict, cfg: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, metrics: list[dict],
             device: str = "cuda", ref_cache: Path | None = None,
             fault=None) -> dict:
    """Run one cell once; returns the result line's object. ``fault``,
    when given, is called with the system before the window (the tests
    break the timed path with it)."""
    import torch

    from portbench import compare, gen, reference, system, workmodel
    from open_source_search_engine_tpu_torch.query import (
        fd_scores_kernel as fdk)
    from open_source_search_engine_tpu_torch.query import (
        min_scores_kernel as msk)
    from open_source_search_engine_tpu_torch.utils import trace as ptrace

    cuda = device.startswith("cuda")
    size, subs = int(traffic["batch"]), int(traffic["submitters"])
    corpus = gen.Corpus(cfg["corpus"])
    g = traffic["queries"]
    warm = list(itertools.islice(
        _module("generators", g["generator"]).stream(
            int(traffic["warmup_seed"]), corpus, **g["args"]),
        size * subs))
    # the window's queries: drawn ahead for ``ahead_qps``, and on from
    # the same stream should the node answer faster
    ahead = int(math.ceil(float(traffic["ahead_qps"]) * seconds))
    stream = query_stream(traffic, seed, corpus, avoid=warm)
    drawn = list(itertools.islice(stream, ahead))
    stream = itertools.chain(drawn, stream)
    node = system.System(cfg, device, log)
    if node.build_s > 1.0:
        log(f"first run in this checkout: the collection's build took "
            f"{node.build_s:.3f} s (left out of setup_s)")
    # one batch a submitter, both in flight: the cell's own shapes
    drive(node, _batcher(warm, size), subs, None, record=False)
    if fault is not None:
        fault(node)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - T_START - node.build_s
    log(f"ready: setup {setup_s:.3f} s (open {node.open_s:.3f} s, device "
        f"bases {node.devbuild_s:.3f} s, build {node.build_s:.3f} s apart)")

    cap = prof = spans = None
    if trace:
        from portbench import devtrace
        cap = Capture()
        cap.install()
        spans = Spans()
        spans.install()
        prof = devtrace.start(cuda)
    ptrace.reset()
    routes0 = node.route_counts()
    msk.launches = msk.plain_calls = 0
    fdk.launches_tail = fdk.launches_notail = fdk.plain_calls = 0
    if cap is not None:
        cap.on = True
    t_start, t_end, batches = drive(node, _batcher(stream, size), subs,
                                    seconds)
    if cuda:
        torch.cuda.synchronize()
    t_close = time.perf_counter()
    if cap is not None:
        cap.on = False
        cap.uninstall()
        spans.uninstall()
    profile = devtrace.stop(prof, t_close - t_start, spans.got) \
        if trace else None
    totals = {k: (int(v[0]), float(v[1])) for k, v in ptrace.totals.items()}
    routes = {k: v - routes0.get(k, 0)
              for k, v in node.route_counts().items()}
    launches = {"k1": msk.launches, "k1_plain": msk.plain_calls,
                "k2": fdk.launches_tail + fdk.launches_notail,
                "k2_plain": fdk.plain_calls}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"

    in_window = [b for b in batches if b[1] <= t_end]
    n_done = sum(len(b[2]) for b in in_window)
    run = {
        "seconds": seconds, "setup_s": setup_s, "open_s": node.open_s,
        "devbuild_s": node.devbuild_s, "queries": n_done,
        "rate": completed_rate(in_window, t_start),
        "traced_queries": sum(len(b[2]) for b in batches),
        "totals": totals, "profile": profile,
        "peaks": workmodel.peaks(kind), "capture": cap,
    }
    values = {}
    for m in metrics:
        v = load_reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    log(f"window: {len(in_window)} batches, {n_done} queries in "
        f"{seconds} s ({len(batches) - len(in_window)} finished after); "
        f"routes {routes}; launches {launches}")
    if profile is not None:
        log(f"trace: reduced in {profile['reduce_s']:.3f} s; launches "
            f"held for the rooflines: K1 {len(cap.kept['k1'])} of "
            f"{cap.launches['k1']}, K2 {len(cap.kept['k2'])} of "
            f"{cap.launches['k2']} ({cap.held} B); device events K1 "
            f"{profile['counts'].get('k1')}, K2 {profile['counts'].get('k2')}")
    log("stage totals: " + "; ".join(
        f"{k} {c} calls {s:.3f} s" for k, (c, s) in sorted(totals.items())))

    # the program's pages, then its state freed before the reference runs
    page_of = {q: r for _, _, qs, pages, _ in in_window
               for q, r in zip(qs, pages)}
    sample = sample_of(sorted(page_of), seed)
    got = {q: (page_of[q].total_matches,
               [(int(x.docid), float(x.score), x.url, x.title)
                for x in page_of[q].results]) for q in sample}
    del batches, in_window, page_of, cap
    node_build_s = node.build_s
    node.close()
    del node
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ix = reference.load_index(cfg["corpus"], ref_cache)
    checks, correct, faults = compare.judge(ix, cfg, got, device)
    log(f"reference: {len(sample)} pages in "
        f"{time.perf_counter() - t0:.3f} s")
    for f in faults:
        log(f"fault: {f}")

    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": n_done,
           "failed": 0, "metrics": values, "device": dev}
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        out["breakdown"] = profile["breakdown"]
    out["build_s"] = node_build_s
    out["checks"] = checks
    return out


def completed_rate(in_window: list, t_start: float) -> float | None:
    """Queries a second that the window completed: each submitter's
    queries whose pages came back inside the window, over the time from
    the window's start to its own last completion there, summed over the
    submitters (a batch still in flight at the close neither counts nor
    leaves its time in)."""
    done: dict = {}
    for _, t1, qs, _, sub in in_window:
        n, last = done.get(sub, (0, t_start))
        done[sub] = (n + len(qs), max(last, t1))
    rate = sum(n / (last - t_start) for n, last in done.values()
               if last > t_start)
    return rate or None


def sample_of(done: list[str], seed: int) -> list[str]:
    """The pages a run holds to the reference: SAMPLE of the window's
    queries drawn from the seed, and the one with most words."""
    sample = random.Random(seed).sample(done, min(SAMPLE, len(done)))
    if done:
        longest = max(done, key=lambda q: (len(q.split()), q))
        if longest not in sample:
            sample.append(longest)
    return sample


def _card_line() -> str:
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(HERE / "cache" / sub)
    bench = load_bench()
    cell, _, cfg, traffic = cell_spec(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"card: {_card_line()}")
    out = run_cell(cell, cfg, traffic, args.seed, args.seconds,
                   bool(args.trace),
                   cell_metrics(bench, args.workload, bool(args.trace)),
                   ref_cache=HERE / "cache")
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        log(f"forbidden modules loaded: {found}")
        return 4
    log(f"bytes written by this process: {_bytes_written()}")
    if (HERE / "cache").exists():
        log("cache: " + ", ".join(
            f"{p.name} {sum(f.stat().st_size for f in p.rglob('*') if f.is_file()) if p.is_dir() else p.stat().st_size} B"
            for p in sorted((HERE / "cache").iterdir())))
    for name, (v, lim) in out["checks"].items():
        log(f"check {name}: {v} (limit {lim})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

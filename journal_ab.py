"""Indexing throughput with the write journal on and off.

Runs chip_smoke's ``[index]`` phase (``N_DOCS`` pages of the synthetic
corpus through ``docproc.index_batch`` in chunks of 512, then
``dump_all()``) in a fresh process per run, alternating the journal on
and off as on, off, off, on (``--pairs`` times), each into a fresh
directory, and prints every run's docs/s and the median of each arm.
``OSSE_NO_JOURNAL=1`` turns the journal off, as a user would.

    python3 journal_ab.py [--docs 100000] [--pairs 1] [--device cuda]

The last line is one JSON object with the runs and the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "journal_ab"

_CHILD = """
import json, sys, time
sys.path.insert(0, {root!r})
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import gen_docs
from open_source_search_engine_tpu_torch.index.collection import CollectionDb
coll = CollectionDb({base!r}, device={device!r}).get("bench")
t0 = time.perf_counter()
chunk = []
for doc in gen_docs({docs}):
    chunk.append(doc)
    if len(chunk) == 512:
        docproc.index_batch(coll, chunk)
        chunk = []
if chunk:
    docproc.index_batch(coll, chunk)
coll.dump_all()
secs = time.perf_counter() - t0
assert coll.num_docs == {docs}, coll.num_docs
print(json.dumps({{"seconds": secs, "docs_s": coll.num_docs / secs}}))
"""


def one_run(docs: int, journal: bool, device: str, i: int) -> dict:
    base = WORK / f"run{i}"
    shutil.rmtree(base, ignore_errors=True)
    env = dict(os.environ)
    env.pop("OSSE_NO_JOURNAL", None)
    if not journal:
        env["OSSE_NO_JOURNAL"] = "1"
    out = subprocess.run(
        [sys.executable, "-c", _CHILD.format(root=str(ROOT), base=str(base),
                                             device=device, docs=docs)],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=max(600, docs // 50))
    shutil.rmtree(base, ignore_errors=True)
    if out.returncode != 0:
        raise SystemExit(f"run {i} failed ({out.returncode}): "
                         f"{out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["journal"] = journal
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--pairs", type=int, default=1,
                    help="repeats of the on, off, off, on sequence")
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip() if shutil.which("nvidia-smi") else ""
    print(f"[journal_ab] {opts.docs} pages per run; {smi or 'no GPU'}",
          flush=True)
    runs = []
    t0 = time.perf_counter()
    for _ in range(opts.pairs):
        for journal in (True, False, False, True):
            r = one_run(opts.docs, journal, opts.device, len(runs))
            runs.append(r)
            print(f"[journal_ab] journal {'on ' if journal else 'off'} "
                  f"{r['seconds']:.1f} s, {r['docs_s']:.1f} docs/s",
                  flush=True)
    med = {arm: statistics.median(r["docs_s"] for r in runs
                                  if r["journal"] == (arm == "on"))
           for arm in ("on", "off")}
    print(f"[journal_ab] median docs/s: journal on {med['on']:.1f}, off "
          f"{med['off']:.1f} ({time.perf_counter() - t0:.1f} s in all)")
    print(json.dumps({"docs": opts.docs, "device": smi, "runs": runs,
                      "median_docs_s": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of the benchmark's comparison: the plain reference,
computed in bfloat16 (the precision below the float32 the configuration
states), put in the program's place and held to the float32 reference
by the same comparison and limits as a run's pages.

    python portbench/control.py --workload <cell> --seeds 11 12 13 \
        [--device cuda]

For each seed it samples the cell's query stream as a run samples its
window (``run.SAMPLE`` queries and the one with most terms) and prints
one JSON line: the numbers compared, each beside its limit, and whether
the control passed. A sound comparison fails every control.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def control(cfg: dict, traffic: dict, seed: int, device: str,
            cache: Path | None, ix=None) -> dict:
    """One seed of the control: its readings, each with its limit."""
    import torch

    from portbench import compare, gen, reference, run
    stream = list(itertools.islice(
        run.query_stream(traffic, seed, gen.Corpus(cfg["corpus"])), 2048))
    sample = run.sample_of(stream, seed)
    ix = ix if ix is not None else reference.load_index(cfg["corpus"],
                                                        cache)
    kw = reference.setting(ix, cfg, device)
    got = {}
    for q in sample:
        low = reference.answer(ix, q, dtype=torch.bfloat16, **kw)
        got[q] = (low.total, [(int(ix.docid[i]), s, str(ix.url[i]),
                               str(ix.title[i])) for i, s in low.page])
    checks, correct, faults = compare.judge(ix, cfg, got, device)
    return {"seed": seed, **checks, "first": faults, "passed": correct}


def main(argv=None) -> int:
    from portbench import reference, run
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, cfg, traffic = run.cell_spec(run.load_bench(), args.workload)
    ix = reference.load_index(cfg["corpus"], HERE / "cache")
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(cfg, traffic, seed, args.device, None, ix=ix)
        out["workload"] = args.workload
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

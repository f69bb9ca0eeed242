"""Small CPU configurations of the benchmark's cells for the harness's
own tests: the cells' traffic and serving at 2,000 pages, with the
port's dense and cube thresholds scaled down so that every route
serves."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
N_DOCS = 2000
#: the port's route thresholds at a small collection (F1, F2 and FD all
#: serve)
ROUTE_ENV = {"OSSE_DENSE_MIN_DF": "32", "OSSE_CUBE_MIN_DF": "32"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def small(cell_name: str):
    """(cell, small configuration, traffic) of a cell."""
    from portbench import run
    cell, _, cfg, traffic = run.cell_spec(bench(), cell_name)
    cfg = copy.deepcopy(cfg)
    cfg["n_docs"] = cfg["corpus"]["n_docs"] = N_DOCS
    traffic = dict(traffic, batch=min(int(traffic["batch"]), 4),
                   pool=dict(traffic["pool"], size=256),
                   ahead_qps=50)
    return cell, cfg, traffic


def set_route_env(monkeypatch) -> None:
    for k, v in ROUTE_ENV.items():
        monkeypatch.setenv(k, v)

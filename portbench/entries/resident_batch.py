"""One search node, one shard: ``engine.search_device_batch(coll,
queries, resident=True)`` on the collection's device base, served by the
resident loop."""

from __future__ import annotations

import time
from importlib import import_module

PORT = "open_source_search_engine_tpu_torch"


class Node:
    def __init__(self, cfg: dict, path, device: str, name: str):
        import torch
        serve = cfg["serving"]
        self.kw = dict(topk=int(serve["topk"]),
                       with_snippets=bool(serve["snippets"]),
                       site_cluster=bool(serve["site_cluster"]))
        self.engine = import_module(f"{PORT}.query.engine")
        self.tenancy = import_module(f"{PORT}.serve.tenancy")
        Collection = import_module(f"{PORT}.index.collection").Collection
        t0 = time.perf_counter()
        self.coll = Collection(name, path, device=device)
        self.coll.conf.pqr_enabled = bool(serve["pqr"])
        self.open_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.index = self.engine.get_device_index(self.coll)
        self.engine.get_resident_loop(self.coll)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.devbuild_s = time.perf_counter() - t0

    def search(self, queries: list[str]):
        return self.engine.search_device_batch(self.coll, queries,
                                               resident=True, **self.kw)

    def route_counts(self) -> dict:
        return dict(self.index.route_counts)

    def close(self) -> None:
        """Stop the loop and drop the device base."""
        self.engine.drop_device_index(self.coll)
        self.tenancy.g_residency.reset()
        self.index = None


def open(cfg: dict, path, device: str, name: str) -> Node:  # noqa: A001
    return Node(cfg, path, device, name)

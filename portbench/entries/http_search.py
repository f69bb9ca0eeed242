"""One search host's web front end: ``SearchHTTPServer`` serving the
built collection, each query one ``GET /search?q=...&format=json&n=10``
on loopback. The server answers through its admission gate and its
``QueryBatcher``, which coalesces concurrent requests into device batches
for the collection's resident loop; the page build, the summaries and
the JSON rendering run on every request.

Each submitting thread keeps its own connection (keep-alive where the
server speaks HTTP/1.1, a new connection a request where it answers
HTTP/1.0), with a 60 s socket timeout, so that a server that hangs fails
the run instead of blocking it. The server's own files (``gb.conf``,
``statsdb.jsonl``, ``slowlog.jsonl``) go to a directory of the entry's
own beside the collection, removed at ``close()``; the shared collection
is only read, and ``close()`` fails if any of its files changed.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import tempfile
import threading
import time
import urllib.parse
from importlib import import_module
from pathlib import Path

PORT = "open_source_search_engine_tpu_torch"
#: seconds a request may wait on its socket before the run fails
TIMEOUT_S = 60.0
#: the first request, which builds the device base and starts the
#: resident loop: capitalized, so that no string of the traffic (all in
#: lower case) can meet it in the result cache
WARM_QUERY = "Word0"


def listing(path) -> dict:
    """Every file under ``path``: relative name -> (size, mtime_ns)."""
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            st = os.stat(os.path.join(root, f))
            out[os.path.relpath(os.path.join(root, f), path)] = \
                (st.st_size, st.st_mtime_ns)
    return out


class Node:
    def __init__(self, cfg: dict, path, device: str, name: str):
        import torch
        serve = cfg["serving"]
        self.path = Path(path)
        self.name = name
        self.topk = int(serve["topk"])
        engine = import_module(f"{PORT}.query.engine")
        self.engine = engine
        self.tenancy = import_module(f"{PORT}.serve.tenancy")
        server = import_module(f"{PORT}.serve.server")
        CollectionDb = import_module(f"{PORT}.index.collection").CollectionDb
        self.before = listing(self.path)
        self.base = Path(tempfile.mkdtemp(prefix="http-",
                                          dir=self.path.parent))
        t0 = time.perf_counter()
        colldb = CollectionDb(self.path, device=device)
        self.coll = colldb.get(name, create=False)
        self.coll.conf.pqr_enabled = bool(serve["pqr"])
        # the front end's defaults are the configuration's page
        if not (bool(serve["snippets"]) and bool(serve["site_cluster"])
                and int(serve["max_per_site"]) == engine.MAX_PER_SITE):
            raise ValueError("the web front end serves summaries and "
                             f"{engine.MAX_PER_SITE} results a site")
        self.open_s = time.perf_counter() - t0
        self._conns: list = []
        self._lock = threading.Lock()
        self._local = threading.local()
        # devbuild_s: the server's start and its first batch, which
        # builds the device base and starts the resident loop
        t0 = time.perf_counter()
        self.server = server.SearchHTTPServer(
            self.base, port=0, device=device, colldb=colldb)
        self.server.start()
        self.search([WARM_QUERY])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.devbuild_s = time.perf_counter() - t0

    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection("127.0.0.1", self.server.port,
                                           timeout=TIMEOUT_S)
            self._local.conn = c
            with self._lock:
                self._conns.append(c)
        return c

    def search(self, queries: list[str]) -> list:
        """Each query one request on this thread's connection."""
        return [self._get(q) for q in queries]

    def _get(self, q: str):
        """One ``format=json`` page, parsed into the engine's
        ``SearchResults`` (the fields the harness reads, and the
        summaries)."""
        url = "/search?" + urllib.parse.urlencode(
            {"q": q, "c": self.name, "format": "json", "n": self.topk})
        c = self._conn()
        c.request("GET", url)
        r = c.getresponse()
        body = r.read()
        if r.status != 200:
            raise RuntimeError(f"/search {q!r}: {r.status} {body[:300]!r}")
        d = json.loads(body)
        return self.engine.SearchResults(
            query=d["query"], total_matches=int(d["totalMatches"]),
            results=[self.engine.Result(
                docid=int(x["docId"]), score=float(x["score"]),
                url=x["url"], title=x["title"], snippet=x["snippet"])
                for x in d["results"]])

    def route_counts(self) -> dict:
        di = getattr(self.coll, "_device_index", None)
        return dict(di.route_counts) if di is not None else {}

    def close(self) -> None:
        """Stop the server and the loop, drop the device base, and check
        that the shared collection was left as it was."""
        with self._lock:
            for c in self._conns:
                c.close()
            self._conns.clear()
        self.server.stop()
        self.engine.drop_device_index(self.coll)
        self.tenancy.g_residency.reset()
        shutil.rmtree(self.base, ignore_errors=True)
        after = listing(self.path)
        if after != self.before:
            changed = sorted(k for k in set(after) | set(self.before)
                             if after.get(k) != self.before.get(k))
            raise RuntimeError(f"the shared collection changed: {changed}")


def open(cfg: dict, path, device: str, name: str) -> Node:  # noqa: A001
    return Node(cfg, path, device, name)

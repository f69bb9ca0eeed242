"""The system under test: the configuration's collection built once into
the benchmark's cache, then opened through the configuration's entry
(``portbench/entries/<entry>.py``) as a restarted node opens it.

The collection is fixed by the configuration; ``--seed`` only orders
the queries. A node that restarts does not re-index: it opens its saved
index and builds its device base. So the first run of a configuration in
a checkout indexes the pages (through ``docproc.index_batch`` in chunks
of 512, dumped and force-merged to one run per Rdb, so that no merge
runs during a window) into ``portbench/cache/``; later runs open what it
left. The cache key holds the corpus settings and a digest of the port's
sources that produce the index, so a change to the indexer never serves
a stale collection.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import shutil
import time
from importlib import import_module
from pathlib import Path

PORT = "open_source_search_engine_tpu_torch"
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "cache"
NAME = "bench"


def _digest(paths) -> str:
    h = hashlib.sha256()
    for base in paths:
        base = Path(base)
        files = sorted(base.rglob("*")) if base.is_dir() else [base]
        for f in files:
            if f.is_file() and "__pycache__" not in f.parts:
                h.update(f.relative_to(base.parent).as_posix().encode())
                h.update(f.read_bytes())
    return h.hexdigest()


def collection_key(cfg: dict) -> str:
    """Key of the collection: the corpus settings, the port's indexing
    sources, the corpus generator and this file."""
    h = hashlib.sha256(json.dumps(cfg["corpus"], sort_keys=True).encode())
    h.update(_digest([ROOT / PORT / d for d in ("build", "index", "native")]
                     + [HERE / "gen.py", Path(__file__)]).encode())
    return h.hexdigest()[:16]


def build_collection(cfg: dict, device: str, log) -> Path:
    """The collection's directory, built when the cache lacks it."""
    from portbench.gen import Corpus
    out = CACHE / f"coll-{collection_key(cfg)}"
    if out.exists():
        return out
    docproc = import_module(f"{PORT}.build.docproc")
    Collection = import_module(f"{PORT}.index.collection").Collection
    native = import_module(f"{PORT}.native")
    corpus = Corpus(cfg["corpus"])
    tmp = out.with_name(out.name + ".building")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    coll = Collection(NAME, tmp, device=device)
    chunk: list = []
    for doc in corpus.docs():
        chunk.append(doc)
        if len(chunk) == 512:
            docproc.index_batch(coll, chunk)
            chunk = []
    if chunk:
        docproc.index_batch(coll, chunk)
    coll.dump_all()
    for rdb in coll.rdbs().values():
        rdb.attempt_merge(force=True)
    coll.save()
    if coll.num_docs != corpus.n_docs:
        raise RuntimeError(f"indexed {coll.num_docs} of {corpus.n_docs} "
                           "pages")
    log(f"built the collection: {coll.num_docs} pages, {corpus.vocab} "
        f"terms in the law, in {time.perf_counter() - t0:.3f} s (native "
        f"host core {native.get_doccore() is not None})")
    del coll
    tmp.rename(out)
    return out


def load_entry(name: str):
    """The entry module ``portbench/entries/<name>.py``."""
    path = HERE / "entries" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_entry_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class System:
    """One configuration's node: its collection from the cache (built on
    a checkout's first run, ``build_s``), opened through its entry.
    ``search(queries)`` is the timed call, ``close()`` frees the
    device."""

    def __init__(self, cfg: dict, device: str, log):
        t0 = time.perf_counter()
        path = build_collection(cfg, device, log)
        self.build_s = time.perf_counter() - t0
        self.node = load_entry(cfg["entry"]).open(cfg, path, device, NAME)
        self.open_s = self.node.open_s
        self.devbuild_s = self.node.devbuild_s

    def search(self, queries: list[str]):
        return self.node.search(queries)

    def route_counts(self) -> dict:
        return self.node.route_counts()

    def close(self) -> None:
        self.node.close()
        self.node = None

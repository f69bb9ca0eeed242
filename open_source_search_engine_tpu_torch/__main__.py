"""Command-line entry point (the reference's ``gb`` verbs)::

    python -m open_source_search_engine_tpu_torch serve --dir ./data --port 8000
    python -m open_source_search_engine_tpu_torch inject --dir ./data URL [FILE]
    python -m open_source_search_engine_tpu_torch search --dir ./data "query"

Each takes ``--torch-device {cuda,cpu}`` (default ``cuda``): the device
queries score on. ``serve`` runs the node's HTTP server until SIGINT or
SIGTERM, then stops it and saves every open collection (its runs, doc
count, speller and conf), so a restart answers the same; the reference's
autosave clock and daily merge are not carried. ``inject`` dumps the
collection after indexing, so a later process reads it back, and exits 1
with ``"error": "banned"`` when a tagdb ``manualban`` drops the page.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dir", default="./osse_data",
                   help="node data directory (default ./osse_data)")
    p.add_argument("--coll", default="main",
                   help="collection name (default main)")
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda", help="scoring device (default cuda)")


def cmd_serve(args) -> int:
    import signal
    import threading

    from .serve.server import SearchHTTPServer

    srv = SearchHTTPServer(args.dir, host=args.host, port=args.port,
                           device=args.torch_device)
    srv.colldb.get(args.coll)   # open (or create) the default collection
    srv.start()
    stop = threading.Event()

    def handler(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    print(json.dumps({"serving": f"http://{args.host}:{srv.port}/",
                      "coll": args.coll, "dir": args.dir,
                      "device": args.torch_device}), flush=True)
    stop.wait()
    srv.stop()
    srv.colldb.save_all()
    print(json.dumps({"stopped": True, "saved": sorted(srv.colldb.colls)}),
          flush=True)
    return 0


def cmd_inject(args) -> int:
    from .build import docproc
    from .index.collection import Collection

    coll = Collection(args.coll, args.dir, device=args.torch_device)
    content = (Path(args.file).read_text(encoding="utf-8", errors="replace")
               if args.file else sys.stdin.read())
    ml = docproc.index_document(coll, args.url, content)
    coll.dump_all()
    if ml is None:  # tagdb manualban
        print(json.dumps({"injected": args.url, "error": "banned"}))
        return 1
    print(json.dumps({"injected": args.url, "docid": int(ml.docid),
                      "docs": coll.num_docs}))
    return 0


def cmd_search(args) -> int:
    from .index.collection import Collection
    from .query import engine

    if not (Path(args.dir) / "coll" / args.coll).is_dir():
        print(f"no such collection: {args.coll}", file=sys.stderr)
        return 1
    coll = Collection(args.coll, args.dir, device=args.torch_device)
    res = engine.search(coll, args.query, topk=args.k)
    out = {
        "query": res.query,
        "total": res.total_matches,
        "results": [{"url": r.url, "title": r.title,
                     "score": round(r.score, 3), "docid": r.docid,
                     "snippet": r.snippet} for r in res.results],
    }
    print(json.dumps(out, indent=None if args.json else 2))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m open_source_search_engine_tpu_torch",
        description="search engine on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="run the node's HTTP server")
    _add_common(p)
    p.add_argument("--host", default="127.0.0.1",
                   help="listen address (default 127.0.0.1)")
    p.add_argument("--port", type=int, default=8000,
                   help="listen port (default 8000; 0 = any free port)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("inject", help="index one document")
    _add_common(p)
    p.add_argument("url")
    p.add_argument("file", nargs="?", help="HTML file (default: stdin)")
    p.set_defaults(fn=cmd_inject)

    p = sub.add_parser("search", help="query a collection")
    _add_common(p)
    p.add_argument("query")
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--json", action="store_true", help="compact JSON")
    p.set_defaults(fn=cmd_search)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Command-line entry point (the reference's ``gb`` verbs)::

    python -m open_source_search_engine_tpu_torch serve --dir ./data --port 8000
    python -m open_source_search_engine_tpu_torch inject --dir ./data URL [FILE]
    python -m open_source_search_engine_tpu_torch search --dir ./data "query"
    python -m open_source_search_engine_tpu_torch crawl --dir ./data \
        --seeds http://a.test/,http://b.test/ --max-pages 100
    python -m open_source_search_engine_tpu_torch save --dir ./data
    python -m open_source_search_engine_tpu_torch repair --dir ./data
    python -m open_source_search_engine_tpu_torch rebalance --dir ./grid \
        --out ./grid4 --old-shards 1 --new-shards 4
    python -m open_source_search_engine_tpu_torch node --dir ./grid4/shard_000 \
        --port 9000 --hosts hosts.conf --shard 0 --device
    python -m open_source_search_engine_tpu_torch proxy --hosts hosts.conf

Each takes ``--torch-device {cuda,cpu}`` (default ``cuda``): the device
queries score on. ``serve`` runs the node's HTTP server with the autosave
clock (``--autosave`` minutes) and the daily merge (the
``merge_quiet_hours`` parm) until SIGINT or SIGTERM, then stops it and
saves every open collection (each Rdb's memtable checkpoint, the doc
count, the speller and the conf), so a restart answers the same; every
write is journaled first, so a kill -9 loses no acknowledged ``/inject``.
Its server has a spider (``SpiderLoop`` over ``--coll``) that ``/addurl``
queues into; with ``--spider`` the serve loop also crawls, a
``crawl_step`` at a time (ignored with ``--hosts``). ``crawl`` crawls the
``--seeds`` into ``--coll`` through a durable frontier
(``--dir/spider/<coll>``) until the frontier drains or ``--max-pages``
pages are indexed, then saves.
``inject`` saves after indexing, and exits 1 with ``"error": "banned"``
when a tagdb ``manualban`` drops the page. ``save`` checkpoints every
collection of the directory; ``repair`` rebuilds a collection's posdb,
clusterdb and linkdb from its titledb. ``rebalance`` (``gb scale``)
re-shards a grid of ``shard_XXX`` directories into a new one, saved.

``node`` runs one shard replica of a cluster (``parallel.cluster``'s
``ShardNodeServer``, its collection ``shard`` under ``--dir``) until
SIGINT or SIGTERM, then saves; ``--device`` serves it through the device
route, and ``--torch-device`` says where that runs. ``proxy`` is the
stateless front end over a cluster (``--hosts``, a hosts.conf file):
``/search`` fans out to the nodes and merges; ``serve --hosts`` does the
same beside a local collection directory.
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
    import time

    from .control.dailymerge import DailyMerge
    from .control.process import Process
    from .serve.server import SearchHTTPServer
    from .spider.loop import SpiderLoop

    cluster = None
    if args.hosts:
        from .parallel.cluster import ClusterClient, HostsConf
        cluster = ClusterClient(HostsConf.load(args.hosts))
        if args.spider:
            print("--spider is ignored with --hosts: crawled pages "
                  "would land in the local collection while searches "
                  "go to the cluster", file=sys.stderr)
            args.spider = False
    srv = SearchHTTPServer(args.dir, host=args.host, port=args.port,
                           device=args.torch_device, cluster=cluster)
    # open (or create) the default collection; its spider feeds /addurl
    spider = SpiderLoop(srv.colldb.get(args.coll))
    srv.spider = spider
    proc = Process(autosave_minutes=args.autosave)
    proc.register(srv.colldb)
    proc.install_signal_handlers()
    proc.start_autosave()
    # quiet-hours full merges (DailyMerge.h:11); the window is the
    # merge_quiet_hours parm, empty = disabled
    dm = DailyMerge(lambda: [srv.colldb.get(n) for n in srv.colldb.names()],
                    srv.conf)
    dm.start()
    proc.on_shutdown(dm.stop)
    srv.start()
    print(json.dumps({"serving": f"http://{args.host}:{srv.port}/",
                      "coll": args.coll, "dir": args.dir,
                      "device": args.torch_device}), flush=True)
    while not proc.stopping:
        if not args.spider:
            time.sleep(0.2)
        elif spider.crawl_step() == 0:
            time.sleep(1.0)
    srv.stop()         # no request writes while the collections save
    proc.shutdown()
    spider.fetcher.close()
    if cluster is not None:
        cluster.close()
    print(json.dumps({"stopped": True, "saved": sorted(srv.colldb.colls)}),
          flush=True)
    return 0


def cmd_proxy(args) -> int:
    """The query-routing front proxy (``gb proxy``, ``Proxy.cpp``): no
    local index; ``/search`` fans out to the cluster's nodes and serves
    the merged page."""
    import tempfile
    import time

    from .control.process import Process
    from .parallel.cluster import ClusterClient, HostsConf
    from .serve.server import SearchHTTPServer

    cluster = ClusterClient(HostsConf.load(args.hosts))
    srv = SearchHTTPServer(tempfile.mkdtemp(prefix="osse_proxy_"),
                           host=args.host, port=args.port,
                           device=args.torch_device, cluster=cluster)
    proc = Process(autosave_minutes=0)
    proc.install_signal_handlers()
    srv.start()
    print(json.dumps({"proxy": f"http://{args.host}:{srv.port}/",
                      "hosts": args.hosts}), flush=True)
    while not proc.stopping:
        time.sleep(0.2)
    srv.stop()
    cluster.close()
    return 0


def cmd_node(args) -> int:
    """One shard-replica node process (the reference's per-host gb
    instance). A fleet spawns it once per (shard, replica) with the
    cluster map (``--hosts``), the node's seat in it and the chaos seed in
    ``OSSE_CHAOS``; SIGTERM or SIGINT saves and stops it."""
    import os
    import signal
    import time

    from .parallel.cluster import HostsConf, ShardNodeServer
    from .utils import chaos as chaos_mod

    chaos_mod.maybe_enable()
    cluster_map = HostsConf.load(args.hosts) if args.hosts else None
    node = ShardNodeServer(args.dir, host=args.host, port=args.port,
                           use_device=args.device, shard=args.shard,
                           replica=args.replica, cluster_map=cluster_map,
                           device=args.torch_device)
    stop = [False]

    def handler(signum, frame):
        stop[0] = True  # the save runs below, under the writer lock

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    node.start()
    print(json.dumps({"node": f"{args.host}:{node.port}",
                      "docs": node.coll.num_docs,
                      "shard": args.shard, "replica": args.replica,
                      "device": args.torch_device, "route":
                      "device" if args.device else "flat",
                      "pid": os.getpid()}), flush=True)
    while not stop[0]:
        time.sleep(0.3)
    node.save()
    node.stop()
    return 0


def cmd_inject(args) -> int:
    from .build import docproc
    from .index.collection import CollectionDb

    colldb = CollectionDb(args.dir, device=args.torch_device)
    coll = colldb.get(args.coll)
    content = (Path(args.file).read_text(encoding="utf-8", errors="replace")
               if args.file else sys.stdin.read())
    ml = docproc.index_document(coll, args.url, content)
    colldb.save_all()
    if ml is None:  # tagdb manualban
        print(json.dumps({"injected": args.url, "error": "banned"}))
        return 1
    print(json.dumps({"injected": args.url, "docid": int(ml.docid),
                      "docs": coll.num_docs}))
    return 0


def cmd_save(args) -> int:
    from .index.collection import CollectionDb

    colldb = CollectionDb(args.dir, device=args.torch_device)
    for name in colldb.names():
        colldb.get(name)
    colldb.save_all()
    print(json.dumps({"saved": colldb.names()}))
    return 0


def cmd_repair(args) -> int:
    from .control.rebalance import repair
    from .index.collection import CollectionDb

    colldb = CollectionDb(args.dir, device=args.torch_device)
    try:
        coll = colldb.get(args.coll, create=False)
    except KeyError:
        print(f"no such collection: {args.coll}", file=sys.stderr)
        return 1
    print(json.dumps({"repaired": args.coll, "docs": repair(coll)}))
    return 0


def cmd_rebalance(args) -> int:
    """``gb scale`` (main.cpp:2356): grow or shrink the shard grid."""
    from .control.rebalance import rebalance

    dst = rebalance(args.coll, args.dir, args.out,
                    old_n_shards=args.old_shards,
                    new_n_shards=args.new_shards,
                    n_replicas=args.replicas, device=args.torch_device)
    print(json.dumps({"shards": dst.n_shards, "docs": dst.num_docs,
                      "out": args.out}))
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


def cmd_crawl(args) -> int:
    from .index.collection import CollectionDb
    from .spider.loop import SpiderLoop
    from .spider.spiderdb import DurableSpiderScheduler

    colldb = CollectionDb(args.dir, device=args.torch_device)
    coll = colldb.get(args.coll)
    sched = DurableSpiderScheduler(Path(args.dir) / "spider" / args.coll,
                                   banned=coll.tagdb.is_banned)
    loop = SpiderLoop(coll, scheduler=sched)
    for seed in (args.seeds or "").split(","):
        if seed.strip():
            loop.add_url(seed.strip())
    stats = loop.crawl(max_pages=args.max_pages)
    colldb.save_all()
    loop.sched.save()
    loop.fetcher.close()
    print(json.dumps({"fetched": stats.fetched, "indexed": stats.indexed,
                      "errors": stats.errors, "docs": coll.num_docs}))
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
    p.add_argument("--autosave", type=float, default=5.0,
                   help="autosave interval in minutes (default 5)")
    p.add_argument("--hosts", help="hosts.conf: front a node cluster "
                   "instead of the local collections")
    p.add_argument("--spider", action="store_true",
                   help="also run the crawl loop in the serve loop")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("node", help="run one shard-replica node (cluster)")
    p.add_argument("--dir", default="./osse_shard",
                   help="the node's data directory (default ./osse_shard)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="listen port (default 0 = any free port)")
    p.add_argument("--device", action="store_true",
                   help="serve queries through the device route")
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda", help="scoring device (default cuda)")
    p.add_argument("--hosts", help="the hosts.conf cluster map")
    p.add_argument("--shard", type=int, default=0,
                   help="this node's shard in the map")
    p.add_argument("--replica", type=int, default=0,
                   help="this node's twin within the shard")
    p.set_defaults(fn=cmd_node)

    p = sub.add_parser("proxy", help="query-routing front proxy: /search "
                       "fans out to the cluster, no local index")
    p.add_argument("--hosts", required=True, help="the hosts.conf map")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda", help="device of the proxy's (empty) "
                   "local collections (default cuda)")
    p.set_defaults(fn=cmd_proxy)

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

    p = sub.add_parser("crawl", help="run the spider")
    _add_common(p)
    p.add_argument("--seeds", help="comma-separated seed URLs")
    p.add_argument("--max-pages", type=int, default=100)
    p.set_defaults(fn=cmd_crawl)

    p = sub.add_parser("save", help="checkpoint every collection")
    _add_common(p)
    p.set_defaults(fn=cmd_save)

    p = sub.add_parser("repair", help="rebuild posdb, clusterdb and "
                       "linkdb from titledb")
    _add_common(p)
    p.set_defaults(fn=cmd_repair)

    p = sub.add_parser("rebalance",
                       help="re-shard a collection grid (gb scale)")
    _add_common(p)
    p.add_argument("--out", required=True, help="new grid directory")
    p.add_argument("--old-shards", type=int, required=True)
    p.add_argument("--new-shards", type=int, required=True)
    p.add_argument("--replicas", type=int, default=1)
    p.set_defaults(fn=cmd_rebalance)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

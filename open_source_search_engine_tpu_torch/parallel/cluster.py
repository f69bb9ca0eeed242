"""Multi-process host plane — shards as separate node processes.

A port of ``open_source_search_engine_tpu/parallel/cluster.py``. A node
takes the port's ``device=`` (where its Collection, its DeviceIndex and
its kernels live; ``None`` means ``cuda``, which raises without a card)
besides the reference's ``use_device`` (the device route instead of the
flat path). Each node plans with its own shard's statistics, as in the
reference: cluster pages can score otherwise than the flat route's, and
their totals are equal. The client merges the legs on the host, in numpy,
in the reference's order (:func:`merge_legs`). ``/rpc/stats`` also
carries the node's kernel launch counters (``kernel.*``), its device
errors (``node.device_error``) and, on a card, its allocator's bytes
there (``node.device_*_bytes`` gauges), and each ``/rpc/search`` is
timed as ``node.search``.

This is the reference's L2 made real across process boundaries: a node
process owns one shard replica (a :class:`~..index.collection.Collection`
plus its device index) and serves a small RPC surface; a client-side
:class:`ClusterClient` routes work by the same key→shard maps the
in-process plane uses. Reference semantics carried over:

* **Topology from a hosts.conf-style file** (``Hostdb.cpp:124``):
  ``num-mirrors: M`` then one ``host:port`` line per node; the first
  ``n_shards`` lines are replica 0, the next ``n_shards`` replica 1, …
* **Writes go to ALL twins, retry-forever to dead ones**
  (``Msg1.cpp:20``): a failed delivery parks in a per-host retry queue
  that redelivers in the background until the twin answers — a
  restarted node catches up from the queue (plus its own durable Rdb
  state) without any resync ceremony.
* **Reads pick the serving twin and reroute on failure**
  (``Multicast.cpp:520`` ``pickBestHost``): a connection error or
  timeout marks the host dead and retries the next twin immediately;
  when every twin of a shard is down the query still answers, flagged
  ``degraded=True`` (the silent-partial-results trap from round 2).
* **Heartbeats** (``PingServer.h:61``): a background prober pings every
  node and maintains the alive matrix; recovered hosts are marked
  alive again and immediately serve.

The courier is :mod:`.transport` (stdlib HTTP, but no longer boring):
pooled keep-alive connections per host, hedged twin reads with RTT
EWMAs, per-shard query batching, and a negotiated binary codec for the
bulk routes — the ``UdpServer.cpp``/``Multicast.cpp`` roles over HTTP.
The *semantics* here stay the work: scatter-gather queries (the Msg3a
merge) run the per-shard execution in parallel and merge top-k
host-side; inside each node the query still runs on the TPU-resident
two-phase kernel, so ICI does the per-shard heavy lifting and this
plane is the DCN/control story.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from ..cache import g_cacheplane
from ..index.collection import Collection
from ..utils import chaos as chaos_mod
from ..utils import deadline as deadline_mod
from ..utils import ghash
from ..utils import priority as priority_mod
from ..utils import threads
from ..utils import trace as trace_mod
from ..utils.lockcheck import make_lock, make_rlock
from ..utils.log import get_logger
from ..utils.stats import g_stats, merge_wire
from . import transport as transport_mod
from .hostmap import HostMap
from .transport import BIN_CONTENT_TYPE, RpcError, Transport, as_array

log = get_logger("cluster")

RPC_TIMEOUT_S = 10.0
#: interactive reads that can legitimately run long (deep paging, big
#: escalations) get their own budget — a 10 s cap would reroute to the
#: twin (doubling work) and falsely mark slow-but-alive hosts dead
SEARCH_TIMEOUT_S = 60.0
PING_TIMEOUT_S = 1.5
SCRAPE_TIMEOUT_S = 2.0
RETRY_INTERVAL_S = 1.0
HEARTBEAT_INTERVAL_S = 1.0


# ---------------------------------------------------------------------------
# topology file (hosts.conf, Hostdb.cpp:124)
# ---------------------------------------------------------------------------

@dataclass
class HostsConf:
    """Parsed hosts.conf: addresses[shard][replica] = "host:port"."""

    n_shards: int
    n_replicas: int
    addresses: list[list[str]]  # [shard][replica]

    @classmethod
    def parse(cls, text: str) -> "HostsConf":
        mirrors = 0
        hosts: list[str] = []
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("num-mirrors:"):
                mirrors = int(line.split(":", 1)[1])
            else:
                hosts.append(line)
        n_replicas = mirrors + 1
        if not hosts or len(hosts) % n_replicas:
            raise ValueError(
                f"hosts.conf: {len(hosts)} hosts not divisible by "
                f"{n_replicas} replicas")
        n_shards = len(hosts) // n_replicas
        addresses = [[hosts[r * n_shards + s] for r in range(n_replicas)]
                     for s in range(n_shards)]
        return cls(n_shards, n_replicas, addresses)

    @classmethod
    def load(cls, path: str | Path) -> "HostsConf":
        return cls.parse(Path(path).read_text())

    def dump(self) -> str:
        lines = [f"num-mirrors: {self.n_replicas - 1}"]
        for r in range(self.n_replicas):
            lines += [self.addresses[s][r] for s in range(self.n_shards)]
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# node side (the per-shard RPC server)
# ---------------------------------------------------------------------------

class ShardNodeServer:
    """One shard replica as a process: Collection + RPC surface.

    Endpoints (the live msgType registry, SURVEY §2.4, as paths):
    ``/rpc/index`` (Msg7/Msg4 add), ``/rpc/remove``, ``/rpc/search``
    (Msg39 per-shard exec), ``/rpc/doc`` (Msg22 titlerec), ``/rpc/ping``
    (PingServer), ``/rpc/save`` (gb save broadcast).
    """

    def __init__(self, data_dir: str | Path, host: str = "127.0.0.1",
                 port: int = 0, use_device: bool = False,
                 use_cache: bool = True, shard: int = 0,
                 replica: int = 0,
                 cluster_map: "HostsConf | None" = None, device=None):
        self.coll = Collection("shard", data_dir, device=device)
        #: this node's seat in the fleet and the Hostdb-style map it was
        #: handed at spawn (hosts.conf semantics: every gb instance
        #: boots knowing the whole topology, Hostdb.cpp:124) — lets the
        #: node name its twins for heal pulls and report its identity
        #: on /rpc/ping so the supervisor can verify placement
        self.shard = int(shard)
        self.replica = int(replica)
        self.cluster_map = cluster_map
        # per-shard results feed the CLIENT-side merge, which applies
        # PostQueryRerank once over the merged page — node-side PQR
        # would demote twice and skew the cross-shard merge
        self.coll.conf.pqr_enabled = False
        self.host = host
        self.port = port
        self.use_device = use_device
        self._httpd: ThreadingHTTPServer | None = None
        self._lock = make_rlock("cluster.node_writer")  # single-writer core
        #: TCP connections accepted since start — with a pooled client
        #: this stays ~1 per peer; it climbing with request count means
        #: keep-alive broke somewhere
        self.accepts = 0
        self._accept_lock = make_lock("cluster.accepts")
        #: live accepted sockets: stop() must sever them, or a handler
        #: thread parked on a keep-alive connection outlives the
        #: "stopped" server and keeps answering for a dead node
        self._conns: set = set()
        #: background RPCs (X-Niceness: 1 — spider writes, heal pulls)
        #: yield to in-flight interactive reads at the door, BEFORE
        #: contending for the writer lock (UdpProtocol.h niceness bit)
        from ..utils.nice import NicenessGate
        self.nice_gate = NicenessGate()
        # crash journal (Msg4.cpp:115 addsinprogress.dat): adds are
        # journaled BEFORE they are acked, replayed on restart, and the
        # journal truncates whenever the memtable state is saved — so a
        # SIGKILL'd node recovers every acked write
        self._journal_path = Path(data_dir) / "addsinprogress.jsonl"
        self._replay_journal()
        self._recount_docs()
        self._journal = open(self._journal_path, "a",  # noqa: SIM115
                             encoding="utf-8")
        self._writes_since_save = 0
        #: writes accepted while a heal pull is in flight (replayed on
        #: top of the pulled snapshot — see heal_from)
        self._heal_buffer: list[dict] | None = None
        #: last applied parm-broadcast sequence per name (0x3f dedup)
        self._parm_seq: dict[str, int] = {}
        #: per-shard search-result cache (the Msg39 leg of the RdbCache
        #: story): normalized (total, docids, scores) per (q, topk,
        #: lang), generation-keyed on posdb.version so any accepted
        #: write invalidates everything in O(1). Checked inside
        #: handle(), so coalesced batch riders hit it too.
        _coll = self.coll
        self._search_cache = g_cacheplane.register(
            "node.search", ttl_s=30.0, max_entries=4096,
            gen_fn=lambda: _coll.posdb.version,
            desc="per-shard /rpc/search replies (Msg39 result cache)")
        if not use_cache:
            self._search_cache.enabled = False
        #: metrics registry served by /rpc/stats — the process-wide
        #: g_stats by default; in-process multi-node tests inject a
        #: private Stats per node so a scrape-merge is a real merge
        #: instead of the singleton merged with itself
        self.stats_registry = g_stats
        #: kernel counters already mirrored into stats_registry
        self._mirrored: dict[str, int] = {}
        self._mirror_lock = make_lock("cluster.kernel_mirror")
        #: per-node admission door on the data-plane RPCs. Configured as
        #: a pure capacity + drain gate (the SLO/membudget degrade
        #: ladder stays at the coordinator, so the signal fns are off):
        #: its job here is bounding concurrent work per process and
        #: being the point a rolling restart closes before checkpoint.
        #: Runtime-layer import: parallel/ stays import-light on serve/
        #: (the tier vocabulary already lives in utils/priority).
        from ..serve.admission import AdmissionGate
        self.admission = AdmissionGate(max_inflight=64, max_queue=512,
                                       max_wait_s=5.0,
                                       degraded_fn=lambda: False,
                                       pressure_fn=lambda: False)

    def _replay_journal(self) -> None:
        from ..build import docproc

        if not self._journal_path.exists():
            return
        n = 0
        for line in self._journal_path.read_text(
                encoding="utf-8").splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                if rec.get("op") == "remove":
                    docproc.remove_document(self.coll, rec["url"])
                else:
                    docproc.index_document(self.coll, rec["url"],
                                           rec["content"])
                n += 1
            except Exception as e:  # noqa: BLE001 — torn tail line etc.
                log.warning("journal replay skipped a record: %s", e)
        if n:
            log.info("replayed %d journaled adds", n)

    def _recount_docs(self) -> None:
        """collstats.json is save-time state — a kill -9 loses it even
        though BOTH journal layers (rdblite's addsinprogress + ours)
        restore every acked record, and replaying an add whose titlerec
        survived is a replace that never re-counts. On boot, trust the
        Rdbs: the live doc count is the merged titledb's positive
        keys."""
        n = self.coll.titledb.count_live()
        if n != self.coll.num_docs:
            log.info("doc count recomputed from titledb: %d "
                     "(collstats said %d)", n, self.coll.num_docs)
            self.coll.num_docs = n
            self.coll._save_stats()

    def _journal_write(self, rec: dict) -> None:
        self._journal.write(json.dumps(rec) + "\n")
        self._journal.flush()
        os.fsync(self._journal.fileno())

    # --- request handlers -------------------------------------------------

    #: data-plane routes pass the per-node admission door; control
    #: routes (ping/stats/drain/save/parm[s]/heal) must keep answering
    #: while the gate is draining — a rolling restart still needs to
    #: probe, checkpoint, and observe the node it is about to stop
    GATED_RPCS = frozenset({"/rpc/index", "/rpc/remove", "/rpc/search",
                            "/rpc/doc", "/rpc/pull", "/rpc/pull-all"})

    def handle(self, path: str, payload: dict) -> dict:
        if path == "/rpc/drain":
            # stop admitting, let in-flight waves collect. Shed write
            # RPCs reply ok=False, so they park in the coordinator's
            # ordered twin queue and redeliver after the restart; shed
            # reads 503 into the transport's instant twin failover.
            self.admission.drain()
            quiesced = self.admission.quiesce(
                float(payload.get("timeout_s", 10.0)))
            snap = self.admission.snapshot()
            return {"ok": True, "drained": bool(quiesced),
                    "inflight": snap["inflight"],
                    "sheds": snap["shed_total"]}
        if path == "/rpc/undrain":
            self.admission.resume()
            return {"ok": True}
        if path in self.GATED_RPCS:
            from ..serve.admission import Shed
            tier = priority_mod.current_tier() or "interactive"
            try:
                ticket = self.admission.admit(
                    tier, deadline_mod.current())
            except Shed as e:
                return {"ok": False, "error": f"shed:{e.reason}",
                        "shed": e.reason,
                        "retry_after_s": e.retry_after_s}
            with ticket:
                return self._handle(path, payload)
        return self._handle(path, payload)

    def _handle(self, path: str, payload: dict) -> dict:
        from ..build import docproc

        if path == "/rpc/ping":
            # lock-free: a long write/checkpoint must not fail heartbeats
            return {"ok": True, "docs": self.coll.num_docs,
                    "accepts": self.accepts,
                    "shard": self.shard, "replica": self.replica,
                    "pid": os.getpid(),
                    "draining": self.admission.draining}
        if path == "/rpc/conf":
            # read-only conf dump (ops + broadcast verification)
            return {"ok": True, "conf": self.coll.conf.to_dict()}
        if path == "/rpc/stats":
            # lock-free like ping: a wedged writer must not blind the
            # fleet scrape. Raw histogram buckets, not percentiles —
            # the coordinator merges distributions (Tail at Scale).
            self._mirror_device_stats()
            return {"ok": True, "host": self.host, "port": self.port,
                    "stats": self.stats_registry.wire()}
        if path == "/rpc/heal":
            # outside the writer lock: heal_from pulls for minutes and
            # takes the lock only for its atomic apply step — holding
            # it here would block every index/search on this node
            n = self.heal_from(payload["from"])
            return {"ok": True, "healed_rdbs": n}
        with self._lock:
            if path == "/rpc/index":
                self._journal_write({"url": payload["url"],
                                     "content": payload["content"]})
                if self._heal_buffer is not None:
                    self._heal_buffer.append(
                        {"url": payload["url"],
                         "content": payload["content"]})
                ml = docproc.index_document(
                    self.coll, payload["url"], payload["content"])
                self._maybe_checkpoint_locked()
                if ml is None:  # tagdb manualban — the DELIVERY
                    # succeeded (ok), the document was refused; ok=False
                    # would park the write and wedge the ordered queue
                    return {"ok": True, "banned": True,
                            "gen": self.coll.posdb.version}
                return {"ok": True, "docid": int(ml.docid),
                        "gen": self.coll.posdb.version}
            if path == "/rpc/remove":
                self._journal_write({"op": "remove",
                                     "url": payload["url"]})
                if self._heal_buffer is not None:
                    self._heal_buffer.append({"op": "remove",
                                              "url": payload["url"]})
                ok = docproc.remove_document(self.coll, payload["url"])
                return {"ok": bool(ok),
                        "gen": self.coll.posdb.version}
            if path == "/rpc/search":
                with trace_mod.timed_span("node.search"):
                    return self._search_locked(payload)
            if path == "/rpc/doc":
                from ..build.docproc import get_document
                rec = get_document(self.coll,
                                   docid=int(payload["docid"]))
                return {"ok": rec is not None, "doc": rec}
            if path == "/rpc/save":
                self.save()
                return {"ok": True}
            if path == "/rpc/parm":
                # live parm update (the 0x3f broadcast receive side,
                # Parms.cpp:21683): host0's client sequences updates;
                # stale/replayed sequence numbers are acked but not
                # applied (retry-forever redelivery may duplicate)
                seq = int(payload.get("seq", 0))
                name = payload["name"]
                if seq <= self._parm_seq.get(name, -1):
                    return {"ok": True, "stale": True}
                try:
                    self.coll.conf.set(name, payload["value"],
                                       _from_sync=True)
                except KeyError as e:
                    return {"ok": False, "error": str(e)}
                self._parm_seq[name] = seq
                # persist: the parm must survive this node's restart
                self.coll.conf.save(self.coll._conf_path)
                log.info("parm %s=%r applied (seq %d)", name,
                         payload["value"], seq)
                return {"ok": True}
            if path == "/rpc/parms":
                # bulk live-update (the whole `gb save`-style broadcast
                # in one RPC): same per-name sequence dedup as
                # /rpc/parm, one conf.save for the batch, applied with
                # NO process restart — the reply carries this node's
                # pid so the caller can prove that
                seq = int(payload.get("seq", 0))
                applied: list[str] = []
                errors: dict[str, str] = {}
                for name, value in dict(payload.get("parms",
                                                    {})).items():
                    if seq <= self._parm_seq.get(name, -1):
                        continue
                    try:
                        self.coll.conf.set(name, value, _from_sync=True)
                    except KeyError as e:
                        errors[name] = str(e)
                        continue
                    self._parm_seq[name] = seq
                    applied.append(name)
                if applied:
                    self.coll.conf.save(self.coll._conf_path)
                    log.info("parms %s applied (seq %d)",
                             ",".join(applied), seq)
                return {"ok": not errors, "applied": applied,
                        "errors": errors, "pid": os.getpid()}
            if path == "/rpc/pull":
                # twin-patch send side (Msg5 error correction): ship one
                # Rdb's full merged content to a healing sibling
                name = payload["name"]
                if name == "speller":
                    return {"ok": True,
                            "counts": dict(self.coll.speller.counts)}
                rdb = self.coll.rdbs().get(name)
                if rdb is None:
                    return {"ok": False, "error": f"no rdb {name}"}
                return {"ok": True, "batch": _encode_batch(rdb.get_all()),
                        "num_docs": self.coll.num_docs}
            if path == "/rpc/pull-all":
                # single CONSISTENT cut: every Rdb + speller + num_docs
                # snapshotted under the writer lock — a healing sibling
                # must never mix Rdb generations (titledb holding a doc
                # whose posdb postings are missing)
                return {
                    "ok": True,
                    "rdbs": {name: _encode_batch(rdb.get_all())
                             for name, rdb in self.coll.rdbs().items()},
                    "counts": dict(self.coll.speller.counts),
                    "num_docs": self.coll.num_docs,
                }
        raise KeyError(path)

    def _search_locked(self, payload: dict) -> dict:
        """``/rpc/search``, one query or a batch (``"queries"``); the
        caller holds the writer lock. A failed search counts
        ``node.device_error`` and raises (a 500): no host fallback."""
        if deadline_mod.check_abandon("node.search"):
            # second checkpoint past the dequeue one: the wait for the
            # writer lock may have eaten what was left of the budget —
            # abandon before the device wave
            raise deadline_mod.DeadlineExceeded("deadline exceeded")
        topk = int(payload.get("topk", 10))
        lang = int(payload.get("lang", 0))
        # replies are cached per (q, topk, lang) under the CURRENT posdb
        # generation — stable while we hold the writer lock, so a reply
        # can never mix generations
        gen = self.coll.posdb.version
        if "queries" in payload:
            # batched scatter-gather: the client coalesces concurrent
            # callers per shard; one device dispatch instead of a
            # request per query. The cache is checked PER RIDER: a
            # repeated query that coalesced into a fresh batch still
            # hits.
            qs = [str(q) for q in payload["queries"]]
            entries: list = [None] * len(qs)
            miss = []
            for i, q in enumerate(qs):
                hit, e = self._search_cache.lookup((q, topk, lang),
                                                   gen=gen)
                if hit:
                    entries[i] = e
                else:
                    miss.append(i)
            if miss:
                many = self._run_search([qs[i] for i in miss], topk, lang)
                for i, r in zip(miss, many):
                    e = leg_of(r)
                    self._search_cache.put((qs[i], topk, lang), e, gen=gen)
                    entries[i] = e
            g_stats.count("transport.node_batched_q", len(qs))
            return {"ok": True, "results": entries, "gen": gen}
        q = str(payload["q"])
        hit, e = self._search_cache.lookup((q, topk, lang), gen=gen)
        if not hit:
            e = leg_of(self._run_search([q], topk, lang)[0])
            self._search_cache.put((q, topk, lang), e, gen=gen)
        return {
            "ok": True,
            "total": e["total"],
            "docids": [int(x) for x in e["docids"]],
            "scores": [float(x) for x in e["scores"]],
            "gen": gen,
        }

    def _run_search(self, qs: list[str], topk: int, lang: int) -> list:
        """The shard's answers, unclustered and without snippets: one
        ``search_device_batch`` on the device route, else the flat path
        query by query."""
        from ..query import engine

        kw = dict(topk=topk, lang=lang, with_snippets=False,
                  site_cluster=False)
        try:
            if self.use_device:
                return engine.search_device_batch(self.coll, qs, **kw)
            return [engine.search(self.coll, q, **kw) for q in qs]
        except deadline_mod.DeadlineExceeded:
            raise
        except Exception:
            g_stats.count("node.device_error")
            raise

    def _mirror_device_stats(self) -> None:
        """Fold the kernel wrappers' launch counters (module globals of
        this process) into the stats registry, so ``/rpc/stats`` carries
        them and a fleet scrape sums them; on a card, also gauge the
        bytes this process's allocator holds there."""
        from ..query import fd_scores_kernel as fdk
        from ..query import min_scores_kernel as msk

        dev = self.coll.device
        if dev.type == "cuda":
            import torch
            self.stats_registry.gauge("node.device_allocated_bytes",
                                      torch.cuda.memory_allocated(dev))
            self.stats_registry.gauge("node.device_reserved_bytes",
                                      torch.cuda.memory_reserved(dev))

        now = {"kernel.min_scores.launches": msk.launches,
               "kernel.min_scores.plain_calls": msk.plain_calls,
               "kernel.fd_scores.launches": (fdk.launches_tail
                                             + fdk.launches_notail),
               "kernel.fd_scores.plain_calls": fdk.plain_calls}
        with self._mirror_lock:
            for name, v in now.items():
                d = v - self._mirrored.get(name, 0)
                if d:
                    self.stats_registry.count(name, d)
                self._mirrored[name] = v

    def scrub(self) -> list[str]:
        """Integrity sweep over this node's Rdbs (quarantines corrupt
        runs; the operator heals via /rpc/heal from a twin)."""
        with self._lock:
            return [f"{name}/{run}"
                    for name, rdb in self.coll.rdbs().items()
                    for run in rdb.scrub()]

    def heal_from(self, addr: str) -> int:
        """Twin-patch receive side: replace every local Rdb with the
        sibling's content (also the recovered-twin catch-up — a node
        that was dead while writes flowed rejoins consistent).

        Consistency, both directions: the SOURCE snapshots all Rdbs in
        ONE /rpc/pull-all held under its writer lock (a single cut —
        never titledb from one generation and posdb from another), and
        the RECEIVER keeps accepting writes during the multi-second
        pull, buffering them and replaying them on top of the applied
        snapshot — so nothing delivered in the pull window is lost."""
        from ..build import docproc

        with self._lock:
            if self._heal_buffer is not None:
                log.warning("heal from %s refused: heal already in "
                            "progress", addr)
                return 0
            self._heal_buffer = []
        try:
            out = _rpc(addr, "/rpc/pull-all", {}, timeout=300.0,
                       niceness=1)
            if not out.get("ok"):
                raise RuntimeError(out.get("error", "pull-all not ok"))
            pulled = out["rdbs"]
            missing = [n for n in self.coll.rdbs() if n not in pulled]
            if missing:
                # apply nothing: a partial snapshot would leave mixed
                # Rdb generations — the exact state heal exists to fix
                raise RuntimeError(f"snapshot missing rdbs {missing}")
        except Exception as e:  # noqa: BLE001 — transport/sibling death
            with self._lock:
                self._heal_buffer = None
            log.error("heal from %s aborted before applying: %s",
                      addr, e)
            return 0
        with self._lock:
            try:
                for name, rdb in self.coll.rdbs().items():
                    rdb.replace_with(_decode_batch(pulled[name]))
                self.coll.num_docs = out.get("num_docs",
                                             self.coll.num_docs)
                if "counts" in out:
                    from collections import defaultdict
                    self.coll.speller.counts = defaultdict(
                        int, out["counts"])
                    self.coll.speller._len_index = None
                self.coll.titlerec_cache.clear()
                # replay the pull-window writes on the fresh snapshot
                # (they were applied to the OLD state, which
                # replace_with just discarded; the journal still holds
                # them for crash safety)
                buf = self._heal_buffer or []
                for rec in buf:
                    try:
                        if rec.get("op") == "remove":
                            docproc.remove_document(self.coll,
                                                    rec["url"])
                        else:
                            docproc.index_document(
                                self.coll, rec["url"], rec["content"])
                    except Exception as e:  # noqa: BLE001
                        log.warning("heal replay skipped a record: %s",
                                    e)
                self.coll._save_stats()
                log.info("healed %d rdbs from %s (+%d pull-window "
                         "writes replayed)", len(pulled), addr,
                         len(buf))
                return len(pulled)
            finally:
                self._heal_buffer = None

    def save(self) -> None:
        """Checkpoint under the writer lock; the saved state supersedes
        the journal (Msg4 truncates addsinprogress once trees save)."""
        with self._lock:
            self.coll.save()
            self._journal.seek(0)
            self._journal.truncate()
            self._writes_since_save = 0

    def _maybe_checkpoint_locked(self) -> None:
        """Bound journal growth/replay cost: checkpoint every few
        hundred acked writes (caller holds the writer lock)."""
        self._writes_since_save += 1
        if self._writes_since_save >= 512:
            self.coll.save()
            self._journal.seek(0)
            self._journal.truncate()
            self._writes_since_save = 0

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive is the whole point of the client's connection
            # pool, and HTTP/1.0 (the BaseHTTPRequestHandler default)
            # closes after every response — 1.1 + the explicit
            # Content-Length below keeps the socket open
            protocol_version = "HTTP/1.1"
            # headers and body go out as two writes; with Nagle on, the
            # body write stalls on the peer's delayed ACK (~40 ms) on
            # every KEEP-ALIVE request — fresh dials dodge it via
            # quick-ack, which would make the pool look slower than
            # dial-per-call
            disable_nagle_algorithm = True

            def setup(self):
                super().setup()
                # one setup() per ACCEPTED connection (many requests
                # ride each under keep-alive) — the pool-effectiveness
                # signal surfaced via /rpc/ping
                with outer._accept_lock:
                    outer.accepts += 1
                    outer._conns.add(self.connection)

            def finish(self):
                with outer._accept_lock:
                    outer._conns.discard(self.connection)
                super().finish()

            def log_message(self, fmt, *args):
                log.debug("%s " + fmt, self.client_address[0], *args)

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b"{}"
                try:
                    nice = int(self.headers.get("X-Niceness") or 0)
                except ValueError:
                    nice = 0
                # honor the coordinator's priority verdict: a crawlbot
                # leg yields inside this host too (its tier maps to the
                # niceness bit the gate below already enforces), and
                # the tier is re-bound so further fan-out keeps it
                tier = priority_mod.tier_from_header(
                    self.headers.get(priority_mod.PRIORITY_HEADER))
                if tier is not None:
                    g_stats.count(f"admission.node.{tier}")
                    nice = max(nice, priority_mod.tier_niceness(tier))
                # the tenant rides the same way: re-bound so this
                # node's accounting (and any further fan-out) bills
                # the coordinator's ledger
                tenant = priority_mod.tenant_from_header(
                    self.headers.get(priority_mod.TENANT_HEADER))
                accept_bin = BIN_CONTENT_TYPE in (
                    self.headers.get("Accept") or "")
                # adopt an incoming trace context: run the handler
                # under a local root span and ship the finished
                # subtree back in the reply for the coordinator to
                # graft into its tree (Dapper-style child spans)
                tr_hdr = trace_mod.parse_header(
                    self.headers.get(trace_mod.TRACE_HEADER) or "")
                # rebuild the coordinator's deadline from the budget it
                # shipped (wall clocks don't cross hosts; budgets do)
                dl = deadline_mod.Deadline.from_header(
                    self.headers.get(deadline_mod.DEADLINE_HEADER))
                outer.nice_gate.enter(nice)
                try:
                    if chaos_mod.g_chaos.enabled:
                        chaos_mod.g_chaos.node_fault(outer)
                    if deadline_mod.check_abandon("node.dequeue", dl):
                        # the coordinator already timed out — abandon
                        # at the door, before the writer lock and the
                        # device wave burn work nobody is waiting for
                        out, code = {"ok": False,
                                     "error": "deadline exceeded"}, 504
                    else:
                        payload = transport_mod.decode_body(
                            body, self.headers.get("Content-Type", ""))
                        with deadline_mod.bind(dl), \
                                priority_mod.bind_tier(tier), \
                                priority_mod.bind_tenant(tenant):
                            if tr_hdr is not None:
                                with trace_mod.g_tracer.adopt(
                                        tr_hdr[0], tr_hdr[1],
                                        self.path.lstrip("/"),
                                        host=f"{outer.host}:{outer.port}"
                                        ) as adopted:
                                    out = outer.handle(self.path,
                                                       payload)
                                if isinstance(out, dict):
                                    out["_trace"] = adopted.export()
                            else:
                                out = outer.handle(self.path, payload)
                        code = 200
                except KeyError:
                    out, code = {"error": "no such rpc"}, 404
                except Exception as e:  # noqa: BLE001 — node must not die
                    out, code = {"error": str(e)}, 500
                finally:
                    outer.nice_gate.exit(nice)
                # reply codec: binary only when the peer advertised it
                # (old clients never do → JSON wire, unchanged bytes);
                # errors stay JSON so any peer can read them
                data, ctype = transport_mod.encode_body(
                    out, accept_bin and code == 200)
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    # every reply advertises this node's Rdb generation:
                    # the client cache plane folds it in (transport
                    # gen_observer) so even a read reply reveals that a
                    # write landed — no stale window beyond one
                    # in-flight read
                    self.send_header(transport_mod.GEN_HEADER,
                                     str(outer.coll.posdb.version))
                    self.end_headers()
                    self.wfile.write(data)
                except OSError:
                    # connection severed under us (stop() / a chaos
                    # kill) — the client's hedge already treats this
                    # leg as failed; don't let the handler thread die
                    # loudly
                    self.close_connection = True

            do_GET = do_POST

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        threads.spawn(f"shard-node-{self.port}",
                      self._httpd.serve_forever)
        log.info("shard node on %s:%d (%d docs)", self.host, self.port,
                 self.coll.num_docs)

    def stop(self) -> None:
        # claim-then-close so concurrent stops (a chaos kill from a
        # side thread racing a test/operator teardown) are safe: only
        # one caller gets the live httpd, the rest see None
        httpd, self._httpd = self._httpd, None
        if httpd:
            httpd.shutdown()
            httpd.server_close()
        # sever live keep-alive connections: their handler threads
        # would otherwise keep serving this "stopped" node (a process
        # kill severs them for free; in-process stop must match)
        with self._accept_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                import socket as _socket
                c.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# client side (Msg1 writes / Msg0+Multicast reads / Msg3a merge)
# ---------------------------------------------------------------------------

def leg_of(res) -> dict:
    """One shard's answer as its leg: the total, and the page's docids
    and scores (float32 scores widened to float64)."""
    return {"total": res.total_matches,
            "docids": np.asarray([int(r.docid) for r in res.results],
                                 dtype=np.int64),
            "scores": np.asarray([float(r.score) for r in res.results],
                                 dtype=np.float64)}


def _encode_batch(batch) -> dict:
    """RecordBatch → wire dict of raw ndarrays. The transport layer
    picks the codec per peer: length-prefixed raw frames on the binary
    wire, base64 ``.npy`` strings on the JSON fallback (byte-compatible
    with the pre-pool wire, so old clients keep decoding)."""
    out = {}
    for nm, arr in (("keys", batch.keys), ("offsets", batch.offsets),
                    ("data", batch.data)):
        if arr is None:
            continue
        out[nm] = np.ascontiguousarray(arr)
    return out


def _decode_batch(d: dict):
    """Wire dict (raw ndarrays OR base64 .npy strings) → RecordBatch."""
    from ..index.rdblite import RecordBatch
    arrs = {nm: as_array(v) for nm, v in d.items()}
    return RecordBatch(arrs["keys"], arrs.get("offsets"),
                       arrs.get("data"))


def _rpc(addr: str, path: str, payload: dict,
         timeout: float = RPC_TIMEOUT_S, niceness: int = 0) -> dict:
    """One RPC over the process-wide pooled transport. ``niceness``
    rides an X-Niceness header (the UdpProtocol.h niceness bit): 1 =
    background traffic the receiving node may hold while interactive
    requests are in flight."""
    return transport_mod.g_transport.request(addr, path, payload,
                                             timeout=timeout,
                                             niceness=niceness)


@dataclass
class _Pending:
    """One undelivered write (the Msg1 retry-forever unit)."""

    shard: int
    replica: int
    path: str
    payload: dict
    attempts: int = 0


class _HostQueue:
    """Per-host ORDERED redelivery queue.

    Ordering is the point: once a host has parked writes, every later
    write to that host must line up behind them — delivering a new
    write around an old one would make the stale version the newest
    memtable insertion on the twin (newest-wins would then resurrect
    it). Drains stop at the first failure so order is preserved."""

    def __init__(self):
        self.items: list[_Pending] = []
        self.lock = make_lock("cluster.hostqueue")
        self.in_flight = False

    def __len__(self) -> int:
        with self.lock:
            return len(self.items)


class _ShardSearchBatcher:
    """Per-shard query coalescing — the cluster-plane analog of the
    serving side's ``QueryBatcher``: concurrent callers hitting the
    same shard within one batching window ride ONE ``/rpc/search``
    carrying a query list, which the node executes as a single
    ``search_device_batch`` dispatch. On loopback the window is ~2 ms;
    across DCN it is hidden entirely inside the shard RTT."""

    WINDOW_S = 0.002
    MAX_B = 64

    def __init__(self, client: "ClusterClient", shard: int):
        self.client = client
        self.shard = shard
        self._cv = threading.Condition()
        #: (key, query, holder) — key groups compatible requests
        self._queue: list[tuple] = []
        self._thread: threading.Thread | None = None

    def submit(self, q: str, topk: int, lang: int,
               timeout: float, parent_span=None,
               deadline=None, tier=None,
               tenant=None) -> dict | None:
        holder = {"done": False, "out": None}
        with self._cv:
            self._queue.append(((topk, lang), q, holder, parent_span,
                                deadline, tier, tenant))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threads.spawn(
                    f"shard{self.shard}-qbatch", self._run)
            self._cv.notify_all()
        wait_dl = deadline_mod.Deadline.after(timeout + 5.0)
        with self._cv:
            while not holder["done"]:
                left = wait_dl.remaining()
                if left <= 0:
                    break
                self._cv.wait(left)
        return holder["out"]

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._queue:
                    self._cv.wait(timeout=5.0)
                    if not self._queue:
                        self._thread = None
                        return  # idle — next submit restarts us
            time.sleep(self.WINDOW_S)  # let concurrent callers pile in
            with self._cv:
                key = self._queue[0][0]
                batch = [e for e in self._queue if e[0] == key]
                batch = batch[: self.MAX_B]
                for e in batch:
                    self._queue.remove(e)
            try:
                self._issue(key, batch)
            except Exception as e:  # noqa: BLE001 — keep the lane alive
                log.warning("shard %d batch failed: %s", self.shard, e)
                with self._cv:
                    for entry in batch:
                        entry[2]["done"] = True
                    self._cv.notify_all()

    def _issue(self, key: tuple, batch: list) -> None:
        topk, lang = key
        qs = [e[1] for e in batch]
        # the batcher runs in its own thread (empty contextvars
        # context); re-attach the first waiter's span so the coalesced
        # RPC lands in SOME trace, and give every other waiter a
        # completed "coalesced" marker span covering the same interval
        parents = [e[3] for e in batch if e[3] is not None]
        primary = parents[0] if parents else None
        # the coalesced RPC carries the LONGEST rider budget — a
        # short-deadline rider must not abandon every other rider's
        # answer (its own coordinator still times out client-side) —
        # and the HIGHEST rider tier (a crawlbot rider must not demote
        # an interactive rider's leg on the node planes)
        dls = [e[4] for e in batch if e[4] is not None]
        dl = max(dls, key=lambda d: d.at) if dls else None
        tiers = [e[5] for e in batch if e[5] is not None]
        tier = (min(tiers, key=priority_mod.TIERS.index)
                if tiers else None)
        # riders of one coalesced leg share a coordinator/collection,
        # so the first bound tenant speaks for the wave
        tenants = [e[6] for e in batch
                   if len(e) > 6 and e[6] is not None]
        tenant = tenants[0] if tenants else None
        t0 = time.perf_counter()
        with trace_mod.attach(primary), deadline_mod.bind(dl), \
                priority_mod.bind_tier(tier), \
                priority_mod.bind_tenant(tenant):
            # span_parent rides along so the hedged read's per-attempt
            # spans (hedge fired/won) land in the primary rider's trace
            out = self.client._read_shard(
                self.shard, "/rpc/search",
                {"queries": qs, "topk": topk, "lang": lang},
                timeout=SEARCH_TIMEOUT_S, span_parent=primary)
            results = out.get("results") if out else None
            if not isinstance(results, list) or len(results) != len(qs):
                # old node (no batch support → 404 on "queries") or a
                # malformed reply: legacy single-query wire, one per entry
                g_stats.count("transport.batch_fallback")
                results = [self.client._read_shard(
                    self.shard, "/rpc/search",
                    {"q": q, "topk": topk, "lang": lang},
                    timeout=SEARCH_TIMEOUT_S) for q in qs]
        for p in parents[1:]:
            p.record("rpc/search", t0, coalesced=True,
                     shard=self.shard, batch=len(qs))
        with self._cv:
            for e, res in zip(batch, results):
                e[2]["out"] = res
                e[2]["done"] = True
            self._cv.notify_all()


class ClusterClient:
    """Routes adds/reads/queries across the node processes."""

    def __init__(self, conf: HostsConf, use_heartbeat: bool = True,
                 parms=None, transport: Transport | None = None,
                 use_cache: bool = True):
        self.conf = conf
        #: optional global Conf (utils.parms) — supplies alert_cmd etc.
        self.parms = parms
        n_hosts = conf.n_shards * conf.n_replicas
        write_workers = max(4, 2 * n_hosts)
        read_workers = max(16, 4 * n_hosts)
        #: the RPCs this client can have in flight to one peer at once:
        #: every worker of its two pools, a batcher per shard and the
        #: heartbeat. Its own transport keeps that many idle sockets per
        #: peer, so a node's connections are bounded by it, not by the
        #: number of requests (the reference keeps 4)
        self.max_inflight = read_workers + write_workers + conf.n_shards + 1
        #: pooled/hedged courier — own instance so tests can isolate
        #: pools, but any Transport (e.g. a JSON-only one) drops in
        self.transport = transport or Transport(max_idle=self.max_inflight)
        self.hostmap = HostMap(conf.n_shards, conf.n_replicas)
        # --- cache-plane generation tracking (per shard) -----------------
        # A shard's generation is the PAIR (local write counter, highest
        # node gen observed). The local counter bumps BEFORE a write is
        # sent — dependent entries die the instant the write is
        # initiated, not when the node acks, so there is no stale
        # window. The node half folds in X-OSSE-Gen reply headers: a
        # write from ANOTHER client shows up at our next read of any
        # kind and invalidates our entries too.
        self._gen_lock = make_lock("cluster.gen")
        self._gen_local = [0] * conf.n_shards
        self._gen_node = [0] * conf.n_shards
        self._addr_shard = {conf.addresses[s][r]: s
                            for s in range(conf.n_shards)
                            for r in range(conf.n_replicas)}
        self.transport.gen_observer = self._observe_gen
        #: per-(shard, query) leg cache: the Msg0/termlist-cache role —
        #: one shard's raw top-k for one query; generation = that
        #: shard's pair only, so a write on shard 1 never flushes
        #: shard 0's legs
        self._leg_cache = g_cacheplane.register(
            "cluster.legs", ttl_s=30.0, max_entries=8192,
            desc="per-shard raw search legs (Msg0 role)")
        #: merged front result cache: the Msg17/Msg40Cache role — the
        #: whole scatter-gather+merge+titlerec answer; generation = the
        #: full shard-gen vector (any shard's write invalidates)
        self._result_cache = g_cacheplane.register(
            "cluster.results", ttl_s=30.0, max_entries=1024,
            gen_fn=self.gen_vector,
            desc="merged cluster SERPs (Msg17/Msg40Cache role)")
        if not use_cache:
            self._leg_cache.enabled = False
            self._result_cache.enabled = False
        self._queues = {(s, r): _HostQueue()
                        for s in range(conf.n_shards)
                        for r in range(conf.n_replicas)}
        self._batchers = {s: _ShardSearchBatcher(self, s)
                          for s in range(conf.n_shards)}
        #: 0x3f broadcast sequencer (this client == the host0 role).
        #: Seeded from the wall clock so a RESTARTED host0 client's
        #: sequence numbers stay above everything the nodes have seen
        #: (an in-memory counter restarting at 0 would make every
        #: post-restart broadcast look stale and be silently dropped)
        self._parm_counter = int(time.time() * 1000)
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=write_workers)
        #: reads get their own pool: a wedged twin blocking long search
        #: reads must not starve write delivery of workers
        self._read_pool = ThreadPoolExecutor(max_workers=read_workers)
        self._retry_thread = threads.spawn("msg1-retry",
                                           self._retry_loop)
        self._hb_thread = None
        if use_heartbeat:
            self._hb_thread = threads.spawn("pingserver",
                                            self._heartbeat_loop)

    def close(self) -> None:
        self._stop.set()
        self._pool.shutdown(wait=False)
        if self.transport.gen_observer == self._observe_gen:
            self.transport.gen_observer = None
        self.transport.close()

    # --- cache-plane generations -----------------------------------------

    def _observe_gen(self, addr: str, gen: int) -> None:
        """Transport hook: an X-OSSE-Gen reply header from any node of
        shard s raises that shard's observed node generation."""
        s = self._addr_shard.get(addr)
        if s is None:
            return
        with self._gen_lock:
            if gen > self._gen_node[s]:
                self._gen_node[s] = gen

    def shard_gen(self, shard: int) -> tuple[int, int]:
        with self._gen_lock:
            return (self._gen_local[shard], self._gen_node[shard])

    def gen_vector(self) -> tuple:
        """All shards' generation pairs — the front result cache's
        generation (equality-compared; any component moving kills
        dependent entries)."""
        with self._gen_lock:
            return tuple(zip(self._gen_local, self._gen_node))

    def _bump_local_gen(self, shard: int) -> None:
        with self._gen_lock:
            self._gen_local[shard] += 1

    @property
    def pending_writes(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # --- fleet metrics scrape (PagePerf-across-hosts) --------------------

    def scrape(self, timeout: float = SCRAPE_TIMEOUT_S) -> dict:
        """Pull ``/rpc/stats`` from every host and merge into the fleet
        view. Returns ``{"hosts": {addr: wire|None}, "fleet":
        {"counters", "latencies" (name -> LatencyStat), "gauges"}}`` —
        fleet percentiles come from the merged histograms, never from
        averaging per-host percentiles. Dead hosts appear as ``None``
        in ``hosts`` and are simply absent from the merge (a scrape is
        a read, not a liveness verdict)."""
        addrs = [self.conf.addresses[s][r]
                 for s in range(self.conf.n_shards)
                 for r in range(self.conf.n_replicas)]
        with trace_mod.timed_span("cluster.scrape", hosts=len(addrs)):
            replies = self.transport.broadcast(
                addrs, "/rpc/stats", {}, timeout)
        hosts = {a: (r.get("stats") if r is not None and r.get("ok")
                     else None)
                 for a, r in replies.items()}
        fleet = merge_wire([w for w in hosts.values() if w is not None])
        g_stats.count("cluster.scrape")
        g_stats.gauge("cluster.scrape_hosts_up",
                      sum(1 for w in hosts.values() if w is not None))
        return {"hosts": hosts, "fleet": fleet}

    # --- liveness (PingServer) -------------------------------------------

    def _ping(self, shard: int, replica: int) -> bool:
        try:
            out = self.transport.request(
                self.conf.addresses[shard][replica], "/rpc/ping", {},
                timeout=PING_TIMEOUT_S)
            return bool(out.get("ok"))
        except Exception:  # noqa: BLE001
            return False

    def check_hosts(self) -> None:
        """One heartbeat sweep over every host. Liveness TRANSITIONS
        fire the operator alert hook (the reference PingServer emails/
        SMSes admins on host death, ``PingServer.h:77`` — here a log
        line plus an optional ``alert_cmd``)."""
        for s in range(self.conf.n_shards):
            for r in range(self.conf.n_replicas):
                was = bool(self.hostmap.alive[s, r])
                now = self._ping(s, r)
                if now:
                    self.hostmap.mark_alive(s, r)
                    # a ping answer drains fault penalty so a
                    # recovered twin re-enters the read rotation
                    # (reads alone can't fix an EWMA it never gets)
                    self.hostmap.decay_rtt(s, r)
                else:
                    self.hostmap.mark_dead(s, r)
                if was != now:
                    self._alert("recovered" if now else "dead", s, r)

    def _alert(self, event: str, shard: int, replica: int) -> None:
        """Operator alert on a liveness transition: always logged; the
        ``alert_cmd`` parm (or OSSE_ALERT_CMD env) additionally runs a
        command with the event in its environment — the email/SMS/
        pager seam without baking in a delivery mechanism."""
        addr = self.conf.addresses[shard][replica]
        log.warning("ALERT host %s (shard %d replica %d) %s",
                    addr, shard, replica, event)
        cmd = os.environ.get("OSSE_ALERT_CMD", "") or \
            getattr(self.parms, "alert_cmd", "")
        if not cmd:
            return
        try:
            import subprocess
            env = dict(os.environ,
                       OSSE_ALERT_EVENT=event,
                       OSSE_ALERT_HOST=addr,
                       OSSE_ALERT_SHARD=str(shard),
                       OSSE_ALERT_REPLICA=str(replica))
            subprocess.Popen(  # osselint: ignore[proc-spawn] — the
                # operator's pager hook (OSSE_ALERT_CMD) is an external
                # command by design; it manages no fleet child
                cmd, shell=True, env=env,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
        except Exception as e:  # noqa: BLE001 — alerting must not kill
            log.warning("alert_cmd failed: %s", e)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(HEARTBEAT_INTERVAL_S):
            self.check_hosts()

    # --- writes (Msg1: all twins, retry forever) -------------------------

    def _deliver(self, p: _Pending) -> bool:
        try:
            # writes are background traffic (reference Msg4 adds run at
            # niceness 1): the receiving node lets interactive queries
            # go first. NEVER hedged: writes are not idempotent at the
            # ordered-queue layer — one delivery path per twin.
            out = self.transport.request(
                self.conf.addresses[p.shard][p.replica], p.path,
                p.payload, timeout=RPC_TIMEOUT_S, niceness=1)
            return bool(out.get("ok"))
        except Exception as e:  # noqa: BLE001
            log.debug("deliver to %d/%d failed: %s", p.shard, p.replica, e)
            return False

    def _drain_host(self, key: tuple[int, int]) -> None:
        """Redeliver one host's parked writes IN ORDER, stopping at the
        first failure (retry forever, Msg1.cpp:20)."""
        q = self._queues[key]
        try:
            while not self._stop.is_set():
                with q.lock:
                    if not q.items:
                        return
                    p = q.items[0]
                if self._deliver(p):
                    self.hostmap.mark_alive(p.shard, p.replica)
                    with q.lock:
                        q.items.pop(0)
                else:
                    p.attempts += 1
                    self.hostmap.mark_dead(p.shard, p.replica)
                    return  # next sweep retries; order preserved
        finally:
            with q.lock:
                q.in_flight = False

    def _retry_loop(self) -> None:
        """Sweep: kick an independent drain per backlogged host — a
        hung host never head-of-line-blocks a healthy one."""
        while not self._stop.wait(RETRY_INTERVAL_S):
            for key, q in self._queues.items():
                with q.lock:
                    if not q.items or q.in_flight:
                        continue
                    q.in_flight = True
                self._pool.submit(self._drain_host, key)

    def _send_one(self, shard: int, r: int, p: _Pending) -> None:
        q = self._queues[(shard, r)]
        with q.lock:
            # ordering: never overtake parked writes OR an in-flight
            # send/drain to this host — concurrent direct sends could
            # otherwise land out of order and newest-wins would keep a
            # stale version
            if q.items or q.in_flight:
                q.items.append(p)
                return
            q.in_flight = True
        try:
            if not self._deliver(p):
                self.hostmap.mark_dead(shard, r)
                with q.lock:
                    q.items.insert(0, p)
        finally:
            with q.lock:
                q.in_flight = False

    def _write_all_twins(self, shard: int, path: str, payload: dict
                         ) -> None:
        # twins deliver concurrently: a hung twin costs its own timeout,
        # not every caller's write latency × replicas
        futs = [self._pool.submit(self._send_one, shard, r,
                                  _Pending(shard, r, path, payload))
                for r in range(self.conf.n_replicas)]
        for f in futs:
            f.result()

    # --- parm broadcast (0x3f from host0, Parms.cpp:21683) ---------------

    def broadcast_parm(self, name: str, value) -> None:
        """Cluster-wide live parameter update: sequenced, delivered to
        EVERY node (all shards, all twins) through the same ordered
        retry-forever queues as writes — a dead node receives the parm
        when it comes back, in order (Parms.h:497 broadcastParmList).
        This client plays the reference's host0 role: the single
        sequencer."""
        self._parm_counter += 1
        payload = {"name": name, "value": value,
                   "seq": self._parm_counter}
        for s in range(self.conf.n_shards):
            self._write_all_twins(s, "/rpc/parm", payload)

    def attach_conf(self, conf) -> None:
        """Wire a CollectionConf's live updates to the cluster: any
        ``conf.set(...)`` on this (host0) process broadcasts to every
        node, unless the parm is flagged broadcast=False (e.g.
        passwords)."""
        from ..utils import parms as parms_mod

        def fanout(name: str, value) -> None:
            try:
                if not parms_mod.parm(name).broadcast:
                    return
            except KeyError:
                return
            self.broadcast_parm(name, value)
        conf.on_update(fanout)

    def index_document(self, url: str, content: str) -> int:
        docid = ghash.doc_id(url)
        shard = int(self.hostmap.shard_of_docid(docid))
        # bump BEFORE sending: entries must be dead while the write is
        # in flight (the no-stale-window half of the cache contract)
        self._bump_local_gen(shard)
        self._write_all_twins(shard, "/rpc/index",
                              {"url": url, "content": content})
        return docid

    def remove_document(self, url: str) -> None:
        docid = ghash.doc_id(url)
        shard = int(self.hostmap.shard_of_docid(docid))
        self._bump_local_gen(shard)
        self._write_all_twins(shard, "/rpc/remove", {"url": url})

    def save_all(self) -> None:
        for s in range(self.conf.n_shards):
            self._write_all_twins(s, "/rpc/save", {})

    # --- reads (Multicast serving-twin pick + reroute) -------------------

    def _read_shard(self, shard: int, path: str, payload: dict,
                    timeout: float = RPC_TIMEOUT_S,
                    span_parent=None) -> dict | None:
        """Hedged twin read: the primary goes to the currently-fastest
        live twin (Multicast.cpp:520 pickBestHost — alive first, then
        lowest RTT EWMA); if it fails outright the next twin launches
        immediately, and if it merely dawdles past the hedge delay the
        SAME request races on the other twin and the first good answer
        wins (Dean & Barroso hedged requests). None = whole shard down.

        A failed read dead-marks the host only when a follow-up ping
        ALSO fails — one slow deep-paging query must not take a
        healthy twin out of rotation (the reference distinguishes
        request timeout from host death the same way: PingServer owns
        liveness, Multicast only reroutes). A twin that completed with
        a mere not-ok answer is healthy by construction — no ping, no
        penalty."""
        order = self.hostmap.twin_order(shard)
        addrs = [self.conf.addresses[shard][r] for r in order]
        t0 = time.monotonic()
        out, winner, failures = self.transport.hedged(
            addrs, path, payload, timeout=timeout,
            span_parent=span_parent)
        for i, err in failures:
            r = order[i]
            if isinstance(err, transport_mod.NotOkError):
                continue
            if isinstance(err, transport_mod.RefusedError):
                # actively refused the dial: known dead RIGHT NOW, not
                # merely slow — no ping grace, out of rotation at once
                # (the transport already penalized its EWMA)
                self.hostmap.mark_dead(shard, r)
                self.hostmap.penalize(shard, r, 1.0)
                continue
            if self._ping(shard, r):
                # alive but slow/failed on this request: penalize its
                # load signal, keep it alive
                self.hostmap.penalize(shard, r, 1.0)
            else:
                self.hostmap.mark_dead(shard, r)
        if out is None:
            return None
        r = order[winner]
        self.hostmap.mark_alive(shard, r)
        self.hostmap.observe_rtt(shard, r, time.monotonic() - t0)
        # a twin still wedged in flight when the hedge won gets its
        # load signal bumped inside Transport.hedged (the abandoned
        # request never reports a latency sample) — mirror that into
        # the hostmap twin ordering
        for i in range(winner):
            if all(f[0] != i for f in failures):
                self.hostmap.penalize(shard, order[i],
                                      time.monotonic() - t0)
        return out

    def get_document(self, docid: int) -> dict | None:
        shard = int(self.hostmap.shard_of_docid(docid))
        out = self._read_shard(shard, "/rpc/doc", {"docid": int(docid)})
        return out.get("doc") if out else None

    # --- scatter-gather query (Msg3a) ------------------------------------

    def _search_shard(self, shard: int, q: str, topk: int,
                      lang: int, parent_span=None,
                      deadline=None, tier=None,
                      tenant=None) -> dict | None:
        """One shard's leg of the scatter: rides the per-shard batcher
        so concurrent queries coalesce into one (hedged) RPC.
        ``parent_span`` carries the caller's trace across the
        read-pool thread hop (contextvars don't follow threads).

        The leg cache is checked here with the shard's generation
        captured BEFORE the RPC: a write racing the read moves the
        generation, so the entry we store is already dead — correctness
        over hit rate."""
        key = (shard, q, topk, lang)
        gen = self.shard_gen(shard)
        hit, out = self._leg_cache.lookup(key, gen=gen)
        if hit:
            if parent_span is not None:
                parent_span.tag(leg_cache="hit")
            return out
        out = self._batchers[shard].submit(q, topk, lang,
                                           SEARCH_TIMEOUT_S,
                                           parent_span=parent_span,
                                           deadline=deadline,
                                           tier=tier,
                                           tenant=tenant)
        if out is not None and out.get("ok", True):
            self._leg_cache.put(key, out, gen=gen)
        return out

    def search_batch(self, queries: list[str], topk: int = 10,
                     lang: int = 0, with_snippets: bool = True,
                     site_cluster: bool = True, offset: int = 0,
                     conf=None) -> list:
        """Many queries, answered concurrently: each runs the normal
        scatter-gather merge, but their per-shard legs coalesce in the
        shard batchers into batched ``/rpc/search`` RPCs — one
        ``search_device_batch`` dispatch per shard per window instead
        of one RPC per (query, shard). Results come back in input
        order."""
        if not queries:
            return []
        from ..query.engine import SearchResults
        with ThreadPoolExecutor(
                max_workers=min(32, len(queries))) as ex:
            futs = [ex.submit(self.search, q, topk=topk, lang=lang,
                              with_snippets=with_snippets,
                              site_cluster=site_cluster,
                              offset=offset, conf=conf)
                    for q in queries]
            out = []
            for q, f in zip(queries, futs):
                try:
                    out.append(f.result())
                except Exception as e:  # noqa: BLE001 — one bad query
                    # must not sink its batchmates: degrade to an
                    # empty, uncacheable answer (same contract as a
                    # timed-out scatter leg)
                    log.warning("search_batch: %r failed: %s", q, e)
                    g_stats.count("results.degraded")
                    out.append(SearchResults(
                        query=q, total_matches=0, results=[],
                        degraded=True))
            return out

    def search(self, q: str, topk: int = 10, lang: int = 0,
               with_snippets: bool = True, site_cluster: bool = True,
               offset: int = 0, conf=None):
        """Fan out to every shard's serving twin, merge top-k, then
        fetch titlerecs from the owning shards (Msg20).

        Wrapped by the front result cache (Msg17/Msg40Cache role):
        keyed on the full request shape, generation = the shard-gen
        vector, single-flight so a stampede of one hot query runs the
        scatter once."""
        # conf enters the ranking only through the PQR factors
        # (engine.apply_pqr), so key on those values — never id(conf):
        # CPython reuses object ids, and equal confs should share
        pqr = None if conf is None else (
            bool(conf.pqr_enabled), float(conf.pqr_lang_demote),
            float(conf.pqr_site_demote), float(conf.pqr_depth_demote))
        key = (q, topk, lang, with_snippets, site_cluster, offset, pqr)
        # the user-observed latency metric (cache hits included) — the
        # histogram the query_p99 SLO reads
        with trace_mod.timed_span("cluster.query"):
            out, _ = self._result_cache.get_or_compute(
                key, lambda: self._search_uncached(
                    q, topk=topk, lang=lang,
                    with_snippets=with_snippets,
                    site_cluster=site_cluster, offset=offset,
                    conf=conf))
        if getattr(out, "degraded", False):
            # a partial answer (shard down) must not be pinned for a
            # whole TTL — serve it once, recompute next time
            self._result_cache.invalidate(key)
        return out

    def _search_uncached(self, q: str, topk: int = 10, lang: int = 0,
                         with_snippets: bool = True,
                         site_cluster: bool = True,
                         offset: int = 0, conf=None):
        over = leg_topk(topk, offset)
        # the scatter span (and the query deadline + tier + tenant)
        # are handed to each leg explicitly: the legs run on read-pool
        # threads, where contextvars do not follow
        scatter_sp = trace_mod.begin("scatter",
                                     shards=self.conf.n_shards)
        dl = deadline_mod.current()
        tier = priority_mod.current_tier()
        tenant = priority_mod.current_tenant()
        futs = [self._read_pool.submit(
            self._search_shard, s, q, over, lang, scatter_sp, dl,
            tier, tenant)
            for s in range(self.conf.n_shards)]
        legs = []
        for f in futs:
            try:
                # overall deadline: one wedged shard degrades the
                # answer instead of hanging the caller for the full
                # per-twin timeout ladder
                legs.append(f.result(timeout=SEARCH_TIMEOUT_S + 5.0))
            except Exception:  # noqa: BLE001 — timeout → partial
                legs.append(None)
        degraded = any(leg is None for leg in legs)
        if degraded:
            # normalized partial answer (shard down / leg timeout):
            # stamped in stats, tagged in the trace, and the SERP is
            # never cached (search() invalidates; the serve layer skips
            # its page cache too)
            g_stats.count("results.degraded")
        if scatter_sp is not None:
            scatter_sp.tag(degraded=degraded)
            scatter_sp.finish()
        return merge_legs(q, legs, self.get_document, topk=topk, lang=lang,
                          with_snippets=with_snippets,
                          site_cluster=site_cluster, offset=offset,
                          conf=conf, fetch_map=self._read_pool.map)


def leg_topk(topk: int, offset: int = 0) -> int:
    """The depth each shard answers a query to: twice the merged page's
    rerank window (at least PQR_SCAN), and at least 16."""
    from ..query.engine import PQR_SCAN

    return max(max(topk + offset, PQR_SCAN) * 2, 16)


def merge_legs(q: str, legs: list, get_document, *, topk: int = 10,
               lang: int = 0, with_snippets: bool = True,
               site_cluster: bool = True, offset: int = 0, conf=None,
               fetch_map=map):
    """The Msg3a merge: the shards' legs (a reply dict each, ``None`` for
    a shard that did not answer, which makes the answer ``degraded``),
    concatenated in shard order and ordered by score with a stable sort
    on the host, then the titlerecs (``get_document(docid)``, the likely
    ones prefetched through ``fetch_map``), the site clustering, PQR and
    the page."""
    from ..query.compiler import compile_query
    from ..query.engine import (PQR_SCAN, SearchResults,
                                build_results, finish_page)

    want = max(topk + offset, PQR_SCAN)
    total = 0
    docids: list[int] = []
    scores: list[float] = []
    for out in legs:
        if out is None:
            continue
        total += int(out.get("total", 0))
        docids += [int(x) for x in as_array(out.get("docids", []))]
        scores += [float(x) for x in as_array(out.get("scores", []))]
    with trace_mod.timed_span("query.merge", docs=len(docids)):
        order = np.argsort(-np.asarray(scores, dtype=np.float64),
                           kind="stable")
        plan = compile_query(q, lang=lang)
    # prefetch the likely titlerecs concurrently (the reference
    # launches its Msg20 summary requests in parallel,
    # Msg40::launchMsg20s); build_results then reads the cache
    prefetch = [docids[i] for i in order[: want + 8]]
    with trace_mod.span("query.prefetch", docs=len(prefetch)):
        fetched = dict(zip(prefetch, fetch_map(get_document, prefetch)))
    get_doc = lambda d: fetched.get(d) if d in fetched \
        else get_document(d)
    results, clustered = build_results(
        get_doc,
        [docids[i] for i in order], [scores[i] for i in order],
        plan, topk=want, with_snippets=False,
        site_cluster=site_cluster)
    page = finish_page(
        results, offset=offset, topk=topk, conf=conf, qlang=lang,
        get_doc=get_doc,
        langid_of=lambda d: (fetched.get(d) or {}).get("langid", 0),
        words=plan.match_words(),
        with_snippets=with_snippets)
    return SearchResults(
        query=q, total_matches=total, results=page,
        clustered=clustered, degraded=any(leg is None for leg in legs))

"""The port's fleet: real node processes (``node --torch-device cpu``)
under the port's ``FleetManager``, in the scenarios of the reference's
``tests/test_fleet.py`` and ``tests/test_cluster.py``:

* spawn, readiness and each node's seat; a parm broadcast applied on
  every node with no restart; a SIGKILL, then the journal replay and the
  rejoin; a drain through the admission gate, then a restart; the
  teardown that reaps every child when the body raises, and the atexit
  reaper (fleets of 1 × 2, the reference's);
* the end to end cluster (2 × 2, on the device route): writes to every
  twin, one twin down and the read rerouted, the whole shard down and the
  answer ``degraded``, a restart caught up from the retry queue; and a
  parm broadcast that reaches a dead node when it returns and survives a
  restart;
* a child asked for ``cuda`` on a host without CUDA exits, and the
  fleet's readiness fails: no child serves from the CPU unasked.

Every wait has a deadline (``tests/polling.wait_until``), and every
fixture asserts on teardown that no child survives. Node processes start
only through ``FleetManager`` (osselint's ``proc-spawn`` rule)."""

import json
import urllib.request

import pytest
import torch

from open_source_search_engine_tpu_torch.parallel.cluster import \
    ClusterClient
from open_source_search_engine_tpu_torch.parallel.fleet import FleetManager
from open_source_search_engine_tpu_torch.utils import ghash
from tests.polling import wait_until

#: the children import torch with one thread each: several nodes share
#: the host's cores with the other test workers
CHILD_ENV = {"OMP_NUM_THREADS": "1"}

DOC = ("<html><head><title>Fleet survivor</title></head><body>"
       "<p>fleet durability words ftoken{i}.</p></body></html>")

DOCS = {
    f"http://s.test/doc{i}": (
        f"<html><head><title>Doc {i} cluster</title></head><body>"
        f"<p>cluster words shared everywhere token{i}.</p></body></html>")
    for i in range(12)
}


def _fleet(path, **kw):
    kw.setdefault("supervise", False)
    return FleetManager(path, device="cpu", env=CHILD_ENV, **kw)


def _index(fm, addr, i):
    out = fm.transport.request(
        addr, "/rpc/index",
        {"url": f"http://fleet.test/{i}", "content": DOC.format(i=i)},
        timeout=60.0)
    assert out["ok"], out
    return out


@pytest.fixture
def fleet(tmp_path):
    """One shard, two twins, no supervisor: the tests decide who dies
    and who comes back."""
    fm = _fleet(tmp_path / "fleet", n_shards=1, n_replicas=2,
                chaos_seed=5)
    try:
        fm.start_all()
        yield fm
    finally:
        fm.shutdown()
        assert fm.surviving_pids() == []


def test_spawn_readiness_and_identity(fleet):
    fm = fleet
    pids = set()
    for r in range(fm.n_replicas):
        ping = fm.wait_ready(0, r)
        assert ping["ok"] and ping["docs"] == 0
        assert (ping["shard"], ping["replica"]) == (0, r)
        assert ping["draining"] is False
        pids.add(ping["pid"])
        assert 0.0 < fm.ready_s[(0, r)] < fm.ready_timeout_s
    assert len(pids) == fm.n_replicas  # distinct real processes
    env = fm._child_env()
    assert env["OSSE_CHAOS"] == "5" and env["OSSE_CHAOS_RATE"] == "0"
    assert "JAX_PLATFORMS" not in CHILD_ENV
    assert fm.hosts_path.read_text() == fm.conf.dump()


def test_parm_broadcast_applies_on_every_node_without_restart(fleet):
    fm = fleet
    pids_before = dict(fm.pids())
    replies = fm.broadcast_parms({"spider_delay_ms": 2718})
    assert len(replies) == fm.n_shards * fm.n_replicas
    for addr, r in replies.items():
        assert r is not None and r["ok"], (addr, r)
        assert "spider_delay_ms" in r["applied"]
        assert r["pid"] == pids_before[
            next(sr for sr in fm.pids() if fm.addr(*sr) == addr)]
    for s in range(fm.n_shards):
        for r in range(fm.n_replicas):
            conf = fm.transport.request(fm.addr(s, r), "/rpc/conf", {},
                                        timeout=10.0)
            assert conf["conf"]["spider_delay_ms"] == 2718
    assert dict(fm.pids()) == pids_before  # applied live, no restart


def test_sigkill_journal_replay_rejoin(fleet):
    fm = fleet
    for i in range(3):  # both twins, as the client's fan-out writes
        _index(fm, fm.addr(0, 0), i)
        _index(fm, fm.addr(0, 1), i)
    fm.kill(0, 0)  # kill -9: no save, the journals only
    wait_until(lambda: not fm.alive(0, 0), timeout=10.0,
               desc="node dead after SIGKILL")
    fm.start_node(0, 0, wait=True)
    ping0 = fm.wait_ready(0, 0)
    ping1 = fm.wait_ready(0, 1)
    assert ping0["docs"] == ping1["docs"] == 3  # the replay kept all
    out = fm.transport.request(fm.addr(0, 0), "/rpc/search",
                               {"q": "fleet durability", "topk": 5},
                               timeout=60.0)
    assert out["ok"] and out["total"] == 3
    stats = fm.transport.request(fm.addr(0, 0), "/rpc/stats", {},
                                 timeout=10.0)
    assert stats["ok"] and "node.search" in stats["stats"]["latencies"]
    counters = stats["stats"]["counters"]
    # the flat path on the CPU runs K1's plain version, and the node
    # mirrors the kernel counters into its stats
    assert counters["kernel.min_scores.plain_calls"] >= 1
    assert "kernel.min_scores.launches" not in counters


def test_drain_then_restart_through_admission_gate(fleet):
    fm = fleet
    _index(fm, fm.addr(0, 0), 7)
    out = fm.transport.request(fm.addr(0, 0), "/rpc/drain",
                               {"timeout_s": 5.0}, timeout=10.0)
    assert out["ok"] and out["drained"], out
    ping = fm.transport.request(fm.addr(0, 0), "/rpc/ping", {},
                                timeout=10.0)
    assert ping["draining"] is True
    shed = fm.transport.request(fm.addr(0, 0), "/rpc/search",
                                {"q": "fleet", "topk": 5}, timeout=10.0)
    assert shed["ok"] is False and shed["shed"] == "draining"
    assert fm.stop_node(0, 0) is not None  # SIGTERM → save
    fm.start_node(0, 0, wait=True)
    ping = fm.wait_ready(0, 0)
    assert ping["draining"] is False  # a fresh gate
    assert ping["docs"] == 1          # the checkpoint held


def test_teardown_reaps_even_when_the_body_raises(tmp_path):
    fm = _fleet(tmp_path / "f2", n_shards=1, n_replicas=1)
    with pytest.raises(RuntimeError, match="boom"):
        with fm:
            assert fm.alive(0, 0)
            raise RuntimeError("boom")
    assert fm.surviving_pids() == []


def test_atexit_reaper_kills_the_process_group(tmp_path):
    fm = _fleet(tmp_path / "f3", n_shards=1, n_replicas=1)
    fm.start_all()
    assert fm.surviving_pids()
    fm._atexit_reap()
    wait_until(lambda: fm.surviving_pids() == [], timeout=10.0,
               desc="the atexit reaper cleared every child")
    fm.shutdown()  # idempotent
    assert fm.surviving_pids() == []


def test_cuda_child_without_cuda_fails_readiness(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fm = FleetManager(tmp_path / "f4", n_shards=1, n_replicas=1,
                      supervise=False, env=CHILD_ENV)
    assert fm.device == "cuda"  # the default
    try:
        with pytest.raises(RuntimeError, match="before answering ping"):
            fm.start_all()
        assert fm.pids()[(0, 0)] is not None and not fm.alive(0, 0)
    finally:
        fm.shutdown()
    assert fm.surviving_pids() == []
    log = (tmp_path / "f4" / "node_s0r0.log").read_text()
    assert "CUDA is not available" in log


# ---- the cluster, end to end (the reference's tests/test_cluster.py) -------

N_SHARDS = 2
N_REPLICAS = 2


@pytest.fixture
def cluster(tmp_path):
    """A 2 × 2 fleet on the device route, and a client with its leg and
    result caches off: a leg cached while its shard was up answers for
    the shard at an unchanged generation, so with the caches on the
    whole-shard death below is not seen (the reference's
    ``tests/test_cluster.py::test_cluster_end_to_end`` fails at that
    assertion on the JAX package for that reason)."""
    fm = _fleet(tmp_path / "fleet", n_shards=N_SHARDS,
                n_replicas=N_REPLICAS, use_device=True)
    try:
        fm.start_all()
        client = ClusterClient(fm.conf, use_heartbeat=False,
                               use_cache=False)
        try:
            yield fm, client
        finally:
            client.close()
    finally:
        fm.shutdown()
        assert fm.surviving_pids() == []


def _kill(fm, s, r):
    """SIGKILL a node and wait until its corpse is observable."""
    fm.kill(s, r)
    wait_until(lambda: not fm.alive(s, r), timeout=10.0,
               desc=f"node s{s}r{r} dead after SIGKILL")


def _search_urls(client, q, **kw):
    kw.setdefault("site_cluster", False)
    res = client.search(q, **kw)
    return res, {r.url for r in res.results}


def test_cluster_end_to_end(cluster):
    fm, client = cluster
    for url, html in DOCS.items():
        client.index_document(url, html)
    assert client.pending_writes == 0
    res, urls = _search_urls(client, "cluster words", topk=12)
    assert res.total_matches == len(DOCS) and not res.degraded
    assert urls == set(DOCS)

    # one twin of shard 0 down: the read reroutes to the other
    _kill(fm, 0, 0)
    res, urls = _search_urls(client, "cluster words", topk=12)
    assert res.total_matches == len(DOCS) and not res.degraded
    assert urls == set(DOCS)

    # a write while the twin is down parks in its retry queue
    client.index_document(
        "http://s.test/late",
        "<html><head><title>Late arrival</title></head><body>"
        "<p>cluster latecomer token99.</p></body></html>")
    late_shard = int(client.hostmap.shard_of_docid(
        ghash.doc_id("http://s.test/late")))
    res, urls = _search_urls(client, "latecomer", topk=5)
    assert "http://s.test/late" in urls

    # the other twin down too: the whole shard is gone → degraded
    _kill(fm, 0, 1)
    res, urls = _search_urls(client, "cluster words", topk=12)
    assert res.degraded
    assert 0 < len(urls) < len(DOCS)

    # one twin back: its durable state and the retry queue catch it up
    fm.start_node(0, 0, wait=True)
    wait_until(lambda: client.pending_writes == 0, timeout=30.0,
               interval=0.1, desc="retry queue drained into reborn twin")
    res, urls = _search_urls(client, "cluster words", topk=12)
    assert not res.degraded
    assert urls == set(DOCS)
    if late_shard == 0:
        res, urls = _search_urls(client, "latecomer", topk=5)
        assert "http://s.test/late" in urls


def test_parm_broadcast_reaches_all_nodes_and_survives(cluster):
    fm, client = cluster

    def parm_on(s, r, name):
        req = urllib.request.Request(f"http://{fm.addr(s, r)}/rpc/conf",
                                     data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            return json.load(resp)["conf"][name]

    client.broadcast_parm("spider_delay_ms", 4321)
    for s in range(N_SHARDS):
        for r in range(N_REPLICAS):
            assert parm_on(s, r, "spider_delay_ms") == 4321, (s, r)

    # a dead node: the update parks in its ordered queue
    _kill(fm, 0, 1)
    client.check_hosts()
    client.broadcast_parm("spider_delay_ms", 9999)
    assert parm_on(1, 0, "spider_delay_ms") == 9999
    fm.start_node(0, 1, wait=True)

    def caught_up():
        client.check_hosts()
        return (client.pending_writes == 0
                and parm_on(0, 1, "spider_delay_ms") == 9999)

    wait_until(caught_up, timeout=30.0, interval=0.1,
               desc="parked parm applied on the reborn node")

    # a restart with no queue: the persisted conf serves
    _kill(fm, 1, 0)
    fm.start_node(1, 0, wait=True)
    assert parm_on(1, 0, "spider_delay_ms") == 9999

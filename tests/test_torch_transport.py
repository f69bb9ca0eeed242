"""The port's cluster transport against the JAX package's (CPU).

* The OSSE1 binary codec and the JSON fallback: on the reference's own
  payload (``tests/test_cluster_transport.py::TestCodec``) the port's
  bytes equal the JAX package's, and a frame written by either package
  decodes in the other to the same arrays (dtype, shape and values
  exact).
* The scenarios of the reference's ``tests/test_cluster_transport.py``
  against the port's node servers (in process, ``device="cpu"``): keep-
  alive reuse and the transparent reconnect, binary and JSON
  ``/rpc/pull-all`` decoding to the same records, the batched
  ``/rpc/search`` in order, ``search_batch`` coalescing in input order,
  a hedged read beating a wedged twin (seen on the port server's
  ``/admin/transport``), and the ordered redelivery to a twin that comes
  back.
* The chaos plane's points (the schedule of each equal to the JAX
  package's for a seed) in the reference's ``tests/test_chaos.py``
  cluster scenarios: a refused primary fast-fails to its twin, a dropped
  leg degrades the page and is not cached, a twin killed mid-query
  leaves its twin to answer and a wedged one is eaten by the hedge (the
  sampled traces hold the answering node's adopted subtree, grafted
  under the winning attempt), and the fleet point SIGKILLs a real node
  process, which the supervisor respawns.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.parallel import transport as jtr
from open_source_search_engine_tpu.utils import chaos as jchaos
from open_source_search_engine_tpu_torch.parallel import cluster as cl
from open_source_search_engine_tpu_torch.parallel import transport as tr
from open_source_search_engine_tpu_torch.serve.server import \
    SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils import chaos as chaos_mod
from open_source_search_engine_tpu_torch.utils import ghash
from open_source_search_engine_tpu_torch.utils.chaos import (ChaosPlane,
                                                             g_chaos)
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from open_source_search_engine_tpu_torch.utils.trace import g_tracer
from tests.polling import wait_until

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_loops():
    yield
    g_residency.reset()


def _doc(i, words="cluster shared words"):
    return (f"<html><head><title>Doc {i}</title></head><body>"
            f"<p>{words} token{i}.</p></body></html>")


def _node(tmp_path, name, n_docs=3, start=True, port=0):
    node = cl.ShardNodeServer(tmp_path / name, port=port, device="cpu")
    for i in range(n_docs):
        node.handle("/rpc/index", {"url": f"http://t.test/{name}{i}",
                                   "content": _doc(i)})
    if start:
        node.start()
    return node


def _free_port():
    import socket
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
    sk.close()
    return port


# ---- the codec -------------------------------------------------------------

PAYLOAD = {
    "ok": True,
    "keys": np.arange(1000, dtype=np.uint64),
    "nested": {"scores": np.linspace(0.0, 1.0, 7),
               "names": ["a", "b"], "n": 3},
    "structured": np.zeros(4, dtype=np.dtype([("k", "<u8"),
                                              ("v", "<u4")])),
}


def _assert_same_tree(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("accept_bin", [True, False])
def test_wire_bytes_equal_the_reference(accept_bin):
    mine, ctype = tr.encode_body(PAYLOAD, accept_bin)
    theirs, jctype = jtr.encode_body(PAYLOAD, accept_bin)
    assert (mine, ctype) == (theirs, jctype)
    if accept_bin:
        assert mine[:5] == b"OSSE1"
        assert tr.encode_bin(PAYLOAD) == jtr.encode_bin(PAYLOAD)
    else:
        assert json.dumps(tr.to_wire_json(PAYLOAD)) == \
            json.dumps(jtr.to_wire_json(PAYLOAD))


@pytest.mark.parametrize("writer,reader", [(tr, jtr), (jtr, tr), (tr, tr)])
def test_frames_cross_the_packages(writer, reader):
    out = reader.decode_bin(writer.encode_bin(PAYLOAD))
    _assert_same_tree(out, jtr.decode_bin(jtr.encode_bin(PAYLOAD)))
    assert out["structured"].dtype == PAYLOAD["structured"].dtype
    wire = json.loads(json.dumps(writer.to_wire_json(PAYLOAD)))
    for k in ("keys",):
        _assert_same_tree(reader.as_array(wire[k]), PAYLOAD[k])
    _assert_same_tree(reader.as_array(wire["nested"]["scores"]),
                      PAYLOAD["nested"]["scores"])


def test_binary_wire_at_least_quarter_smaller():
    payload = {"ok": True, "batch": {
        "keys": np.arange(200_000, dtype=np.uint64)}}
    bin_bytes, _ = tr.encode_body(payload, True)
    json_bytes, _ = tr.encode_body(payload, False)
    assert len(bin_bytes) <= 0.75 * len(json_bytes)


# ---- the connection pool ---------------------------------------------------

def test_connection_reuse_and_transparent_reconnect(tmp_path):
    g_stats.reset()
    node = _node(tmp_path, "a", n_docs=0)
    t = tr.Transport()
    addr = f"127.0.0.1:{node.port}"
    try:
        for _ in range(12):
            out = t.request(addr, "/rpc/ping", {}, timeout=5.0)
        # 12 sequential RPCs rode one accepted TCP connection
        assert out["accepts"] == 1
        snap = g_stats.snapshot()["counters"]
        assert snap["transport.conn_dial"] == 1
        assert snap["transport.conn_reuse"] == 11
        # the peer restarts: the pooled socket is dead, and the next
        # request retries once on a fresh dial
        port = node.port
        node.stop()
        node2 = _node(tmp_path, "a2", n_docs=0, port=port)
        try:
            out = t.request(addr, "/rpc/ping", {}, timeout=5.0)
            assert out["ok"] and out["accepts"] == 1
            assert g_stats.snapshot()["counters"][
                "transport.conn_retry"] >= 1
        finally:
            node2.stop()
    finally:
        t.close()
        node.stop()


def test_binary_and_json_pull_all_decode_identically(tmp_path):
    node = _node(tmp_path, "pull", n_docs=3)
    addr = f"127.0.0.1:{node.port}"
    t_bin, t_json = tr.Transport(binary=True), tr.Transport(binary=False)
    try:
        out_b = t_bin.request(addr, "/rpc/pull-all", {}, timeout=30.0)
        out_j = t_json.request(addr, "/rpc/pull-all", {}, timeout=30.0)
        assert isinstance(out_b["rdbs"]["posdb"]["keys"], np.ndarray)
        assert isinstance(out_j["rdbs"]["posdb"]["keys"], str)
        assert sorted(out_b["rdbs"]) == sorted(node.coll.rdbs())
        for name in out_b["rdbs"]:
            bb = cl._decode_batch(out_b["rdbs"][name])
            bj = cl._decode_batch(out_j["rdbs"][name])
            np.testing.assert_array_equal(bb.keys, bj.keys)
            if bb.data is not None:
                np.testing.assert_array_equal(bb.data, bj.data)
        assert out_b["num_docs"] == out_j["num_docs"] == 3
    finally:
        t_bin.close()
        t_json.close()
        node.stop()


# ---- batched scatter-gather ------------------------------------------------

def _fruit_node(tmp_path, name, use_device=False):
    node = cl.ShardNodeServer(tmp_path / name, device="cpu",
                              use_device=use_device)
    node.handle("/rpc/index", {"url": "http://t.test/apple",
                               "content": _doc(0, "apple orchard")})
    node.handle("/rpc/index", {"url": "http://t.test/pie",
                               "content": _doc(1, "pie crust")})
    node.start()
    return node


@pytest.mark.parametrize("use_device", [False, True])
def test_batched_rpc_search_returns_per_query_results_in_order(
        tmp_path, use_device):
    node = _fruit_node(tmp_path, "b", use_device)
    t = tr.Transport()
    try:
        out = t.request(f"127.0.0.1:{node.port}", "/rpc/search",
                        {"queries": ["apple", "zebra", "pie"],
                         "topk": 5, "lang": 0}, timeout=30.0)
        assert out["ok"]
        assert [r["total"] for r in out["results"]] == [1, 0, 1]
        # a binary reply: docids come back as ndarrays
        assert isinstance(out["results"][0]["docids"], np.ndarray)
        assert out["results"][0]["scores"].dtype == np.float64
    finally:
        t.close()
        node.stop()


def test_search_batch_coalesces_and_keeps_input_order(tmp_path):
    g_stats.reset()
    node = _fruit_node(tmp_path, "sb")
    conf = cl.HostsConf.parse(f"num-mirrors: 0\n127.0.0.1:{node.port}")
    client = cl.ClusterClient(conf, use_heartbeat=False)
    try:
        res = client.search_batch(["apple", "zebra", "pie"], topk=5,
                                  with_snippets=False, site_cluster=False)
        assert [r.total_matches for r in res] == [1, 0, 1]
        assert res[0].query == "apple" and res[2].query == "pie"
        assert g_stats.snapshot()["counters"][
            "transport.node_batched_q"] >= 3
    finally:
        client.close()
        node.stop()


# ---- hedged twin reads -----------------------------------------------------

def test_hedged_read_beats_wedged_twin(tmp_path):
    """The primary twin sits on a search; the hedge fires after the
    floored hedge delay, the other twin answers, and the caller gets a
    full, non-degraded page in a fraction of the request timeout. The
    wedged twin stays alive but loses its primary slot."""
    docs = {f"http://t.test/h{i}": _doc(i) for i in range(3)}
    a = cl.ShardNodeServer(tmp_path / "wedged", device="cpu")
    b = cl.ShardNodeServer(tmp_path / "healthy", device="cpu")
    for url, html in docs.items():
        a.handle("/rpc/index", {"url": url, "content": html})
        b.handle("/rpc/index", {"url": url, "content": html})
    a.start()
    b.start()
    conf = cl.HostsConf.parse(
        f"num-mirrors: 1\n127.0.0.1:{a.port}\n127.0.0.1:{b.port}")
    client = cl.ClusterClient(conf, use_heartbeat=False)
    wedge = threading.Event()
    real_handle = a.handle

    def wedged_handle(path, payload):
        if path == "/rpc/search":
            wedge.wait(10.0)
        return real_handle(path, payload)

    a.handle = wedged_handle
    # seed the twin order so that the wedged node is the primary pick
    client.hostmap.rtt_s[0, 0] = 0.001
    client.hostmap.rtt_s[0, 1] = 0.002
    g_stats.reset()
    try:
        t0 = time.monotonic()
        res = client.search("cluster shared", topk=5, with_snippets=False,
                            site_cluster=False)
        elapsed = time.monotonic() - t0
        assert not res.degraded
        assert res.total_matches == len(docs)
        assert elapsed < 0.25 * cl.SEARCH_TIMEOUT_S
        snap = g_stats.snapshot()["counters"]
        assert snap["transport.hedge_fired"] >= 1
        assert snap["transport.hedge_won"] >= 1
        assert bool(client.hostmap.alive[0, 0])
        assert client.hostmap.twin_order(0)[0] == 1
        srv = SearchHTTPServer(str(tmp_path / "web"), port=0, device="cpu",
                               cluster=client)
        srv.start()
        try:
            body = json.load(urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/admin/transport",
                timeout=10.0))
            assert body["counters"]["transport.hedge_fired"] >= 1
            assert body["hostmap"]["shard0"]["twin_order"] == [1, 0]
            assert any(addr.endswith(str(b.port)) for addr in body["peers"])
        finally:
            srv.stop()
    finally:
        wedge.set()
        client.close()
        a.stop()
        b.stop()


# ---- ordered redelivery ----------------------------------------------------

def test_hostqueue_ordered_redelivery_with_pooled_client(tmp_path):
    """Writes to a dead twin park in order and redeliver in order when it
    returns: the newest version of a rewritten URL wins on the twin."""
    a = _node(tmp_path, "live", n_docs=0)
    port_b = _free_port()
    conf = cl.HostsConf.parse(
        f"num-mirrors: 1\n127.0.0.1:{a.port}\n127.0.0.1:{port_b}")
    client = cl.ClusterClient(conf, use_heartbeat=False)
    t = tr.Transport()
    try:
        client.index_document("http://t.test/versioned",
                              _doc(0, "first edition"))
        client.index_document("http://t.test/versioned",
                              _doc(0, "second edition"))
        assert client.pending_writes >= 1
        b = cl.ShardNodeServer(tmp_path / "back", port=port_b, device="cpu")
        b.start()
        try:
            wait_until(lambda: client.pending_writes == 0, timeout=30.0,
                       interval=0.1,
                       desc="parked writes drained into the reborn twin")
            out = t.request(f"127.0.0.1:{port_b}", "/rpc/search",
                            {"q": "second edition", "topk": 5},
                            timeout=30.0)
            assert out["total"] == 1
            out = t.request(f"127.0.0.1:{port_b}", "/rpc/search",
                            {"q": "first edition", "topk": 5},
                            timeout=30.0)
            assert out["total"] == 0
        finally:
            b.stop()
    finally:
        t.close()
        client.close()
        a.stop()


# ---- the chaos plane's transport, node and fleet points --------------------


def _count(name):
    return g_stats.snapshot()["counters"].get(name, 0)


class TestChaosPlane:
    @pytest.mark.parametrize("point", sorted(chaos_mod.DEFAULT_POINTS))
    def test_schedule_equals_the_reference(self, point):
        """The same seed fires the same kinds at the same calls as the
        JAX package's plane, per point."""
        p, j = ChaosPlane(), jchaos.ChaosPlane()
        p.enable(42, rate=0.5)
        j.enable(42, rate=0.5)
        mine = [p.decide(point, key="k") for _ in range(64)]
        assert mine == [j.decide(point, key="k") for _ in range(64)]
        assert any(k is not None for k in mine) and None in mine
        p.enable(42, rate=0.5)  # a re-arm replays from the top
        assert [p.decide(point) for _ in range(64)] == mine
        p.disable()
        assert p.decide(point) is None

    def test_match_configure_fired_and_env(self, monkeypatch):
        p, q = ChaosPlane(), ChaosPlane()
        p.enable(7, rate=1.0)
        q.enable(7, rate=1.0)
        q.configure("transport.request", match="10.0.0.9:8042")
        for k in ["10.0.0.9:8042/rpc/search", "10.0.0.7:8042/rpc/search"]:
            kind_all = p.decide("transport.request", key=k)
            kind_aimed = q.decide("transport.request", key=k)
            assert kind_aimed == (kind_all if "10.0.0.9" in k else None)
        p.enable(5, rate=0.0)
        p.configure("transport.request", rate=1.0, kinds=("refuse",))
        assert all(p.decide("transport.request") == "refuse"
                   for _ in range(10))
        assert p.decide("cluster.node") is None
        assert p.fired("transport.request")["refuse"] == 10
        monkeypatch.delenv("OSSE_CHAOS", raising=False)
        assert chaos_mod.maybe_enable() is False
        monkeypatch.setenv("OSSE_CHAOS", "not-a-seed")
        assert chaos_mod.maybe_enable() is False and not g_chaos.enabled
        monkeypatch.setenv("OSSE_CHAOS", "7")
        monkeypatch.setenv("OSSE_CHAOS_RATE", "0")
        try:
            assert chaos_mod.maybe_enable() is True
            assert g_chaos.enabled and g_chaos.seed == 7
            assert g_chaos.decide("fleet") is None  # rate 0: only aimed
        finally:
            g_chaos.disable()


def _twins(tmp_path, n_docs=4):
    a, b = (cl.ShardNodeServer(tmp_path / nm, device="cpu")
            for nm in ("a", "b"))
    for n in (a, b):
        for i in range(n_docs):
            n.handle("/rpc/index", {"url": f"http://t.test/d{i}",
                                    "content": _doc(i)})
        n.start()
    conf = cl.HostsConf.parse(
        f"num-mirrors: 1\n127.0.0.1:{a.port}\n127.0.0.1:{b.port}")
    client = cl.ClusterClient(conf, use_heartbeat=False)
    client.hostmap.rtt_s[0, 0] = 0.001  # a is the primary
    client.hostmap.rtt_s[0, 1] = 0.002
    return a, b, client


def _span_tags(node, out):
    out.append(node.get("tags", {}))
    for c in node.get("children", []):
        _span_tags(c, out)
    return out


class TestClusterChaos:
    def test_refused_primary_fastfails_to_twin(self, tmp_path):
        a, b, client = _twins(tmp_path)
        g_stats.reset()
        try:
            g_chaos.enable(11, rate=0.0)
            g_chaos.configure("transport.request", rate=1.0,
                              kinds=("refuse",),
                              match=f"127.0.0.1:{a.port}")
            res = client.search("cluster shared", topk=5)
            assert res.total_matches > 0 and res.results
            assert not res.degraded
            assert _count("transport.fastfail") >= 1
            assert not client.hostmap.alive[0, 0]
            assert client.hostmap.twin_order(0)[0] == 1
        finally:
            g_chaos.disable()
            client.close()
            a.stop()
            b.stop()

    def test_dropped_leg_degrades_partial_and_stays_uncached(
            self, tmp_path):
        a = cl.ShardNodeServer(tmp_path / "a", device="cpu")
        b = cl.ShardNodeServer(tmp_path / "b", device="cpu")
        a.start()
        b.start()
        conf = cl.HostsConf.parse(
            f"num-mirrors: 0\n127.0.0.1:{a.port}\n127.0.0.1:{b.port}")
        client = cl.ClusterClient(conf, use_heartbeat=False)
        g_stats.reset()
        try:
            per_shard = {0: 0, 1: 0}
            for i in range(16):
                url = f"http://t.test/d{i}"
                per_shard[int(client.hostmap.shard_of_docid(
                    ghash.doc_id(url)))] += 1
                client.index_document(url, _doc(i))
            assert per_shard[0] and per_shard[1]
            g_chaos.enable(13, rate=0.0)
            g_chaos.configure("transport.request", rate=1.0,
                              kinds=("drop",),
                              match=f"127.0.0.1:{b.port}")
            res = client.search("cluster shared words", topk=10)
            assert res.degraded and res.total_matches == per_shard[0]
            before = _count("results.degraded")
            assert before >= 1
            # a degraded page is served once, never cached
            assert client.search("cluster shared words", topk=10).degraded
            assert _count("results.degraded") > before
        finally:
            g_chaos.disable()
            client.close()
            a.stop()
            b.stop()

    def test_kill_primary_mid_query_twin_answers(self, tmp_path):
        """The node point kills the primary twin mid-query (its server
        stops from a side thread and the reply is severed): the other
        twin answers in full, nothing degraded, and the sampled trace
        holds the answering node's adopted subtree, grafted under the
        client's winning RPC span. (Whether the hedge timer or the
        severed reply moves the read first depends on when the stop
        lands; the wedge case below holds the hedge.)"""
        a, b, client = _twins(tmp_path)
        try:
            g_chaos.enable(17, rate=0.0)
            g_chaos.configure("cluster.node", rate=1.0, kinds=("kill",),
                              match=str(a.port), delay_s=0.05)
            with g_tracer.start("killquery", sampled=True) as tr:
                res = client.search("cluster shared words", topk=10)
            assert not res.degraded and res.total_matches == 4
            assert g_chaos.fired("cluster.node").get("kill", 0) >= 1
            wait_until(lambda: a._httpd is None, timeout=10.0,
                       desc="the killed node stopped")
            won = [t for t in _span_tags(tr.export()["root"], [])
                   if t.get("won")]
            assert [t.get("addr") for t in won] == [f"127.0.0.1:{b.port}"]
            # the node's adopted root names the client's RPC span
            assert any(t.get("parent") for t in _span_tags(
                tr.export()["root"], []))
        finally:
            g_chaos.disable()
            client.close()
            a.stop()
            b.stop()

    def test_wedged_primary_mid_query_hedge_eats_it(self, tmp_path):
        """The node point wedges the primary twin (its handler sits on
        the query for 20x the delay): after the hedge delay the same
        read races on the twin, which wins; the trace marks the hedge's
        attempt the winner, and the twin's subtree is grafted there."""
        a, b, client = _twins(tmp_path)
        g_stats.reset()
        try:
            g_chaos.enable(19, rate=0.0)
            g_chaos.configure("cluster.node", rate=1.0, kinds=("wedge",),
                              match=str(a.port), delay_s=0.25)
            with g_tracer.start("wedgequery", sampled=True) as tr:
                res = client.search("cluster shared words", topk=10)
            assert not res.degraded and res.total_matches == 4
            assert g_chaos.fired("cluster.node").get("wedge", 0) >= 1
            assert _count("transport.hedge_fired") >= 1
            assert _count("transport.hedge_won") >= 1
            root = tr.export()["root"]
            tags = _span_tags(root, [])
            assert any(t.get("hedge") and t.get("won") for t in tags)

            def hosts(node, out):
                out.add(node.get("host"))
                for c in node.get("children", []):
                    hosts(c, out)
                return out
            assert f"127.0.0.1:{b.port}" in hosts(root, set())
            assert bool(client.hostmap.alive[0, 0])  # slow is not dead
        finally:
            g_chaos.disable()
            client.close()
            a.stop()
            b.stop()

    def test_fleet_fault_signals_a_real_process(self, tmp_path):
        """The fleet point SIGKILLs (or SIGSTOPs) a spawned node; the
        supervisor respawns a killed one, and the respawned node replays
        its journal."""
        from open_source_search_engine_tpu_torch.parallel.fleet import \
            FleetManager
        fm = FleetManager(tmp_path / "fleet", n_shards=1, n_replicas=1,
                          device="cpu", env={"OMP_NUM_THREADS": "1"})
        try:
            fm.start_all()
            out = fm.transport.request(
                fm.addr(0, 0), "/rpc/index",
                {"url": "http://t.test/x", "content": _doc(1)},
                timeout=30.0)
            assert out["ok"]
            pid = fm.pid(0, 0)
            g_chaos.enable(3, rate=0.0)
            g_chaos.configure("fleet", rate=1.0, kinds=("kill",))
            assert g_chaos.fleet_fault(pid) == "kill"
            wait_until(lambda: fm.pid(0, 0) != pid, timeout=30.0,
                       interval=0.05, desc="the supervisor respawned")
            ping = fm.wait_ready(0, 0)
            assert ping["docs"] == 1 and ping["pid"] != pid
        finally:
            g_chaos.disable()
            fm.shutdown()
        assert fm.surviving_pids() == []

"""The port's control plane: the process lifecycle, shard liveness
(``Heartbeat``, with ``make_rpc_probe`` pinging real node servers), the
daily merge, the repair rebuild and the CLI's ``save`` and ``repair``
verbs.

``TestProcess`` is ``tests/test_control.py``'s; the daily merge's window
parsing and ``tick`` run with a fixed clock; ``repair`` runs as in
``tests/test_rebalance.py`` on a copy of a directory the JAX package
wrote, and its posdb, clusterdb and linkdb must be bitwise the JAX
package's after its own repair of the original, with equal pages."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path

import pytest

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.control.rebalance import \
    repair as jrepair
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.control import Heartbeat, Process
from open_source_search_engine_tpu_torch.control.process import \
    make_rpc_probe
from open_source_search_engine_tpu_torch.control.dailymerge import (
    DailyMerge, in_window, parse_window)
from open_source_search_engine_tpu_torch.control.rebalance import repair
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils.parms import Conf
from tests import jax_gc
from tests.golden.corpus import golden_docs

ROOT = Path(__file__).resolve().parent.parent
QUERIES = ["alpha", "alpha bravo", '"lima kilo"', "report -alpha",
           "alpha AND NOT bravo", "site:site0.golden.test alpha",
           "charlie delta report"]


def _page(res):
    return (res.total_matches,
            [(r.docid, r.url, round(r.score, 4)) for r in res.results])


class TestProcess:
    def test_save_all_and_shutdown(self, tmp_path):
        coll = Collection("proc", tmp_path, device="cpu")
        proc = Process()
        proc.register(coll)
        closed = []
        proc.on_shutdown(lambda: closed.append(1))
        proc.save_all()
        assert proc.saves == 1
        proc.shutdown()
        assert closed == [1] and proc.saves == 2 and proc.stopping

    def test_restart_recovers_memtable(self, tmp_path):
        c1 = Collection("re", tmp_path, device="cpu")
        docproc.index_document(
            c1, "http://r.test/p",
            "<html><title>T</title><body>persistent walrus</body></html>")
        Process().register(c1)
        c1.save()
        c2 = Collection("re", tmp_path, device="cpu")
        assert c2.num_docs == 1 and not c2.posdb.runs
        assert engine.search(c2, "walrus").results

    def test_a_failed_save_does_not_stop_the_others(self, tmp_path):
        class Broken:
            def save(self):
                raise OSError("disk gone")
        coll = Collection("ok", tmp_path, device="cpu")
        docproc.index_document(coll, "http://ok.test/", "<p>kept</p>")
        proc = Process()
        proc.register(Broken())
        proc.register(coll)
        proc.save_all()
        assert (coll.posdb.dir / "saved").is_dir()

    def test_autosave_clock(self, tmp_path):
        coll = Collection("auto", tmp_path, device="cpu")
        docproc.index_document(coll, "http://auto.test/", "<p>tick</p>")
        proc = Process(autosave_minutes=0.0005)
        proc.register(coll)
        proc.start_autosave()
        deadline = time.monotonic() + 30
        while proc.saves == 0:
            assert time.monotonic() < deadline, "autosave never ran"
            time.sleep(0.01)
        proc.shutdown()
        assert (coll.posdb.dir / "saved").is_dir()

    def test_signal_requests_a_shutdown(self):
        old = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                signal.SIGINT)}
        proc = Process()
        try:
            proc.install_signal_handlers()
            signal.raise_signal(signal.SIGTERM)
            assert proc.stopping and proc.saves == 0
        finally:
            for s, h in old.items():
                signal.signal(s, h)


@pytest.mark.parametrize("spec,want", [
    ("2-5", (2, 5)), ("22-4", (22, 4)), (" 0-23 ", (0, 23)), ("", None),
    ("2-", None), ("24-3", None), ("a-b", None), ("1-2-3", None)])
def test_parse_window(spec, want):
    assert parse_window(spec) == want


def test_in_window():
    assert [h for h in range(24) if in_window(h, (2, 5))] == [2, 3, 4]
    assert [h for h in range(24) if in_window(h, (22, 2))] == [0, 1, 22, 23]


class TestHeartbeat:
    """``tests/test_control.py::TestHeartbeat``, and the probe over RPC."""

    def test_dead_marking_and_recovery(self):
        from open_source_search_engine_tpu_torch.parallel import HostMap
        hm = HostMap(4)
        down = {2}
        hb = Heartbeat(hm, probe=lambda s: s not in down)
        hb.check_once()
        assert hm.alive[:, 0].tolist() == [True, True, False, True]
        down.clear()
        hb.check_once()
        assert hm.alive.all()

    def test_a_raising_probe_is_a_dead_shard(self):
        from open_source_search_engine_tpu_torch.parallel import HostMap
        hm = HostMap(2)

        def probe(s):
            if s == 1:
                raise OSError("unreachable")
            return True
        Heartbeat(hm, probe=probe).check_once()
        assert hm.alive[:, 0].tolist() == [True, False]

    def test_rpc_probe_follows_real_nodes(self, tmp_path):
        """Shard 0 has two twins, shard 1 one: a shard is alive while any
        of its twins answers ``/rpc/ping``, and the heartbeat's own
        thread marks the death and the return."""
        from open_source_search_engine_tpu_torch.parallel import HostMap
        from open_source_search_engine_tpu_torch.parallel.cluster import (
            HostsConf, ShardNodeServer)
        from open_source_search_engine_tpu_torch.parallel.transport import \
            Transport
        from tests.polling import wait_until
        nodes = [ShardNodeServer(tmp_path / f"n{i}", device="cpu")
                 for i in range(3)]
        for n in nodes:
            n.start()
        conf = HostsConf(2, 2, [[f"127.0.0.1:{nodes[0].port}",
                                 f"127.0.0.1:{nodes[1].port}"],
                                [f"127.0.0.1:{nodes[2].port}",
                                 f"127.0.0.1:{nodes[2].port}"]])
        t = Transport()
        hm = HostMap(2)
        hb = Heartbeat(hm, probe=make_rpc_probe(conf, transport=t,
                                                timeout_s=1.0),
                       interval_s=0.05)
        try:
            hb.check_once()
            assert hm.alive[:, 0].tolist() == [True, True]
            nodes[0].stop()  # a twin of shard 0 is left
            hb.check_once()
            assert hm.alive[:, 0].tolist() == [True, True]
            port = nodes[2].port
            nodes[2].stop()
            hb.start()
            wait_until(lambda: not hm.alive[1, 0], timeout=10.0,
                       desc="the heartbeat marked shard 1 dead")
            nodes[2] = ShardNodeServer(tmp_path / "n2", port=port,
                                       device="cpu")
            nodes[2].start()
            wait_until(lambda: hm.alive[1, 0], timeout=10.0,
                       desc="the heartbeat marked shard 1 alive again")
        finally:
            hb.stop()
            t.close()
            for n in nodes:
                n.stop()


def _runs(coll):
    return {n: len(db.runs) for n, db in coll.rdbs().items()}


def test_daily_merge_tick(tmp_path):
    coll = Collection("dm", tmp_path, device="cpu")
    for i in range(3):
        docproc.index_document(coll, f"http://dm{i}.test/",
                               f"<p>merge day words{i}</p>")
        coll.dump_all()
    conf = Conf()
    dm = DailyMerge(lambda: [coll], conf)
    night = datetime(2026, 10, 17, 3, 0)
    assert not dm.tick(now=night)          # no window: disabled
    conf.merge_quiet_hours = "2-5"
    assert not dm.tick(now=datetime(2026, 10, 17, 12, 0))
    before = _runs(coll)
    page = _page(engine.search(coll, "merge day"))
    assert before["posdb"] == 3
    assert dm.tick(now=night)
    assert all(n <= 1 for n in _runs(coll).values())
    assert _page(engine.search(coll, "merge day")) == page
    assert not dm.tick(now=night.replace(hour=4))   # once a day
    assert dm.tick(now=datetime(2026, 10, 18, 2, 30)) and dm.merges == 2


def test_daily_merge_thread_stops(tmp_path):
    conf = Conf()
    dm = DailyMerge([], conf, check_interval_s=0.01)
    dm.start()
    dm.stop()
    dm._thread.join(timeout=10)
    assert not dm._thread.is_alive()


#: two pages that link to each other, so linkdb holds edges and the
#: second pass reindexes with inlink anchor text
LINKED = {
    "http://hub.link.test/": '<html><title>Hub</title><body><p>alpha hub '
    '<a href="http://leaf.other.test/">bravo anchor words</a></p></body>'
    '</html>',
    "http://leaf.other.test/": '<html><title>Leaf</title><body><p>alpha '
    'leaf <a href="http://hub.link.test/">charlie anchor</a></p></body>'
    '</html>'}


def _golden_dir(base: Path) -> None:
    """10 golden pages and the two linked ones, indexed and saved by the
    JAX package (clock fixed: pages without a date take the index
    time)."""
    with jax_gc.quiet():
        c = JCollection("r", base)
        for url, html in list(golden_docs().items())[:10] + list(
                LINKED.items()):
            jdocproc.index_document(c, url, html)
        c.save()


@pytest.fixture
def fixed_clock():
    real = time.time
    time.time = lambda: 1.7e9
    yield
    time.time = real


def test_repair_matches_the_jax_package(tmp_path, fixed_clock):
    _golden_dir(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    with jax_gc.quiet():
        jc = JCollection("r", tmp_path / "jax")
        assert jrepair(jc) == 12
        jpages = {q: _page(jengine.search(jc, q, topk=10,
                                          site_cluster=False))
                  for q in QUERIES}
    pc = Collection("r", tmp_path / "port", device="cpu")
    before = {q: _page(engine.search(pc, q, topk=10, site_cluster=False))
              for q in QUERIES}
    pc.posdb.wipe()
    pc.clusterdb.wipe()
    pc.linkdb.rdb.wipe()
    assert engine.search(pc, "alpha", topk=10).total_matches == 0
    assert repair(pc) == 12
    for name in ("posdb", "clusterdb", "linkdb"):
        a = jc.rdbs()[name].get_all().keys
        b = pc.rdbs()[name].get_all().keys
        assert len(a) and a.tobytes() == b.tobytes(), name
    for q in QUERIES:
        got = _page(engine.search(pc, q, topk=10, site_cluster=False))
        assert got == before[q], q
        assert got[0] == jpages[q][0], q
        assert [r[:2] for r in got[1]] == [r[:2] for r in jpages[q][1]], q
        assert [r[2] for r in got[1]] == pytest.approx(
            [r[2] for r in jpages[q][1]], rel=1e-5), q
    # saved, not dumped into new runs beyond the wipe's rebuild
    again = Collection("r", tmp_path / "port", device="cpu")
    assert again.posdb.get_all().keys.tobytes() == \
        pc.posdb.get_all().keys.tobytes()


def test_repair_stops_the_resident_loop(tmp_path):
    coll = Collection("live", tmp_path, device="cpu")
    for i in range(4):
        docproc.index_document(coll, f"http://live{i}.test/",
                               f"<p>live words token{i}</p>")
    try:
        (want,) = engine.search_device_batch(coll, ["live words"],
                                             resident=True)
        loop = coll._resident_loop
        assert loop is not None and loop.alive
        assert repair(coll) == 4
        assert not loop.alive and coll._device_index is None
        assert coll._resident_loop is None
        (got,) = engine.search_device_batch(coll, ["live words"],
                                            resident=True)
        assert [(r.docid, r.score) for r in got.results] == \
            [(r.docid, r.score) for r in want.results]
    finally:
        g_residency.reset()


def _cli(*args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "open_source_search_engine_tpu_torch", *args,
         "--torch-device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_cli_save_and_repair(tmp_path):
    base = tmp_path / "d"
    coll = Collection("main", base, device="cpu")
    for i in range(5):
        docproc.index_document(coll, f"http://cli{i}.test/",
                               f"<p>verb words token{i}</p>")
    page = _page(engine.search(coll, "verb words"))
    runs = {n: len(db.runs) for n, db in coll.rdbs().items()}
    del coll
    assert _cli("save", "--dir", str(base)) == {"saved": ["main"]}
    saved = Collection("main", base, device="cpu")
    assert {n: len(db.runs) for n, db in saved.rdbs().items()} == runs
    assert (saved.posdb.dir / "saved").is_dir()
    assert not (saved.posdb.dir / "addsinprogress.bin").exists()
    del saved
    assert _cli("repair", "--dir", str(base)) == {"repaired": "main",
                                                  "docs": 5}
    again = Collection("main", base, device="cpu")
    assert _page(engine.search(again, "verb words")) == page

"""The port's write journal: no acknowledged add is lost.

``tests/test_journal.py``'s Rdb scenarios run against the port's
``Rdb``: a replay after an unclean close (payloads and tombstones too),
a torn tail that stops the replay and is cut so later batches survive,
the checkpoint's crash window, and a save that truncates the journal
without a double apply. Then the serve-layer contract: a port ``serve``
node on the CPU answers three ``/inject`` requests with 200 and is
killed with SIGKILL; the restarted node finds every page, with the same
pages as before the kill, and the restarted collection's pages equal
the JAX package's after the same injects and a clean restart (after an
unclean one the reference reads the doc count of its last save; the
test holds that difference too).

The node runs in a ``-c`` child driven by ``subprocess.run`` with a
timeout; its own client thread sends the requests and then signals the
process, and every wait in it has a deadline."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import engine as jengine
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index import posdb, rdblite
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
from tests import jax_gc

ROOT = Path(__file__).resolve().parent.parent


def _mk(tmp_path, **kw):
    return rdblite.Rdb("t", tmp_path, posdb.KEY_DTYPE, **kw)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return posdb.pack(termid=rng.integers(1, 1 << 40, n),
                      docid=rng.integers(1, 1 << 30, n),
                      wordpos=rng.integers(0, 1000, n))


def _span(k):
    ks = np.sort(k, order=("n2", "n1", "n0"))
    return ks[0], ks[-1]


class TestRdbJournal:
    def test_replay_after_unclean_close(self, tmp_path):
        k = _keys(100)
        _mk(tmp_path).add(k)   # no save, no dump: the object is dropped
        assert len(_mk(tmp_path).get_list(*_span(k))) == 100

    def test_blobs_replay(self, tmp_path):
        r = rdblite.Rdb("b", tmp_path, posdb.KEY_DTYPE, has_data=True)
        r.add(_keys(3, seed=1), [b"alpha", b"", b"\x00bin\xff" * 10])
        b = rdblite.Rdb("b", tmp_path, posdb.KEY_DTYPE,
                        has_data=True).mem.batch()
        assert sorted(b.payloads()) == sorted(
            [b"alpha", b"", b"\x00bin\xff" * 10])

    def test_tombstones_replay(self, tmp_path):
        r = _mk(tmp_path)
        k = _keys(10, seed=2)
        r.add(k)
        r.dump()
        assert not (r.dir / "addsinprogress.bin").exists()
        r.delete(k[:4])
        assert len(_mk(tmp_path).get_list(*_span(k))) == 6

    def test_torn_tail_stops_replay(self, tmp_path):
        r = _mk(tmp_path)
        r.add(_keys(50, seed=3))
        r.add(_keys(50, seed=4))
        jp = r.dir / "addsinprogress.bin"
        jp.write_bytes(jp.read_bytes()[:-7])
        assert len(_mk(tmp_path).mem.batch()) == 50

    def test_torn_tail_truncates_so_later_batches_survive(self, tmp_path):
        r = _mk(tmp_path)
        r.add(_keys(50, seed=30))
        jp = r.dir / "addsinprogress.bin"
        jp.write_bytes(jp.read_bytes()[:-7])
        r2 = _mk(tmp_path)          # the replay cuts the torn batch
        r2.add(_keys(10, seed=31))  # acknowledged after the restart
        assert len(_mk(tmp_path).mem.batch()) == 10

    def test_save_crash_window_keeps_old_checkpoint(self, tmp_path):
        import shutil
        r = _mk(tmp_path)
        r.add(_keys(20, seed=32))
        r.save()
        shutil.copytree(r.dir / "saved", r.dir / "saved.new")
        shutil.rmtree(r.dir / "saved")
        assert len(_mk(tmp_path).mem.batch()) == 20

    def test_save_truncates_and_no_double_apply(self, tmp_path):
        r = _mk(tmp_path)
        r.add(_keys(20, seed=5))
        r.save()
        assert not (r.dir / "addsinprogress.bin").exists()
        r.add(_keys(5, seed=6))
        assert len(_mk(tmp_path).mem.batch()) == 25

    def test_no_journal_env_drops_a_stale_journal(self, tmp_path,
                                                  monkeypatch):
        _mk(tmp_path).add(_keys(8, seed=7))
        monkeypatch.setenv("OSSE_NO_JOURNAL", "1")
        r = _mk(tmp_path)
        assert not r.journal_enabled and len(r.mem.batch()) == 0
        r.add(_keys(4, seed=8))
        assert (r.dir / "addsinprogress.bin").read_bytes() == b""
        monkeypatch.delenv("OSSE_NO_JOURNAL")
        assert len(_mk(tmp_path).mem.batch()) == 0

    def test_fsync_env_still_replays(self, tmp_path, monkeypatch):
        monkeypatch.setenv("OSSE_JOURNAL_FSYNC", "1")
        _mk(tmp_path).add(_keys(9, seed=9))
        assert len(_mk(tmp_path).mem.batch()) == 9


def _count_ops(c, index_batch, index_document, remove_document):
    index_batch(c, [(f"http://n{i}.test/", f"<p>count words{i}</p>")
                    for i in range(3)])
    index_document(c, "http://n9.test/", "<p>count words9</p>")
    index_document(c, "http://n1.test/", "<p>count words1 again</p>")
    remove_document(c, "http://n0.test/")


def test_doc_count_follows_the_journal(tmp_path):
    """A departure from the reference: an open that replays a journal
    recounts the documents from titledb, so the restarted scores equal
    the scores before the kill. The reference, after the same unclean
    stop, reads the count of its last save; after a clean one both
    packages read the saved count."""
    c = Collection("n", tmp_path / "t", device="cpu")
    _count_ops(c, docproc.index_batch, docproc.index_document,
               docproc.remove_document)
    assert c.num_docs == 3 and c.titledb.count_live() == 3
    again = Collection("n", tmp_path / "t", device="cpu")
    assert again.titledb.replayed and again.num_docs == 3
    a = engine.search(c, "count", topk=5, with_snippets=False)
    b = engine.search(again, "count", topk=5, with_snippets=False)
    assert [(r.docid, r.score) for r in a.results] == \
        [(r.docid, r.score) for r in b.results]
    again.save()   # a clean stop: the saved count is read, nothing replays
    clean = Collection("n", tmp_path / "t", device="cpu")
    assert not clean.titledb.replayed and clean.num_docs == 3
    with jax_gc.quiet():
        jc = JCollection("n", tmp_path / "j")
        _count_ops(jc, jdocproc.index_batch, jdocproc.index_document,
                   jdocproc.remove_document)
        assert jc.num_docs == 3
        del jc
        assert JCollection("n", tmp_path / "j").num_docs == 0


# --- kill -9 of a serving node ---------------------------------------------

PAGES = {f"http://kill{i}.test/doc{i}": (
    f"<html><head><title>Survivor page {i}</title></head><body><p>"
    f"durability words survive kill nine journal replay token{i}.</p>"
    f"</body></html>") for i in range(3)}
QUERIES = ["durability journal", "token1", "survive nine"]

_NODE = """
import json, os, signal, sys, threading, time, urllib.parse, urllib.request
sys.path.insert(0, {root!r})
from open_source_search_engine_tpu_torch.__main__ import main
base, pages, queries = "http://127.0.0.1:{port}/", {pages!r}, {queries!r}

def call(path, data=None):
    req = urllib.request.Request(base + path, data=data)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.load(r)

def client():
    sig = signal.SIGTERM
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                call("admin/stats")
                break
            except OSError:
                assert time.monotonic() < deadline, "node never answered"
                time.sleep(0.05)
        acks = [call("inject?u=" + urllib.parse.quote(u), html.encode())[0]
                for u, html in pages.items()]
        out = [call("search?format=json&n=10&q=" + urllib.parse.quote(q))
               for q in queries]
        print("RESULT " + json.dumps(dict(acks=acks, pages=out)), flush=True)
        sig = getattr(signal, {signal!r})
    finally:
        os.kill(os.getpid(), sig)

threading.Thread(target=client, daemon=True).start()
sys.exit(main(["serve", "--dir", {base!r}, "--port", "{port}",
               "--torch-device", "cpu"]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _node(base: Path, pages: dict, sig: str):
    """One ``serve`` child: inject ``pages``, run the queries, print the
    answers, then send itself ``sig``. Returns (returncode, result)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _NODE.format(
            root=str(ROOT), port=_free_port(), pages=pages,
            queries=QUERIES, base=str(base), signal=sig)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    result = [json.loads(ln[len("RESULT "):])
              for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    assert result, (out.returncode, out.stderr[-2000:])
    return out.returncode, result[0]


def _flat(results):
    return [(r.docid, r.url, r.title, round(r.score, 4))
            for r in results.results]


def test_inject_kill9_restart_loses_nothing(tmp_path):
    base = tmp_path / "node"
    rc, before = _node(base, PAGES, "SIGKILL")
    assert rc == -9 and before["acks"] == [200, 200, 200]
    status, first = before["pages"][0]
    assert status == 200 and first["totalMatches"] == 3

    # the restarted collection, in process: every acknowledged page is
    # back from the journal, titlerec included
    coll = Collection("main", base, device="cpu")
    assert coll.num_docs == 3
    for i, url in enumerate(PAGES):
        rec = docproc.get_document(coll, url=url)
        assert rec is not None and rec["title"] == f"Survivor page {i}"
    res = engine.search(coll, "durability journal", topk=10)
    assert res.total_matches == 3
    assert {r.url for r in res.results} == set(PAGES)
    assert engine.search(coll, "token1").results[0].url == \
        "http://kill1.test/doc1"

    # the JAX package after the same injects and an unclean reopen
    with jax_gc.quiet():
        jbase = tmp_path / "jax"
        for stop in ("unclean", "clean"):
            jc = JCollection("main", jbase / stop)
            for url, html in PAGES.items():
                jdocproc.index_document(jc, url, html)
            if stop == "clean":
                jc.save()
            del jc
            jc = JCollection("main", jbase / stop)
            for q in QUERIES:
                want = jengine.search(jc, q, topk=10, with_snippets=False)
                got = engine.search(coll, q, topk=10, with_snippets=False)
                assert got.total_matches == want.total_matches, q
                if stop == "clean":
                    assert _flat(got) == _flat(want), q
                else:
                    assert {r.docid for r in got.results} == \
                        {r.docid for r in want.results}, q
            # the reference's unclean reopen reads the count of its last
            # save (none here), so its scores move (ROADMAP §3); the
            # port recounts, and scores as the clean reference does
            assert jc.num_docs == (3 if stop == "clean" else 0)
    del coll

    # the restarted node answers every page as before the kill
    rc, again = _node(base, {}, "SIGTERM")
    assert rc == 0
    assert again["pages"] == before["pages"]

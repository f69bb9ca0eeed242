"""The port's device ingest plane (``build/devbuild.py``) against the
host oracle and the JAX package's ``devbuild`` (CPU).

Mirrors ``tests/test_devbuild.py`` ``TestBaseBitExact`` and
``TestDeltaFold``: over multi-run corpora with tombstones, re-adds
(newest wins) and a term past the positions-per-(term, doc) store cap,
every base and delta column and directory table the port's device build
makes must be bitwise equal to the port's host pipeline
(``OSSE_DEVBUILD=0``) and to JAX ``devbuild.build_base``/``build_delta``
on the same keys. A corpus of hand-made keys puts bit 31 of each
32-bit half of the key words to work (the unsigned-order hazard), and
``_demote`` is held to ``packer.demote_impacts`` on its edge values."""

import jax
import numpy as np
import pytest
import torch

from open_source_search_engine_tpu.build import devbuild as jdevbuild
from open_source_search_engine_tpu_torch.build import devbuild, docproc
from open_source_search_engine_tpu_torch.index import posdb
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex
from open_source_search_engine_tpu_torch.query.packer import (IMPACT_SCALE,
                                                              demote_impacts)
from open_source_search_engine_tpu_torch.utils import ghash
from open_source_search_engine_tpu_torch.utils.stats import g_stats

#: the tier-1 run shares the host's cores among several workers
torch.set_num_threads(1)

COLUMNS = ("payload", "docc", "doc", "imp", "rs", "cnt", "dense_imp",
           "dense_rs", "dense_cnt", "cube", "siterank", "doclang", "dead")
DIRS = ("dir_termids", "base_df", "dir_dstart", "dir_pstart",
        "base_docids", "h_doc_col", "dir2_termids", "delta_df",
        "dir2_dstart", "dir2_pstart", "all_docids", "tomb_df")
#: derive outputs compared with the JAX program's, column by column
DERIVED = ("payload", "docc", "docidx", "siterank", "langid", "doc_col",
           "imp32", "imp16", "rs", "cnt")


def _mkdoc(rng, words, i, repeat=None):
    n = int(rng.integers(20, 160))
    toks = list(rng.choice(words, size=n))
    if repeat is not None:
        # one term far past the positions-per-(term, doc) store cap
        toks += [repeat] * 30
    return (f"http://h{i % 17}.example.com/p{i}",
            f"<html><title>{' '.join(rng.choice(words, size=4))}</title>"
            f"<body><p>{' '.join(toks)}</p></body></html>")


def _seed_corpus(tmp_path, seed, name="pb"):
    """Three runs: tombstones for docs of runs 1 and 2 and a re-add in
    run 3 (annihilation across runs, newest wins), and an over-cap term."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    c = Collection(name, tmp_path / f"{name}{seed}", device="cpu")
    docs = [_mkdoc(rng, words, i) for i in range(100)]
    docs[7] = _mkdoc(rng, words, 7, repeat="capstone")
    docproc.index_batch(c, docs[:60])
    c.posdb.dump()
    c.titledb.dump()
    docproc.index_batch(c, docs[60:90])
    c.posdb.dump()
    docproc.remove_document(c, docs[3][0])
    docproc.remove_document(c, docs[65][0])
    docproc.index_document(c, *docs[5])
    c.posdb.dump()
    return c, docs


def _index(monkeypatch, c, on: bool) -> DeviceIndex:
    monkeypatch.setenv("OSSE_DEVBUILD", "1" if on else "0")
    return DeviceIndex(c)


def _assert_index_equal(host, dev):
    for name in DIRS:
        a, b = getattr(host, name), getattr(dev, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("Nb", "Mb", "N2", "M2", "D_cap", "Vc", "dense_slot_of",
                 "cube_slot_of"):
        assert getattr(host, name) == getattr(dev, name), name
    for name in COLUMNS:
        a, b = host.columns()[name], dev.columns()[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float16:  # impacts: raw float16 bits
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), name


class _Spy:
    """Records the arguments of the port's devbuild entry point."""

    def __init__(self, monkeypatch, name):
        self.calls = []
        real = getattr(devbuild, name)

        def spy(*a):
            self.calls.append(a)
            return real(*a)
        monkeypatch.setattr(devbuild, name, spy)


def _assert_build_equal(dv, jdv):
    """A port DeviceBuild against the JAX one over the same inputs."""
    assert (dv.n, dv.n_pairs) == (jdv.n, jdv.n_pairs)
    for name in ("dir_termids", "df", "dir_dstart", "dir_pstart",
                 "base_docids", "h_doc_col"):
        a, b = getattr(dv, name), getattr(jdv, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in DERIVED:
        have = dv.cols[name].numpy()
        want = np.asarray(jdv.cols[name])[: len(have)]
        # compare bits: floats and uint32 as same-width signed views
        views = {np.dtype(np.float16): np.int16,
                 np.dtype(np.float32): np.int32,
                 np.dtype(np.uint32): np.int32}
        have = have.view(views.get(have.dtype, have.dtype))
        want = want.view(views.get(want.dtype, want.dtype))
        assert np.array_equal(have.astype(np.int64),
                              want.astype(np.int64)), name
        # the reference's columns are zero past their counters too
        assert not np.asarray(jdv.cols[name])[len(have):].any(), name


class TestBaseBitExact:
    @pytest.mark.parametrize("seed", [7, 23, 101])
    def test_device_base_matches_host_and_jax(self, tmp_path, monkeypatch,
                                              seed):
        c, _ = _seed_corpus(tmp_path, seed)
        spy = _Spy(monkeypatch, "build_base")
        before = g_stats.counters.get("build.device_base", 0)
        dev = _index(monkeypatch, c, True)
        assert g_stats.counters.get("build.device_base", 0) == before + 1
        host = _index(monkeypatch, c, False)
        assert len(spy.calls) == 1  # the host build never reached it
        assert host._base_fp == dev._base_fp
        _assert_index_equal(host, dev)
        run_keys, device = spy.calls[0]
        assert len(run_keys) == 3 and torch.device(device).type == "cpu"
        _assert_build_equal(devbuild.build_base(run_keys, device),
                            jdevbuild.build_base(run_keys, jax.device_put))

    def test_store_cap_applied(self, tmp_path, monkeypatch):
        """The over-cap doc keeps exactly P positions of the repeated
        term (occ < P store cap)."""
        c, _ = _seed_corpus(tmp_path, 7, name="cap")
        dev = _index(monkeypatch, c, True)
        tid = ghash.term_id("capstone")
        i = int(np.searchsorted(dev.dir_termids, np.uint64(tid)))
        assert dev.dir_termids[i] == np.uint64(tid)
        assert int(dev.dir_dstart[i + 1] - dev.dir_dstart[i]) == 1
        assert int(dev.dir_pstart[i + 1] - dev.dir_pstart[i]) == dev.P
        assert int(dev.base_df[i]) == 1

    def test_high_bits_of_key_words(self, tmp_path, monkeypatch):
        """Termids with bit 47 set (bit 31 of the high word of n2, the
        int64 sign bit of the whole word) and docids with bit 21 set
        (bit 63 of n1) sort as unsigned: the directory ascends, and every
        column equals the host's and the JAX program's."""
        rng = np.random.default_rng(5)
        tids = np.array([5, (1 << 47) | 5, (1 << 47) | (1 << 46) | 9,
                         (1 << 31) | 3, (1 << 48) - 1, 1 << 40],
                        np.uint64)
        docids = np.array([1, (1 << 21) | 2, (1 << 37) | (1 << 21) | 7,
                           (1 << 38) - 1, 1 << 30], np.uint64)

        def keys(n, seed):
            r = np.random.default_rng(seed)
            return posdb.pack(
                r.choice(tids, n), r.choice(docids, n),
                wordpos=r.integers(0, 1 << 18, n).astype(np.uint64),
                densityrank=r.integers(0, 32, n).astype(np.uint64),
                wordspamrank=r.integers(0, 16, n).astype(np.uint64),
                hashgroup=r.integers(0, 11, n).astype(np.uint64),
                siterank=r.integers(0, 16, n).astype(np.uint64),
                langid=r.integers(0, 64, n).astype(np.uint64))

        c = Collection("hb", tmp_path, device="cpu")
        first = keys(400, 1)
        c.posdb.add(first)
        c.posdb.dump()
        c.posdb.add(keys(300, 2))
        c.posdb.delete(first[rng.choice(400, 60, replace=False)])
        c.posdb.dump()
        spy = _Spy(monkeypatch, "build_base")
        dev = _index(monkeypatch, c, True)
        host = _index(monkeypatch, c, False)
        _assert_index_equal(host, dev)
        assert len(dev.dir_termids) == len(tids)
        assert np.all(np.diff(dev.dir_termids.astype(object)) > 0)
        assert dev.base_docids.max() == np.uint64((1 << 38) - 1)
        run_keys, device = spy.calls[0]
        _assert_build_equal(devbuild.build_base(run_keys, device),
                            jdevbuild.build_base(run_keys, jax.device_put))


class TestDemote:
    def test_edge_values(self):
        """0, the 1e-30 presence floor, float16 subnormals, exact float16
        values and the float32 values just above them, the largest finite
        float16 and past it: the device demotion's bits equal the host's
        (``packer.demote_impacts``) and the JAX program's."""
        f16 = np.array([0.0, 2.0 ** -24, 3 * 2.0 ** -24, 2.0 ** -14,
                        0.5, 1.0, 1.5, 1000.0, 65504.0], np.float16)
        exact = f16.astype(np.float32) * np.float32(IMPACT_SCALE)
        above = np.nextafter(exact, np.float32(np.inf))
        below = np.nextafter(exact, np.float32(0.0))
        a = np.concatenate([exact, above, below, np.array(
            [1e-30, 1e-9, 7e-8, 1e6, 65504 * 16 + 1, 3e38],
            np.float32)]).astype(np.float32)
        got = devbuild._demote(torch.from_numpy(a)).numpy()
        with np.errstate(over="ignore"):  # past 65504: inf, as intended
            want = demote_impacts(a)
        assert np.array_equal(got.view(np.uint16), want.view(np.uint16))
        assert np.array_equal(
            got.view(np.uint16),
            np.asarray(jdevbuild._demote(jax.numpy.asarray(a))).view(
                np.uint16))
        assert got.view(np.uint16)[0] == 1  # 0 → smallest subnormal


class TestDeltaFold:
    QUERIES = ["w1", "w2 w3", '"w4 w5"', "w1 -w2", "capstone"]

    def test_delta_fold_equals_full_rebuild(self, tmp_path, monkeypatch):
        """Folding unflushed writes as a device delta must rank as
        dumping them and rebuilding the base does."""
        rng = np.random.default_rng(31)
        words = [f"w{i}" for i in range(120)]
        c, docs = _seed_corpus(tmp_path, 31, name="df")
        folded = _index(monkeypatch, c, True)
        docproc.index_batch(c, [_mkdoc(rng, words, 1000 + i)
                                for i in range(20)])
        docproc.remove_document(c, docs[10][0])
        before = g_stats.counters.get("build.device_delta", 0)
        deltas = folded.delta_rebuilds
        assert folded.refresh()
        assert folded.delta_rebuilds == deltas + 1
        assert folded.full_rebuilds == 1  # the fold never rebuilt the base
        assert g_stats.counters.get("build.device_delta", 0) == before + 1
        c.posdb.dump()
        c.titledb.dump()
        rebuilt = DeviceIndex(c)
        for q in self.QUERIES:
            a = folded.search(q, topk=32)
            b = rebuilt.search(q, topk=32)
            assert a[2] == b[2], q
            ka = sorted(zip([round(float(s), 3) for s in a[1][:a[2]]],
                            a[0][:a[2]]))
            kb = sorted(zip([round(float(s), 3) for s in b[1][:b[2]]],
                            b[0][:b[2]]))
            assert ka == kb, q

    def test_delta_matches_host_and_jax(self, tmp_path, monkeypatch):
        """Device delta columns bitwise equal to the host delta oracle,
        and the delta program's outputs to the JAX one's on the same
        memtable positives."""
        c, docs = _seed_corpus(tmp_path, 57, name="dh")
        rng = np.random.default_rng(57)
        words = [f"w{i}" for i in range(120)]
        dev = _index(monkeypatch, c, True)
        docproc.index_batch(c, [_mkdoc(rng, words, 2000 + i)
                                for i in range(15)])
        docproc.remove_document(c, docs[11][0])
        # a re-add of a base doc: its base postings die, the new ones
        # ride the delta
        docproc.index_document(c, docs[12][0], _mkdoc(rng, words, 12)[1])
        spy = _Spy(monkeypatch, "build_delta")
        assert dev.refresh()
        host = _index(monkeypatch, c, False)
        _assert_index_equal(host, dev)
        assert dev.d_dead.any()
        fp_, docidx, device = spy.calls[0]
        _assert_build_equal(devbuild.build_delta(fp_, docidx, device),
                            jdevbuild.build_delta(fp_, docidx,
                                                  jax.device_put))

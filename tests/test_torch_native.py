"""The port's native storage core (``native/rdbcore.cpp``) held to the
cases of the reference's ``tests/test_native.py``: it builds and loads,
its key search and n-way merge equal the port's numpy path and the JAX
package's ``rdblite`` on the same runs, and a tombstone annihilates its
record. The libraries build from the port's own sources into a
git-ignored directory, and processes that build them at once all load a
whole library."""

import concurrent.futures
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from open_source_search_engine_tpu.index import posdb as jposdb
from open_source_search_engine_tpu.index import rdblite as jrdblite
from open_source_search_engine_tpu_torch import native
from open_source_search_engine_tpu_torch.index import posdb, rdblite

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "g++ builds librdbcore here"
    return lib


def _random_keys(n, seed, frac_tombstone=0.2):
    rng = np.random.default_rng(seed)
    keys = posdb.pack(
        termid=rng.integers(0, 50, n), docid=rng.integers(0, 200, n),
        wordpos=rng.integers(0, 1000, n),
        delbit=(rng.random(n) > frac_tombstone).astype(int))
    return keys[rdblite.key_sort_order(keys)]


def _bytes(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


class TestNativeCore:
    def test_builds_and_loads_from_the_ports_sources(self, lib):
        for name, opt, got in (("rdbcore", "-O3", lib),
                               ("doccore", "-O2", native.get_doccore())):
            so = native.library_path(name, opt)
            assert Path(got._name) == so and so.exists()
            assert so.parent == ROOT / "build" / "torch_native"
            assert (native.SRC_DIR / f"{name}.cpp").parent == \
                ROOT / "open_source_search_engine_tpu_torch" / "native"
        assert "/build/torch_native/" in \
            (ROOT / ".gitignore").read_text().split()

    @pytest.mark.parametrize("side", ["left", "right"])
    def test_searchsorted_matches_numpy_and_the_reference(
            self, lib, monkeypatch, side):
        keys = _random_keys(500, seed=1)
        probes = _random_keys(40, seed=2)
        nat = rdblite.searchsorted_keys(keys, probes, side)
        ref = jrdblite.searchsorted_keys(keys, probes, side)
        monkeypatch.setattr(native, "available", lambda: False)
        py = rdblite.searchsorted_keys(keys, probes, side)
        np.testing.assert_array_equal(nat, py)
        np.testing.assert_array_equal(nat, ref)

    def test_searchsorted_many_matches_one_probe_at_a_time(
            self, lib, monkeypatch):
        """Many probes in one search, each on its own side, natively and
        in numpy's rounds, equal the reference's search a probe."""
        keys = _random_keys(500, seed=4)
        probes = np.concatenate([_random_keys(40, seed=5), keys[::17]])
        right = np.arange(len(probes)) % 3 == 0
        want = [int(jrdblite.searchsorted_keys(
            keys, probes[i:i + 1], "right" if right[i] else "left")[0])
            for i in range(len(probes))]
        nat = rdblite.searchsorted_keys_many(keys, probes, right)
        monkeypatch.setattr(native, "available", lambda: False)
        py = rdblite.searchsorted_keys_many(keys, probes, right)
        assert nat.tolist() == py.tolist() == want
        assert rdblite.searchsorted_keys_many(keys[:0], probes,
                                              right).tolist() == \
            [0] * len(probes)

    @pytest.mark.parametrize("keep_tombstones", [False, True])
    def test_merge_matches_numpy_and_the_reference(
            self, lib, monkeypatch, keep_tombstones):
        runs = [_random_keys(300, seed=s) for s in range(4)]
        nat = rdblite.merge_batches([rdblite.RecordBatch(r) for r in runs],
                                    keep_tombstones)
        ref = jrdblite.merge_batches([jrdblite.RecordBatch(r)
                                      for r in runs], keep_tombstones)
        direct = native.merge_runs(runs, keep_tombstones)
        monkeypatch.setattr(native, "available", lambda: False)
        py = rdblite.merge_batches([rdblite.RecordBatch(r) for r in runs],
                                   keep_tombstones)
        assert len(nat) == len(py) == len(ref) > 0
        assert _bytes(nat.keys) == _bytes(py.keys) == _bytes(ref.keys) == \
            _bytes(direct)

    def test_merge_annihilation(self, lib):
        pos = posdb.pack(termid=7, docid=42, wordpos=5, delbit=1)
        neg = posdb.pack(termid=7, docid=42, wordpos=5, delbit=0)
        keep = posdb.pack(termid=7, docid=43, wordpos=9, delbit=1)
        both = np.stack([pos, keep])
        old = rdblite.RecordBatch(both[rdblite.key_sort_order(both)])
        new = rdblite.RecordBatch(np.atleast_1d(neg))
        merged = rdblite.merge_batches([old, new], keep_tombstones=False)
        assert len(merged) == 1
        # the tombstone killed docid 42's posting
        assert int(posdb.unpack(merged.keys)["docid"][0]) == 43
        jm = jrdblite.merge_batches(
            [jrdblite.RecordBatch(np.asarray(old.keys)),
             jrdblite.RecordBatch(np.atleast_1d(neg))],
            keep_tombstones=False)
        assert _bytes(jm.keys) == _bytes(merged.keys)
        assert jposdb.KEY_DTYPE.itemsize == posdb.KEY_DTYPE.itemsize

    def test_rejects_runs_of_other_key_dtypes(self, lib):
        a = _random_keys(4, seed=3)
        b = np.zeros(2, dtype=np.dtype([("n0", "<u8"), ("n1", "<u8")]))
        with pytest.raises(ValueError, match="dtype"):
            native.merge_runs([a, b], False)
        with pytest.raises(ValueError, match="dtype"):
            native.searchsorted_many(a, b[:1], np.zeros(1, bool))


_BUILD_PROBE = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from open_source_search_engine_tpu_torch import native
native.BUILD_DIR = Path({build!r})
assert native.get_lib() is not None and native.get_doccore() is not None
cols = native.tokenize_native("<p>alpha beta.</p>", None, True)
print(cols.words, native.hash64_native(b"alpha"))
"""


def test_concurrent_builds_all_load_a_whole_library(tmp_path):
    """Processes that build the libraries at the same moment (six test
    workers do) each write a temporary file and rename it into place:
    every one loads a whole library, and no temporary file is left."""
    probe = _BUILD_PROBE.format(root=str(ROOT), build=str(tmp_path))

    def run(_):
        return subprocess.run([sys.executable, "-c", probe],
                              capture_output=True, text=True, timeout=300)

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(run, range(4)))
    for out in outs:
        assert out.returncode == 0, out.stderr[-2000:]
    assert len({out.stdout for out in outs}) == 1
    assert "['alpha', 'beta']" in outs[0].stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [native.library_path("doccore", "-O2").name,
         native.library_path("rdbcore", "-O3").name])


@pytest.mark.slow
class TestSanitizerParity:
    """The ``OSSE_NATIVE_SAN=1`` libraries (ASan+UBSan) pass the same
    parity checks (``native/san_check.py``): a memory error or undefined
    behaviour in ``rdbcore.cpp`` or ``doccore.cpp`` aborts the run."""

    def test_asan_ubsan_parity_clean(self):
        from open_source_search_engine_tpu_torch.native import san_check
        if len(san_check.sanitizer_libs()) < 2:
            pytest.skip("libasan/libubsan not found by g++")
        proc = subprocess.run(
            [sys.executable, "-m",
             "open_source_search_engine_tpu_torch.native.san_check"],
            cwd=ROOT, capture_output=True, text=True, timeout=420)
        assert proc.returncode == 0, \
            f"sanitizer parity failed:\n{proc.stdout}\n{proc.stderr}"
        assert "OK" in proc.stdout

"""The port's jit watcher (``utils/jitwatch.py``) on the CPU.

The scenarios of ``tests/test_jitwatch.py`` against the port: explicit
transfers are counted and keyed by site (the port's seams report them:
``DeviceIndex._put``, the wave fetch), a steady state builds nothing, the
off switch is a true no-op, enable/disable restore every hook, the
device layer's import arms the watcher under ``OSSE_JITWATCH=1``, and
``/admin/jit`` serves the table. A compile is a kernel build or load by
``query/cuda_build.py`` (faked here: no ``nvcc`` on the CPU); the
implicit-transfer tripwire is torch's sync-debug warning, captured and
sited (raised here by hand: no card on the CPU). The snapshot has the
JAX package's keys. ``first_traces`` and ``retraces`` stay 0: the port
runs eager torch and traces nothing.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from open_source_search_engine_tpu.utils import jitwatch as jjitwatch
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import cuda_build, engine
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils import jitwatch
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """The collector collects before and after this module and stays off
    inside it (``tests/jax_gc.py``): the JAX package's tests that a
    worker runs next start from no leftover garbage."""
    with jax_gc.quiet():
        yield


@pytest.fixture
def watch():
    """Enabled watcher with a fresh table; restores the enablement it
    found (tier-1 may run with OSSE_JITWATCH=1)."""
    was = jitwatch.enabled()
    jitwatch.enable()
    jitwatch.reset()
    yield jitwatch.g_jitwatch
    jitwatch.reset()
    if not was:
        jitwatch.disable()
    g_residency.reset()


def _small_coll(tmp_path) -> Collection:
    c = Collection("jw", tmp_path, device="cpu")
    c.conf.pqr_enabled = False
    for i in range(3):
        docproc.index_document(c, f"http://jw.test/p{i}",
                               f"<p>walrus herd {i} shore</p>")
    return c


def test_transfer_events_counted_and_sited(watch):
    jitwatch.note_transfer("device_get", "d2h", 32)
    snap = jitwatch.snapshot()
    assert snap["totals"]["transfers"] == 1
    ev = [e for e in snap["events"] if e["kind"] == "transfer"]
    assert ev[0]["fn"] == "device_get"
    assert "test_torch_jitwatch.py" in ev[0]["site"]
    assert ev[0]["bytes"] == 32
    # tests/ is not a blessed device-boundary module
    assert not ev[0]["boundary"]
    assert snap["totals"]["transfers_offboundary"] == 1
    assert jitwatch.is_boundary_site("query/devindex.py:1582")


def test_the_route_s_transfers_are_on_the_boundary(watch, tmp_path):
    coll = _small_coll(tmp_path)
    di = engine.get_device_index(coll)
    jitwatch.reset()
    di.search_batch(["walrus herd"], topk=8)
    snap = jitwatch.snapshot()
    ev = [e for e in snap["events"] if e["kind"] == "transfer"]
    fns = {e["fn"] for e in ev}
    assert {"_put", "_queue_fetch"} <= fns, fns
    assert all(e["boundary"] for e in ev), ev
    assert all(e["site"].startswith("query/devindex.py:") for e in ev)
    assert snap["totals"]["transfers"] == sum(e["count"] for e in ev)
    assert snap["totals"]["transfers_offboundary"] == 0
    ctr = g_stats.snapshot()["counters"]
    assert any(k.startswith("jit.transfer.query/devindex.py:")
               for k in ctr)


def test_steady_state_is_quiet(watch, tmp_path):
    coll = _small_coll(tmp_path)
    di = engine.get_device_index(coll)
    di.search_batch(["walrus"], topk=8)
    jitwatch.reset()
    for _ in range(3):
        di.search_batch(["walrus"], topk=8)
    t = jitwatch.snapshot()["totals"]
    assert t["compiles"] == 0 and t["retraces"] == 0
    assert t["first_traces"] == 0


def test_kernel_build_and_load_are_compiles(watch, tmp_path, monkeypatch):
    """A build runs the compiler once per source and flags (a cached
    library is no compile); a load is one compile per process."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 1 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
                    "done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "_libs", {})

    class _Lib:
        osse_min_scores = staticmethod(lambda *a: 0)

    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: _Lib())
    cuda_build.build("min_scores")
    cuda_build.build("min_scores")  # cached: no compile
    cuda_build.load("min_scores", "osse_min_scores", [])
    cuda_build.load("min_scores", "osse_min_scores", [])  # loaded once
    snap = jitwatch.snapshot()
    assert snap["totals"]["compiles"] == 2
    ev = {e["last"]: e for e in snap["events"] if e["kind"] == "compile"}
    assert set(ev) == {"nvcc", "load"}
    assert ev["nvcc"]["fn"] == ev["load"]["fn"] == "min_scores"
    assert "test_torch_jitwatch.py" in ev["load"]["site"]
    assert g_stats.snapshot()["counters"]["jit.compiles"] >= 2


def test_sync_warnings_are_captured_and_sited(monkeypatch):
    """The tripwire's warning (torch's sync-debug text) counts as an
    implicit transfer at the line that raised it and is not shown; any
    other warning still is."""
    was = jitwatch.enabled()
    jitwatch.disable()
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda msg, *a, **k: shown.append(str(msg)))
    jitwatch.enable()
    jitwatch.reset()
    try:
        for _ in range(2):
            warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("an unrelated warning")
        snap = jitwatch.snapshot()
    finally:
        jitwatch.disable()
        if was:
            jitwatch.enable()
    ev = [e for e in snap["events"] if e["fn"] == "sync"]
    assert len(ev) == 1 and ev[0]["count"] == 2
    assert ev[0]["last"] == "d2h-implicit"
    assert "test_torch_jitwatch.py" in ev[0]["site"]
    assert snap["totals"]["transfers_offboundary"] == 2
    assert shown == ["an unrelated warning"]


def test_enable_disable_restores_hooks():
    was = jitwatch.enabled()
    jitwatch.disable()
    show, filters = warnings.showwarning, list(warnings.filters)
    jitwatch.enable()
    assert warnings.showwarning is not show
    jitwatch.disable()
    assert warnings.showwarning is show
    assert warnings.filters == filters
    if was:
        jitwatch.enable()


def test_snapshot_keys_are_the_reference_s(watch):
    jitwatch.note_transfer("x", "h2d", 4)
    mine = jitwatch.snapshot()
    ref = jjitwatch.snapshot()
    assert sorted(mine) == sorted(ref)
    assert sorted(mine["totals"]) == sorted(ref["totals"])
    ev = jjitwatch.Event("transfer", "x", "", "a.py:1").as_dict()
    assert sorted(mine["events"][0]) == sorted(ev)


def test_off_is_true_noop():
    """With OSSE_JITWATCH unset, importing the device layer hooks no
    warning path and mints no jit.* counters."""
    code = (
        "import os, warnings\n"
        "os.environ.pop('OSSE_JITWATCH', None)\n"
        "show = warnings.showwarning\n"
        "from open_source_search_engine_tpu_torch.utils import jitwatch\n"
        "from open_source_search_engine_tpu_torch.query import devindex\n"
        "assert not jitwatch.enabled()\n"
        "assert warnings.showwarning is show\n"
        "from open_source_search_engine_tpu_torch.utils.stats import "
        "g_stats\n"
        "ctr = g_stats.snapshot()['counters']\n"
        "assert not any(k.startswith('jit.') for k in ctr), ctr\n"
        "print('NOOP-OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NOOP-OK" in proc.stdout


def test_env_enables_via_device_layer_import():
    code = (
        "from open_source_search_engine_tpu_torch.query import devindex\n"
        "from open_source_search_engine_tpu_torch.utils import jitwatch\n"
        "assert jitwatch.enabled()\n"
        "print('ON-OK')\n")
    env = dict(os.environ)
    env["OSSE_JITWATCH"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ON-OK" in proc.stdout


def test_admin_jit_page(tmp_path, watch):
    """/admin/jit serves the attribution table in HTML and JSON."""
    from open_source_search_engine_tpu_torch.serve.server import \
        SearchHTTPServer
    jitwatch.note_transfer("device_get", "d2h", 16)
    s = SearchHTTPServer(tmp_path, port=0, device="cpu")
    try:
        code, html, _ = s.handle("GET", "/admin/jit", {}, b"")
        assert code == 200
        assert "jit plane" in html and "watcher enabled" in html
        js = json.loads(s.handle("GET", "/admin/jit",
                                 {"format": "json"}, b"")[1])
        assert js["enabled"]
        assert js["totals"]["transfers"] >= 1
        assert any(e["kind"] == "transfer" for e in js["events"])
        assert any(k.startswith("jit.transfer.") for k in js["counters"])
    finally:
        s.stop()

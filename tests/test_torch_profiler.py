"""The port's sampling profiler (``utils/profiler.py``) on the CPU.

The three scenarios of ``tests/test_profiler.py`` against the port:
start/stop are idempotent (one sampler thread), a busy thread's frames
land in both the self and cumulative histograms, and reset() zeroes the
aggregation. Every wait polls against a deadline (a loaded host samples
late, never wrongly). The report has the JAX package's keys, and
``/admin/profiler`` drives the process-wide sampler.
"""

import json
import threading
import time

import pytest

from open_source_search_engine_tpu.utils.profiler import \
    SamplingProfiler as JSamplingProfiler
from open_source_search_engine_tpu_torch.serve.server import SearchHTTPServer
from open_source_search_engine_tpu_torch.utils.profiler import (
    SamplingProfiler, g_profiler)
from tests import jax_gc

DEADLINE_S = 30.0


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """The collector collects before and after this module and stays off
    inside it (``tests/jax_gc.py``): the JAX package's tests that a
    worker runs next start from no leftover garbage."""
    with jax_gc.quiet():
        yield


def _burn_inner(n=20_000):
    x = 0
    for i in range(n):
        x += i * i
    return x


def _burn_loop(stop):
    while not stop.is_set():
        _burn_inner()


def _sample_until(p, pred):
    """Run a busy thread under ``p`` until ``pred(p)`` holds or the
    deadline passes."""
    stop = threading.Event()
    th = threading.Thread(target=_burn_loop, args=(stop,), daemon=True)
    th.start()
    p.start()
    try:
        deadline = time.monotonic() + DEADLINE_S
        while not pred(p) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        p.stop()
        stop.set()
        th.join(5.0)


def test_start_stop_idempotent():
    p = SamplingProfiler(interval_s=0.002)
    assert not p.running
    p.stop()  # stop before any start: no-op
    p.start()
    first = p._thread
    p.start()  # a second start keeps the same sampler thread
    assert p._thread is first and p.running
    p.stop()
    assert not p.running and p._thread is None
    p.stop()  # double stop: no-op


def test_busy_thread_frames_aggregated():
    p = SamplingProfiler(interval_s=0.001)
    _sample_until(p, lambda p: (
        p.samples >= 20 and "_burn_inner" in {k[0] for k in p.self_hits}))
    assert p.samples >= 20
    assert "_burn_loop" in {k[0] for k in p.cum_hits}
    # the leaf shows up as self time, and the report carries the share
    assert "_burn_inner" in {k[0] for k in p.self_hits}
    rep = p.report()
    assert rep["samples"] == p.samples and not rep["running"]
    assert any(r["func"] == "_burn_inner" and r["hits"] > 0
               for r in rep["top_self"])
    assert all(0.0 <= r["frac"] <= 1.0 for r in rep["top_cumulative"])
    # the reference's report keys
    assert sorted(rep) == sorted(JSamplingProfiler().report())


def test_reset_zeroes_aggregation():
    p = SamplingProfiler(interval_s=0.001)
    _sample_until(p, lambda p: p.samples >= 5)
    assert p.samples >= 5
    p.reset()
    assert p.samples == 0 and not p.self_hits and not p.cum_hits
    assert p.report()["top_self"] == []


def test_admin_page_drives_the_sampler(tmp_path):
    s = SearchHTTPServer(tmp_path, port=0, device="cpu")
    try:
        code, body, _ = s.handle("GET", "/admin/profiler",
                                 {"sample": "start"}, b"")
        assert code == 200 and json.loads(body) == {"sampling": True}
        assert g_profiler.running
        deadline = time.monotonic() + DEADLINE_S
        while g_profiler.samples < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        code, body, _ = s.handle("GET", "/admin/profiler",
                                 {"sample": "stop"}, b"")
        rep = json.loads(body)
        assert code == 200 and not rep["running"] and rep["samples"] >= 3
        assert json.loads(s.handle("GET", "/admin/profiler",
                                   {"sample": "reset"}, b"")[1]) == \
            {"reset": True}
        assert g_profiler.samples == 0
        code, html, ctype = s.handle("GET", "/admin/profiler", {}, b"")
        assert code == 200 and "stage timings" in html
    finally:
        g_profiler.stop()
        s.stop()

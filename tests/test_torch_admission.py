"""The port's admission plane (``serve/admission.py``, the tier
vocabulary of ``utils/priority.py`` and the QueryBatcher's queue cap)
against the JAX package's (CPU).

Each scenario of ``tests/test_admission.py`` and of the weighted-fair
quota cases of ``tests/test_tenancy.py`` drives both packages' gates
through the same sequence and must see the same decisions: admit or
shed with the same reason, the same wake order, the same counters."""

import threading

import pytest

from open_source_search_engine_tpu.serve import admission as jadmission
from open_source_search_engine_tpu.serve.server import \
    QueryBatcher as JQueryBatcher
from open_source_search_engine_tpu.serve.tenancy import \
    g_residency as jresidency
from open_source_search_engine_tpu.utils import deadline as jdeadline
from open_source_search_engine_tpu.utils import priority as jpriority
from open_source_search_engine_tpu.utils.stats import g_stats as jstats
from open_source_search_engine_tpu_torch.serve import admission
from open_source_search_engine_tpu_torch.serve.server import QueryBatcher
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils import deadline, priority
from open_source_search_engine_tpu_torch.utils.stats import g_stats
from tests import jax_gc
from tests.polling import wait_until

IMPLS = {
    "jax": (jadmission, jdeadline, jpriority, jstats, JQueryBatcher),
    "torch": (admission, deadline, priority, g_stats, QueryBatcher),
}


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection inside the JAX package's locked membudget
    sections, which its QueryBatcher enters (``tests/jax_gc.py``); both
    tenant planes are left empty."""
    with jax_gc.quiet():
        yield
        # inside the quiet block: what parking frees is collected with
        # no lock held
        jresidency.reset()
        g_residency.reset()


@pytest.fixture(autouse=True)
def _stats_reset():
    jstats.reset()
    g_stats.reset()
    yield


def _counters(stats, prefix="admission."):
    return {k: v for k, v in stats.snapshot()["counters"].items()
            if k.startswith(prefix)}


def _shed_reason(gate, *a, **k):
    try:
        gate.admit(*a, **k).__exit__(None, None, None)
        return "admitted"
    except Exception as e:  # the package's own Shed
        return getattr(e, "reason", repr(e))


def _worker(gate, dl_mod, results, tier, tenant=None):
    try:
        with gate.admit(tier, deadline=dl_mod.Deadline.after(30.0),
                        tenant=tenant):
            results.append(("served", tier, tenant))
    except Exception as e:
        results.append((getattr(e, "reason", repr(e)), tier, tenant))


def _start(target, *args):
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# scenarios: (adm, dl, prio, stats, batcher) -> outcomes
# ---------------------------------------------------------------------------

def s_admit_release(adm, dl, prio, stats, _):
    g = adm.AdmissionGate(max_inflight=2)
    with g.admit("interactive"):
        inflight = g.snapshot()["inflight"]
    lat = stats.snapshot()["latencies"]["admission.queue_delay"]["count"]
    return [inflight, g.idle(), lat, _counters(stats)]


def s_signals(adm, dl, prio, stats, _):
    out = []
    g = adm.AdmissionGate(degraded_fn=lambda: True)
    out += [_shed_reason(g, t) for t in ("crawlbot", "suggest",
                                         "interactive")]
    g2 = adm.AdmissionGate(pressure_fn=lambda: True)
    out += [_shed_reason(g2, t) for t in ("crawlbot", "interactive")]
    return out + [g.shed_total, g2.shed_total, _counters(stats)]


def s_predicted_delay(adm, dl, prio, stats, _):
    g = adm.AdmissionGate(max_inflight=1)
    g._svc_s = 1.0   # a pessimistic service time: ~1 s a slot
    tok = g.admit("interactive")
    try:
        g.admit("interactive", deadline=dl.Deadline.after(0.05))
        out = ["admitted"]
    except Exception as e:
        out = [e.reason, e.retry_after_s >= 1.0]
    tok.__exit__(None, None, None)
    return out + [g.idle()]


def s_wait_timeout(adm, dl, prio, stats, _):
    g = adm.AdmissionGate(max_inflight=1, max_wait_s=0.05)
    tok = g.admit("interactive")
    out = [_shed_reason(g, "interactive"), g.snapshot()["queued_total"]]
    tok.__exit__(None, None, None)
    return out + [g.idle(), _counters(stats)]


def s_drain_resume(adm, dl, prio, stats, _):
    g = adm.AdmissionGate(max_inflight=2)
    tok = g.admit("interactive")
    g.drain()
    out = [g.draining, _shed_reason(g, "interactive")]
    tok.__exit__(None, None, None)
    out.append(g.quiesce(timeout_s=5.0))
    g.resume()
    return out + [_shed_reason(g, "interactive"), g.snapshot()["shed_total"]]


def s_priority_wake_order(adm, dl, prio, stats, _):
    g = adm.AdmissionGate(max_inflight=1, max_queue=8, max_wait_s=5.0)
    tok = g.admit("interactive")
    order = []

    def waiter(tier):
        with g.admit(tier):
            order.append(tier)
    tc = _start(waiter, "crawlbot")
    wait_until(lambda: g.snapshot()["queued"]["crawlbot"] == 1)
    ti = _start(waiter, "interactive")
    wait_until(lambda: g.snapshot()["queued"]["interactive"] == 1)
    tok.__exit__(None, None, None)
    ti.join(5.0)
    tc.join(5.0)
    return [order, g.idle(), _counters(stats)]


def s_queue_full(adm, dl, prio, stats, _):
    g = adm.AdmissionGate(max_inflight=1, max_queue=1, max_wait_s=5.0)
    tok = g.admit("interactive")
    t = _start(lambda: g.admit("interactive").__exit__(None, None, None))
    wait_until(lambda: g.snapshot()["queued_total"] == 1)
    out = [_shed_reason(g, "interactive")]
    tok.__exit__(None, None, None)
    t.join(5.0)
    return out + [g.idle(), _counters(stats)]


def s_quota(adm, dl, prio, stats, _):
    g = adm.AdmissionGate(max_inflight=1, max_queue=4)
    holder = g.admit("interactive", tenant="quiet")
    results = []
    ts = [_start(_worker, g, dl, results, "interactive", "greedy")
          for _ in range(2)]
    wait_until(lambda: g.snapshot()["tenants"].get(
        "greedy", {}).get("queued") == 2)
    third = _shed_reason(g, "interactive",
                         deadline=dl.Deadline.after(30.0), tenant="greedy")
    tq = _start(_worker, g, dl, results, "interactive", "quiet")
    wait_until(lambda: g.snapshot()["tenants"]["quiet"].get("queued") == 1)
    holder.__exit__(None, None, None)
    for t in ts + [tq]:
        t.join(timeout=30)
    snap = g.snapshot()["tenants"]
    return [third, sorted(results), snap, _counters(stats)]


def s_displacement(adm, dl, prio, stats, _):
    g = adm.AdmissionGate(max_inflight=1, max_queue=2)
    holder = g.admit("interactive")
    results = []
    ts = [_start(_worker, g, dl, results, "interactive", "greedy")
          for _ in range(2)]
    wait_until(lambda: g.snapshot()["tenants"].get(
        "greedy", {}).get("queued") == 2)
    tq = _start(_worker, g, dl, results, "interactive", "quiet")
    wait_until(lambda: ("quota", "interactive", "greedy") in results)
    holder.__exit__(None, None, None)
    for t in ts + [tq]:
        t.join(timeout=30)
    return [sorted(results), g.snapshot()["tenants"]]


def s_weights(adm, dl, prio, stats, _):
    g = adm.AdmissionGate(max_inflight=1, max_queue=8)
    g.set_tenant_weight("gold", 3.0)
    holder = g.admit("interactive", tenant="gold")
    results = []
    tb = _start(_worker, g, dl, results, "interactive", "bronze")
    wait_until(lambda: g.snapshot()["tenants"].get(
        "bronze", {}).get("queued") == 1)
    tg = _start(_worker, g, dl, results, "interactive", "gold")
    wait_until(lambda: g.snapshot()["tenants"].get(
        "gold", {}).get("queued") == 1)
    holder.__exit__(None, None, None)
    tb.join(timeout=30)
    tg.join(timeout=30)
    return [results, g.snapshot()["tenants"]]


def s_classify(adm, dl, prio, stats, _):
    cases = [({"tier": "crawlbot"}, 0, None), ({}, 0, "suggest"),
             ({"tier": "suggest"}, 0, "crawlbot"), ({}, 1, None),
             ({}, 0, None), ({"tier": "root"}, 0, None),
             ({}, 0, "bogus")]
    return ([prio.classify(q, niceness=n, header_tier=h)
             for q, n, h in cases]
            + [prio.tier_from_header(v) for v in ("ADMIN", " Crawlbot ",
                                                  None, "suggest")]
            + [prio.tenant_from_header(v) for v in ("", " acme ", "x" * 99)])


def s_batcher_caps(adm, dl, prio, stats, QB):
    b = QB(lambda key, qs: ["r"] * len(qs))
    try:
        first = b.search(("main", 10, 0), "words")
        b.MAX_QUEUE = 0   # every enqueue refused
        try:
            b.search(("main", 10, 0), "words")
            refused = False
        except prio.QueueFull:
            refused = True
    finally:
        b.stop()
    c = _counters(stats)
    return [first, refused, c.get("admission.queue_full"),
            c.get("admission.wave.idle_flush", 0) >= 1]


def s_batcher_error_reaches_waiters(adm, dl, prio, stats, QB):
    def fail(key, qs):
        raise RuntimeError("device batch failed")
    b = QB(fail)
    try:
        b.search(("main", 10, 0), "words")
        out = ["answered"]
    except RuntimeError as e:
        out = [str(e)]
    finally:
        b.stop()
    return out + [b.alive]


SCENARIOS = [s_admit_release, s_signals, s_predicted_delay, s_wait_timeout,
             s_drain_resume, s_priority_wake_order, s_queue_full, s_quota,
             s_displacement, s_weights, s_classify, s_batcher_caps,
             s_batcher_error_reaches_waiters]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_decisions_match_the_jax_package(scenario):
    want = scenario(*IMPLS["jax"])
    got = scenario(*IMPLS["torch"])
    assert got == want


def test_decisions():
    """What the shared scenarios must give (the reference's asserts)."""
    t = IMPLS["torch"]
    assert s_signals(*t)[:5] == ["signal", "signal", "admitted", "signal",
                                 "admitted"]
    assert s_predicted_delay(*t) == ["deadline", True, True]
    assert s_wait_timeout(*t)[:3] == ["timeout", 0, True]
    assert s_drain_resume(*t) == [True, "draining", True, "admitted", 1]
    assert s_priority_wake_order(*t)[0] == ["interactive", "crawlbot"]
    assert s_queue_full(*t)[0] == "queue_full"
    quota = s_quota(*t)
    assert quota[0] == "quota"
    assert quota[2]["greedy"]["shed"] == 1 and quota[2]["quiet"]["shed"] == 0
    disp = s_displacement(*t)[0]
    assert ("served", "interactive", "quiet") in disp
    assert ("quota", "interactive", "greedy") in disp
    assert s_weights(*t)[0][0][2] == "bronze"
    g_stats.reset()
    assert s_batcher_caps(*t) == ["r", True, 1, True]


def test_response_header_side_channel():
    for adm in (jadmission, admission):
        assert adm.pop_response_headers() == []
        adm.set_response_header("Retry-After", "2")
        assert adm.pop_response_headers() == [("Retry-After", "2")]
        assert adm.pop_response_headers() == []


def test_shed_floor_on_retry_after():
    for adm in (jadmission, admission):
        assert adm.Shed("x", retry_after_s=0.01).retry_after_s == 1.0
        assert adm.Shed("y", retry_after_s=3.5).reason == "y"

"""Admission plane — bounded, tiered, shed-before-refuse overload gate.

A copy of ``open_source_search_engine_tpu/serve/admission.py``; the port imports
nothing of that package.

Reference: the engine survived open-internet traffic because Msg40 /
HttpServer degraded instead of collapsing — AutoBan rejected abusive
sources at the door, queries queued into Msg39 waves instead of
spawning unbounded work, cached answers went out when fresh ones were
over budget (``maxQueryTime``), and spider traffic yielded the niceness
bit. This module is that discipline for the device-serving planes: a
bounded gate in front of ``QueryBatcher``/``ResidentLoop`` that admits
by priority tier and sheds *cheaply* — a same-generation SWR-stale
answer marked degraded, else 503 + Retry-After — long before the
membudget has to refuse real work.

Shed triggers, in the order they are consulted:

1. the bounded queue is full (``admission.queue_full``) — an overload
   burst must never grow host memory without bound;
2. the SLO tracker reports a burning error budget (``slo.degraded``)
   or the membudget is out of headroom — background tiers shed at the
   door while the signal stands;
3. the *predicted* queue delay (waiters ahead x EWMA service time)
   would eat the request's deadline — shedding now is strictly cheaper
   than timing out later (the metastable-collapse preventer: work that
   cannot finish in time never enters the queue);
4. the tenant is over its weighted-fair queue share while other
   tenants are active (``quota``) — the crawlbot-API story: one
   aggressive customer must not starve the others. Shares borrow when
   idle (a lone tenant may use the whole gate), and a full queue owes
   an under-share tenant room: the arrival displaces the newest waiter
   of an over-share tenant instead of shedding.

A gate can also be **drained** (``drain()``): every new arrival sheds
with reason ``draining`` while admitted work runs to completion —
the rolling-restart sequence the fleet plane uses (stop admitting,
``quiesce()`` until in-flight waves collect, checkpoint, then kill the
process; its twin absorbs the shed traffic via transport hedging).

The tier vocabulary (names, header, contextvar) lives in
``utils/priority.py`` so ``parallel/`` can stamp scatter legs without
importing the serve layer.
"""

from __future__ import annotations

import contextvars
import time
from collections import deque

from ..utils import deadline as deadline_mod
from ..utils import trace as trace_mod
from ..utils.lockcheck import make_condition
from ..utils.membudget import g_membudget
from ..utils.priority import TIERS
from ..utils.slo import g_slo
from ..utils.stats import g_stats


class Shed(RuntimeError):
    """The gate refused this request. ``reason`` names the trigger
    (``queue_full``/``signal``/``deadline``/``timeout``/``quota``);
    ``retry_after_s`` is the Retry-After hint for the 503 path."""

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(f"admission shed: {reason}")
        self.reason = reason
        self.retry_after_s = max(float(retry_after_s), 1.0)


class _Admitted:
    """The held slot; a context manager so the release (and the
    service-time EWMA feeding the delay predictor) can't be skipped."""

    __slots__ = ("_gate", "_t0", "tenant")

    def __init__(self, gate: "AdmissionGate", tenant: str | None = None):
        self._gate = gate
        self.tenant = tenant
        self._t0 = time.monotonic()

    def __enter__(self) -> "_Admitted":
        return self

    def __exit__(self, *exc) -> None:
        # monotonic delta = budget arithmetic for the predictor, not a
        # reported latency (those ride trace.record below)
        self._gate._release(time.monotonic() - self._t0,
                            tenant=self.tenant)


class AdmissionGate:
    """Bounded admission in front of the device dispatch planes.

    ``max_inflight`` bounds concurrently *running* requests (past the
    gate, the QueryBatcher/ResidentLoop coalesce them into waves);
    ``max_queue`` bounds waiters across all tiers. Waiters wake in
    strict tier order — interactive first, FIFO within a tier — so a
    crawlbot burst can delay at most the wave in flight, never the
    queue ahead of a human."""

    def __init__(self, max_inflight: int = 32, max_queue: int = 256,
                 max_wait_s: float = 2.0,
                 degraded_fn=None, pressure_fn=None):
        self.max_inflight = int(max_inflight)
        self.max_queue = int(max_queue)
        self.max_wait_s = float(max_wait_s)
        #: overridable overload signals (tests aim them; defaults are
        #: the live SLO burn-rate and membudget headroom planes)
        self._degraded_fn = degraded_fn or (lambda: g_slo.degraded())
        self._pressure_fn = pressure_fn or self._mem_pressure
        self._cv = make_condition("admission.cv")
        self._inflight = 0
        self._draining = False
        self._waiting: dict[str, deque] = {t: deque() for t in TIERS}
        #: EWMA of admitted service time (s) — the queue-delay
        #: predictor's clock; seeded pessimistically so a cold gate
        #: sheds late rather than early
        self._svc_s = 0.020
        self.admitted_total = 0
        self.shed_total = 0
        #: the tier × tenant weighted-fair ledger; callers passing
        #: ``tenant=None`` bypass it entirely (legacy behavior)
        self._t_weight: dict[str, float] = {}
        self._t_inflight: dict[str, int] = {}
        self._t_queued: dict[str, int] = {}
        self._t_served: dict[str, int] = {}
        self._t_shed: dict[str, int] = {}

    @staticmethod
    def _mem_pressure() -> bool:
        # under ~6% headroom the next reserve is likely to refuse real
        # work — shed background traffic first (the OOM-merge-defer
        # ancestor: degrade cheap things before expensive things fail)
        return g_membudget.free() < (g_membudget.limit >> 4)

    # --- admission --------------------------------------------------------

    def admit(self, tier: str, deadline=None,
              tenant: str | None = None) -> _Admitted:
        """Admit or raise :class:`Shed`. Blocks (bounded by the
        request deadline and ``max_wait_s``) while the gate is full.
        ``tenant`` opts the request into the weighted-fair ledger: a
        tenant over its queue share sheds with reason ``quota`` while
        other tenants contend (shares borrow when idle, so a lone
        tenant may use the whole gate)."""
        if tier not in TIERS:
            tier = "interactive"
        t_enq = time.perf_counter()
        with self._cv:
            if self._draining:
                # draining gates shed unconditionally — cheaper for the
                # caller to hedge to the twin than to queue behind a
                # node that is about to checkpoint and exit
                raise self._shed_locked(tier, "draining", tenant)
            if tenant is not None:
                self._t_weight.setdefault(tenant, 1.0)
            n_wait = sum(len(q) for q in self._waiting.values())
            if n_wait >= self.max_queue:
                # a full queue still owes an under-share tenant room:
                # displace an over-share tenant's newest waiter rather
                # than shed the quiet arrival (the fairness half of
                # queue_full)
                if tenant is None or not self._displace_locked(tenant):
                    g_stats.count("admission.queue_full")
                    raise self._shed_locked(tier, "queue_full", tenant)
            if tier != "interactive" and \
                    (self._degraded_fn() or self._pressure_fn()):
                # the cheap early shed: while the error budget burns or
                # memory headroom is gone, background tiers never enter
                raise self._shed_locked(tier, "signal", tenant)
            est = self._est_wait_locked(tier)
            if deadline is not None and (
                    deadline.expired() or est > deadline.remaining()):
                raise self._shed_locked(tier, "deadline", tenant)
            if self._inflight < self.max_inflight and \
                    not self._ahead_locked(tier):
                self._inflight += 1
                self.admitted_total += 1
                if tenant is not None:
                    self._t_inflight[tenant] = \
                        self._t_inflight.get(tenant, 0) + 1
            else:
                # the queue path is where shares bind: an over-share
                # tenant sheds at the door instead of eating a slot a
                # quieter tenant is owed
                if tenant is not None and \
                        self._t_queued.get(tenant, 0) + 1 > \
                        self._share_locked(tenant):
                    raise self._shed_locked(tier, "quota", tenant)
                self._wait_locked(tier, deadline, tenant)
            if tenant is not None:
                self._t_served[tenant] = \
                    self._t_served.get(tenant, 0) + 1
        g_stats.count("admission.admitted")
        if tenant is not None:
            g_stats.count(f"admission.tenant.{tenant}.served")
        trace_mod.record("admission.queue_delay", t_enq)
        return _Admitted(self, tenant)

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Relative fair-share weight (default 1.0; <= 0 resets)."""
        with self._cv:
            self._t_weight[tenant] = \
                float(weight) if weight > 0 else 1.0

    def _share_locked(self, tenant: str,
                      extra: str | None = None) -> float:
        """The tenant's fair queue share: ``max_queue`` split by
        weight across *active* tenants (inflight or queued, plus the
        arrival). Idle tenants donate their share — a lone tenant gets
        the whole queue; everyone is owed at least one slot. ``extra``
        counts a not-yet-queued arrival as active (displacement asks
        for the VICTIM's share as it will be once the arrival joins)."""
        active = {t for t, n in self._t_inflight.items() if n > 0}
        active.update(t for t, n in self._t_queued.items() if n > 0)
        active.add(tenant)
        if extra is not None:
            active.add(extra)
        if len(active) <= 1:
            return float("inf")
        total_w = sum(self._t_weight.get(t, 1.0) for t in active)
        return max(self.max_queue
                   * self._t_weight.get(tenant, 1.0)
                   / max(total_w, 1e-9), 1.0)

    def _displace_locked(self, tenant: str) -> bool:
        """queue_full fairness: when the arriving tenant is under its
        share, evict an over-share tenant's newest waiter (lowest tier
        first) with reason ``quota`` to make room. False leaves the
        arrival to shed ``queue_full`` itself."""
        if self._t_queued.get(tenant, 0) + 1 > \
                self._share_locked(tenant):
            return False
        for t in reversed(TIERS):
            q = self._waiting[t]
            for i in range(len(q) - 1, -1, -1):
                victim = q[i]
                vt = victim.get("tenant")
                if vt is None or vt == tenant:
                    continue
                if self._t_queued.get(vt, 0) > \
                        self._share_locked(vt, extra=tenant):
                    del q[i]
                    self._t_queued[vt] = self._t_queued.get(vt, 1) - 1
                    victim["shed"] = "quota"
                    self._cv.notify_all()  # its thread raises on wake
                    return True
        return False

    def _ahead_locked(self, tier: str) -> bool:
        """Any waiter at the same or higher priority? (FIFO within a
        tier; a new arrival never jumps its own class.)"""
        for t in TIERS:
            if self._waiting[t]:
                return True
            if t == tier:
                return False
        return False

    def _est_wait_locked(self, tier: str) -> float:
        """Predicted queue delay: slots drain at ``max_inflight`` per
        EWMA service time; this tier waits behind every same-or-higher
        waiter plus the waves in flight."""
        ahead = 0
        for t in TIERS:
            ahead += len(self._waiting[t])
            if t == tier:
                break
        backlog = ahead + self._inflight
        if backlog < self.max_inflight:
            return 0.0
        return (backlog / max(self.max_inflight, 1)) * self._svc_s

    def _wait_locked(self, tier: str, deadline,
                     tenant: str | None = None) -> None:
        w = {"go": False, "tenant": tenant, "shed": None}
        self._waiting[tier].append(w)
        if tenant is not None:
            self._t_queued[tenant] = self._t_queued.get(tenant, 0) + 1
        g_stats.count("admission.queued")
        budget = deadline_mod.Deadline.after(self.max_wait_s)
        if deadline is not None and deadline.at < budget.at:
            budget = deadline
        while not w["go"] and w["shed"] is None and not self._draining:
            left = budget.remaining()
            if left <= 0:
                break
            self._cv.wait(left)
        if w["shed"] is not None:
            # displaced by an under-share arrival; the displacer
            # already removed us from the queue and the ledger
            raise self._shed_locked(tier, w["shed"], tenant)
        if not w["go"]:
            # grant pops under this lock, so un-granted => still queued
            self._waiting[tier].remove(w)
            if tenant is not None:
                self._t_queued[tenant] = \
                    self._t_queued.get(tenant, 1) - 1
            if self._draining:
                raise self._shed_locked(tier, "draining", tenant)
            raise self._shed_locked(
                tier, "deadline" if deadline is not None
                and deadline.expired() else "timeout", tenant)
        self.admitted_total += 1  # _grant_locked took the slot for us

    def _shed_locked(self, tier: str, reason: str,
                     tenant: str | None = None) -> Shed:
        self.shed_total += 1
        g_stats.count(f"admission.shed.reason.{reason}")
        if tenant is not None:
            self._t_shed[tenant] = self._t_shed.get(tenant, 0) + 1
            g_stats.count(f"admission.tenant.{tenant}.shed")
        retry = max(self._est_wait_locked(tier), self._svc_s)
        return Shed(reason, retry_after_s=retry)

    def _release(self, service_s: float,
                 tenant: str | None = None) -> None:
        with self._cv:
            self._svc_s += 0.2 * (max(service_s, 0.0) - self._svc_s)
            self._inflight -= 1
            if tenant is not None:
                n = self._t_inflight.get(tenant, 1) - 1
                if n <= 0:
                    self._t_inflight.pop(tenant, None)
                else:
                    self._t_inflight[tenant] = n
            self._grant_locked()
            self._cv.notify_all()

    def _grant_locked(self) -> None:
        while self._inflight < self.max_inflight:
            w = None
            for t in TIERS:
                q = self._waiting[t]
                if not q:
                    continue
                # weighted-fair within the tier: wake the waiter whose
                # tenant holds the least inflight per unit weight
                # (strict < keeps FIFO on ties, and all-legacy queues
                # — tenant None, load 0 — degenerate to pure FIFO)
                best_i, best = 0, None
                for i, cand in enumerate(q):
                    ct = cand.get("tenant")
                    load = 0.0 if ct is None else (
                        self._t_inflight.get(ct, 0)
                        / self._t_weight.get(ct, 1.0))
                    if best is None or load < best:
                        best, best_i = load, i
                w = q[best_i]
                del q[best_i]
                break
            if w is None:
                return
            w["go"] = True
            self._inflight += 1
            wt = w.get("tenant")
            if wt is not None:
                self._t_queued[wt] = self._t_queued.get(wt, 1) - 1
                self._t_inflight[wt] = self._t_inflight.get(wt, 0) + 1

    # --- drain (rolling-restart sequencing) -------------------------------

    def drain(self) -> None:
        """Stop admitting: new arrivals (and queued waiters) shed with
        reason ``draining``; work already admitted runs to completion.
        Idempotent."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        g_stats.count("admission.drain")

    def resume(self) -> None:
        """Reopen a drained gate (operator aborted the restart)."""
        with self._cv:
            self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def quiesce(self, timeout_s: float = 10.0) -> bool:
        """Block until nothing is admitted and nothing waits — the
        let-in-flight-waves-collect step between ``drain()`` and the
        checkpoint. False if the gate did not empty in time."""
        dl = deadline_mod.Deadline.after(float(timeout_s))
        with self._cv:
            while self._inflight > 0 or any(
                    self._waiting[t] for t in TIERS):
                if dl.expired():
                    return False
                self._cv.wait(dl.clamp(0.05))
            return True

    # --- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "inflight": self._inflight,
                "draining": self._draining,
                "max_inflight": self.max_inflight,
                "max_queue": self.max_queue,
                "queued": {t: len(self._waiting[t]) for t in TIERS},
                "queued_total": sum(len(q)
                                    for q in self._waiting.values()),
                "svc_ewma_ms": round(self._svc_s * 1000.0, 3),
                "admitted_total": self.admitted_total,
                "shed_total": self.shed_total,
                "tenants": {
                    t: {
                        "weight": self._t_weight.get(t, 1.0),
                        "inflight": self._t_inflight.get(t, 0),
                        "queued": self._t_queued.get(t, 0),
                        "served": self._t_served.get(t, 0),
                        "shed": self._t_shed.get(t, 0),
                    }
                    for t in sorted(set(self._t_weight)
                                    | set(self._t_served)
                                    | set(self._t_shed))
                },
            }

    def idle(self) -> bool:
        """Nothing admitted and nothing waiting — the post-burst
        drained state the load harness polls for."""
        with self._cv:
            return self._inflight == 0 and not any(
                self._waiting[t] for t in TIERS)


# --- response-header side channel -----------------------------------------
# handle() returns (status, payload, ctype); the shed path needs to add
# Retry-After without widening that contract for every route. The gate
# stashes extra headers in a contextvar the HTTP handler drains on the
# same thread (direct handle() callers also get the value in the JSON
# body, so tests and bench never need the header channel).

_resp_headers: contextvars.ContextVar = contextvars.ContextVar(
    "osse-admission-resp-headers", default=None)


def set_response_header(name: str, value: str) -> None:
    cur = _resp_headers.get()
    if cur is None:
        cur = []
        _resp_headers.set(cur)
    cur.append((name, value))


def pop_response_headers() -> list:
    cur = _resp_headers.get()
    if cur:
        _resp_headers.set(None)
        return list(cur)
    return []

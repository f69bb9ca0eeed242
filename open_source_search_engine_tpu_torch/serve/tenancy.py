"""Tenant plane — device residency for many collections.

Port of ``open_source_search_engine_tpu/serve/tenancy.py:100-380``. A hot
collection owns a device-resident :class:`~..query.devindex.DeviceIndex`
and an always-running :class:`~..query.resident.ResidentLoop`;
:class:`ResidencyManager` owns that lifecycle:

* **LRU-with-pinning hot set.** Every resident tenant carries a recency
  sequence; the set is bounded by count (``max_resident``) and by the
  membudget "device" label's soft cap, which sums each tenant's
  ``resident_bytes()``. ``pin()`` exempts a tenant from eviction.
* **Parked state.** Eviction stops the loop and drops the DeviceIndex,
  so its tensors go back to the caching allocator, and zeroes the gauge.
  A cold start rebuilds the index: on CUDA through the device build; on
  the CPU, or with the device build off, from the run set's disk base
  cache (``posdb/devcache``) when one exists (read first, as in the
  reference).
* **Single-flight cold start.** Concurrent queries to a cold tenant
  trigger one build; riders wait on the leader's flight under their own
  deadline and shed (``DeadlineExceeded``) if the budget burns first.
* **Pressure eviction.** The manager registers as a low-priority
  membudget pressure handler scoped to the "device" label, so device
  pressure parks cold tenants before anything else is shed, and host
  pressure never parks one (the device bytes are not host bytes).

With devwatch on, a tenant's device bytes come from the HBM ledger (the
columns every refresh registered), ``resident_bytes()`` being the
always-on fallback; a park drops the collection's ledger slice.
"""

from __future__ import annotations

import time
from collections import deque

from ..utils import deadline as deadline_mod
from ..utils import devwatch
from ..utils import trace as trace_mod
from ..utils.lockcheck import make_event, make_rlock
from ..utils.log import get_logger
from ..utils.membudget import g_membudget
from ..utils.stats import g_stats

log = get_logger("tenancy")

#: riders without a deadline bound their flight wait here (Ticket.wait's
#: default: a wedged build must not hang callers forever)
COLD_WAIT_S = 120.0

#: pressure-handler priority, below the cache plane's default (100), so
#: cold tenants shed first
PRESSURE_PRIORITY = 10


class _Tenant:
    """One collection's residency record."""

    __slots__ = ("name", "coll", "loop", "pinned", "parked", "seq",
                 "nbytes", "hits", "cold_starts")

    def __init__(self, name: str, coll):
        self.name = name
        self.coll = coll
        self.loop = None
        self.pinned = False
        self.parked = False
        self.seq = 0
        self.nbytes = 0
        self.hits = 0
        self.cold_starts = 0


class _Flight:
    """A single-flight cold start: the leader builds, riders wait."""

    __slots__ = ("ev", "loop", "err")

    def __init__(self):
        self.ev = make_event("tenancy.flight")
        self.loop = None
        self.err: BaseException | None = None


class ResidencyManager:
    """Owns the collection → (DeviceIndex, ResidentLoop) hot set."""

    def __init__(self, max_resident: int = 0):
        #: count bound on the resident set; 0 = unbounded (the byte bound
        #: is the membudget "device" label cap, set separately)
        self.max_resident = int(max_resident)
        self._lock = make_rlock("tenancy.manager")
        self._tenants: dict[str, _Tenant] = {}
        self._flights: dict[str, _Flight] = {}
        self._seq = 0
        #: recent cold-start walls (ms), bounded
        self.coldstart_ms: deque[float] = deque(maxlen=4096)

    # --- wiring -----------------------------------------------------------

    def configure(self, max_resident: int | None = None) -> None:
        """Live-update knobs (the tenant_hot parm hook)."""
        if max_resident is not None:
            with self._lock:
                self.max_resident = int(max_resident)

    def attach(self, budget=None) -> None:
        """(Re-)register the pressure handler (idempotent by key)."""
        (budget or g_membudget).add_pressure_handler(
            self._on_pressure, priority=PRESSURE_PRIORITY, key="tenancy",
            label="device")

    # --- the hot path -----------------------------------------------------

    def loop_for(self, coll, deadline=None):
        """The collection's ResidentLoop, promoting a cold tenant first
        (single-flight): ``engine.get_resident_loop``."""
        name = getattr(coll, "name", "coll")
        while True:
            stale = False
            with self._lock:
                t = self._tenants.get(name)
                if t is not None and t.coll is not None \
                        and t.coll is not coll:
                    # same name, another Collection object: the record
                    # and its loop belong to the old object
                    stale = True
                elif t is not None and not t.parked \
                        and t.loop is not None and t.loop.alive:
                    self._seq += 1
                    t.seq = self._seq
                    t.hits += 1
                    g_stats.count("tenancy.hit")
                    return t.loop
                else:
                    fl = self._flights.get(name)
                    leader = fl is None
                    if leader:
                        fl = self._flights[name] = _Flight()
            if stale:
                g_stats.count("tenancy.stale_record")
                self.release(name)  # outside the lock: park joins
                continue
            if leader:
                return self._promote(name, coll, fl)
            loop = self._ride(name, fl, deadline)
            if loop is not None:
                return loop
            # the leader failed without a result, or the loop died
            # between flights: retake the fast path or a fresh flight

    def _ride(self, name: str, fl: _Flight, deadline):
        """Wait out another thread's cold start under our deadline: an
        expired rider sheds instead of queueing blind."""
        g_stats.count("tenancy.singleflight_join")
        budget = deadline_mod.Deadline.after(COLD_WAIT_S)
        if deadline is not None and deadline.at < budget.at:
            budget = deadline
        while not fl.ev.is_set():
            left = budget.remaining()
            if left <= 0:
                if deadline is not None and deadline.expired():
                    g_stats.count("tenancy.rider_shed")
                    raise deadline_mod.DeadlineExceeded(
                        f"deadline exceeded waiting for cold start of "
                        f"{name!r}")
                raise TimeoutError(f"cold start of {name!r} timed out")
            fl.ev.wait(min(left, 0.5))
        if fl.err is not None:
            raise fl.err
        return fl.loop

    def _promote(self, name: str, coll, fl: _Flight):
        """The leader's cold start: build (or delta-refresh) the device
        index, spawn the loop, charge the bytes, evict LRU tenants past
        the bounds."""
        from ..query import engine
        t0 = time.perf_counter()
        try:
            di = engine.get_device_index(coll)
            loop = engine.spawn_resident_loop(
                lambda: engine.get_device_index(coll),
                gen_fn=lambda: coll.posdb.version, name=name)
            coll._resident_loop = loop
            # the HBM ledger (when on) saw every column the refresh
            # registered; resident_bytes() is the same sum from shapes
            nbytes = int(devwatch.collection_bytes(name)
                         or di.resident_bytes())
            with self._lock:
                t = self._tenants.get(name)
                if t is None:
                    t = self._tenants[name] = _Tenant(name, coll)
                self._seq += 1
                t.coll = coll
                t.loop = loop
                t.parked = False
                t.seq = self._seq
                t.nbytes = nbytes
                t.cold_starts += 1
            t1 = time.perf_counter()
            self.coldstart_ms.append((t1 - t0) * 1000.0)
            g_stats.count("tenancy.coldstart")
            trace_mod.record("tenancy.coldstart", t0, t1, tenant=name)
            fl.loop = loop
            fl.ev.set()
            # outside self._lock: the gauge can breach the device cap,
            # whose relief re-enters park() on this manager
            g_membudget.set_gauge("device", f"di:{name}", nbytes)
            self._evict_over_count(keep=name)
            return loop
        except BaseException as exc:
            fl.err = exc
            fl.ev.set()
            raise
        finally:
            with self._lock:
                self._flights.pop(name, None)

    # --- eviction / parking ----------------------------------------------

    def _evict_over_count(self, keep: str | None = None) -> None:
        """LRU-evict unpinned tenants past ``max_resident``."""
        while True:
            with self._lock:
                if self.max_resident <= 0:
                    return
                resident = [t for t in self._tenants.values()
                            if not t.parked]
                if len(resident) <= self.max_resident:
                    return
                victims = [t for t in resident
                           if not t.pinned and t.name != keep]
                if not victims:
                    return
                victim = min(victims, key=lambda t: t.seq).name
            g_stats.count("tenancy.evict")
            self.park(victim)

    def park(self, name: str) -> int:
        """Demote to the parked state: loop stopped, DeviceIndex dropped
        (its tensors go back to the caching allocator), gauge zeroed.
        Returns the freed device bytes."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None or t.parked:
                return 0
            loop, freed = t.loop, t.nbytes
            t.loop = None
            t.parked = True
            t.nbytes = 0
        if loop is not None:
            loop.stop()
        coll = t.coll
        if coll is not None:
            coll._resident_loop = None
            coll._device_index = None
        g_membudget.set_gauge("device", f"di:{name}", 0)
        devwatch.drop(name)  # every plane: the columns die with the index
        g_stats.count("tenancy.park")
        log.info("parked tenant %s (%d MB device)", name, freed >> 20)
        return freed

    def _on_pressure(self, need: int) -> int:
        """Membudget pressure: park cold (least recent, unpinned) tenants
        before anyone refuses work."""
        freed = 0
        while freed < int(need):
            with self._lock:
                victims = [t for t in self._tenants.values()
                           if not t.parked and not t.pinned
                           and t.loop is not None]
                if len(victims) > 1:
                    # spare the hottest tenant: parking the one most
                    # likely mid-request trades a shed for a failed query
                    victims.remove(max(victims, key=lambda t: t.seq))
                if not victims:
                    break
                victim = min(victims, key=lambda t: t.seq).name
            g_stats.count("tenancy.pressure_evict")
            got = self.park(victim)
            if got <= 0:
                break
            freed += got
        return freed

    def pin(self, name: str) -> None:
        """Exempt from eviction (never from release())."""
        with self._lock:
            t = self._tenants.get(name)
            if t is not None:
                t.pinned = True

    def unpin(self, name: str) -> None:
        with self._lock:
            t = self._tenants.get(name)
            if t is not None:
                t.pinned = False

    # --- teardown ---------------------------------------------------------

    def release(self, name: str) -> bool:
        """Full teardown for a deleted collection: stop the loop, drop
        the index and the gauge, forget the tenant (pinning does not
        protect)."""
        self.park(name)
        with self._lock:
            return self._tenants.pop(name, None) is not None

    def release_collection(self, coll) -> bool:
        """``release`` the tenant of ``coll``'s name only if ``coll`` owns
        its record (a same-named collection of another registry keeps
        its own)."""
        with self._lock:
            t = self._tenants.get(getattr(coll, "name", "coll"))
            if t is None or t.coll is not coll:
                return False
        return self.release(t.name)

    def stop_all(self) -> None:
        """Shutdown: park everything (records survive)."""
        with self._lock:
            names = list(self._tenants)
        for n in names:
            self.park(n)

    def reset(self) -> None:
        """Test isolation: stop loops, drop all records and knobs."""
        self.stop_all()
        with self._lock:
            self._tenants.clear()
            self._flights.clear()
            self.max_resident = 0
            self.coldstart_ms.clear()

    # --- observability ----------------------------------------------------

    def resident_names(self) -> list[str]:
        with self._lock:
            return sorted(t.name for t in self._tenants.values()
                          if not t.parked)

    def snapshot(self) -> dict:
        cs = sorted(self.coldstart_ms)

        def pct(p: float) -> float:
            return round(cs[min(int(p * len(cs)), len(cs) - 1)], 3) \
                if cs else 0.0

        with self._lock:
            tenants = {
                t.name: {"resident": not t.parked, "pinned": t.pinned,
                         "device_bytes": t.nbytes, "hits": t.hits,
                         "cold_starts": t.cold_starts, "lru_seq": t.seq}
                for t in self._tenants.values()}
            return {
                "max_resident": self.max_resident,
                "resident": sum(1 for t in self._tenants.values()
                                if not t.parked),
                "parked": sum(1 for t in self._tenants.values()
                              if t.parked),
                "device_cap": g_membudget.label_cap("device"),
                "device_bytes": g_membudget.used("device"),
                "coldstart_p50_ms": pct(0.50),
                "coldstart_p99_ms": pct(0.99),
                "coldstarts": len(cs),
                "tenants": tenants,
            }


#: process-wide singleton; engine.get_resident_loop routes through it
g_residency = ResidencyManager()

"""devwatch — the device telemetry plane: HBM ledger, wave flight
recorder, roofline attribution.

Port of ``open_source_search_engine_tpu/utils/devwatch.py`` (the port
imports nothing of that package). jitwatch watches what the runtime
*does* (kernel builds, host transfers); this module watches what the card
*holds* and what the waves *cost*:

* **HBM ledger** — every long-lived device buffer of the device layers
  (the DeviceIndex columns, the device build's staging, the mesh's wave
  staging) registers under a ``(collection, plane, column)`` label. The
  tenant plane reads its device bytes from it when it is on; it is
  reconciled against ``torch.cuda.memory_stats`` and
  ``torch.cuda.mem_get_info`` for each visible card (nulls on the CPU),
  and exports ``hbm.<plane>.bytes`` gauges for ``/metrics``.
* **Wave flight recorder** — a bounded ring of the resident loop's waves:
  the issue → wait → collect split, each collect round's device wait,
  fetched bytes, modelled F1 wave bytes and escalations, and a
  ``devwatch.wave`` span into the trace plane.
* **Roofline attribution** — at the first dispatch of each (kernel, shape
  bucket) the caller's thunk counts the work (``{"flops": ...,
  "bytes accessed": ...}``); the entry keeps the arithmetic intensity and
  a bandwidth- or compute-bound verdict against the card's published
  peaks (:data:`GPU_PEAKS`). Later dispatches of the bucket only count.

Departure: the reference reads its counts from XLA's cost model
(``lower().compile().cost_analysis()``). Eager torch has no compiled
program to ask, so the port counts the work from the tensors the kernel
is given (``min_scores_kernel.work``, ``fd_scores_kernel.work``), what
the card must do for this data, not what the code around it does.

``OSSE_DEVWATCH=1`` turns the plane on through :func:`maybe_enable` (at
the device layer's import and at server start); off, every hook is a
guarded early return.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager

from . import trace
from .stats import g_stats

#: flight-recorder ring bound — old waves fall off, the plane never
#: grows with uptime
RING = int(os.environ.get("OSSE_DEVWATCH_RING", "256"))

#: published peaks (FP32 FLOP/s outside the tensor cores, HBM bytes/s)
#: per card, matched by substring against the lower-cased
#: ``torch.cuda.get_device_name()``: the NVIDIA H100 data sheet's SXM
#: (HBM3) and PCIe figures. The roofline ridge (flops / bw) splits
#: bandwidth-bound from compute-bound.
GPU_PEAKS = (
    ("h100 pcie", 51e12, 2.0e12, "h100-pcie"),
    ("hbm3", 67e12, 3.35e12, "h100-sxm"),
)

#: order-of-magnitude host numbers for the CPU fallback — labeled
#: assumed so nobody reads a CPU verdict as a card verdict
_CPU_PEAKS = (2e11, 4e10, "cpu (assumed)")


def peaks_for(kind: str) -> dict:
    """The peak row for a device name: ``flops``, ``bw``, ``label``,
    ``assumed`` (True when the name matched no card of the table) and
    ``ridge``."""
    flops, bw, label = _CPU_PEAKS
    assumed = True
    low = kind.lower()
    for sub, f, b, lab in GPU_PEAKS:
        if sub in low:
            flops, bw, label, assumed = f, b, lab, False
            break
    return {"flops": flops, "bw": bw, "label": label,
            "assumed": assumed, "ridge": flops / bw}


def _nbytes(a) -> int:
    """Bytes of one registered buffer — a tensor, a numpy array or a
    plain int."""
    if isinstance(a, int):
        return a
    try:
        return int(a.numel()) * int(a.element_size())
    except Exception:
        try:
            return int(a.nbytes)
        except Exception:
            g_stats.count("devwatch.nbytes_errors")
            return 0


class _Once:
    """A work thunk evaluated at most once (a wave's roofline and the
    kernel launch inside it share one count)."""

    __slots__ = ("fn", "val")

    def __init__(self, fn):
        self.fn, self.val = fn, None

    def __call__(self):
        if self.val is None:
            self.val = self.fn()
        return self.val


def _cost_of(ca) -> tuple[float, float]:
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return (float(ca.get("flops", 0.0) or 0.0),
            float(ca.get("bytes accessed", 0.0) or 0.0))


def sum_work(thunks) -> dict:
    """One cost dict over several launches' work thunks."""
    flops = nbytes = 0.0
    for th in thunks:
        f, b = _cost_of(th())
        flops += f
        nbytes += b
    return {"flops": flops, "bytes accessed": nbytes}


class DevWatch:
    """Singleton telemetry plane; enable()/disable() are idempotent flag
    flips — every capture point is an explicit hook in the device
    layers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.enabled = False
        #: (collection, plane) -> {column: bytes}
        self.ledger: dict[tuple[str, str], dict[str, int]] = {}
        self._planes: set[str] = set()
        #: bounded flight-recorder ring
        self.waves: deque = deque(maxlen=RING)
        #: (kernel, bucket-tuple) -> roofline entry
        self.costs: dict[tuple[str, tuple], dict] = {}
        self.totals = {"waves": 0, "wave_errors": 0, "rounds": 0}
        self.wave_seq = 0
        self._peaks: dict | None = None
        self._tl = threading.local()

    # -- lifecycle ----------------------------------------------------

    def enable(self) -> None:
        with self._lock:
            if self.enabled:
                return
            self.enabled = True
        g_stats.gauge("devwatch.enabled", 1)

    def disable(self) -> None:
        with self._lock:
            if not self.enabled:
                return
            self.enabled = False
        g_stats.gauge("devwatch.enabled", 0)

    def reset(self) -> None:
        """Drop ledger, ring and cost table (g_stats counters persist —
        benches snapshot deltas instead)."""
        with self._lock:
            self.ledger.clear()
            self.waves.clear()
            self.costs.clear()
            for k in self.totals:
                self.totals[k] = 0
            self.wave_seq = 0
        self._export_gauges()

    # -- HBM ledger ---------------------------------------------------

    def note_columns(self, coll: str, plane: str, columns: dict) -> None:
        """Register (replace) the whole (collection, plane) slice — one
        call after every rebuild covers base, delta and regrow alike."""
        if not self.enabled:
            return
        sizes = {str(k): _nbytes(v) for k, v in columns.items()}
        with self._lock:
            self.ledger[(coll, plane)] = sizes
            self._planes.add(plane)
        self._export_gauges()

    def note_buffer(self, coll: str, plane: str, column: str,
                    nbytes) -> None:
        """Register (replace) ONE buffer — transient staging (mesh wave
        operands) that comes and goes per wave."""
        if not self.enabled:
            return
        with self._lock:
            self.ledger.setdefault((coll, plane), {})[column] = \
                _nbytes(nbytes)
            self._planes.add(plane)
        self._export_gauges()

    def drop_buffer(self, coll: str, plane: str, column: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            cols = self.ledger.get((coll, plane))
            if cols is not None:
                cols.pop(column, None)
        self._export_gauges()

    def drop(self, coll: str, plane: str | None = None) -> None:
        """Release a collection's entries (one plane, or all on park)."""
        if not self.enabled:
            return
        with self._lock:
            for key in [k for k in self.ledger
                        if k[0] == coll
                        and (plane is None or k[1] == plane)]:
                del self.ledger[key]
        self._export_gauges()

    def collection_bytes(self, coll: str) -> int:
        with self._lock:
            return sum(sum(cols.values())
                       for (c, _p), cols in self.ledger.items()
                       if c == coll)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(sum(cols.values())
                       for cols in self.ledger.values())

    def _export_gauges(self) -> None:
        with self._lock:
            per_plane = {p: 0 for p in self._planes}
            for (_c, p), cols in self.ledger.items():
                per_plane[p] = per_plane.get(p, 0) + sum(cols.values())
        for p, n in per_plane.items():
            g_stats.gauge(f"hbm.{p}.bytes", n)
        g_stats.gauge("hbm.total.bytes", sum(per_plane.values()))

    def reconcile(self) -> dict:
        """Ledger vs what the card says it holds, for each visible CUDA
        device: the caching allocator's ``allocated_bytes.all.current``
        and ``.peak`` (this process only) and ``mem_get_info``'s free and
        total bytes (the whole card, every process on it; total is
        ``bytes_limit``). Headroom is the free bytes: several
        processes on one card (the cluster's nodes) each see only their
        own allocator, so limit − in_use would count the others' bytes as
        free. Fragmentation is the share of this process's live bytes the
        ledger cannot name (allocator slack, wave temporaries). Without
        CUDA the one entry is the CPU's, every figure null; nothing here
        raises."""
        ledger_total = self.total_bytes()
        devices = []
        try:
            import torch
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if n == 0:
                devices.append({"device": "cpu", "kind": "cpu",
                                **_NULL_DEVICE})
            for i in range(n):
                ent = {"device": f"cuda:{i}",
                       "kind": torch.cuda.get_device_name(i)}
                try:
                    ms = torch.cuda.memory_stats(i)
                    free, total = torch.cuda.mem_get_info(i)
                    in_use = int(ms.get("allocated_bytes.all.current", 0))
                    peak = int(ms.get("allocated_bytes.all.peak", 0))
                    ent.update({
                        "bytes_in_use": in_use,
                        "peak_bytes_in_use": peak,
                        "bytes_limit": int(total),
                        "headroom": int(free),
                        "ledger_delta": in_use - ledger_total,
                        "fragmentation": (
                            max(0.0, (in_use - ledger_total) / in_use)
                            if in_use else 0.0)})
                except Exception:
                    g_stats.count("devwatch.reconcile_errors")
                    ent.update(_NULL_DEVICE)
                devices.append(ent)
        except Exception:
            g_stats.count("devwatch.reconcile_errors")
        return {"ledger_bytes": ledger_total, "devices": devices}

    # -- wave flight recorder ----------------------------------------

    def wave_begin(self, source: str, **tags) -> dict | None:
        """Open a wave record on the loop thread, before issue. None
        when disabled — every later stage no-ops on None."""
        if not self.enabled:
            return None
        with self._lock:
            self.wave_seq += 1
            seq = self.wave_seq
        return {"seq": seq, "source": source, "tags": dict(tags),
                "t0": time.perf_counter(), "t_issue": None,
                "t_collect": None, "rounds": []}

    def wave_issued(self, obs: dict | None, **tags) -> None:
        if obs is None:
            return
        obs["t_issue"] = time.perf_counter()
        obs["tags"].update(tags)

    def wave_collect(self, obs: dict | None) -> None:
        """Collect starts: rounds noted by the index's collect_batch on
        this thread attach to this wave until :meth:`wave_end`."""
        if obs is None:
            return
        obs["t_collect"] = time.perf_counter()
        self._tl.active = obs

    def note_round(self, **detail) -> None:
        """One collect round (fetch + parse + escalation reissue) as seen
        from inside collect_batch. Attaches to the thread's active wave;
        a collect outside the loop is counted, not recorded."""
        if not self.enabled:
            return
        obs = getattr(self._tl, "active", None)
        if obs is None:
            g_stats.count("devwatch.rounds_unattached")
            return
        obs["rounds"].append(detail)
        with self._lock:
            self.totals["rounds"] += 1

    def wave_end(self, obs: dict | None, error: str | None = None,
                 **tags) -> None:
        if obs is None:
            return
        if getattr(self._tl, "active", None) is obs:
            self._tl.active = None
        t_end = time.perf_counter()
        obs["tags"].update(tags)
        t0 = obs["t0"]
        ti = obs["t_issue"] if obs["t_issue"] is not None else t0
        tc = obs["t_collect"] if obs["t_collect"] is not None else ti
        rec = {"seq": obs["seq"], "source": obs["source"],
               "issue_s": ti - t0, "wait_s": max(0.0, tc - ti),
               "collect_s": max(0.0, t_end - tc),
               "total_s": t_end - t0,
               "rounds": obs["rounds"], "error": error}
        rec.update(obs["tags"])
        with self._lock:
            self.waves.append(rec)
            self.totals["waves"] += 1
            if error:
                self.totals["wave_errors"] += 1
        g_stats.count("devwatch.waves")
        g_stats.record_ms("devwatch.wave_ms", 1000.0 * (t_end - t0))
        trace.record("devwatch.wave", t0, t_end, device=1,
                     source=obs["source"], seq=obs["seq"],
                     rounds=len(obs["rounds"]), error=error or "")

    # -- roofline attribution ----------------------------------------

    def _peaks_for(self) -> dict:
        if self._peaks is not None:
            return self._peaks
        kind = "cpu"
        try:
            import torch
            if torch.cuda.is_available():
                kind = torch.cuda.get_device_name(0)
        except Exception:
            g_stats.count("devwatch.peaks_errors")
        self._peaks = peaks_for(kind)
        return self._peaks

    @contextmanager
    def launches(self):
        """Collect the work thunks of the kernel launches made on this
        thread inside the block (a wave's roofline counts its kernels'
        work). Yields the list."""
        mine: list = []
        self._tl.launches = mine
        try:
            yield mine
        finally:
            self._tl.launches = None

    def note_cost(self, kernel: str, bucket, thunk,
                  modeled_bytes=None) -> None:
        """Roofline one (kernel, shape-bucket): the FIRST dispatch pays
        ``thunk()`` (a work count, ``{"flops": ..., "bytes accessed":
        ...}``); every later dispatch is a dict hit and a counter bump,
        which keeps the armed overhead small."""
        if not self.enabled:
            return
        th = _Once(thunk)
        col = getattr(self._tl, "launches", None)
        if col is not None:
            col.append(th)
        key = (kernel, tuple(int(x) for x in bucket))
        ent = self.costs.get(key)
        if ent is not None:
            with self._lock:
                ent["dispatches"] += 1
            return
        peaks = self._peaks_for()
        flops = nbytes = 0.0
        try:
            flops, nbytes = _cost_of(th())
        except Exception:
            g_stats.count("devwatch.cost_errors")
        intensity = (flops / nbytes) if nbytes else 0.0
        verdict = ("unknown" if not nbytes else
                   "bandwidth-bound" if intensity < peaks["ridge"]
                   else "compute-bound")
        entry = {"kernel": kernel, "bucket": list(key[1]),
                 "flops": flops, "bytes": nbytes,
                 "intensity": intensity, "ridge": peaks["ridge"],
                 "verdict": verdict,
                 "modeled_bytes": (int(modeled_bytes)
                                   if modeled_bytes else None),
                 "dispatches": 1, "peak": peaks["label"],
                 "assumed": peaks["assumed"]}
        with self._lock:
            cur = self.costs.setdefault(key, entry)
            if cur is not entry:  # another thread got there first
                cur["dispatches"] += 1
        g_stats.count("devwatch.cost_entries")

    def dispatches(self, kernel: str) -> int:
        """Dispatches recorded for ``kernel`` over all its buckets."""
        with self._lock:
            return sum(e["dispatches"] for (k, _b), e in self.costs.items()
                       if k == kernel)

    # -- reporting ----------------------------------------------------

    def ledger_snapshot(self) -> dict:
        """collection → plane → column → bytes."""
        out: dict = {}
        with self._lock:
            for (c, p), cols in self.ledger.items():
                out.setdefault(c, {})[p] = dict(cols)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            waves = list(self.waves)
            costs = sorted((dict(e) for e in self.costs.values()),
                           key=lambda e: (e["kernel"], e["bucket"]))
            totals = dict(self.totals)
            per_plane: dict[str, int] = {}
            per_coll: dict[str, int] = {}
            for (c, p), cols in self.ledger.items():
                n = sum(cols.values())
                per_plane[p] = per_plane.get(p, 0) + n
                per_coll[c] = per_coll.get(c, 0) + n
        return {"enabled": self.enabled,
                "totals": totals,
                "ledger": self.ledger_snapshot(),
                "planes": per_plane,
                "collections": per_coll,
                "total_bytes": sum(per_plane.values()),
                "reconcile": self.reconcile(),
                "waves": waves,
                "rooflines": costs,
                "peaks": self._peaks_for()}


_NULL_DEVICE = {"bytes_in_use": None, "peak_bytes_in_use": None,
                "bytes_limit": None, "headroom": None,
                "ledger_delta": None, "fragmentation": None}

g_devwatch = DevWatch()


def enable() -> None:
    g_devwatch.enable()


def disable() -> None:
    g_devwatch.disable()


def enabled() -> bool:
    return g_devwatch.enabled


def reset() -> None:
    g_devwatch.reset()


def snapshot() -> dict:
    return g_devwatch.snapshot()


def reconcile() -> dict:
    return g_devwatch.reconcile()


def note_columns(coll: str, plane: str, columns: dict) -> None:
    g_devwatch.note_columns(coll, plane, columns)


def note_buffer(coll: str, plane: str, column: str, nbytes) -> None:
    g_devwatch.note_buffer(coll, plane, column, nbytes)


def drop_buffer(coll: str, plane: str, column: str) -> None:
    g_devwatch.drop_buffer(coll, plane, column)


def drop(coll: str, plane: str | None = None) -> None:
    g_devwatch.drop(coll, plane)


def collection_bytes(coll: str) -> int:
    return g_devwatch.collection_bytes(coll)


def wave_begin(source: str, **tags) -> dict | None:
    return g_devwatch.wave_begin(source, **tags)


def wave_issued(obs, **tags) -> None:
    g_devwatch.wave_issued(obs, **tags)


def wave_collect(obs) -> None:
    g_devwatch.wave_collect(obs)


def note_round(**detail) -> None:
    g_devwatch.note_round(**detail)


def wave_end(obs, error: str | None = None, **tags) -> None:
    g_devwatch.wave_end(obs, error=error, **tags)


def note_cost(kernel: str, bucket, thunk, modeled_bytes=None) -> None:
    g_devwatch.note_cost(kernel, bucket, thunk,
                         modeled_bytes=modeled_bytes)


def launches():
    return g_devwatch.launches()


def maybe_enable() -> None:
    """Enable iff OSSE_DEVWATCH=1 — import-time wiring in the device
    layers and the server; a true no-op otherwise."""
    if os.environ.get("OSSE_DEVWATCH", "") == "1":
        enable()

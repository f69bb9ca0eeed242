"""Query tracing and stage timing.

A port of ``open_source_search_engine_tpu/utils/trace.py`` (the
Dapper-style tracer of the reference, Sigelman et al., 2010), with the
stage totals this package's scripts read:

* **Stage totals** — every :class:`span`, :class:`timed_span` and
  :func:`record` adds its wall time to :data:`totals` (span name →
  [calls, seconds] since :func:`reset`), traced or not, so a run can say
  where its time went without sampling.
* **Span trees** — ``g_tracer.start(name)`` opens a trace whose root
  span rides a :mod:`contextvars` context; ``span(name, **tags)`` hangs
  a child span off whatever span is current. Timestamps come from the
  monotonic ``time.perf_counter`` clock and serialize as millisecond
  offsets from the trace start.
* **Head-based sampling** — the keep/drop decision is made once, at
  trace start (the ``trace_sample`` parm, default 1 in 64). Unsampled
  traces time their root only; every ``span()`` inside them builds no
  node (it still feeds the totals).
* **Slow-query log** — a trace slower than ``slow_query_ms`` is kept
  whatever the coin flip and appended as one JSON line to
  ``slowlog.jsonl``.
* **Histograms** — :class:`timed_span` and :func:`record` also feed
  ``g_stats.record_ms`` (``/admin/stats``, ``/metrics``), with the trace
  id as the bucket's exemplar when the interval ran under a sampled
  trace.

Threads: a fresh thread starts with an empty contextvars context, so a
trace does not follow work into a pool on its own; re-attach the parent
span in the worker (``with attach(sp): ...``), as the query batcher
does, or open the child with ``begin(name, parent=sp)``.

Across processes the transport stamps each RPC with ``X-OSSE-Trace:
<trace_id>:<parent_span_id>`` (:func:`header_for`); the node
:meth:`Tracer.adopt` adopts it, runs its handler under a local root span and
ships the finished subtree back in the reply (``"_trace"``), which the
caller's RPC span grafts (:meth:`Span.graft`). Remote offsets are rebased onto
the RPC span's start, so two hosts' clocks are never compared.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time
import uuid
from collections import defaultdict, deque

from .log import get_logger
from .stats import g_stats

log = get_logger("perf")

#: finished sampled/slow traces kept in memory for /admin/traces
RING_KEEP = 128
#: default head-sampling rate: keep 1 trace in N (0 disables tracing)
DEFAULT_SAMPLE_N = 64
#: default slow-query threshold (ms); slower traces always kept
DEFAULT_SLOW_MS = 1000.0
#: HTTP header carrying "<trace_id>:<parent_span_id>" across processes
TRACE_HEADER = "X-OSSE-Trace"

#: span name → [calls, seconds] since the last :func:`reset`
totals: defaultdict = defaultdict(lambda: [0, 0.0])

_ids = itertools.count(1)

#: current span (None outside any SAMPLED trace)
_ctx: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "osse_trace_span", default=None)
#: current trace id, set for unsampled traces too, so that log lines
#: carry it without the cost of span bookkeeping
_tid_ctx: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "osse_trace_id", default=None)


def reset() -> None:
    """Zero the stage totals."""
    totals.clear()


def _total(name: str, dt: float, tags: dict) -> None:
    tot = totals[name]
    tot[0] += 1
    tot[1] += dt
    if log.isEnabledFor(10):  # logging.DEBUG
        log.debug("%s %.3f ms %s", name, dt * 1e3, tags or "")


class Span:
    """One timed node in a trace tree. Times are raw ``perf_counter``
    seconds; ``finish`` is idempotent, and a span still unfinished at
    export exports with ``abandoned: true``."""

    __slots__ = ("trace_id", "span_id", "name", "host", "tags",
                 "children", "_grafts", "_t0", "_t1")

    def __init__(self, trace_id: str, name: str, host: str = "",
                 tags: dict | None = None):
        self.trace_id = trace_id
        self.span_id = f"{next(_ids):x}"
        self.name = name
        self.host = host
        self.tags = dict(tags) if tags else {}
        self.children: list[Span] = []
        #: remote subtrees (already-exported dicts) from RPC replies
        self._grafts: list[dict] = []
        self._t0 = time.perf_counter()
        self._t1: float | None = None

    def tag(self, **kw) -> "Span":
        self.tags.update(kw)
        return self

    def finish(self) -> None:
        if self._t1 is None:
            self._t1 = time.perf_counter()

    def child(self, name: str, **tags) -> "Span":
        sp = Span(self.trace_id, name, host=self.host, tags=tags)
        self.children.append(sp)
        return sp

    def graft(self, subtree: dict) -> None:
        """Hang a remote process's exported subtree under this span."""
        if isinstance(subtree, dict):
            self._grafts.append(subtree)

    def record(self, name: str, t0: float, t1: float | None = None,
               **tags) -> "Span":
        """Attach an already-measured interval as a completed child."""
        sp = self.child(name, **tags)
        sp._t0 = t0
        sp._t1 = time.perf_counter() if t1 is None else t1
        return sp

    def to_dict(self, base_t0: float, end: float) -> dict:
        t1 = self._t1
        start_ms = (self._t0 - base_t0) * 1000.0
        d = {
            "id": self.span_id,
            "name": self.name,
            "host": self.host,
            "start_ms": round(start_ms, 3),
            "dur_ms": round(((end if t1 is None else t1) - self._t0)
                            * 1000.0, 3),
            "tags": dict(self.tags),
        }
        if t1 is None:
            d["tags"]["abandoned"] = True
        kids = [c.to_dict(base_t0, end) for c in self.children]
        # a remote subtree's offsets are relative to its own root: rebase
        # them onto this (RPC) span's start
        kids.extend(_shift(g, start_ms) for g in self._grafts)
        if kids:
            d["children"] = kids
        return d


def _shift(node: dict, delta_ms: float) -> dict:
    out = dict(node)
    out["start_ms"] = round(node.get("start_ms", 0.0) + delta_ms, 3)
    if node.get("children"):
        out["children"] = [_shift(c, delta_ms) for c in node["children"]]
    return out


def span_count(node: dict) -> int:
    return 1 + sum(span_count(c) for c in node.get("children", ()))


# ---------------------------------------------------------------------------
# context helpers
# ---------------------------------------------------------------------------

def current_span() -> Span | None:
    return _ctx.get()


def current_trace_id() -> str | None:
    tid = _tid_ctx.get()
    if tid is not None:
        return tid
    sp = _ctx.get()
    return sp.trace_id if sp is not None else None


def begin(name: str, parent: Span | None = None, **tags) -> Span | None:
    """Open a child span without making it current, for work handed to
    another thread or process; the caller owns ``finish()``."""
    p = parent if parent is not None else _ctx.get()
    return None if p is None else p.child(name, **tags)


class attach:
    """Re-establish ``sp`` as the current span inside a worker thread
    (fresh threads start with an empty contextvars context)."""

    __slots__ = ("sp", "_tok", "_tok2")

    def __init__(self, sp: Span | None):
        self.sp = sp

    def __enter__(self) -> Span | None:
        if self.sp is None:
            self._tok = None
            return None
        self._tok = _ctx.set(self.sp)
        self._tok2 = _tid_ctx.set(self.sp.trace_id)
        return self.sp

    def __exit__(self, *exc) -> None:
        if self._tok is not None:
            _ctx.reset(self._tok)
            _tid_ctx.reset(self._tok2)


class span:
    """``with span("query.pack", npass=i):`` — adds to :data:`totals`,
    and is a child of the current span inside a sampled trace (yields
    None outside one)."""

    __slots__ = ("name", "tags", "sp", "_tok", "_t0")

    def __init__(self, name: str, **tags):
        self.name = name
        self.tags = tags

    def __enter__(self) -> Span | None:
        self._t0 = time.perf_counter()
        p = _ctx.get()
        if p is None:
            self.sp = None
            self._tok = None
            return None
        self.sp = p.child(self.name, **self.tags)
        self._tok = _ctx.set(self.sp)
        return self.sp

    def __exit__(self, *exc) -> None:
        _total(self.name, time.perf_counter() - self._t0, self.tags)
        if self.sp is not None:
            _ctx.reset(self._tok)
            self.sp.finish()


class timed_span:
    """A span that also feeds ``g_stats.record_ms(name)``, so the
    histogram plane and the trace plane cannot drift apart."""

    __slots__ = ("name", "_cm", "_t0")

    def __init__(self, name: str, **tags):
        self.name = name
        self._cm = span(name, **tags)

    def __enter__(self) -> Span | None:
        self._t0 = time.perf_counter()
        return self._cm.__enter__()

    def __exit__(self, *exc) -> None:
        self._cm.__exit__(*exc)
        # exemplar: pin a sampled trace's id to the histogram bucket its
        # interval lands in (the aggregate → trace bridge)
        sp = self._cm.sp
        g_stats.record_ms(
            self.name, (time.perf_counter() - self._t0) * 1000.0,
            exemplar=sp.trace_id if sp is not None else None)


def record(name: str, t0: float, t1: float | None = None, **tags) -> None:
    """Add an interval the caller timed (``time.perf_counter()`` marks)
    to the totals, to the current span and to ``g_stats``, as a
    :class:`timed_span` would."""
    end = time.perf_counter() if t1 is None else t1
    _total(name, end - t0, tags)
    p = _ctx.get()
    if p is not None:
        p.record(name, t0, end, **tags)
    g_stats.record_ms(name, (end - t0) * 1000.0,
                      exemplar=p.trace_id if p is not None else None)


def tag(**kw) -> None:
    """Merge tags into the current span, if any."""
    p = _ctx.get()
    if p is not None:
        p.tags.update(kw)
    elif log.isEnabledFor(10):
        log.debug("tags %s", kw)


def header_for(sp: Span | None) -> str | None:
    return None if sp is None else f"{sp.trace_id}:{sp.span_id}"


def parse_header(value: str) -> tuple[str, str] | None:
    tid, sep, psid = (value or "").partition(":")
    if not sep or not tid:
        return None
    return tid, psid


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

class _LiveTrace:
    """Handle yielded by :meth:`Tracer.start` while the trace runs."""

    __slots__ = ("trace_id", "name", "sampled", "root")

    def __init__(self, trace_id: str, name: str, sampled: bool,
                 root: Span):
        self.trace_id = trace_id
        self.name = name
        self.sampled = sampled
        self.root = root

    def export(self) -> dict:
        end = (time.perf_counter() if self.root._t1 is None
               else self.root._t1)
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "sampled": self.sampled,
            "ts": time.time(),
            "dur_ms": round((end - self.root._t0) * 1000.0, 3),
            "root": self.root.to_dict(self.root._t0, end),
        }


class _StartCM:
    def __init__(self, tracer: "Tracer", name: str, trace_id, sampled,
                 tags):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.sampled = sampled
        self.tags = tags
        self.trace: _LiveTrace | None = None

    def __enter__(self) -> _LiveTrace | None:
        tr = self.tracer
        if tr.sample_n <= 0:
            return None
        sampled = self.sampled
        if sampled is None:
            with tr._lock:
                tr._n += 1
                n = tr._n
            sampled = tr.sample_n == 1 or n % tr.sample_n == 0
        tid = self.trace_id or uuid.uuid4().hex[:16]
        root = Span(tid, self.name, host=tr.host, tags=self.tags)
        self.trace = _LiveTrace(tid, self.name, bool(sampled), root)
        self._tok = _ctx.set(root if sampled else None)
        self._tok2 = _tid_ctx.set(tid)
        g_stats.count("trace.started")
        if sampled:
            g_stats.count("trace.sampled")
        return self.trace

    def __exit__(self, *exc) -> None:
        t = self.trace
        if t is None:
            return
        _ctx.reset(self._tok)
        _tid_ctx.reset(self._tok2)
        t.root.finish()
        self.tracer._finish(t)


class _Adopted:
    """Handle yielded by :meth:`Tracer.adopt` on the node side."""

    __slots__ = ("root",)

    def __init__(self, root: Span):
        self.root = root

    def export(self) -> dict:
        self.root.finish()
        return self.root.to_dict(self.root._t0, self.root._t1)


class _AdoptCM:
    """:meth:`Tracer.adopt`'s context manager: an :class:`attach` of the
    local root that yields the adopted-trace handle."""

    __slots__ = ("adopted", "_att")

    def __init__(self, root: Span):
        self.adopted = _Adopted(root)
        self._att = attach(root)

    def __enter__(self) -> _Adopted:
        self._att.__enter__()
        return self.adopted

    def __exit__(self, *exc) -> None:
        self._att.__exit__(*exc)
        self.adopted.root.finish()


class Tracer:
    """Process-wide trace collector: sampling decision, finished-trace
    ring, slow-query log. One instance (:data:`g_tracer`); the server
    configures it from the ``trace_sample`` / ``slow_query_ms`` parms and
    points ``slowlog_path`` into its base directory."""

    def __init__(self, sample_n: int = DEFAULT_SAMPLE_N,
                 slow_ms: float = DEFAULT_SLOW_MS):
        self.sample_n = sample_n
        self.slow_ms = slow_ms
        self.slowlog_path = None
        self.host = ""
        self.ring: deque[dict] = deque(maxlen=RING_KEEP)
        self._lock = threading.Lock()
        self._n = 0

    def configure(self, sample_n: int | None = None,
                  slow_ms: float | None = None,
                  slowlog_path=None, host: str | None = None) -> None:
        if sample_n is not None:
            self.sample_n = int(sample_n)
        if slow_ms is not None:
            self.slow_ms = float(slow_ms)
        if slowlog_path is not None:
            self.slowlog_path = slowlog_path
        if host is not None:
            self.host = host

    def start(self, name: str, trace_id: str | None = None,
              sampled: bool | None = None, **tags) -> _StartCM:
        """Open a root trace. ``sampled=None`` → the head-sampling coin
        flip; ``True`` forces a full trace (debug=1, tests)."""
        return _StartCM(self, name, trace_id, sampled, tags)

    def adopt(self, trace_id: str, parent_span_id: str, name: str,
              host: str = "") -> _AdoptCM:
        """Node side: continue a remote trace under a local root span.
        An adopted trace never enters the local ring or slowlog: it ships
        back to the caller inside the RPC reply."""
        root = Span(trace_id, name, host=host or self.host)
        if parent_span_id:
            root.tags["parent"] = parent_span_id
        return _AdoptCM(root)

    def recent(self) -> list[dict]:
        return list(self.ring)

    def find(self, trace_id: str) -> dict | None:
        for t in reversed(self.ring):
            if t["trace_id"] == trace_id:
                return t
        return None

    def _finish(self, t: _LiveTrace) -> None:
        dur_ms = (t.root._t1 - t.root._t0) * 1000.0
        slow = self.slow_ms > 0 and dur_ms >= self.slow_ms
        if not (t.sampled or slow):
            return
        exported = t.export()
        exported["slow"] = slow
        self.ring.append(exported)
        if slow:
            g_stats.count("trace.slow")
            self._slowlog_append(exported)

    def _slowlog_append(self, exported: dict) -> None:
        path = self.slowlog_path
        if path is None:
            return
        try:
            with self._lock:
                with open(path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(exported) + "\n")
        except OSError as exc:  # never break serving
            g_stats.count("trace.slowlog_errors")
            log.debug("slowlog append failed: %s", exc)

    def slowlog_tail(self, n: int = 50) -> list[dict]:
        """Last ``n`` slowlog entries, skipping torn lines (a kill
        mid-append leaves a partial JSON line)."""
        path = self.slowlog_path
        if path is None:
            return []
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            return []
        out = []
        for line in lines[-n:]:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
        return out


#: process-wide tracer
g_tracer = Tracer()

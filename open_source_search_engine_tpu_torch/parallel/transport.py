"""Cluster transport — pooled keep-alive RPC with hedged twin reads.

A port of ``open_source_search_engine_tpu/parallel/transport.py``: the
same pool, hedging and wire codec (the OSSE1 frames are byte-equal with
the JAX package's on the same payload, so either package's client talks
to either package's node). One departure: the idle sockets kept per peer
are a constructor argument (``max_idle``, default the reference's
:data:`POOL_MAX_IDLE`); a ``ClusterClient`` sizes its transport's to the
requests it can have in flight at once, because with 4 a burst of titlerec
prefetches closes its sockets at check-in and redials them, so a node's
new connections grew with the requests instead of with the callers.

The reference treats its inter-host courier as a first-class perf
component: ``UdpServer.cpp`` keeps persistent endpoints per host with
niceness-aware resend, and ``Multicast.cpp:520`` (``pickBestHost``)
sends each read to the least-loaded twin and re-routes when it dawdles.
This module is that layer for the HTTP plane:

* **Connection pool** — one keep-alive :class:`http.client.HTTPConnection`
  stack per peer address. A reused socket that turns out to be stale
  (peer restarted, idle timeout) is retried ONCE on a fresh dial;
  errors on a fresh dial propagate. Timeouts never auto-retry — the
  request may have executed.
* **Hedged reads** (Dean & Barroso, "The Tail at Scale", CACM 2013) —
  the primary goes to the currently-fastest live twin; after a hedge
  delay of ``clamp(2×EWMA(rtt), floor, cap)`` the SAME request launches
  at the next twin, first good answer wins, the loser is abandoned.
  ``transport.hedge_fired`` / ``transport.hedge_won`` count how often
  the insurance was bought and how often it paid.
* **Binary wire codec** for bulk routes — length-prefixed raw ndarray
  frames instead of base64-inside-JSON (+33% wire, megabytes through
  ``json.loads``). Negotiated per request: the client advertises
  ``Accept: application/x-osse-bin``; a node that understands replies
  binary with the matching Content-Type, an old node ignores the header
  and replies JSON, and an old client never advertises — so any
  new↔old version mix degrades to the JSON wire cleanly.

Everything observable lands in :data:`~..utils.stats.g_stats`
(``transport.*`` counters/latencies/gauges) and is served by
``/admin/transport`` on the serving side.
"""

from __future__ import annotations

import http.client
import io
import json
import struct
import threading
import time
from typing import Callable

import numpy as np

from ..utils import chaos as chaos_mod, deadline as deadline_mod, \
    priority as priority_mod, threads, trace as trace_mod
from ..utils.lockcheck import make_lock
from ..utils.log import get_logger
from ..utils.stats import g_stats

log = get_logger("transport")

#: reply header carrying the answering node's Rdb generation (its posdb
#: version) — the cache plane's cluster-wide invalidation signal
GEN_HEADER = "X-OSSE-Gen"

#: negotiated content type for the binary frame codec
BIN_CONTENT_TYPE = "application/x-osse-bin"
#: frame magic + codec version (bump on incompatible frame changes)
BIN_MAGIC = b"OSSE1"

#: hedge delay bounds: never hedge sooner than the floor (loopback EWMA
#: is microseconds — hedging every request would double cluster read
#: load), never later than the cap (the whole point is beating the
#: multi-second request timeout)
HEDGE_FLOOR_S = 0.05
HEDGE_CAP_S = 2.0
#: idle keep-alive sockets retained per peer (ThreadingHTTPServer burns
#: a thread per open connection — keep the standing footprint small)
POOL_MAX_IDLE = 4

_RETRY_ERRORS = (http.client.BadStatusLine, http.client.CannotSendRequest,
                 http.client.ResponseNotReady, ConnectionResetError,
                 ConnectionAbortedError, BrokenPipeError)


class RpcError(Exception):
    """Transport-level RPC failure (connect/send/recv/HTTP status)."""


class NotOkError(RpcError):
    """The peer ANSWERED, but the reply failed the acceptability check —
    a healthy host saying no (doc miss, refused op), not a sick one."""


class RefusedError(RpcError):
    """The peer actively refused the dial (RST, nothing listening) —
    known-dead right now, not merely slow. Callers fast-fail: no ping
    grace, twin demoted immediately (``transport.fastfail``)."""


# ---------------------------------------------------------------------------
# binary wire codec
# ---------------------------------------------------------------------------
#
# Frame layout:
#   b"OSSE1"                     magic + version
#   uint32 LE                    header length H
#   H bytes                      JSON header: the payload tree with every
#                                ndarray replaced by
#                                {"__nd__": i, "d": descr, "s": shape}
#   per buffer i, in order:      uint64 LE byte length + raw C-order bytes
#
# dtype/shape ride in the JSON header rather than per-buffer .npy
# headers: a 128-byte .npy preamble per array would put the
# binary/base64 ratio at 4/3 only asymptotically — raw buffers keep the
# ≥25% wire saving at every array size.

def encode_bin(obj) -> bytes:
    """Encode a JSON-like tree (dicts/lists/scalars/ndarrays) into one
    binary frame."""
    bufs: list[bytes] = []

    def strip(o):
        if isinstance(o, np.ndarray):
            a = np.ascontiguousarray(o)
            bufs.append(a.tobytes())
            return {"__nd__": len(bufs) - 1,
                    "d": np.lib.format.dtype_to_descr(a.dtype),
                    "s": list(a.shape)}
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [strip(v) for v in o]
        if isinstance(o, np.generic):
            return o.item()
        return o

    header = json.dumps(strip(obj)).encode()
    parts = [BIN_MAGIC, struct.pack("<I", len(header)), header]
    for b in bufs:
        parts.append(struct.pack("<Q", len(b)))
        parts.append(b)
    return b"".join(parts)


def decode_bin(data: bytes):
    """Decode one binary frame back into the payload tree (ndarrays are
    writable copies)."""
    if data[:len(BIN_MAGIC)] != BIN_MAGIC:
        raise ValueError("bad transport frame magic")
    off = len(BIN_MAGIC)
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    header = json.loads(data[off:off + hlen])
    off += hlen
    bufs: list[bytes] = []
    view = memoryview(data)
    while off < len(data):
        (blen,) = struct.unpack_from("<Q", data, off)
        off += 8
        bufs.append(view[off:off + blen])
        off += blen

    def undescr(d):
        # JSON round-trips descr tuples as lists; np.dtype wants the
        # tuples back for structured dtypes
        if isinstance(d, str):
            return np.dtype(d)
        def tup(e):
            return tuple(tup(x) if isinstance(x, list) else x
                         for x in e)
        return np.dtype([tup(e) for e in d])

    def build(o):
        if isinstance(o, dict):
            if "__nd__" in o and isinstance(o["__nd__"], int):
                arr = np.frombuffer(bufs[o["__nd__"]],
                                    dtype=undescr(o["d"]))
                return arr.reshape(o["s"]).copy()
            return {k: build(v) for k, v in o.items()}
        if isinstance(o, list):
            return [build(v) for v in o]
        return o

    return build(header)


def to_wire_json(obj):
    """ndarray-bearing tree → pure-JSON tree for the fallback wire.

    Arrays become base64 ``.npy`` strings — byte-compatible with the
    pre-transport ``_encode_batch`` format, so an old client decoding a
    new node's JSON pull reply sees exactly the wire it always saw."""
    import base64

    if isinstance(obj, np.ndarray):
        bio = io.BytesIO()
        np.save(bio, np.ascontiguousarray(obj))
        return base64.b64encode(bio.getvalue()).decode()
    if isinstance(obj, dict):
        return {k: to_wire_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire_json(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def as_array(v, dtype=None) -> np.ndarray:
    """Whatever the wire delivered → ndarray: already-decoded binary
    arrays pass through, base64 .npy strings load, plain JSON lists
    convert."""
    import base64

    if isinstance(v, np.ndarray):
        arr = v
    elif isinstance(v, str):
        arr = np.load(io.BytesIO(base64.b64decode(v)))
    else:
        arr = np.asarray(v)
    return arr.astype(dtype) if dtype is not None else arr


def encode_body(payload, accept_bin: bool) -> tuple[bytes, str]:
    """Serialize one RPC body per the negotiated codec: binary when the
    peer advertised it, legacy JSON otherwise."""
    if accept_bin:
        return encode_bin(payload), BIN_CONTENT_TYPE
    return (json.dumps(to_wire_json(payload)).encode(),
            "application/json")


def decode_body(data: bytes, content_type: str):
    if (content_type or "").split(";")[0].strip() == BIN_CONTENT_TYPE:
        return decode_bin(data)
    return json.loads(data or b"{}")


# ---------------------------------------------------------------------------
# pooled + hedged transport
# ---------------------------------------------------------------------------

class _PeerState:
    """Per-address pool + health signals."""

    __slots__ = ("idle", "ewma", "lock")

    def __init__(self):
        self.idle: list[http.client.HTTPConnection] = []
        #: route → RTT EWMA seconds (the pickBestHost load signal and
        #: the hedge-delay input)
        self.ewma: dict[str, float] = {}
        self.lock = make_lock("transport.peer")


class Transport:
    """Keep-alive connection pool + hedged request fan-out.

    One instance per process (see :data:`g_transport`); every cluster
    RPC — client reads/writes, node-to-node heal pulls, pings — flows
    through :meth:`request` so pooling, codec negotiation and the
    ``transport.*`` stats cover the whole plane.
    """

    def __init__(self, binary: bool = True,
                 max_idle: int = POOL_MAX_IDLE):
        #: advertise the binary codec on requests (off = JSON-only
        #: client, the "old client" half of the mixed-version matrix)
        self.binary = binary
        #: idle keep-alive sockets retained per peer
        self.max_idle = int(max_idle)
        self._peers: dict[str, _PeerState] = {}
        self._lock = make_lock("transport.peers")
        #: optional hook ``fn(addr, gen)`` fed every ``X-OSSE-Gen``
        #: reply header — nodes stamp their Rdb version on every reply
        #: so the caller's cache plane observes generation moves even on
        #: replies whose body carries no "gen" field (pings, reads)
        self.gen_observer: Callable[[str, int], None] | None = None

    # --- pool -------------------------------------------------------------

    def _peer(self, addr: str) -> _PeerState:
        with self._lock:
            st = self._peers.get(addr)
            if st is None:
                st = self._peers[addr] = _PeerState()
            return st

    def _checkout(self, addr: str, timeout: float
                  ) -> tuple[http.client.HTTPConnection, bool]:
        st = self._peer(addr)
        with st.lock:
            conn = st.idle.pop() if st.idle else None
        if conn is not None:
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            conn.timeout = timeout
            g_stats.count("transport.conn_reuse")
            return conn, True
        host, _, port = addr.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=timeout)
        g_stats.count("transport.conn_dial")
        return conn, False

    def _checkin(self, addr: str, conn: http.client.HTTPConnection
                 ) -> None:
        st = self._peer(addr)
        with st.lock:
            if len(st.idle) < self.max_idle:
                st.idle.append(conn)
                return
        conn.close()

    def _discard(self, conn: http.client.HTTPConnection) -> None:
        try:
            conn.close()
        except Exception as exc:  # noqa: BLE001 — already-dead socket
            log.debug("discarding connection failed: %s", exc)

    def close(self) -> None:
        with self._lock:
            peers = list(self._peers.values())
        for st in peers:
            with st.lock:
                idle, st.idle = st.idle, []
            for c in idle:
                self._discard(c)

    # --- health signals ---------------------------------------------------

    def ewma_s(self, addr: str, route: str) -> float:
        st = self._peer(addr)
        with st.lock:
            return st.ewma.get(route, 0.0)

    def _observe(self, addr: str, route: str, dt: float) -> None:
        st = self._peer(addr)
        with st.lock:
            prev = st.ewma.get(route)
            st.ewma[route] = dt if prev is None else 0.8 * prev + 0.2 * dt
            now = st.ewma[route]
        g_stats.record_ms(f"transport.rtt.{addr}", 1000.0 * dt)
        g_stats.gauge(f"transport.ewma_ms.{addr}{route}", 1000.0 * now)

    def penalize(self, addr: str, route: str, dt: float) -> None:
        """Bump a peer's load signal without a completed request — the
        hedge fired because this peer sat on the request, or a read
        failed while the host still answers pings. Keeps a wedged twin
        from staying 'fastest' forever just because its EWMA never gets
        a slow sample (the abandoned request never reports)."""
        st = self._peer(addr)
        with st.lock:
            st.ewma[route] = st.ewma.get(route, 0.0) + dt

    def hedge_delay_s(self, addr: str, route: str) -> float:
        return min(max(2.0 * self.ewma_s(addr, route), HEDGE_FLOOR_S),
                   HEDGE_CAP_S)

    def stats(self) -> dict:
        """Point-in-time pool/EWMA snapshot (the /admin/transport body;
        counters and histograms live in g_stats)."""
        out = {}
        with self._lock:
            items = list(self._peers.items())
        for addr, st in items:
            with st.lock:
                out[addr] = {
                    "idle_conns": len(st.idle),
                    "ewma_ms": {route: 1000.0 * v
                                for route, v in st.ewma.items()},
                }
        return out

    # --- single request ---------------------------------------------------

    def request(self, addr: str, path: str, payload: dict,
                timeout: float, niceness: int = 0,
                span: "trace_mod.Span | None" = None) -> dict:
        """One RPC over a pooled connection.

        A send/recv failure on a REUSED socket retries once on a fresh
        dial (the peer closed an idle keep-alive socket under us — the
        request never reached it). Fresh-dial failures and timeouts
        propagate as :class:`RpcError`: a timed-out request may have
        executed, so only idempotent layers above (hedging, the Msg1
        retry queue) decide about re-sending.

        Request bodies are ALWAYS JSON — an old node would reject a
        binary body outright. Only the REPLY codec is negotiated: the
        ``Accept`` header advertises binary, and a node that doesn't
        understand it simply answers JSON.

        Tracing: inside a sampled trace the RPC gets a child span
        (``rpc/...``) and the ``X-OSSE-Trace`` header; the node ships
        its subtree back under ``"_trace"``, grafted here. ``span``
        lets :meth:`hedged` pass pre-made per-attempt spans across its
        launch threads (contextvars don't follow threads)."""
        sp = span if span is not None else \
            trace_mod.begin(path.lstrip("/"), addr=addr)
        try:
            out = self._request_inner(addr, path, payload, timeout,
                                      niceness, sp)
        except Exception as e:  # noqa: BLE001
            if sp is not None:
                sp.tag(error=repr(e))
            raise
        finally:
            if sp is not None:
                sp.finish()
        if sp is not None and isinstance(out, dict):
            sub = out.pop("_trace", None)
            if sub is not None:
                sp.graft(sub)
        return out

    def _request_inner(self, addr, path, payload, timeout, niceness,
                       sp) -> dict:
        body = json.dumps(to_wire_json(payload)).encode()
        headers = {"Content-Type": "application/json",
                   "X-Niceness": str(niceness)}
        if self.binary:
            headers["Accept"] = BIN_CONTENT_TYPE
        if sp is not None:
            headers[trace_mod.TRACE_HEADER] = trace_mod.header_for(sp)
        dl = deadline_mod.current()
        if dl is not None:
            # budget, not an absolute clock — wall clocks don't agree
            # across hosts (the node rebuilds a local Deadline from it)
            headers[deadline_mod.DEADLINE_HEADER] = dl.header_value()
        tier = priority_mod.current_tier()
        if tier is not None:
            # the front door's priority verdict rides every scatter
            # leg, so node planes honor the tier too (crawlbot work
            # yields inside each host, not just at the coordinator)
            headers[priority_mod.PRIORITY_HEADER] = tier
        tenant = priority_mod.current_tenant()
        if tenant is not None:
            # ...and its quota verdict: a node's gate bills the leg to
            # the same tenant ledger the coordinator admitted against
            headers[priority_mod.TENANT_HEADER] = tenant
        t0 = time.monotonic()
        for attempt in (0, 1):
            conn, reused = self._checkout(addr, timeout)
            try:
                if chaos_mod.g_chaos.enabled:
                    chaos_mod.g_chaos.leg_fault(addr, path, timeout)
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except _RETRY_ERRORS as e:
                self._discard(conn)
                if reused and attempt == 0:
                    # stale keep-alive socket — transparent reconnect
                    g_stats.count("transport.conn_retry")
                    continue
                g_stats.count("transport.error")
                raise RpcError(f"{addr}{path}: {e!r}") from e
            except Exception as e:  # noqa: BLE001 — timeout, refused, DNS
                self._discard(conn)
                g_stats.count("transport.error")
                if isinstance(e, ConnectionRefusedError):
                    # dead-peer fast-fail: demote the twin's load signal
                    # NOW instead of letting a refused dial wait out the
                    # EWMA clamp, and raise typed so the layer above can
                    # skip the ping grace a merely-slow host gets
                    g_stats.count("transport.fastfail")
                    self.penalize(addr, path, 1.0)
                    raise RefusedError(f"{addr}{path}: {e!r}") from e
                raise RpcError(f"{addr}{path}: {e!r}") from e
            if resp.will_close:
                self._discard(conn)
            else:
                self._checkin(addr, conn)
            if resp.status != 200:
                g_stats.count("transport.error")
                try:
                    err = decode_body(
                        data, resp.headers.get("Content-Type", ""))
                except Exception:  # noqa: BLE001
                    err = {}
                raise RpcError(
                    f"{addr}{path}: HTTP {resp.status} "
                    f"{err.get('error', '')}".strip())
            self._observe(addr, path, time.monotonic() - t0)
            g_stats.count("transport.rpc")
            obs = self.gen_observer
            if obs is not None:
                gen_hdr = resp.headers.get(GEN_HEADER)
                if gen_hdr is not None:
                    try:
                        obs(addr, int(gen_hdr))
                    except Exception as exc:  # noqa: BLE001 — obs only
                        g_stats.count("transport.gen_observer_error")
                        log.warning("gen observer failed: %s", exc)
            return decode_body(data,
                               resp.headers.get("Content-Type", ""))
        raise AssertionError("unreachable")

    def probe(self, addr: str, path: str = "/rpc/ping",
              timeout: float = 1.5) -> dict | None:
        """One quiet liveness probe: the reply dict when the peer
        answers ``ok``, else ``None`` — never raises. Readiness polls
        (a fleet child mid-boot) and heartbeats call this in a loop;
        the normal error/fast-fail counters still move underneath, so
        a flapping peer stays visible in the stats plane."""
        try:
            out = self.request(addr, path, {}, timeout=timeout)
        except Exception:  # noqa: BLE001 — an absent peer is a None
            return None
        return out if out.get("ok") else None

    def broadcast(self, addrs: list[str], path: str, payload: dict,
                  timeout: float, niceness: int = 1
                  ) -> dict[str, dict | None]:
        """The same request to EVERY address concurrently — the scrape
        shape, not the race shape: no hedging, no winner, each peer's
        answer (or ``None`` on failure) keyed by address. Pooled
        connections are reused per-peer like any other RPC; background
        niceness by default so a fleet scrape never contends with
        query traffic."""
        out: dict[str, dict | None] = {}
        lock = threading.Lock()

        def one(addr: str) -> None:
            try:
                res = self.request(addr, path, payload, timeout,
                                   niceness=niceness)
            except Exception:  # noqa: BLE001 — absent peer is a None
                res = None
            with lock:
                out[addr] = res

        ts = [threads.spawn(f"scrape-{a}", one, a) for a in addrs]
        for t in ts:
            t.join(timeout + 1.0)
        with lock:
            return {a: out.get(a) for a in addrs}

    # --- hedged fan-out ---------------------------------------------------

    def hedged(self, addrs: list[str], path: str, payload: dict,
               timeout: float, niceness: int = 0,
               is_ok=None, span_parent=None
               ) -> tuple[dict | None, int, list]:
        """The same request raced across twins, tail-latency style.

        ``addrs[0]`` (caller pre-sorts fastest-live-first) launches
        immediately; each further twin launches either the moment the
        previous attempt FAILS, or after that twin's hedge delay while
        it is still in flight (``hedge_fired``). First acceptable
        answer wins (``hedge_won`` when a hedge launch beat the
        primary); losers are abandoned — their threads finish into the
        void and only their EWMA penalty remains.

        Returns ``(result, winner_index, failures)`` where failures is
        ``[(index, exception), ...]`` for attempts that COMPLETED
        badly — a still-wedged in-flight twin is not in it (slow is not
        dead; liveness stays with the heartbeat prober)."""
        if is_ok is None:
            is_ok = lambda o: bool(o.get("ok")) or "total" in o
        parent = span_parent if span_parent is not None else \
            trace_mod.current_span()
        dl = deadline_mod.current()
        tier = priority_mod.current_tier()
        tenant = priority_mod.current_tenant()
        deadline = deadline_mod.Deadline.after(timeout)
        if dl is not None and dl.at < deadline.at:
            deadline = dl  # the query budget runs out first
        cv = threading.Condition()
        #: per attempt: None = in flight, ("ok", out) or ("err", e)
        state: list = [None] * len(addrs)
        launched = [False] * len(addrs)
        launch_t = [0.0] * len(addrs)
        hedge_launch = [False] * len(addrs)
        spans: list = [None] * len(addrs)

        def run(i: int) -> None:
            try:
                # span= only when tracing: tests monkeypatch request()
                # with the plain 5-arg signature
                kw = {} if spans[i] is None else {"span": spans[i]}
                # launch threads start with empty contextvars: re-bind
                # the caller's deadline, tier AND tenant so all three
                # ride the wire
                with deadline_mod.bind(dl), \
                        priority_mod.bind_tier(tier), \
                        priority_mod.bind_tenant(tenant):
                    out = self.request(addrs[i], path, payload,
                                       timeout=timeout,
                                       niceness=niceness, **kw)
                res = ("ok", out) if is_ok(out) else \
                    ("err", NotOkError(f"{addrs[i]}{path}: not ok"))
            except Exception as e:  # noqa: BLE001
                res = ("err", e)
            with cv:
                state[i] = res
                cv.notify_all()

        def launch(i: int, hedge: bool) -> None:
            launched[i] = True
            launch_t[i] = time.monotonic()
            hedge_launch[i] = hedge
            if hedge:
                g_stats.count("transport.hedge_fired")
            if parent is not None:
                spans[i] = parent.child(path.lstrip("/"),
                                        addr=addrs[i], hedge=hedge)
            threads.spawn(f"hedge-{path.rsplit('/', 1)[-1]}-{i}",
                          run, i)

        launch(0, hedge=False)
        winner, result = -1, None
        with cv:
            while True:
                done = [i for i in range(len(addrs))
                        if state[i] is not None]
                ok = [i for i in done if state[i][0] == "ok"]
                if ok:
                    winner = ok[0]
                    result = state[winner][1]
                    break
                in_flight = [i for i in range(len(addrs))
                             if launched[i] and state[i] is None]
                next_i = next((i for i in range(len(addrs))
                               if not launched[i]), None)
                now = time.monotonic()
                if next_i is None:
                    if not in_flight or deadline.expired():
                        break  # every attempt failed (or clock ran out)
                    cv.wait(min(deadline.remaining(), 0.5))
                    continue
                if not in_flight:
                    # previous attempt(s) failed outright — immediate
                    # failover, no hedge delay (Multicast reroute)
                    launch(next_i, hedge=False)
                    continue
                # hedge timing keys off the most recent in-flight
                # launch: the delay is how long we give that attempt
                # past its own expected completion (2×EWMA) before
                # buying the next insurance request — anchoring on an
                # older attempt would cascade every remaining twin at
                # once the moment the first one dawdles
                anchor = max(in_flight, key=lambda i: launch_t[i])
                fire_at = launch_t[anchor] + self.hedge_delay_s(
                    addrs[anchor], path)
                if now >= fire_at:
                    # dawdling past the hedge delay: penalize the load
                    # signal by the time sat on it (the abandoned
                    # request will never report a latency sample)
                    for i in in_flight:
                        self.penalize(addrs[i], path, now - launch_t[i])
                    launch(next_i, hedge=True)
                    continue
                cv.wait(min(fire_at - now,
                            max(deadline.remaining(), 0.0)))
        if winner >= 0 and hedge_launch[winner]:
            g_stats.count("transport.hedge_won")
        if winner >= 0 and spans[winner] is not None:
            spans[winner].tag(won=True,
                              hedge_won=bool(hedge_launch[winner]))
        failures = [(i, state[i][1]) for i in range(len(addrs))
                    if state[i] is not None and state[i][0] == "err"]
        return result, winner, failures


#: process-wide transport (the UdpServer singleton role)
g_transport = Transport()

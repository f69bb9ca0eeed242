"""Fleet plane — every shard node a REAL OS process under one supervisor.

A port of ``open_source_search_engine_tpu/parallel/fleet.py``. Two
departures: each child gets ``--torch-device`` explicitly (``device=``,
default ``cuda``: a child asked for ``cuda`` on a host without CUDA exits
non-zero, so readiness fails, and no child falls back to the CPU), and
the route reaches it as the ``node --device`` flag (``use_device=``, the
device route; off, the flat path, as the reference's children run). The
reference's children default to the CPU instead (``JAX_PLATFORMS=cpu``).
A child's standard error goes to ``node_s<S>r<R>.log`` in the base
directory, and ``ready_s`` keeps each node's last spawn-to-ready seconds.

Reference: Gigablast ran one ``gb`` binary per host across ~200 servers.
``hosts.conf`` (Hostdb.cpp:124) was the cluster map every instance got
at boot; ``gb start`` ssh'd the fleet up, PingServer probed it,
``gb stop``/``gb save`` broadcast orderly shutdown/checkpoint, and parm
changes rode the 0x3f broadcast to every host live (SURVEY §6, §7
stage 7). Until this module, our "cluster" was threads in one Python
process — one GIL, one fate domain, shared caches — so the transport's
hedging, the chaos kills, and the fleet scrape had never crossed a real
process boundary.

:class:`FleetManager` is that ancestry on one machine:

* spawns the ``node`` subcommand (``python -m <pkg> node``) once per
  (shard, replica), each child booting from its checkpoint dir with the
  serialized hosts.conf map, its seat in it, and the chaos seed in
  ``OSSE_CHAOS`` (rate 0: seams armed, only aimed faults fire);
* waits on a ``/rpc/ping`` readiness probe over the pooled transport;
* supervises children — an UNEXPECTED death (the chaos plane's real
  SIGKILL) respawns with exponential backoff, and the node's journal
  replay is what makes that restart lossless;
* tears down by process group: children are session leaders
  (``start_new_session``), so ``killpg`` reaps them and anything they
  spawned, and an ``atexit`` finalizer per manager guarantees no test
  run leaks orphans even when the caller never reaches ``shutdown()``;
* ``rolling_restart`` drains each node through its admission gate
  (stop admitting → in-flight waves collect → ``/rpc/save`` →
  SIGTERM, SIGKILL on timeout) while the twin absorbs traffic via the
  transport's hedging;
* ``broadcast_parms`` is the live 0x3f update: applied on every node,
  no restarts (the replies carry pids to prove it).

Data dirs use ShardedCollection's naming (``shard_SSS[_rR]``), so a
fleet base dir doubles as a grid for the offline ``rebalance`` path —
the cross-process shard-split gate in bench.py rides that.
"""

from __future__ import annotations

import atexit
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

from ..utils import deadline as deadline_mod
from ..utils import threads
from ..utils.lockcheck import make_lock
from ..utils.log import get_logger
from ..utils.stats import g_stats
from . import transport as transport_mod
from .cluster import HostsConf

log = get_logger("fleet")

PKG = "open_source_search_engine_tpu_torch"

READY_TIMEOUT_S = 120.0   # a cold child imports torch (and inits CUDA)
STOP_TIMEOUT_S = 15.0     # SIGTERM grace (save under the writer lock)
BACKOFF_BASE_S = 0.25
BACKOFF_CAP_S = 5.0
SUPERVISE_INTERVAL_S = 0.1


def _grid_dirname(shard: int, replica: int) -> str:
    """ShardedCollection's layout (replica 0 unsuffixed) so the fleet
    base dir IS a loadable shard grid for rebalance/repair."""
    return (f"shard_{shard:03d}" if replica == 0
            else f"shard_{shard:03d}_r{replica}")


class _Child:
    """One supervised node process slot (survives respawns)."""

    __slots__ = ("shard", "replica", "port", "data_dir", "proc",
                 "restarts", "expected_exit", "next_respawn_at",
                 "spawned_at")

    def __init__(self, shard: int, replica: int, port: int,
                 data_dir: Path):
        self.shard = shard
        self.replica = replica
        self.port = port
        self.data_dir = data_dir
        self.proc: subprocess.Popen | None = None
        #: unexpected-death respawn count (the backoff's exponent; reset once
        #: the respawned child answers a readiness probe)
        self.restarts = 0
        #: set before an ON-PURPOSE stop so the supervisor does not
        #: fight the operator by resurrecting a drained node
        self.expected_exit = False
        self.next_respawn_at = 0.0
        #: monotonic time of the last spawn (spawn-to-ready seconds)
        self.spawned_at = 0.0


class FleetManager:
    """Spawn, probe, supervise, and reap a grid of real node processes."""

    def __init__(self, base_dir: str | Path, n_shards: int = 2,
                 n_replicas: int = 2, host: str = "127.0.0.1",
                 chaos_seed: int | None = None, supervise: bool = True,
                 env: dict | None = None,
                 ready_timeout_s: float = READY_TIMEOUT_S,
                 device: str = "cuda", use_device: bool = False):
        self.base_dir = Path(base_dir)
        self.base_dir.mkdir(parents=True, exist_ok=True)
        self.host = host
        self.chaos_seed = chaos_seed
        self.supervise = supervise
        self.extra_env = dict(env or {})
        self.ready_timeout_s = float(ready_timeout_s)
        #: the children's torch device and route (node --torch-device,
        #: node --device)
        self.device = str(device)
        self.use_device = bool(use_device)
        #: (shard, replica) -> seconds from its last spawn to the first
        #: ping answer wait_ready saw
        self.ready_s: dict[tuple[int, int], float] = {}
        self.transport = transport_mod.Transport()
        self._lock = make_lock("fleet.manager")
        self._stopping = False
        self._supervisor = None
        #: wall-clock-seeded like ClusterClient's parm counter so a
        #: fresh manager never replays below a node's persisted seq
        self._parm_seq = int(time.time() * 1000)
        ports = self._reserve_ports(n_shards * n_replicas)
        self.conf = HostsConf(
            n_shards, n_replicas,
            [[f"{host}:{ports[s * n_replicas + r]}"
              for r in range(n_replicas)] for s in range(n_shards)])
        self.hosts_path = self.base_dir / "hosts.conf"
        self.hosts_path.write_text(self.conf.dump())
        self._children = {
            (s, r): _Child(s, r, ports[s * n_replicas + r],
                           self.base_dir / _grid_dirname(s, r))
            for s in range(n_shards) for r in range(n_replicas)}
        # the orphan-reaper guarantee: registered per manager (no
        # module-global registry to share between request threads),
        # unregistered again once shutdown() has reaped everything
        atexit.register(self._atexit_reap)

    # --- topology helpers -------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.conf.n_shards

    @property
    def n_replicas(self) -> int:
        return self.conf.n_replicas

    def addr(self, shard: int, replica: int) -> str:
        return self.conf.addresses[shard][replica]

    def addrs(self) -> list[str]:
        return [self.conf.addresses[s][r]
                for s in range(self.n_shards)
                for r in range(self.n_replicas)]

    def data_dir(self, shard: int, replica: int) -> Path:
        return self._children[(shard, replica)].data_dir

    def pid(self, shard: int, replica: int) -> int | None:
        proc = self._children[(shard, replica)].proc
        return proc.pid if proc is not None else None

    def pids(self) -> dict[tuple[int, int], int | None]:
        return {sr: (c.proc.pid if c.proc else None)
                for sr, c in self._children.items()}

    def alive(self, shard: int, replica: int) -> bool:
        proc = self._children[(shard, replica)].proc
        return proc is not None and proc.poll() is None

    def surviving_pids(self) -> list[int]:
        """Child pids still alive RIGHT NOW — the teardown-hygiene
        assertion every fleet test makes (empty after shutdown)."""
        out = []
        for c in self._children.values():
            if c.proc is None:
                continue
            if c.proc.poll() is not None:
                continue  # exited (poll also reaps a zombie child)
            try:
                os.kill(c.proc.pid, 0)
            except (ProcessLookupError, PermissionError):
                continue
            out.append(c.proc.pid)
        return out

    @staticmethod
    def _reserve_ports(n: int) -> list[int]:
        """Bind-to-0 / record / close: the kernel hands out n distinct
        free ports the children re-bind moments later (the window is a
        loopback race accepted everywhere this pattern appears)."""
        socks, ports = [], []
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
        for s in socks:
            s.close()
        return ports

    # --- spawn / readiness ------------------------------------------------

    def _child_env(self) -> dict:
        env = dict(os.environ)
        repo_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = repo_root + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        if self.chaos_seed is not None:
            env["OSSE_CHAOS"] = str(self.chaos_seed)
            # seams armed + replayable, zero AMBIENT faults: only what
            # the parent aims (fleet_fault, configure over /rpc) fires
            env.setdefault("OSSE_CHAOS_RATE", "0")
        env.update(self.extra_env)
        return env

    def _spawn(self, child: _Child) -> None:
        argv = [sys.executable, "-m", PKG, "node",
                "--dir", str(child.data_dir),
                "--host", self.host, "--port", str(child.port),
                "--hosts", str(self.hosts_path),
                "--shard", str(child.shard),
                "--replica", str(child.replica),
                "--torch-device", self.device]
        if self.use_device:
            argv.append("--device")
        # start_new_session: the child leads its own session AND
        # process group (pgid == pid), so killpg reaps it plus any
        # grandchildren, and our own SIGINT never propagates into it
        with open(self.base_dir / f"node_s{child.shard}r{child.replica}"
                  ".log", "ab") as err:
            child.proc = subprocess.Popen(
                argv, env=self._child_env(), start_new_session=True,
                stdout=subprocess.DEVNULL, stderr=err)
        child.spawned_at = time.monotonic()
        self.ready_s.pop((child.shard, child.replica), None)
        child.expected_exit = False
        g_stats.count("fleet.spawn")
        log.info("spawned node s%dr%d pid=%d port=%d", child.shard,
                 child.replica, child.proc.pid, child.port)

    def start_all(self) -> None:
        """Spawn the whole grid, wait until every node answers ping,
        then start the supervisor."""
        for child in self._children.values():
            self._spawn(child)
        for (s, r) in self._children:
            self.wait_ready(s, r)
        if self.supervise and self._supervisor is None:
            self._supervisor = threads.spawn("fleet-supervisor",
                                             self._supervise_loop)

    def wait_ready(self, shard: int, replica: int,
                   timeout_s: float | None = None) -> dict:
        """Poll ``/rpc/ping`` until the node answers; returns the ping
        reply (identity-checked). Raises on timeout or when the child
        died and nobody will respawn it."""
        child = self._children[(shard, replica)]
        addr = self.addr(shard, replica)
        dl = deadline_mod.Deadline.after(
            timeout_s if timeout_s is not None else self.ready_timeout_s)
        while not dl.expired():
            out = self.transport.probe(addr, timeout=1.0)
            if out is not None:
                if ("shard" in out
                        and (out["shard"], out["replica"])
                        != (shard, replica)):
                    raise RuntimeError(
                        f"node at {addr} reports seat "
                        f"s{out['shard']}r{out['replica']}, expected "
                        f"s{shard}r{replica}")
                child.restarts = 0  # healthy: reset the backoff ladder
                self.ready_s.setdefault(
                    (shard, replica), time.monotonic() - child.spawned_at)
                return out
            proc = child.proc
            dead = proc is None or proc.poll() is not None
            will_respawn = (self._supervisor is not None
                            and not child.expected_exit)
            if dead and not will_respawn:
                raise RuntimeError(
                    f"node s{shard}r{replica} exited "
                    f"(rc={proc.poll() if proc else None}) before "
                    "answering ping")
            time.sleep(0.05)
        raise TimeoutError(
            f"node s{shard}r{replica} at {addr} not ready in time")

    # --- supervision (restart-and-backoff) --------------------------------

    def _supervise_loop(self) -> None:
        while not self._stopping:
            time.sleep(SUPERVISE_INTERVAL_S)
            now = time.monotonic()
            for child in self._children.values():
                with self._lock:
                    proc = child.proc
                    if (self._stopping or child.expected_exit
                            or proc is None or proc.poll() is None):
                        continue
                    if child.next_respawn_at == 0.0:
                        # first sighting of this corpse: schedule the
                        # respawn one backoff step out
                        delay = min(BACKOFF_CAP_S,
                                    BACKOFF_BASE_S * (2 ** child.restarts))
                        child.next_respawn_at = now + delay
                        g_stats.count("fleet.child_died")
                        log.warning(
                            "node s%dr%d died (rc=%s); respawn in "
                            "%.2fs", child.shard, child.replica,
                            proc.poll(), delay)
                        continue
                    if now < child.next_respawn_at:
                        continue
                    child.restarts += 1
                    child.next_respawn_at = 0.0
                    self._spawn(child)
                    g_stats.count("fleet.restart")

    # --- chaos entry points ----------------------------------------------

    def kill(self, shard: int, replica: int,
             sig: int = signal.SIGKILL) -> int:
        """Signal a node like the chaos plane would (default kill -9 —
        no save, no atexit; journal replay is the recovery). The
        supervisor treats the death as unexpected and respawns."""
        child = self._children[(shard, replica)]
        if child.proc is None:
            raise RuntimeError(f"node s{shard}r{replica} not running")
        pid = child.proc.pid
        os.kill(pid, sig)
        g_stats.count("fleet.kill")
        return pid

    # --- orderly stop / restart -------------------------------------------

    def stop_node(self, shard: int, replica: int,
                  timeout_s: float = STOP_TIMEOUT_S) -> int | None:
        """SIGTERM (the node saves + exits via its signal handler),
        escalate to killpg-SIGKILL past the grace window."""
        child = self._children[(shard, replica)]
        proc = child.proc
        if proc is None:
            return None
        with self._lock:
            child.expected_exit = True
        try:
            os.kill(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            log.warning("node s%dr%d ignored SIGTERM; killpg", shard,
                        replica)
            self._killpg(proc, signal.SIGKILL)
            rc = proc.wait()
        return rc

    def start_node(self, shard: int, replica: int,
                   wait: bool = True) -> None:
        """(Re)spawn one node slot on its reserved port/dir."""
        child = self._children[(shard, replica)]
        with self._lock:
            if child.proc is not None and child.proc.poll() is None:
                raise RuntimeError(
                    f"node s{shard}r{replica} already running")
            self._spawn(child)
        if wait:
            self.wait_ready(shard, replica)

    def rolling_restart(self, drain_timeout_s: float = 10.0) -> dict:
        """Restart every node, one at a time, the reference's orderly
        way: drain through the admission gate (new work sheds to the
        twin via hedging / the client's parked write queue), let
        in-flight waves collect, checkpoint via ``/rpc/save``, SIGTERM,
        respawn, and only move on once the reborn node answers ping —
        so at most one twin per shard is ever down."""
        report: dict = {"nodes": [], "sheds": 0}
        for (s, r) in sorted(self._children):
            addr = self.addr(s, r)
            drained = self._rpc(addr, "/rpc/drain",
                                {"timeout_s": drain_timeout_s},
                                timeout=drain_timeout_s + 5.0)
            saved = self._rpc(addr, "/rpc/save", {}, timeout=60.0)
            self.stop_node(s, r)
            self.start_node(s, r, wait=True)
            report["nodes"].append({
                "node": f"s{s}r{r}",
                "drained": bool(drained and drained.get("drained")),
                "saved": bool(saved and saved.get("ok")),
                "sheds": int(drained.get("sheds", 0)) if drained
                else 0})
            report["sheds"] += report["nodes"][-1]["sheds"]
            g_stats.count("fleet.rolled")
        return report

    # --- live parm broadcast ----------------------------------------------

    def broadcast_parms(self, parms: dict) -> dict[str, dict | None]:
        """The 0x3f live-update, fleet-wide and bulk: one ``/rpc/parms``
        to every node, one sequence number for the batch; applied with
        no restart (replies carry each node's pid so callers can prove
        it)."""
        with self._lock:
            self._parm_seq += 1
            seq = self._parm_seq
        return self.transport.broadcast(
            self.addrs(), "/rpc/parms",
            {"parms": dict(parms), "seq": seq}, timeout=10.0)

    def _rpc(self, addr: str, path: str, payload: dict,
             timeout: float = 10.0) -> dict | None:
        try:
            return self.transport.request(addr, path, payload,
                                          timeout=timeout)
        except Exception as e:  # noqa: BLE001 — callers gate on None
            log.warning("fleet rpc %s %s failed: %s", addr, path, e)
            return None

    # --- teardown ---------------------------------------------------------

    @staticmethod
    def _killpg(proc: subprocess.Popen, sig: int) -> None:
        try:
            os.killpg(proc.pid, sig)  # pgid == pid (start_new_session)
        except (ProcessLookupError, PermissionError):
            pass

    def shutdown(self, timeout_s: float = STOP_TIMEOUT_S) -> None:
        """Reap the whole fleet: SIGTERM every process group, escalate
        to SIGKILL past the grace window, wait, and only then drop the
        atexit finalizer. Idempotent; never leaves orphans."""
        self._stopping = True
        with self._lock:
            for child in self._children.values():
                child.expected_exit = True
        live = [c.proc for c in self._children.values()
                if c.proc is not None and c.proc.poll() is None]
        for proc in live:
            self._killpg(proc, signal.SIGTERM)
        dl = deadline_mod.Deadline.after(timeout_s)
        for proc in live:
            try:
                proc.wait(timeout=max(0.05, dl.remaining()))
            except subprocess.TimeoutExpired:
                pass
        for proc in live:
            if proc.poll() is None:
                self._killpg(proc, signal.SIGKILL)
                proc.wait()
        self.transport.close()
        atexit.unregister(self._atexit_reap)
        log.info("fleet down (%d processes reaped)", len(live))

    def _atexit_reap(self) -> None:
        """Last-resort orphan reaper: if the owner never reached
        shutdown() (test body raised, operator ^C'd), nuke every child
        process group on interpreter exit."""
        for child in self._children.values():
            proc = child.proc
            if proc is not None and proc.poll() is None:
                self._killpg(proc, signal.SIGKILL)

    # --- context manager sugar --------------------------------------------

    def __enter__(self) -> "FleetManager":
        self.start_all()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

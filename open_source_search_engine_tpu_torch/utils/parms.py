"""Typed parameter registry — the single source of truth for every knob.

Copy of ``open_source_search_engine_tpu/utils/parms.py`` (reference
``Parms.cpp/h``): one declarative table, :data:`PARMS`, declares each
parameter once with its cgi name, type, default and scope; :class:`Conf`
(global scope, ``gb.conf``) and :class:`CollectionConf`
(per-collection, ``coll.conf``) are dict-backed objects generated from
it, with a JSON round trip (``load``/``save``), the URL api
(``set_from_cgi``) and an ``on_update`` hook, which the server uses to
apply live changes (``max_mem``, ``checkify``, ``trace_sample``, ...).
The cluster-wide broadcast of the reference waits for the mesh.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

GLOBAL = "global"
COLL = "coll"


@dataclass(frozen=True)
class Parm:
    """One row of the parameter table (reference ``Parms.h`` ``class Parm``)."""

    name: str              # python/config attribute name
    cgi: str               # URL-api query parameter name
    type: type             # bool / int / float / str
    default: Any
    scope: str             # GLOBAL (gb.conf) or COLL (coll.conf)
    desc: str = ""
    # reference PF_REBUILD/PF_NOSYNC-style flags
    broadcast: bool = True  # sync to cluster on change (0x3f equivalent)


def _p(name, cgi, typ, default, scope, desc="", broadcast=True) -> Parm:
    return Parm(name, cgi, typ, default, scope, desc, broadcast)


#: The parameter table. Kept deliberately small-but-real for round 1; grows
#: alongside features. Reference rows cited per entry.
PARMS: list[Parm] = [
    # --- global (Conf.h / gb.conf) ---
    _p("http_port", "hport", int, 8000, GLOBAL, "HTTP serving port (hosts.conf port column)"),
    _p("max_mem", "maxmem", int, 4 << 30, GLOBAL, "memory budget per instance (Conf::m_maxMem, Mem.cpp:255); enforced by utils.membudget"),
    _p("checkify", "checkify", bool, False, GLOBAL, "on-device checkify guardrails on kernel routes (query.devcheck; OSSE_CHECKIFY=1 equivalent)"),
    _p("num_shards", "nshards", int, 1, GLOBAL, "index shards == mesh size (hosts.conf 'index-splits:')"),
    _p("num_mirrors", "nmirrors", int, 0, GLOBAL, "replicas per shard (hosts.conf 'num-mirrors:', Hostdb.cpp:336)"),
    _p("working_dir", "wdir", str, "./data", GLOBAL, "data directory (hosts.conf 'working-dir:')"),
    _p("autosave_minutes", "autosave", int, 5, GLOBAL, "autosave frequency (Process.cpp:1299)"),
    _p("spider_enabled", "se", bool, True, GLOBAL, "master spider switch (Conf::m_spideringEnabled)"),
    _p("query_max_terms", "qmax", int, 64, GLOBAL, "max query terms (reference ABS_MAX_QUERY_TERMS=9000, Query.h:43; ours is the padded device width)"),
    _p("dns_servers", "dns", str, "", GLOBAL, "DNS resolver ips (Conf dns parms)"),
    _p("master_password", "mpwd", str, "", GLOBAL, "admin master password; empty = open (Conf::m_masterPwds, PageLogin)", broadcast=False),
    _p("ssl_cert", "sslcert", str, "", GLOBAL, "TLS certificate chain path (gb.pem role, TcpServer.cpp SSL) — empty serves plaintext", broadcast=False),
    _p("ssl_key", "sslkey", str, "", GLOBAL, "TLS private key path (empty = key inside ssl_cert)", broadcast=False),
    _p("serve_device", "sdev", bool, True, GLOBAL, "serve /search from the HBM-resident index with micro-batching (SURVEY §7.8 throughput mode)"),
    _p("serve_mesh", "smesh", bool, False, GLOBAL, "sharded instances serve /search through the mesh-resident path: one shard_map program per wave, Msg3a merge + site dedup in-jit (SURVEY §7 stage 4/5)"),
    _p("tenant_hot", "thot", int, 0, GLOBAL, "resident-tenant count bound for the tenancy plane's LRU hot set (serve.tenancy; addColl/delColl CollectionRec scale); 0 = unbounded"),
    _p("device_budget", "devbudget", int, 0, GLOBAL, "soft byte cap on the membudget 'device' label — HBM-resident tenant bases; breach parks cold tenants (membudget.cap_evict); 0 = uncapped"),
    _p("merge_quiet_hours", "mergehours", str, "", GLOBAL, "DailyMerge window (DailyMerge.h:11)"),
    _p("alert_cmd", "alertcmd", str, "", GLOBAL, "command run on host death/recovery with OSSE_ALERT_* env (PingServer.h:77 email/SMS role); empty = log only", broadcast=False),
    _p("trace_sample", "tsample", int, 64, GLOBAL, "head-sample 1 in N query traces (utils.trace, Dapper-style); 1 = every query, 0 = tracing off"),
    _p("slow_query_ms", "slowms", float, 1000.0, GLOBAL, "queries slower than this keep their trace regardless of sampling and land in slowlog.jsonl"),
    _p("shard_cache_ttl", "shcttl", float, 30.0, GLOBAL, "seconds a shard node caches /rpc/search replies (termlist-cache role, RdbCache); generation-invalidated on writes, 0 disables"),
    # --- per-collection (coll.conf / CollectionRec) ---
    _p("docs_wanted", "n", int, 10, COLL, "results per page (SearchInput 'n')"),
    _p("site_cluster", "sc", bool, True, COLL, "max-2-per-site clustering (Msg51/Clusterdb)"),
    _p("dedup_results", "dr", bool, True, COLL, "content-hash dedup of results (Msg40)"),
    _p("spider_max_pages", "maxpages", int, 0, COLL, "crawl page quota (CollectionRec::m_maxToCrawl)"),
    _p("spider_delay_ms", "sdelay", int, 1000, COLL, "same-IP politeness wait (Spider.cpp wait tree)"),
    _p("max_spiders", "maxspiders", int, 8, COLL, "concurrent fetches (Spider.h MAX_SPIDERS)"),
    _p("spider_proxies", "sproxies", str, "", COLL, "comma-separated crawl proxy host:port pool (SpiderProxy.h:27); empty = direct"),
    _p("lang_weight", "langw", float, 20.0, COLL, "same-language score boost (Posdb.cpp SAMELANGMULT)"),
    _p("title_max_len", "tml", int, 80, COLL, "title truncation (Title.cpp)"),
    _p("summary_excerpts", "ns", int, 3, COLL, "summary excerpt count (Summary.h)"),
    _p("pqr_enabled", "pqr", bool, True, COLL, "post-query rerank pass (PostQueryRerank.cpp)"),
    _p("result_cache_ttl", "rcttl", float, 10.0, COLL, "seconds to cache rendered result pages (Msg17/Msg40Cache); 0 disables"),
    _p("result_cache_swr", "rcswr", float, 0.0, COLL, "stale-while-revalidate window after result_cache_ttl expires: serve the stale page and refresh in the background (same generation only); 0 disables"),
    _p("pqr_lang_demote", "pqrlang", float, 0.8, COLL, "foreign-language demotion factor (m_pqr_demFactForeignLanguage)"),
    _p("pqr_site_demote", "pqrsite", float, 0.85, COLL, "per-extra-result same-domain demotion (PQR diversity role)"),
    _p("pqr_depth_demote", "pqrdepth", float, 0.97, COLL, "url path-depth demotion (prefer canonical pages)"),
    _p("autoban_qps", "abqps", int, 0, COLL, "per-IP query rate limit, 0 = off (AutoBan.cpp)"),
    _p("summary_max_len", "sml", int, 180, COLL, "summary length (Summary.h)"),
]

_BY_SCOPE: dict[str, dict[str, Parm]] = {GLOBAL: {}, COLL: {}}
_BY_CGI: dict[str, Parm] = {}
for parm in PARMS:
    _BY_SCOPE[parm.scope][parm.name] = parm
    _BY_CGI[parm.cgi] = parm


class _ParmObject:
    """Dict-backed object whose attributes are defined by the parm table."""

    _scope: str = GLOBAL

    def __init__(self, **overrides: Any):
        self._values: dict[str, Any] = {
            p.name: p.default for p in _BY_SCOPE[self._scope].values()
        }
        self._listeners: list[Callable[[str, Any], None]] = []
        for k, v in overrides.items():
            self.set(k, v)

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        # route parm names through set() so plain assignment can't shadow
        # the registry (conf.num_shards = 8 must behave like set())
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self.set(name, value)

    def set(self, name: str, value: Any, *, _from_sync: bool = False) -> None:
        parm = _BY_SCOPE[self._scope].get(name)
        if parm is None:
            raise KeyError(f"unknown parm {name!r} in scope {self._scope}")
        value = parm.type(value)
        self._values[name] = value
        if not _from_sync:
            for fn in self._listeners:
                fn(name, value)

    def on_update(self, fn: Callable[[str, Any], None]) -> None:
        """Register a live-update listener (the 0x3f broadcast hook)."""
        self._listeners.append(fn)

    def set_from_cgi(self, cgi: str, value: Any) -> None:
        """URL-api update: ``&maxmem=...`` (reference Pages/Parms URL api)."""
        parm = _BY_CGI.get(cgi)
        if parm is None or parm.scope != self._scope:
            raise KeyError(f"unknown cgi parm {cgi!r}")
        if parm.type is bool and isinstance(value, str):
            value = value not in ("0", "false", "False", "")
        self.set(parm.name, value)

    # --- config file round trip (gb.conf / coll.conf equivalent) ---
    def to_dict(self) -> dict[str, Any]:
        return dict(self._values)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self._values, indent=2, sort_keys=True))

    def load(self, path: str | Path) -> None:
        for k, v in json.loads(Path(path).read_text()).items():
            if k in _BY_SCOPE[self._scope]:
                self.set(k, v, _from_sync=True)


class Conf(_ParmObject):
    """Global config (reference ``Conf.h:49``, file ``gb.conf``)."""

    _scope = GLOBAL


class CollectionConf(_ParmObject):
    """Per-collection config (reference ``CollectionRec``, file ``coll.conf``)."""

    _scope = COLL

    def __init__(self, name: str = "main", **overrides: Any):
        super().__init__(**overrides)
        self.__dict__["name"] = name


def parm_table() -> list[Parm]:
    """The full table — used by the admin UI to render parameter pages."""
    return list(PARMS)


def parm(name: str) -> Parm:
    """One parm's table entry by name (any scope)."""
    for scope in _BY_SCOPE.values():
        if name in scope:
            return scope[name]
    raise KeyError(f"unknown parm {name!r}")

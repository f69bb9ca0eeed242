"""Spiderdb: the crawl frontier as an Rdb, durable and sharded.

Port of ``open_source_search_engine_tpu/spider/spiderdb.py`` (reference
``Spider.h:388,468``): SpiderRequests and SpiderReplies in spiderdb,
keyed so that one shard owns all of an IP's URLs (firstIP sharding,
``Hostdb.cpp:~2526``).

A 16-byte key: ``n1 = iphash32 << 32 | urlhash_hi32`` (the hash of the
host's resolved first IP, :mod:`..utils.ipresolve`), ``n0 =
urlhash_lo31 << 2 | type << 1 | delbit``, with a JSON payload for
requests that records the resolved IP (a reload never resolves again).
A REQUEST is written when a URL is queued, a REPLY when its fetch
completed; the frontier is the requests without a reply, found by one
pass over the merged Rdb at open.

Durability: every record is appended to ``addsinprogress.jsonl`` and
fsynced before it is applied (the reference's ``addsinprogress.dat``,
``Msg4.cpp:115``), and replayed at open; :meth:`SpiderDb.checkpoint`
dumps the memtable and truncates the journal once either grows. A kill
-9 loses nothing accepted: the URLs in flight dole again (fetched twice,
never lost).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..index import rdblite
from ..utils import ghash
from ..utils.url import normalize
from .scheduler import SpiderScheduler, UrlFilterRule

KEY_DTYPE = np.dtype([("n0", "<u8"), ("n1", "<u8")], align=False)

TYPE_REQUEST = 0
TYPE_REPLY = 1


def _iphash32(ip: str) -> int:
    return ghash.hash64(ip) & 0xFFFFFFFF


def first_ip_of(url: str, resolver=None) -> str:
    from ..utils import ipresolve
    host = normalize(url).host
    return resolver(host) if resolver is not None \
        else ipresolve.first_ip(host)


def shard_of_url(url: str, n_shards: int, resolver=None) -> int:
    """The shard that owns a URL's frontier entry, routed by first IP:
    one shard owns an IP's whole queue, so per-IP politeness needs no
    cluster locks."""
    return int(ghash.hash64_array(
        np.asarray([_iphash32(first_ip_of(url, resolver))], np.uint64))[0]
        % np.uint64(n_shards))


def urlhash63(url_full: str) -> int:
    """The 63-bit URL identity the key carries losslessly (the seen set
    uses it, so dedup after a restart is exact)."""
    return ghash.hash64(url_full) >> 1


def pack_key(url: str, rec_type: int, first_ip: str | None = None,
             resolver=None) -> np.ndarray:
    u = normalize(url)
    uh = urlhash63(u.full)
    ip = first_ip if first_ip is not None else first_ip_of(url, resolver)
    k = np.zeros((), dtype=KEY_DTYPE)
    k["n1"] = np.uint64((_iphash32(ip) << 32) | (uh >> 31))
    k["n0"] = np.uint64(((uh & 0x7FFFFFFF) << 2)
                        | ((rec_type & 1) << 1) | 1)
    return k


def unpack_keys(keys: np.ndarray):
    return {
        "iphash": (keys["n1"] >> np.uint64(32)).astype(np.uint64),
        "urlhash": (((keys["n1"] & np.uint64(0xFFFFFFFF)) << np.uint64(31))
                    | ((keys["n0"] >> np.uint64(2))
                       & np.uint64(0x7FFFFFFF))),
        "type": ((keys["n0"] >> np.uint64(1)) & np.uint64(1)),
    }


class SpiderDb:
    """The frontier Rdb: requests and replies, loaded in one pass, each
    record journaled (``addsinprogress.jsonl``, fsynced) before it
    applies."""

    def __init__(self, directory: str | Path):
        # journal=False: the jsonl journal below is spiderdb's; the Rdb's
        # own would write every record twice
        self.rdb = rdblite.Rdb("spiderdb", directory, KEY_DTYPE,
                               has_data=True, journal=False)
        self._journal_path = self.rdb.dir / "addsinprogress.jsonl"
        self._replay_journal()
        self._journal = open(self._journal_path, "a",  # noqa: SIM115
                             encoding="utf-8")

    def _replay_journal(self) -> None:
        if not self._journal_path.exists():
            return
        for line in self._journal_path.read_text(
                encoding="utf-8").splitlines():
            try:
                rec = json.loads(line)
                if rec["t"] == TYPE_REPLY:
                    self.add_reply(rec["u"], first_ip=rec.get("ip"),
                                   _journal=False)
                else:
                    self.add_request(rec["u"], rec.get("h", 0),
                                     rec.get("p", 0), rec.get("s", 0),
                                     first_ip=rec.get("ip"),
                                     _journal=False)
            except Exception:  # noqa: BLE001 — a torn tail line
                continue

    def _journal_write(self, rec: dict) -> None:
        self._journal.write(json.dumps(rec) + "\n")
        self._journal.flush()
        os.fsync(self._journal.fileno())

    def add_request(self, url: str, hopcount: int, priority: int,
                    seq: int, first_ip: str | None = None,
                    _journal: bool = True) -> None:
        if _journal:
            self._journal_write({"t": TYPE_REQUEST, "u": url,
                                 "h": hopcount, "p": priority, "s": seq,
                                 "ip": first_ip})
        payload = json.dumps({"u": url, "h": hopcount, "p": priority,
                              "s": seq, "ip": first_ip}).encode()
        self.rdb.add(pack_key(url, TYPE_REQUEST,
                              first_ip=first_ip).reshape(1), [payload])

    def add_reply(self, url: str, first_ip: str | None = None,
                  _journal: bool = True) -> None:
        if _journal:
            self._journal_write({"t": TYPE_REPLY, "u": url,
                                 "ip": first_ip})
        self.rdb.add(pack_key(url, TYPE_REPLY,
                              first_ip=first_ip).reshape(1), [b"{}"])

    def load(self):
        """One merged scan: (pending requests, seen urlhashes). Pending
        means a request with no reply for the same URL."""
        batch = self.rdb.get_all()
        if not len(batch):
            return [], set()
        f = unpack_keys(batch.keys)
        is_req = f["type"] == TYPE_REQUEST
        replied = set(f["urlhash"][~is_req].tolist())
        seen = set(f["urlhash"].tolist())
        pending = []
        for i in np.nonzero(is_req)[0]:
            if int(f["urlhash"][i]) in replied:
                continue
            try:
                pending.append(json.loads(batch.payload(int(i))))
            except Exception:  # noqa: BLE001 — a torn record
                continue
        return pending, seen

    def checkpoint(self) -> None:
        """Bound the journal and the memtable: once the memtable is big
        enough, dump it to a run and truncate the journal (the dumped
        records no longer need it)."""
        if self.rdb.mem.nbytes > self.rdb.max_memtable_bytes // 4 \
                or self._journal.tell() > (8 << 20):
            self.rdb.dump()
            self._journal.seek(0)
            self._journal.truncate()


class DurableSpiderScheduler(SpiderScheduler):
    """A SpiderScheduler whose frontier lives in spiderdb: every accepted
    URL writes a REQUEST, every completed fetch a REPLY, and the
    constructor replays the Rdb, so a restart resumes with the exact
    surviving frontier."""

    def __init__(self, directory: str | Path,
                 filters: list[UrlFilterRule] | None = None,
                 max_hops: int = 3, same_host_only: bool = False,
                 banned=None, resolver=None):
        super().__init__(filters=filters, max_hops=max_hops,
                         same_host_only=same_host_only, banned=banned,
                         resolver=resolver)
        self.db = SpiderDb(directory)
        pending, seen = self.db.load()
        #: URL identities already in spiderdb (the 63-bit key hash)
        self._seen63 = {int(x) for x in seen}
        # replayed in arrival order, so priorities and tie breaks hold;
        # the stored IPs replay as they are
        for rec in sorted(pending, key=lambda r: r.get("s", 0)):
            super().add_url(rec["u"], hopcount=rec.get("h", 0),
                            _ip=rec.get("ip"))

    def add_url(self, url: str, hopcount: int = 0,
                _ip: str | None = None) -> bool:
        try:
            uh = urlhash63(normalize(url).full)
        except Exception:  # noqa: BLE001 — junk URLs abound
            return False
        if uh in self._seen63:
            return False
        ok = super().add_url(url, hopcount=hopcount, _ip=_ip)
        if ok:
            self._seen63.add(uh)
            self.db.add_request(url, hopcount, 0, self.n_added,
                                first_ip=self.last_added_ip)
        return ok

    def mark_done(self, url: str, first_ip: str | None = None) -> None:
        """The SpiderReply write: this URL never doles again."""
        self.db.add_reply(url, first_ip=first_ip)

    def checkpoint(self) -> None:
        self.db.checkpoint()

    def save(self) -> None:  # a Process savable
        self.db.checkpoint()

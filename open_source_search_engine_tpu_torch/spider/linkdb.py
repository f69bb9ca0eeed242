"""Linkdb — the link graph store: site quality and inlink anchor text.

Reference: ``Linkdb.{h,cpp}``: inlink records keyed by linkee site and
url hash (``Linkdb.h:166``), harvested at index time and aggregated by
Msg25 into LinkInfo (``Linkdb.h:424``). The distinct-linker-site count
drives site quality through ``getSiteRank(sni)`` (``Linkdb.cpp:7110``,
:func:`site_rank`), and the inlink *text* is hashed into the linkee's
posdb postings at ``HASHGROUP_INLINKTEXT`` with the linker's siterank in
the wordspamrank slot (``XmlDoc::hashIncomingLinkText``).

Keys: (linkee site hash 32 | linkee url hash 32) in n1, (linker site
hash 32 | linker url hash 31 | delbit) in n0, so the site-level inlink
count and the url-level anchor harvest are single range reads. Payload:
the anchor text and the linker's siterank at link time (JSON).
"""

from __future__ import annotations

import json

import numpy as np

from ..index import rdblite
from ..utils import ghash

KEY_DTYPE = np.dtype([("n0", "<u8"), ("n1", "<u8")], align=False)

#: cap on harvested anchors per linkee (the reference caps LinkInfo)
MAX_INLINKS = 128


def _h32(s: str) -> int:
    return ghash.hash64(s) & 0xFFFFFFFF


def pack_key(linkee_site: str, linkee_url: str, linker_site: str,
             linker_url: str, delbit: int = 1) -> np.ndarray:
    k = np.zeros((), dtype=KEY_DTYPE)
    k["n1"] = np.uint64((_h32(linkee_site) << 32) | _h32(linkee_url))
    k["n0"] = np.uint64((_h32(linker_site) << 32)
                        | ((ghash.hash64(linker_url) & 0x7FFFFFFF) << 1)
                        | (delbit & 1))
    return k


def shard_of_keys(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """Owning shard per record from the key's linkee sitehash32, so a
    rebalance can route records without the site string."""
    site32 = (keys["n1"] >> np.uint64(32)).astype(np.uint64)
    return (ghash.hash64_array(site32)
            % np.uint64(num_shards)).astype(np.int64)


def _range(n1_lo: int, n1_hi: int) -> tuple[np.ndarray, np.ndarray]:
    lo = np.zeros((), dtype=KEY_DTYPE)
    lo["n1"] = np.uint64(n1_lo)
    hi = np.zeros((), dtype=KEY_DTYPE)
    hi["n1"] = np.uint64(n1_hi)
    hi["n0"] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return lo, hi


class Linkdb:
    """Per-collection link graph database."""

    def __init__(self, directory):
        self.rdb = rdblite.Rdb("linkdb", directory, KEY_DTYPE,
                               has_data=True)

    def add_link(self, linkee_site: str, linker_site: str,
                 linker_url: str, linkee_url: str = "",
                 anchor_text: str = "", linker_siterank: int = 0) -> None:
        """Record one (linking page → linked page) edge with its anchor
        text. Internal links (same site) do not count."""
        if linkee_site == linker_site:
            return
        payload = json.dumps(
            {"t": anchor_text[:512], "sr": int(linker_siterank)},
            separators=(",", ":")).encode()
        self.rdb.add(pack_key(linkee_site, linkee_url, linker_site,
                              linker_url).reshape(1), [payload])

    def site_num_inlinks(self, site: str) -> int:
        """Distinct linking sites (Msg25's 'good inlinks' count)."""
        h = _h32(site)
        batch = self.rdb.get_list(*_range(h << 32, (h << 32) | 0xFFFFFFFF))
        if not len(batch):
            return 0
        return int(len(np.unique(batch.keys["n0"] >> np.uint64(32))))

    def inlinks_for_url(self, linkee_site: str, linkee_url: str
                        ) -> list[tuple[str, int]]:
        """[(anchor text, linker siterank)] for one linkee URL, one vote
        per linking site, non-empty anchors only, capped at MAX_INLINKS
        (the LinkInfo harvest that feeds ``hashIncomingLinkText``)."""
        n1 = (_h32(linkee_site) << 32) | _h32(linkee_url)
        batch = self.rdb.get_list(*_range(n1, n1))
        out: list[tuple[str, int]] = []
        seen_sites: set[int] = set()
        for i in range(len(batch)):
            linker_site = int(batch.keys["n0"][i] >> np.uint64(32))
            if linker_site in seen_sites:
                continue
            try:
                rec = json.loads(batch.payload(i))
            except (ValueError, UnicodeDecodeError):
                continue
            if not rec.get("t"):
                continue
            seen_sites.add(linker_site)
            out.append((rec["t"], int(rec.get("sr", 0))))
            if len(out) >= MAX_INLINKS:
                break
        return out

    def save(self) -> None:
        """Checkpoint the memtable (no run is added)."""
        self.rdb.save()


#: siteNumInlinks → siterank step table (Linkdb.cpp:7110-7128)
_SITE_RANK_STEPS = [
    (0, 0), (1, 1), (2, 2), (3, 3), (4, 4), (5, 5), (9, 6), (19, 7),
    (39, 8), (79, 9), (199, 10), (499, 11), (1999, 12), (4999, 13),
    (9999, 14),
]


def site_rank(site_num_inlinks: int) -> int:
    for cap, rank in _SITE_RANK_STEPS:
        if site_num_inlinks <= cap:
            return rank
    return 15

"""Tagdb — per-site metadata tags: manual bans, site boundary overrides,
siterank overrides, and freeform operator tags.

Reference: ``Tagdb.{h,cpp}`` (``Tagdb.h:323``): an Rdb of ``Tag``
records keyed by site hash; ``TagRec`` gathers every tag that applies to
a url by probing progressively wider containers (subdirectory, host,
registrable domain). ``manualban`` bans a site outright,
``sitepathdepth`` widens a site to a host subdirectory
(``SiteGetter.cpp``: user homepages on a hosting domain), ``siterank``
pins site quality.

One record per (site, tag name), newest write wins (a re-set replaces,
a tombstone deletes); the value is a small JSON payload.
"""

from __future__ import annotations

import json
import time

import numpy as np

from ..utils import ghash
from ..utils.url import Url, normalize
from . import rdblite

KEY_DTYPE = np.dtype([("n0", "<u8"), ("n1", "<u8")], align=False)

#: tag names with engine-defined semantics (any other name is a
#: freeform operator annotation, stored and returned verbatim)
TAG_MANUAL_BAN = "manualban"
TAG_SITE_PATH_DEPTH = "sitepathdepth"
TAG_SITE_RANK = "siterank"


def _apply_path_depth(u: Url, depth) -> str:
    """host + first ``depth`` path directories (a trailing filename
    segment never counts, so ``/page.html`` at the root stays on the
    host site)."""
    if not depth or int(depth) <= 0:
        return u.host
    segs = [s for s in u.path.split("/") if s]
    if segs and not u.path.endswith("/"):
        segs = segs[:-1]  # drop the filename
    if len(segs) < int(depth):
        return u.host
    return u.host + "/" + "/".join(segs[: int(depth)]) + "/"


def pack_key(site: str, name: str, delbit: int = 1) -> np.ndarray:
    """n1 = sitehash64 (a site's tags are one range read); n0 =
    taghash32<<32 | delbit, one slot per (site, tag name)."""
    k = np.zeros((), dtype=KEY_DTYPE)
    k["n1"] = np.uint64(ghash.hash64(site))
    k["n0"] = np.uint64(((ghash.hash64(name) & 0xFFFFFFFF) << 32)
                        | (delbit & 1))
    return k


def _site_range(site: str) -> tuple[np.ndarray, np.ndarray]:
    h = np.uint64(ghash.hash64(site))
    lo = np.zeros((), dtype=KEY_DTYPE)
    lo["n1"] = h
    hi = np.zeros((), dtype=KEY_DTYPE)
    hi["n1"] = h
    hi["n0"] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return lo, hi


def _parse(url_or_site: str) -> Url | None:
    try:
        return normalize(url_or_site if "://" in url_or_site
                         else "http://" + url_or_site)
    except ValueError:
        return None


class Tagdb:
    """Per-collection tag database."""

    def __init__(self, directory):
        self.rdb = rdblite.Rdb("tagdb", directory, KEY_DTYPE,
                               has_data=True)
        #: (site, rdb version) → tags: one probe per container site per
        #: indexed doc, and any write moves the version (RdbCache.h:50)
        self._cache: dict[tuple[str, int], dict[str, object]] = {}

    @property
    def empty(self) -> bool:
        """With no tags anywhere every lookup is a no-op; the indexer
        checks this before probing container sites."""
        return not self.rdb.runs and not len(self.rdb.mem)

    # --- writes ---

    def set_tag(self, site: str, name: str, value,
                user: str = "admin") -> None:
        """Set one tag on a site string (host, domain, or a subdirectory
        site like ``host/~user/``)."""
        payload = json.dumps(
            {"n": name, "v": value, "ts": int(time.time()), "u": user},
            separators=(",", ":")).encode()
        self.rdb.add(pack_key(site, name).reshape(1), [payload])

    def remove_tag(self, site: str, name: str) -> None:
        self.rdb.delete(pack_key(site, name, delbit=0).reshape(1))

    # --- reads ---

    def tags_for_site(self, site: str) -> dict[str, object]:
        """All tags set directly on one site string (one range read,
        version-cached)."""
        ck = (site, self.rdb.version)
        hit = self._cache.get(ck)
        if hit is not None:
            return hit
        batch = self.rdb.get_list(*_site_range(site))
        out: dict[str, object] = {}
        for i in range(len(batch)):
            try:
                rec = json.loads(batch.payload(i))
            except (ValueError, UnicodeDecodeError):
                continue
            if "n" in rec:
                out[rec["n"]] = rec["v"]
        if len(self._cache) > 65536:
            self._cache.clear()
        self._cache[ck] = out
        return out

    def _candidate_sites(self, u: Url) -> list[str]:
        """Narrowest-first container sites for a url: subdirectory
        prefixes (deepest first, the exact directory path first when it
        is deeper than the three-level probe cap), host, registrable
        domain."""
        cands: list[str] = []
        segs = [s for s in u.path.split("/") if s]
        if segs and not u.path.endswith("/"):
            segs = segs[:-1]  # directories only, never the filename
        if len(segs) > 3:
            cands.append(u.host + "/" + "/".join(segs) + "/")
        for depth in range(min(len(segs), 3), 0, -1):
            cands.append(u.host + "/" + "/".join(segs[:depth]) + "/")
        cands.append(u.host)
        if u.domain != u.host:
            cands.append(u.domain)
        return cands

    def get_tag(self, url_or_site: str, name: str, default=None):
        """The tag value that applies to a url: the narrowest container
        wins (subdirectory site over host over domain)."""
        u = _parse(url_or_site)
        if u is None:
            return default
        for site in self._candidate_sites(u):
            tags = self.tags_for_site(site)
            if name in tags:
                return tags[name]
        return default

    def tag_rec(self, url_or_site: str) -> dict[str, object]:
        """Every tag applying to a url, narrowest container winning
        (the reference's TagRec)."""
        u = _parse(url_or_site)
        if u is None:
            return {}
        merged: dict[str, object] = {}
        for site in reversed(self._candidate_sites(u)):
            merged.update(self.tags_for_site(site))
        return merged

    # --- engine-defined semantics ---

    def is_banned(self, url_or_site: str) -> bool:
        """``manualban`` on any containing site (XmlDoc indexDoc's
        EDOCBANNED check)."""
        if self.empty:
            return False
        return bool(self.get_tag(url_or_site, TAG_MANUAL_BAN, False))

    def site_of(self, u: Url | str) -> str:
        """Site boundary (SiteGetter.cpp): the host, unless a
        ``sitepathdepth`` tag on the host or domain widens it to host +
        first N path directories."""
        if not isinstance(u, Url):
            parsed = _parse(u)
            if parsed is None:
                return str(u)
            u = parsed
        if self.empty:
            return u.host
        depth = None
        for site in (u.host, u.domain):
            tags = self.tags_for_site(site)
            if TAG_SITE_PATH_DEPTH in tags:
                depth = int(tags[TAG_SITE_PATH_DEPTH])
                break
        return _apply_path_depth(u, depth)

    def index_gate(self, u: Url) -> tuple[bool, str, int | None]:
        """One container walk → (banned, site, siterank override):
        everything ``XmlDoc::indexDoc`` needs from tagdb for one
        document."""
        if self.empty:
            return False, u.host, None
        cands = self._candidate_sites(u)
        per = [self.tags_for_site(s) for s in cands]

        def first(name, only=None):
            for s, t in zip(cands, per):
                if only is not None and s not in only:
                    continue
                if name in t:
                    return t[name]
            return None

        banned = bool(first(TAG_MANUAL_BAN) or False)
        depth = first(TAG_SITE_PATH_DEPTH, only={u.host, u.domain})
        sr = first(TAG_SITE_RANK)
        return (banned, _apply_path_depth(u, depth),
                int(sr) if sr is not None else None)

    def siterank_override(self, url_or_site: str) -> int | None:
        """Operator-pinned siterank (tagdb overrides link-derived site
        quality)."""
        if self.empty:
            return None
        v = self.get_tag(url_or_site, TAG_SITE_RANK)
        return int(v) if v is not None else None

    def save(self) -> None:
        """Checkpoint the memtable (no run is added)."""
        self.rdb.save()

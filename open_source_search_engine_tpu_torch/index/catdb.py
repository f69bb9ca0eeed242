"""Catdb — the directory taxonomy (Catdb.h:27 / dmozparse).

* a **category tree** loaded from ``categories.txt``: one
  ``catid<TAB>parent_catid<TAB>Topic/Path`` line per node (parent 0 =
  root);
* a **site→category Rdb** (dataless keys: sitehash major, catid minor),
  written by :meth:`Catdb.assign`;
* **index-time fields**: documents of an assigned site carry numeric
  ``catid``/``catid_top`` fields and ``category``/``category_top``
  topic-path strings, so ``gbmin:catid:`` restricts and
  ``gbfacet:category`` drills down with the existing operators.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils import ghash
from . import rdblite

#: dataless key: n1 = 48-bit sitehash (major), n0 = catid (minor); the
#: low bit of n0 is the delbit (tombstones annihilate assignments)
KEY_DTYPE = np.dtype([("n0", "<u4"), ("n1", "<u8")], align=False)

SITEHASH_BITS = 48


def _sitehash(site: str) -> int:
    return ghash.hash64(site) & ((1 << SITEHASH_BITS) - 1)


def pack_key(site: str, catid: int, delbit: int = 1) -> np.ndarray:
    out = np.zeros(1, KEY_DTYPE)
    out["n1"] = _sitehash(site)
    out["n0"] = (np.uint32(catid) << np.uint32(1)) | np.uint32(delbit)
    return out


class Catdb:
    def __init__(self, directory: str | Path):
        self.rdb = rdblite.Rdb("catdb", directory, KEY_DTYPE)
        #: catid → (parent, "Topic/Path")
        self.tree: dict[int, tuple[int, str]] = {}
        self._by_path: dict[str, int] = {}
        p = Path(directory) / "catdb" / "categories.txt"
        if p.exists():
            self.load_tree(p.read_text(encoding="utf-8"))

    # --- taxonomy ------------------------------------------------------

    def load_tree(self, text: str) -> int:
        """Parse the taxonomy file; returns the nodes read."""
        n = 0
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                cid, parent, path = line.split("\t", 2)
                self.tree[int(cid)] = (int(parent), path)
                self._by_path[path.lower()] = int(cid)
                n += 1
            except ValueError:
                continue
        return n

    def save_tree(self, directory: str | Path | None = None) -> None:
        base = Path(directory) if directory else self.rdb.dir
        lines = [f"{cid}\t{parent}\t{path}"
                 for cid, (parent, path) in sorted(self.tree.items())]
        (base / "categories.txt").write_text(
            "\n".join(lines) + "\n", encoding="utf-8")

    def catid_of_path(self, path: str) -> int | None:
        return self._by_path.get(path.lower())

    def path_of(self, catid: int) -> str:
        return self.tree.get(catid, (0, ""))[1]

    def ancestors(self, catid: int) -> list[int]:
        """catid and every ancestor up to the root."""
        out = []
        seen = set()
        while catid and catid in self.tree and catid not in seen:
            out.append(catid)
            seen.add(catid)
            catid = self.tree[catid][0]
        return out

    # --- assignments ---------------------------------------------------

    def assign(self, site: str, catid: int) -> None:
        self.rdb.add(pack_key(site, catid))

    def unassign(self, site: str, catid: int) -> None:
        self.rdb.add(pack_key(site, catid, delbit=0))

    def categories_of(self, site: str) -> list[int]:
        """Directly assigned catids of a site (newest wins under
        tombstones)."""
        sh = _sitehash(site)
        lo = np.zeros(1, KEY_DTYPE)
        lo["n1"] = sh
        hi = np.zeros(1, KEY_DTYPE)
        hi["n1"] = sh
        hi["n0"] = 0xFFFFFFFF
        lst = self.rdb.get_list(lo[0], hi[0])
        if not len(lst):
            return []
        n0 = lst.keys["n0"]
        live = (n0 & np.uint32(1)) == 1
        return sorted({int(k) >> 1 for k in n0[live]})

    def doc_fields(self, site: str) -> dict:
        """The fields an indexed document of this site carries: ``catid``
        (the most specific assigned catid), ``catid_top`` (its root
        ancestor, so restricting on a top category catches its subtree),
        and the ``category``/``category_top`` topic paths. One primary
        assignment drives them (fielddb columns are single-valued). Empty
        when the site is unfiled."""
        cids = self.categories_of(site)
        if not cids:
            return {}
        cid = cids[0]
        chain = self.ancestors(cid)
        top = chain[-1] if chain else cid
        out: dict = {"catid": float(cid), "catid_top": float(top)}
        if self.path_of(cid):
            out["category"] = self.path_of(cid)
        if self.path_of(top):
            out["category_top"] = self.path_of(top)
        return out

"""Titledb — docid-keyed store of compressed document records.

Reference: ``Titledb.h:34`` (12-byte docid key + zlib-compressed TitleRec
payload holding the page content and LinkInfo; built by
``XmlDoc::getTitleRecBuf`` ``XmlDoc.cpp:5385``). Ours: a 12-byte
``(n0:u32, n1:u64)`` key — docid in n1 so the sort is docid order, a url
hash in n0 for collision discrimination — and a zlib-compressed JSON
payload (the TitleRec equivalent: url, title, visible text, links, site,
language, timestamp).
"""

from __future__ import annotations

import json
import zlib

import numpy as np

from ..utils.ghash import hash64

KEY_DTYPE = np.dtype([("n0", "<u4"), ("n1", "<u8")], align=False)
assert KEY_DTYPE.itemsize == 12


def pack_key(docid, urlhash32=0, delbit=1) -> np.ndarray:
    """docid-major key: n1 = docid, n0 = urlhash31<<1 | delbit."""
    docid = np.asarray(docid, dtype=np.uint64)
    urlhash32 = np.asarray(urlhash32, dtype=np.uint64)
    delbit_a = np.asarray(delbit, dtype=np.uint32)
    docid, urlhash32, delbit_a = np.broadcast_arrays(docid, urlhash32, delbit_a)
    out = np.empty(docid.shape, dtype=KEY_DTYPE)
    out["n1"] = docid
    out["n0"] = (((urlhash32 & np.uint64(0x7FFFFFFF)) << np.uint64(1))
                 | delbit_a.astype(np.uint64)).astype(np.uint32)
    return out


def unpack_key(keys: np.ndarray) -> dict[str, np.ndarray]:
    return {
        "docid": keys["n1"],
        "urlhash32": (keys["n0"] >> np.uint32(1)).astype(np.uint64),
        "delbit": keys["n0"] & np.uint32(1),
    }


def start_key(docid) -> np.ndarray:
    """The first key a docid (or an array of docids) can hold."""
    k = np.zeros(np.shape(docid), dtype=KEY_DTYPE)
    k["n1"] = np.asarray(docid, np.uint64)
    return k


def end_key(docid) -> np.ndarray:
    """The last key a docid (or an array of docids) can hold."""
    k = start_key(docid)
    k["n0"] = np.uint32(0xFFFFFFFF)
    return k


def make_title_rec(url: str, title: str, text: str, links: list,
                   site: str, langid: int, siterank: int = 0,
                   content_hash: int = 0, ts: float = 0.0,
                   extra: dict | None = None) -> bytes:
    """Serialize + zlib-compress a TitleRec (reference compresses with zlib
    too, ``XmlDoc.cpp:5385``)."""
    rec = {
        "url": url, "title": title, "text": text, "links": links,
        "site": site, "langid": langid, "siterank": siterank,
        "content_hash": content_hash, "ts": ts,
    }
    if extra:
        rec.update(extra)
    # level 1: ~3× faster than 6 for ~10% larger recs — indexing is
    # compute-bound (the reference's niceness-2 build competes for the
    # same cores that serve queries)
    return zlib.compress(json.dumps(rec).encode("utf-8"), level=1)


def read_title_rec(blob: bytes) -> dict:
    return json.loads(zlib.decompress(blob).decode("utf-8"))


def urlhash32(url: str) -> int:
    return hash64(url) & 0x7FFFFFFF

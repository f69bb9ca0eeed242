"""Posdb key codec — the positional-index record format, bit-exact to the
reference's 18-byte key (``Posdb.h:4-50``, ``types.h:431`` ``key144_t``).

An 18-byte key is, in memory (little-endian), ``n0:uint16, n1:uint64,
n2:uint64``; comparison order is ``(n2, n1, n0)``. Fields:

===========  ====  =========================================================
field        bits  position
===========  ====  =========================================================
termId        48   n2[16:64]
docId         38   n2[0:16] = docId>>22,  n1[42:64] = docId&0x3fffff
siterank       4   n1[37:41]
langId(lo5)    5   n1[32:37]          (6th bit lives in n0 bit 3)
wordpos       18   n1[14:32]
hashgroup      4   n1[10:14]          (HASHGROUP_* below)
wordspamrank   4   n1[6:10]
diversityrank  4   n1[2:6]
synonym form   2   n1[0:2]
densityrank    5   n0[11:16]
outlink bit    1   n0[10]
alignment      1   n0[9]              (always 1 on full keys)
shardByTermId  1   n0[8]
multiplier     4   n0[4:8]
langId(hi)     1   n0[3]
compression    2   n0[1:3]            (00 for full 18-byte keys)
delbit         1   n0[0]              (1 = positive, 0 = tombstone)
===========  ====  =========================================================
"""

from __future__ import annotations

import numpy as np

from ..utils.ghash import hash64_array

# field maxima (Posdb.h:62-71)
MAXSITERANK = 0x0F
MAXLANGID = 0x3F
MAXWORDPOS = 0x0003FFFF
MAXDENSITYRANK = 0x1F
MAXWORDSPAMRANK = 0x0F
MAXDIVERSITYRANK = 0x0F
MAXHASHGROUP = 0x0F
MAXMULTIPLIER = 0x0F

# hashgroups (Posdb.h:74-85)
HASHGROUP_BODY = 0
HASHGROUP_TITLE = 1
HASHGROUP_HEADING = 2
HASHGROUP_INLIST = 3
HASHGROUP_INMETATAG = 4
HASHGROUP_INLINKTEXT = 5
HASHGROUP_INTAG = 6
HASHGROUP_NEIGHBORHOOD = 7
HASHGROUP_INTERNALINLINKTEXT = 8
HASHGROUP_INURL = 9
HASHGROUP_INMENU = 10
HASHGROUP_END = 11

# synonym forms (Posdb.h:21-25)
FORM_ORIGINAL = 0
FORM_CONJUGATE = 1
FORM_SYNONYM = 2
FORM_HYPONYM = 3

DOCID_BITS = 38
DOCID_MASK = (1 << DOCID_BITS) - 1
TERMID_BITS = 48
TERMID_MASK = (1 << TERMID_BITS) - 1

KEY_SIZE = 18

#: structured dtype whose byte image == the reference's little-endian key144
KEY_DTYPE = np.dtype([("n0", "<u2"), ("n1", "<u8"), ("n2", "<u8")], align=False)
assert KEY_DTYPE.itemsize == KEY_SIZE


def _u64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


def pack(termid, docid, wordpos=0, densityrank=0,
         diversityrank=MAXDIVERSITYRANK, wordspamrank=MAXWORDSPAMRANK,
         siterank=0, hashgroup=HASHGROUP_BODY, langid=0, multiplier=0,
         synform=FORM_ORIGINAL, outlink=0, shardbytermid=0,
         delbit=1) -> np.ndarray:
    """Vectorized key pack (reference ``Posdb::makeKey``). All args
    broadcast; returns a structured array of :data:`KEY_DTYPE`."""
    termid = _u64(termid) & np.uint64(TERMID_MASK)
    docid = _u64(docid) & np.uint64(DOCID_MASK)
    wordpos, densityrank, diversityrank, wordspamrank = (
        _u64(wordpos), _u64(densityrank), _u64(diversityrank),
        _u64(wordspamrank))
    siterank, hashgroup, langid, multiplier = (
        _u64(siterank), _u64(hashgroup), _u64(langid), _u64(multiplier))
    synform, outlink, shardbytermid, delbit = (
        _u64(synform), _u64(outlink), _u64(shardbytermid), _u64(delbit))
    shape = np.broadcast_shapes(
        termid.shape, docid.shape, wordpos.shape, densityrank.shape,
        diversityrank.shape, wordspamrank.shape, siterank.shape,
        hashgroup.shape, langid.shape, multiplier.shape, synform.shape,
        outlink.shape, shardbytermid.shape, delbit.shape)

    n2 = (termid << np.uint64(16)) | (docid >> np.uint64(22))
    n1 = (
        ((docid & np.uint64(0x3FFFFF)) << np.uint64(42))
        | ((siterank & np.uint64(0xF)) << np.uint64(37))
        | ((langid & np.uint64(0x1F)) << np.uint64(32))
        | ((wordpos & np.uint64(MAXWORDPOS)) << np.uint64(14))
        | ((hashgroup & np.uint64(0xF)) << np.uint64(10))
        | ((wordspamrank & np.uint64(0xF)) << np.uint64(6))
        | ((diversityrank & np.uint64(0xF)) << np.uint64(2))
        | (synform & np.uint64(0x3))
    )
    n0 = (
        ((densityrank & np.uint64(0x1F)) << np.uint64(11))
        | ((outlink & np.uint64(1)) << np.uint64(10))
        | np.uint64(1 << 9)  # alignment bit, always set on full keys
        | ((shardbytermid & np.uint64(1)) << np.uint64(8))
        | ((multiplier & np.uint64(0xF)) << np.uint64(4))
        | (((langid >> np.uint64(5)) & np.uint64(1)) << np.uint64(3))
        | (delbit & np.uint64(1))
    )
    out = np.empty(shape, dtype=KEY_DTYPE)
    out["n0"] = n0.astype(np.uint16)
    out["n1"] = n1
    out["n2"] = n2
    return out


def unpack(keys: np.ndarray) -> dict[str, np.ndarray]:
    """Vectorized inverse of :func:`pack`."""
    n0 = keys["n0"].astype(np.uint64)
    n1 = keys["n1"]
    n2 = keys["n2"]
    return {
        "termid": n2 >> np.uint64(16),
        "docid": ((n2 & np.uint64(0xFFFF)) << np.uint64(22))
        | (n1 >> np.uint64(42)),
        "siterank": (n1 >> np.uint64(37)) & np.uint64(0xF),
        "langid": ((n1 >> np.uint64(32)) & np.uint64(0x1F))
        | (((n0 >> np.uint64(3)) & np.uint64(1)) << np.uint64(5)),
        "wordpos": (n1 >> np.uint64(14)) & np.uint64(MAXWORDPOS),
        "hashgroup": (n1 >> np.uint64(10)) & np.uint64(0xF),
        "wordspamrank": (n1 >> np.uint64(6)) & np.uint64(0xF),
        "diversityrank": (n1 >> np.uint64(2)) & np.uint64(0xF),
        "synform": n1 & np.uint64(0x3),
        "densityrank": (n0 >> np.uint64(11)) & np.uint64(0x1F),
        "outlink": (n0 >> np.uint64(10)) & np.uint64(1),
        "shardbytermid": (n0 >> np.uint64(8)) & np.uint64(1),
        "multiplier": (n0 >> np.uint64(4)) & np.uint64(0xF),
        "delbit": n0 & np.uint64(1),
    }


def to_bytes(keys: np.ndarray) -> bytes:
    """Byte image — identical to the reference's on-disk key bytes."""
    return keys.tobytes()


def start_key(termid: int) -> np.ndarray:
    """First key of a termlist (reference ``Posdb::makeStartKey``)."""
    k = np.zeros((), dtype=KEY_DTYPE)
    k["n2"] = np.uint64((termid & TERMID_MASK) << 16)
    return k


def end_key(termid: int) -> np.ndarray:
    """Last key of a termlist (reference ``Posdb::makeEndKey``)."""
    k = np.zeros((), dtype=KEY_DTYPE)
    k["n2"] = np.uint64(((termid & TERMID_MASK) << 16) | 0xFFFF)
    k["n1"] = np.uint64(0xFFFFFFFFFFFFFFFF)
    k["n0"] = np.uint16(0xFFFF)
    return k


def shard_of_docid(docid, num_shards: int) -> np.ndarray:
    """docId → shard (reference ``Hostdb::getShardNum`` for posdb keys,
    ``Hostdb.cpp:2486-2504``): a stable avalanche hash mod
    ``num_shards``."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return (hash64_array(_u64(docid))
            % np.uint64(num_shards)).astype(np.int32)


def shard_of_termid(termid, num_shards: int) -> np.ndarray:
    """termId → shard for the shardByTermId checksum terms (reference
    ``Hostdb::getShardNumByTermId``, ``Hostdb.cpp:2468``)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return (hash64_array(_u64(termid))
            % np.uint64(num_shards)).astype(np.int32)


def shard_of_keys(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """Owning shard per key: by termid where the shardByTermId bit is
    set, else by docid."""
    f = unpack(keys)
    by_doc = shard_of_docid(f["docid"], num_shards)
    by_term = shard_of_termid(f["termid"], num_shards)
    return np.where(f["shardbytermid"].astype(bool), by_term, by_doc)

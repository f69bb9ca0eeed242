"""64-bit term hashing (reference: ``hash.h`` / ``hash.cpp`` ``hash64``).

FNV-1a-64 with an avalanche finalizer for short keys (words, URLs) and
blake2b for long payloads; word → 64-bit → 48-bit termId, with field
prefixes salted in. Bit-identical to the reference package's hashes, so
both packages index a document to the same posdb keys.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF

TERMID_BITS = 48
TERMID_MASK = (1 << TERMID_BITS) - 1

#: payloads longer than this take the C-speed blake2b path
_LONG_DATA = 1024

_native_hash = None


def _get_native_hash():
    """``native.hash64_native`` (libdoccore's ``osse_hash64``,
    bit-identical, ~10x the Python loop on URL-length keys), imported at
    first use: ``native`` imports this package's utilities. It returns
    None while the library is not built or is switched off, so each call
    decides and a library restored later is used again."""
    global _native_hash
    if _native_hash is None:
        from .. import native
        _native_hash = native.hash64_native
    return _native_hash


def hash64(data: bytes | str, seed: int = 0) -> int:
    """64-bit content hash: FNV-1a + murmur finalizer for short keys,
    blake2b for long payloads."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    if len(data) > _LONG_DATA:
        import hashlib
        h = hashlib.blake2b(data, digest_size=8,
                            key=seed.to_bytes(8, "little") if seed
                            else b"").digest()
        return int.from_bytes(h, "little")
    h = _get_native_hash()(data, seed)
    if h is not None:  # None: no library, the Python loop below
        return h
    h = (_FNV_OFFSET ^ seed) & _MASK64
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK64
    h ^= h >> 33
    return h


@lru_cache(maxsize=1 << 20)
def term_id(word: str, prefix: str | None = None) -> int:
    """48-bit termId for a word, optionally field-prefixed (the prefix
    hash is mixed into the word hash, so ``site:foo.com`` and the body
    word occupy distinct termId spaces)."""
    h = hash64(word.lower())
    if prefix:
        h = hash64(prefix, seed=h)
    return h & TERMID_MASK


@lru_cache(maxsize=1 << 20)
def bigram_id(w1: str, w2: str) -> int:
    """termId of the bigram "w1 w2" (reference ``Phrases.cpp``)."""
    return hash64(w2.lower(), seed=hash64(w1.lower())) & TERMID_MASK


def doc_id(url: str) -> int:
    """38-bit docId from a normalized URL (``Titledb.h``
    ``getProbableDocId``)."""
    return hash64(url) & ((1 << 38) - 1)


def hash64_array(arr: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized 64-bit avalanche over a uint64 array."""
    with np.errstate(over="ignore"):  # modular 2^64 wraparound is the point
        h = arr.astype(np.uint64) ^ np.uint64(seed)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xC4CEB9FE1A85EC53)
        h ^= h >> np.uint64(33)
    return h

"""The native host core: two C++ libraries behind ``ctypes``.

* ``rdbcore.cpp``: the n-way merge of sorted key runs with newest-wins
  dedup and tombstone annihilation (``RdbList.cpp`` ``merge_r``), and a
  binary search over structured keys. ``index/rdblite.py`` rides them.
* ``doccore.cpp``: the HTML tokenizer with its entity table, the term
  hash, the density and spam rank columns, the sections and the bigram
  termids of ``build/tokenizer.py`` and ``build/docproc.py``, as columns
  for one document. A document with an entity outside the native table
  comes back flagged, and the Python tokenizer owns it.

Reference: ``open_source_search_engine_tpu/native/__init__.py``. The
sources are this package's own copies. Each library is built with
``g++`` at first use into ``build/torch_native/`` at the repository
root, named by a hash of its source and flags, so an edit rebuilds. A
build writes a temporary file and ``os.replace``-s it into place, so
concurrent processes never load a half-written library. When ``g++``
fails, a warning is logged and every caller takes its Python path, which
computes the same records.

``OSSE_NATIVE_SAN=1`` builds and loads ASan+UBSan-instrumented
libraries under their own names (``*.san.so``) instead of the optimized
ones. The sanitizer runtimes must then be preloaded into the Python
process (``LD_PRELOAD``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.log import get_logger

log = get_logger("native")

SANITIZE = os.environ.get("OSSE_NATIVE_SAN") == "1"
_SAN_FLAGS = ("-fsanitize=address,undefined", "-fno-omit-frame-pointer",
              "-g", "-O1")

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def _flags(opt: str) -> tuple[str, ...]:
    return (*(_SAN_FLAGS if SANITIZE else (opt,)), "-shared", "-fPIC")


def library_path(name: str, opt: str) -> Path:
    """Where ``<name>.cpp`` built with ``opt`` lives: named by a hash of
    the source and the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(_flags(opt)).encode())
    suffix = ".san.so" if SANITIZE else ".so"
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}{suffix}"


def _build(name: str, opt: str) -> Path | None:
    """Compile ``<name>.cpp`` unless a library built from the same source
    and flags exists; None when ``g++`` fails."""
    so = library_path(name, opt)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp")
    try:
        subprocess.run(["g++", *_flags(opt), str(SRC_DIR / f"{name}.cpp"),
                        "-o", str(tmp)],
                       check=True, capture_output=True, timeout=180)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native %s build failed (Python path in use): %s",
                    name, e)
        tmp.unlink(missing_ok=True)
        return None
    return so


def _load(name: str, opt: str, declare) -> ctypes.CDLL | None:
    """The library ``<name>``, built and loaded at first use (None when
    that failed; the failure is not retried)."""
    lib = _libs.get(name)
    if lib is not None or name in _libs:
        return lib
    with _lock:
        if name in _libs:
            return _libs[name]
        so = _build(name, opt)
        lib = None
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                log.warning("native %s load failed: %s", name, e)
            else:
                declare(lib)
                log.info("lib%s loaded from %s", name, so)
        _libs[name] = lib
        return lib


# --- rdbcore: n-way run merge and key search -----------------------------

def _declare_rdbcore(lib: ctypes.CDLL) -> None:
    lib.osse_merge_runs.restype = ctypes.c_int64
    lib.osse_merge_runs.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    lib.osse_searchsorted_many.restype = None
    lib.osse_searchsorted_many.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]


def get_lib() -> ctypes.CDLL | None:
    """librdbcore, built on first use; None = the numpy path."""
    return _load("rdbcore", "-O3", _declare_rdbcore)


def available() -> bool:
    return get_lib() is not None


def merge_runs(key_arrays: list[np.ndarray],
               keep_tombstones: bool) -> np.ndarray | None:
    """Merge sorted structured-key runs (oldest → newest) natively, or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    key_dtype = key_arrays[0].dtype
    bufs = [np.ascontiguousarray(a) for a in key_arrays]
    if any(b.dtype != key_dtype for b in bufs):
        raise ValueError("merge_runs: runs of different key dtypes")
    out = np.empty(sum(len(b) for b in bufs), dtype=key_dtype)
    runs = (ctypes.c_void_p * len(bufs))(*[b.ctypes.data for b in bufs])
    counts = (ctypes.c_int64 * len(bufs))(*[len(b) for b in bufs])
    n = lib.osse_merge_runs(runs, counts, len(bufs), key_dtype.itemsize,
                            int(keep_tombstones), out.ctypes.data)
    return out[:n].copy()


def searchsorted_many(sorted_keys: np.ndarray, probes: np.ndarray,
                      right: np.ndarray) -> np.ndarray | None:
    """Native binary searches of many probe keys in one call, probe i on
    the right side where ``right[i]``, or None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(sorted_keys)
    p = np.ascontiguousarray(probes)
    if p.dtype != a.dtype:
        raise ValueError("searchsorted_many: probes of the run's key dtype")
    side = np.ascontiguousarray(right, dtype=np.uint8)
    out = np.empty(len(p), np.int64)
    lib.osse_searchsorted_many(a.ctypes.data, len(a), a.dtype.itemsize,
                               p.ctypes.data, len(p), side.ctypes.data,
                               out.ctypes.data)
    return out


# --- doccore: HTML tokenize, term hash and rank columns ------------------

class _OsseDoc(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("termid", ctypes.POINTER(ctypes.c_uint64)),
        ("wordpos", ctypes.POINTER(ctypes.c_int32)),
        ("hashgroup", ctypes.POINTER(ctypes.c_uint8)),
        ("density", ctypes.POINTER(ctypes.c_uint8)),
        ("spam", ctypes.POINTER(ctypes.c_uint8)),
        ("sentence", ctypes.POINTER(ctypes.c_int32)),
        ("sect", ctypes.POINTER(ctypes.c_uint64)),
        ("nb", ctypes.c_int64),
        ("b_termid", ctypes.POINTER(ctypes.c_uint64)),
        ("b_src", ctypes.POINTER(ctypes.c_int32)),
        # POINTER(c_char), not c_char_p: a c_char_p field copies up to
        # the first NUL, and crawled pages carry NULs
        ("words_buf", ctypes.POINTER(ctypes.c_char)),
        ("words_len", ctypes.c_int64),
        ("text_buf", ctypes.POINTER(ctypes.c_char)),
        ("text_len", ctypes.c_int64),
        ("title_buf", ctypes.POINTER(ctypes.c_char)),
        ("title_len", ctypes.c_int64),
        ("desc_buf", ctypes.POINTER(ctypes.c_char)),
        ("desc_len", ctypes.c_int64),
        ("date_buf", ctypes.POINTER(ctypes.c_char)),
        ("date_len", ctypes.c_int64),
        ("links_buf", ctypes.POINTER(ctypes.c_char)),
        ("links_len", ctypes.c_int64),
        ("nsect", ctypes.c_int64),
        ("sect_hash", ctypes.POINTER(ctypes.c_uint64)),
        ("sect_words", ctypes.POINTER(ctypes.c_int32)),
        ("sect_buf", ctypes.POINTER(ctypes.c_char)),
        ("sect_len", ctypes.c_int64),
        ("fallback", ctypes.c_int32),
    ]


def _declare_doccore(lib: ctypes.CDLL) -> None:
    lib.osse_tokenize.restype = ctypes.POINTER(_OsseDoc)
    lib.osse_tokenize.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32]
    lib.osse_doc_free.restype = None
    lib.osse_doc_free.argtypes = [ctypes.POINTER(_OsseDoc)]
    lib.osse_hash64.restype = ctypes.c_uint64
    lib.osse_hash64.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_uint64]


def get_doccore() -> ctypes.CDLL | None:
    """libdoccore, built on first use; None = the Python tokenizer."""
    return _load("doccore", "-O2", _declare_doccore)


class NativeDocCols:
    """The columns of one native tokenize call, as numpy copies (the C
    arena is freed before :func:`tokenize_native` returns)."""

    __slots__ = ("termid", "wordpos", "hashgroup", "density", "spam",
                 "sentence", "sect", "b_termid", "b_src", "words",
                 "text", "title", "desc", "date", "links", "sect_hash",
                 "sect_words", "sect_content")


def _arr(ptr, n: int, dtype) -> np.ndarray:
    """Copy n elements out of a ctypes pointer."""
    if n == 0:
        return np.empty(0, dtype)
    src = np.dtype(ptr._type_)
    a = np.frombuffer(ctypes.string_at(ptr, n * src.itemsize), dtype=src,
                      count=n)
    return a.astype(dtype) if a.dtype != dtype else a.copy()


def _str(ptr, n: int) -> str:
    return ctypes.string_at(ptr, n).decode("utf-8", "replace")


def tokenize_native(content: str, url: str | None,
                    is_html: bool) -> NativeDocCols | None:
    """Tokenize, hash and rank one document natively; None when the
    library is unavailable or the document needs the Python tokenizer
    (an entity outside the native table)."""
    lib = get_doccore()
    if lib is None:
        return None
    cb = content.encode("utf-8", "replace")
    ub = url.encode("utf-8", "replace") if url else b""
    dp = lib.osse_tokenize(cb, len(cb), ub, len(ub), int(is_html))
    try:
        d = dp.contents
        if d.fallback:
            return None
        out = NativeDocCols()
        n = int(d.n)
        out.termid = _arr(d.termid, n, np.uint64)
        out.wordpos = _arr(d.wordpos, n, np.int64)
        out.hashgroup = _arr(d.hashgroup, n, np.uint64)
        out.density = _arr(d.density, n, np.uint64)
        out.spam = _arr(d.spam, n, np.uint64)
        out.sentence = _arr(d.sentence, n, np.int64)
        out.sect = _arr(d.sect, n, np.uint64)
        nb = int(d.nb)
        out.b_termid = _arr(d.b_termid, nb, np.uint64)
        out.b_src = _arr(d.b_src, nb, np.int64)
        words = _str(d.words_buf, d.words_len)
        out.words = words.split("\n") if words else []
        out.text = _str(d.text_buf, d.text_len)
        out.title = _str(d.title_buf, d.title_len)
        out.desc = _str(d.desc_buf, d.desc_len)
        out.date = _str(d.date_buf, d.date_len)
        links = _str(d.links_buf, d.links_len)
        out.links = [(href, anchor) for href, _, anchor in
                     (rec.partition("\x1f") for rec in links.split("\x1e"))
                     ] if links else []
        ns = int(d.nsect)
        out.sect_hash = _arr(d.sect_hash, ns, np.uint64)
        out.sect_words = _arr(d.sect_words, ns, np.int64)
        sb = _str(d.sect_buf, d.sect_len)
        out.sect_content = sb.split("\x1e") if sb else []
        return out
    finally:
        lib.osse_doc_free(dp)


def hash64_native(data: bytes, seed: int = 0) -> int | None:
    """``utils.ghash.hash64`` for short payloads, natively; None when the
    library is unavailable."""
    lib = get_doccore()
    if lib is None:
        return None
    return int(lib.osse_hash64(data, len(data), seed))

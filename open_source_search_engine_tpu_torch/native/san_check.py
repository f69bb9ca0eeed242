"""Sanitizer parity check: the native host core under ASan+UBSan.

A port of the JAX package's ``tools/native_san_check.py``. It builds the
``OSSE_NATIVE_SAN=1`` libraries (``librdbcore_<hash>.san.so``,
``libdoccore_<hash>.san.so``: ``-fsanitize=address,undefined``) and
drives the parity checks of the native tests through them: the merge
and the key search against the numpy path, the tokenizer, termids and
hash against the Python path. A heap overflow, a use after free or
undefined behaviour in ``rdbcore.cpp`` or ``doccore.cpp`` then aborts
the run instead of corrupting an index.

The sanitizer runtimes must be loaded before an uninstrumented Python:
started without them, this script runs itself again with
``LD_PRELOAD`` set to ``libasan.so`` and ``libubsan.so`` (their paths
from ``g++ -print-file-name``) and ``ASAN_OPTIONS=detect_leaks=0``
(CPython keeps interned objects to its exit, which leak mode reports).

Usage::

    python -m open_source_search_engine_tpu_torch.native.san_check

Exit 0: every check clean; 1: a parity check failed; 2: no sanitizer
runtime or no sanitized build.
"""

from __future__ import annotations

import os
import subprocess
import sys


def sanitizer_libs() -> list[str]:
    """The paths of ``libasan.so`` and ``libubsan.so`` that ``g++``
    links against, where both exist."""
    libs = []
    for name in ("libasan.so", "libubsan.so"):
        out = subprocess.run(["g++", f"-print-file-name={name}"],
                             capture_output=True, text=True,
                             check=False).stdout.strip()
        if out and out != name and os.path.exists(out):
            libs.append(out)
    return libs


def _run_under_preload() -> int:
    libs = sanitizer_libs()
    if len(libs) < 2:
        print("san_check: no sanitizer runtimes found (g++ "
              "-print-file-name)", file=sys.stderr)
        return 2
    env = dict(os.environ, LD_PRELOAD=":".join(libs), OSSE_NATIVE_SAN="1")
    env.setdefault("ASAN_OPTIONS", "detect_leaks=0")
    return subprocess.run([sys.executable, "-m", __spec__.name],
                          env=env, check=False).returncode


def _checks() -> int:
    import numpy as np

    from .. import native
    from ..build import tokenizer
    from ..index import posdb, rdblite
    from ..utils import ghash

    if not native.SANITIZE:
        print("san_check: OSSE_NATIVE_SAN=1 not honoured at import",
              file=sys.stderr)
        return 2
    if native.get_lib() is None or native.get_doccore() is None:
        print("san_check: a sanitized build failed", file=sys.stderr)
        return 2

    def random_run(n, seed):
        r = np.random.default_rng(seed)
        keys = posdb.pack(
            termid=r.integers(0, 60, n), docid=r.integers(0, 300, n),
            wordpos=r.integers(0, 2000, n),
            delbit=(r.random(n) > 0.25).astype(int))
        return keys[rdblite.key_sort_order(keys)]

    checks = 0
    rng = np.random.default_rng(7)
    runs = [random_run(int(rng.integers(50, 600)), s) for s in range(5)]
    for keep in (False, True):
        nat = native.merge_runs(runs, keep)
        all_keys = np.concatenate(runs)
        recency = np.concatenate(
            [np.full(len(r), i, np.int64) for i, r in enumerate(runs)])
        ref = all_keys[rdblite._dedup_newest(all_keys, recency, keep)]
        if nat.tobytes() != ref.tobytes():
            print(f"san_check: merge parity (keep={keep})", file=sys.stderr)
            return 1
        checks += 1

    keys, probes = random_run(800, 99), random_run(64, 100)
    for side in ("left", "right"):
        nat = rdblite.searchsorted_keys(keys, probes, side)
        available, native.available = native.available, lambda: False
        try:
            ref = rdblite.searchsorted_keys(keys, probes, side)
        finally:
            native.available = available
        if not np.array_equal(nat, ref):
            print(f"san_check: searchsorted parity ({side})",
                  file=sys.stderr)
            return 1
        checks += 1

    html = ("<html><head><title>Sanitizer parity</title>"
            "<meta name=\"description\" content=\"asan ubsan\"></head>"
            "<body><h1>Heading words</h1><p>Body text with "
            "<a href=\"http://example.com/x\">anchor text</a> and "
            "repeated repeated terms.</p>"
            "<script>ignored()</script></body></html>")
    url = "http://example.com/parity"
    nat_doc = tokenizer.tokenize_html(html, url)
    doccore, native.get_doccore = native.get_doccore, lambda: None
    try:
        py = tokenizer.tokenize_html(html, url)
        tids = [ghash.term_id(w) for w in nat_doc.words]
    finally:
        native.get_doccore = doccore
    if nat_doc.native is None or any(
            getattr(py, f) != getattr(nat_doc, f)
            for f in ("words", "wordpos", "hashgroups", "sentence_ids",
                      "section_ids", "links", "text")) \
            or tids != nat_doc.native.termid.tolist():
        print("san_check: tokenizer parity", file=sys.stderr)
        return 1
    checks += 1
    # hash64 takes blake2b above 1 KiB: the native hash is the short-key
    # function only; the expected value is the Python loop's, with the
    # library switched off
    blobs = (b"", b"a", b"hello world", b"ab\x00cd", bytes(range(256)) * 4)
    doccore, native.get_doccore = native.get_doccore, lambda: None
    try:
        want = [ghash.hash64(blob) for blob in blobs]
    finally:
        native.get_doccore = doccore
    for blob, h in zip(blobs, want):
        if native.hash64_native(blob) != h:
            print(f"san_check: hash64 parity ({blob[:8]!r})",
                  file=sys.stderr)
            return 1
    checks += 1
    print(f"san_check: OK ({checks} parity checks clean under ASan+UBSan)")
    return 0


def main() -> int:
    if "libasan" not in os.environ.get("LD_PRELOAD", ""):
        return _run_under_preload()
    return _checks()


if __name__ == "__main__":
    sys.exit(main())

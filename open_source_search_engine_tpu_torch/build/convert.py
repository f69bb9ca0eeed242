"""Document converters: pdf, doc and ps to indexable text.

Port of ``open_source_search_engine_tpu/build/convert.py`` (reference
``XmlDoc.cpp:19206-19227``, which shells to ``pdftohtml``, ``antiword``
and ``pstotext`` under a timeout and indexes the text):

* an external converter runs when its binary is on ``PATH``, under a
  subprocess timeout, its output capped, the content on stdin (no shell,
  no temporary file names);
* PDFs also have a built-in minimal extractor (uncompressed and Flate
  content streams, the Tj and TJ show-text operators), so the pdf path
  works where no poppler is installed.

:func:`convert_to_text` is the one entry point; the spider indexes its
result with ``is_html=False``.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import zlib

from ..utils.log import get_logger

log = get_logger("convert")

CONVERT_TIMEOUT_S = 20.0
MAX_TEXT_BYTES = 2 << 20

#: content type -> kind, and file extension -> kind
_KINDS = {
    "application/pdf": "pdf",
    "application/msword": "doc",
    "application/postscript": "ps",
}
_EXT_KINDS = {".pdf": "pdf", ".doc": "doc", ".ps": "ps", ".eps": "ps"}


def kind_of(content_type: str, url: str = "") -> str | None:
    k = _KINDS.get((content_type or "").split(";")[0].strip().lower())
    if k:
        return k
    low = url.lower().split("?")[0]
    for ext, kk in _EXT_KINDS.items():
        if low.endswith(ext):
            return kk
    return None


def is_convertible(content_type: str, url: str = "") -> bool:
    return kind_of(content_type, url) is not None


def _run_tool(argv: list[str], data: bytes) -> str | None:
    """One converter subprocess, stdin to stdout under a timeout and an
    output cap; None on any failure (missing binary, crash, timeout)."""
    if shutil.which(argv[0]) is None:
        return None
    try:
        p = subprocess.run(argv, input=data, capture_output=True,
                           timeout=CONVERT_TIMEOUT_S)
        if p.returncode != 0:
            return None
        return p.stdout[:MAX_TEXT_BYTES].decode("utf-8", "replace")
    except Exception as e:  # noqa: BLE001 — converter faults are data
        log.warning("converter %s failed: %s", argv[0], e)
        return None


# --- the built-in minimal PDF text extractor ---------------------------

_PDF_STREAM_RE = re.compile(
    rb"<<(.*?)>>\s*stream\r?\n(.*?)\r?\nendstream", re.DOTALL)
_PDF_TEXT_OP_RE = re.compile(
    rb"\((?P<s>(?:\\.|[^()\\])*)\)\s*Tj"
    rb"|\[(?P<a>(?:\\.|[^\]\\])*)\]\s*TJ"
    rb"|(?P<nl>T\*|TD|Td|TL)", re.DOTALL)
_PDF_ARRAY_STR_RE = re.compile(rb"\((?:\\.|[^()\\])*\)", re.DOTALL)
_PDF_ESC_RE = re.compile(rb"\\([nrtbf()\\]|[0-7]{1,3})")
_PDF_ESCAPES = {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b",
                b"f": b"\f", b"(": b"(", b")": b")", b"\\": b"\\"}


def _pdf_unescape(raw: bytes) -> bytes:
    def sub(m):
        e = m.group(1)
        if e.isdigit():
            return bytes([int(e, 8) & 0xFF])
        return _PDF_ESCAPES.get(e, e)
    return _PDF_ESC_RE.sub(sub, raw)


def pdf_text_builtin(data: bytes) -> str:
    """The show-text operators of the (optionally Flate-compressed)
    content streams: plain text PDFs; CID fonts and hex strings need the
    external tool."""
    parts: list[bytes] = []
    for m in _PDF_STREAM_RE.finditer(data):
        head, body = m.group(1), m.group(2)
        if b"FlateDecode" in head:
            try:
                body = zlib.decompress(body)
            except zlib.error:
                continue
        elif b"Filter" in head:
            continue  # other encodings are the external tool's
        for tm in _PDF_TEXT_OP_RE.finditer(body):
            if tm.group("nl") is not None:
                parts.append(b"\n")
            elif tm.group("s") is not None:
                parts.append(_pdf_unescape(tm.group("s")))
            else:
                for sm in _PDF_ARRAY_STR_RE.finditer(tm.group("a")):
                    parts.append(_pdf_unescape(sm.group(0)[1:-1]))
        parts.append(b"\n")
        if sum(map(len, parts)) > MAX_TEXT_BYTES:
            break
    text = b"".join(parts).decode("latin-1", "replace")
    return re.sub(r"[ \t]+", " ", text).strip()


def convert_to_text(data: bytes, content_type: str = "",
                    url: str = "") -> str | None:
    """Binary document bytes to plain text; None when the kind is not
    convertible or its converter is missing and the built-in failed."""
    kind = kind_of(content_type, url)
    if kind is None:
        return None
    if kind == "pdf":
        out = _run_tool(["pdftotext", "-q", "-", "-"], data)
        if out is None:
            out = pdf_text_builtin(data) or None
        return out
    if kind == "doc":
        # catdoc reads stdin; antiword does in some builds
        return _run_tool(["catdoc", "-"], data) \
            or _run_tool(["antiword", "-"], data)
    if kind == "ps":
        return _run_tool(["pstotext", "-"], data) \
            or _run_tool(["ps2ascii"], data)
    return None

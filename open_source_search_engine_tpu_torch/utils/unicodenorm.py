"""Unicode normalization (the ``UCNormalizer.cpp`` role): NFC at the
tokenizer and query seams, so composed and decomposed forms index as
one term. ASCII text skips the normalizer.

Also the crawler's charset names (the ``iana_charset.cpp`` role):
:data:`CHARSET_ALIASES` maps web spellings Python's codec registry does
not know, and :func:`resolve_charset` turns a declared charset into a
codec name or None."""

from __future__ import annotations

import codecs
import unicodedata


def nfc(text: str) -> str:
    if not text or text.isascii():
        return text
    return unicodedata.normalize("NFC", text)


#: IANA and web spellings of charsets that Python's codecs do not know by
#: that name (the registry covers the decoders themselves)
CHARSET_ALIASES = {
    "x-sjis": "shift_jis",
    "x-euc-jp": "euc_jp",
    "iso-8859-8-i": "iso-8859-8",
    "unicode-1-1-utf-8": "utf-8",
    "unicode": "utf-16",
    "ks_c_5601-1987": "cp949",
    "ks_c_5601": "cp949",
    "macintosh": "mac_roman",
    "x-mac-roman": "mac_roman",
    "iso-latin-1": "latin-1",
    "8859-1": "latin-1",
    "win-1251": "cp1251",
    "windows-874": "cp874",
    "x-gbk": "gbk",
    "gb_2312-80": "gb2312",
    "ansi": "cp1252",
    "none": "utf-8",
}


def resolve_charset(name: str | None) -> str | None:
    """A codec name for a declared charset, or None when neither the
    alias table nor the codec registry knows it (the caller then decodes
    as utf-8 with replacement)."""
    if not name:
        return None
    cand = CHARSET_ALIASES.get(name.strip().lower(), name)
    try:
        codecs.lookup(cand)
        return cand
    except LookupError:
        return None

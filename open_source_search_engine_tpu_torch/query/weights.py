"""Scoring weight tables — faithful to the reference's ``initWeights``
(``Posdb.cpp:1105-1197``) and scoring constants (``Posdb.h:94-117``).

Every weight is applied *squared* in single-term scoring and once per
side in pair scoring, so tables hold the raw (unsquared) values. The
scalar constants are Python floats, so mixing them with float32 tensors
keeps float32. The per-hashgroup tables are float32 and padded to the
16 values a 4-bit hashgroup field can hold by repeating the last entry
(an out-of-range hashgroup reads as HASHGROUP_INMENU, the clamped
lookup); the CUDA kernel carries the same padded tables.
"""

from __future__ import annotations

import numpy as np

from ..index.posdb import (
    HASHGROUP_BODY, HASHGROUP_END, HASHGROUP_HEADING, HASHGROUP_INLINKTEXT,
    HASHGROUP_INLIST, HASHGROUP_INMENU, HASHGROUP_INMETATAG, HASHGROUP_INTAG,
    HASHGROUP_INTERNALINLINKTEXT, HASHGROUP_INURL, HASHGROUP_NEIGHBORHOOD,
    HASHGROUP_TITLE,
)

# scoring constants (Posdb.h:94-117, 765, 817)
SYNONYM_WEIGHT = 0.90
SITERANKMULTIPLIER = 0.33333333
FIXED_DISTANCE = 400.0
MAX_TOP = 10
#: default same-language boost (Parms.cpp "language weight" m_def 20.0)
SAME_LANG_WEIGHT = 20.0
#: pairs of non-body positions >50 apart get FIXED_DISTANCE
NONBODY_DIST_CAP = 50.0
#: every position/pair score starts at 100 (Posdb.cpp:3118)
BASE_SCORE = 100.0

#: padded table width: every value of the 4-bit hashgroup field
HG_TABLE = 16


def _pad(table: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [table, np.repeat(table[-1:], HG_TABLE - len(table))])


def _hash_group_weights() -> np.ndarray:
    w = np.zeros(HASHGROUP_END, dtype=np.float32)
    w[HASHGROUP_BODY] = 1.0
    w[HASHGROUP_TITLE] = 8.0
    w[HASHGROUP_HEADING] = 1.5
    w[HASHGROUP_INLIST] = 0.3
    w[HASHGROUP_INMETATAG] = 0.1
    w[HASHGROUP_INLINKTEXT] = 16.0
    w[HASHGROUP_INTAG] = 1.0
    w[HASHGROUP_NEIGHBORHOOD] = 0.0
    w[HASHGROUP_INTERNALINLINKTEXT] = 4.0
    w[HASHGROUP_INURL] = 1.0
    w[HASHGROUP_INMENU] = 0.2
    return _pad(w)


def _in_body() -> np.ndarray:
    # body-ish hashgroups (Posdb.cpp:1142-1148)
    b = np.zeros(HASHGROUP_END, dtype=bool)
    for hg in (HASHGROUP_BODY, HASHGROUP_HEADING, HASHGROUP_INLIST,
               HASHGROUP_INMENU):
        b[hg] = True
    return _pad(b)


#: density weight per densityrank 0..31: min(0.35·1.03445^rank, 1)
#: (Posdb.cpp:1117-1125), each entry exactly the float32 value the
#: reference package's closed form min(0.35·exp(rank·log 1.03445), 1)
#: yields on its CPU backend. A table, not exp(): float32 exp
#: implementations differ in the last bit, and the scores must not.
DENSITY_WEIGHTS = np.array([
    0.3499999940395355, 0.36205750703811646, 0.3745303750038147,
    0.38743293285369873, 0.4007800221443176, 0.4145868718624115,
    0.42886942625045776, 0.4436439573764801, 0.4589274823665619,
    0.4747375249862671, 0.4910922646522522, 0.5080103874206543,
    0.5255113244056702, 0.5436152219772339, 0.5623427033424377,
    0.58171546459198, 0.6017555594444275, 0.6224860548973083,
    0.6439306735992432, 0.666114091873169, 0.6890617609024048,
    0.7127999067306519, 0.7373558282852173, 0.7627577781677246,
    0.7890347242355347, 0.8162170052528381, 0.8443357348442078,
    0.8734230399131775, 0.9035124778747559, 0.9346385598182678,
    0.9668368697166443, 1.0], dtype=np.float32)

HASH_GROUP_WEIGHTS = _hash_group_weights()
IN_BODY = _in_body()


def _impact_density_weights() -> np.ndarray:
    # the reference's initWeights loop: 0.35, times 1.03445 per rank in
    # float64, clamped at 1.0 (Posdb.cpp:1117-1125)
    w = np.zeros(len(DENSITY_WEIGHTS), dtype=np.float32)
    s = 0.35
    for i in range(len(w)):
        w[i] = min(s, 1.0)
        s *= 1.03445
    return w


#: the build-time impact bounds (``devindex._posscore_np``) weigh
#: density with the running-product table, as the reference's build does;
#: it differs from DENSITY_WEIGHTS in the last bit at 10 of 32 ranks, and
#: the resident impact columns must match the reference's bit for bit
IMPACT_DENSITY_WEIGHTS = _impact_density_weights()
#: (i+1)/16 per word-spam rank (Posdb.cpp:1128-1129)
WORD_SPAM_WEIGHTS = ((np.arange(16) + 1.0) / 16).astype(np.float32)
#: sqrt(1+i): the inlink-text spam field holds the linker's siterank
#: (Posdb.cpp:1136-1137)
LINKER_WEIGHTS = np.sqrt(1.0 + np.arange(16)).astype(np.float32)

#: mapped hashgroup for single-term dedup: body-ish groups collapse to
#: BODY (Posdb.cpp:3126-3127 "if s_inBody[mhg] mhg = HASHGROUP_BODY")
MAPPED_HASHGROUP = np.where(
    IN_BODY, HASHGROUP_BODY, np.arange(HG_TABLE)).astype(np.int64)


def term_freq_weight(term_freq, num_docs) -> np.ndarray:
    """IDF-ish weight in [0.5, 1.0]: 0.5 + min(tf/N, 0.5)
    (``getTermFreqWeight`` ``Posdb.cpp:1225-1252`` — *inverted* because
    the min-algorithm needs common terms to score higher)."""
    tf = np.asarray(term_freq, dtype=np.float32)
    n = max(float(num_docs), 1.0)
    return (0.5 + np.minimum(tf / n, 0.5)).astype(np.float32)

"""Query packer — termlists → padded, statically shaped arrays.

Reference seam: ``Msg2::getLists`` (one RdbList per query term,
``Msg2.cpp:30``) feeding ``PosdbTable::setQueryTermInfo`` /
``intersectLists10_r`` (``Posdb.cpp:4354,5437``). The packer:

1. fetches each group's sublists from posdb and concatenates them (the
   mini-merge, done columnarly up front);
2. picks the **driver**: the required group with the fewest unique
   docids — only its docids can match an AND query, so the candidate doc
   axis ``D`` is bounded by the driver list;
3. maps every other list onto the candidate axis with ``searchsorted``;
4. emits arrays padded to power-of-two buckets: per (group, candidate
   doc) up to ``P`` positions with a packed uint32 payload (wordpos |
   hashgroup | density | spam | syn).

Docid-range multipass (``Msg39.cpp:277-305``): callers cap ``max_docs``
and the engine runs one pass per candidate slice.

The numeric operators (``gbmin:``/``gbmax:``/``gbsortby:``) read the
fielddb columns on the host: a boolean range mask and a positive sort
key per candidate, formed in float64 and cast to float32 once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index import posdb
from ..index.collection import Collection
from ..utils import trace
from ..utils.membudget import g_membudget
from . import weights
from .compiler import SUB_SYNONYM, QueryPlan

#: max positions kept per (group, doc)
MAX_POSITIONS = 16

# packed payload bit layout (uint32)
_POS_SHIFT = 0          # wordpos: 18 bits
_HG_SHIFT = 18          # hashgroup: 4 bits
_DEN_SHIFT = 22         # densityrank: 5 bits
_SPAM_SHIFT = 27        # wordspamrank: 4 bits
_SYN_SHIFT = 31         # synonym-ish (scored with SYNONYM_WEIGHT): 1 bit


def pack_payload(f: dict[str, np.ndarray], syn: int = 0) -> np.ndarray:
    """Unpacked posdb fields → the scorer's uint32 payload (the single
    definition of the bit layout; ``min_scores_kernel._decode`` is its
    inverse)."""
    return (
        f["wordpos"].astype(np.uint32) << np.uint32(_POS_SHIFT)
        | f["hashgroup"].astype(np.uint32) << np.uint32(_HG_SHIFT)
        | f["densityrank"].astype(np.uint32) << np.uint32(_DEN_SHIFT)
        | f["wordspamrank"].astype(np.uint32) << np.uint32(_SPAM_SHIFT)
        | np.uint32(syn) << np.uint32(_SYN_SHIFT)
    )


#: resident impacts are stored scaled by 1/IMPACT_SCALE (an exact
#: power-of-two exponent shift): inlink-heavy docs can push the raw
#: bound past float16's 65504 maximum, and an inf in the dense rows
#: would turn the phase-1 selector product's zero lanes into NaN.
#: Consumers multiply back after the float32 cast.
IMPACT_SCALE = 16.0


def demote_impacts(a: np.ndarray) -> np.ndarray:
    """float32 per-(term, doc) impact bounds → float16 at 1/IMPACT_SCALE,
    rounded UP. Impacts are phase-1 upper bounds, so rounding must never
    go down: a nearest-rounding cast that landed low is nudged up one
    ulp. The 1e-30 presence floor would underflow to 0.0 and erase the
    posting from the intersection mask, so it lands on the smallest
    float16 subnormal."""
    s = a * np.float32(1.0 / IMPACT_SCALE)
    h = s.astype(np.float16)
    low = h.astype(np.float32) < s
    h = np.where(low, np.nextafter(h, np.float16(np.inf)), h)
    return np.maximum(h, np.finfo(np.float16).smallest_subnormal)


def _bucket(n: int, floor: int = 8) -> int:
    """Next power of two ≥ n (≥ floor)."""
    b = floor
    while b < n:
        b <<= 1
    return b


#: shape-bucket floors: term groups, postings per group, candidate docs
T_FLOOR = 4
L_FLOOR = 512
D_FLOOR = 256

#: truth-table size: boolean tables pad to 2^10 = MAX_BOOL_TERMS
#: entries; non-boolean queries carry the all-true table
TABLE_SIZE = 1 << 10


def pad_table(table: np.ndarray | None) -> np.ndarray:
    out = np.ones(TABLE_SIZE, bool)
    if table is not None:
        out[:] = False
        out[: len(table)] = table
    return out


@dataclass
class PackedQuery:
    """Everything the scorer consumes, as numpy arrays.

    Shapes: T groups × L postings (× D docs × P positions after the
    scatter)."""

    doc_idx: np.ndarray       # int32 [T, L]; D_pad = padding (dropped)
    payload: np.ndarray       # uint32 [T, L]
    slot: np.ndarray          # int32 [T, L]
    valid: np.ndarray         # bool [T, L]
    freq_weight: np.ndarray   # float32 [T]
    required: np.ndarray      # bool [T]
    negative: np.ndarray      # bool [T]
    scored: np.ndarray        # bool [T]
    counts: np.ndarray        # bool [T] groups entering the min-score
    table: np.ndarray         # bool [TABLE_SIZE] boolean truth table
    cand_docids: np.ndarray   # uint64 [D] (actual candidates; D_pad ≥ D)
    siterank: np.ndarray      # int32 [D_pad]
    doclang: np.ndarray       # int32 [D_pad]
    n_docs: int               # real candidate count (≤ D_pad)
    qlang: int
    #: numeric-operator columns (gbmin/gbmax/gbsortby): the range mask
    #: and the positive sort keys over the candidate axis; None when the
    #: query has no such operator
    filt: np.ndarray | None = None      # bool [D_pad]
    sortc: np.ndarray | None = None     # float32 [D_pad]


@dataclass
class GroupList:
    """One group's fetched and merged postings (columnar)."""

    docids: np.ndarray     # uint64, sorted
    payload: np.ndarray    # uint32, parallel
    siterank: np.ndarray   # int32, parallel
    langid: np.ndarray     # int32, parallel
    sub: np.ndarray        # int32, parallel: originating sublist index
    n_subs: int = 1
    #: max distinct-doc count over the group's sublists — THE group df
    group_df: int = 0
    #: per-sublist distinct-doc counts (slot_plan's variant funding)
    sub_df: np.ndarray | None = None


def fetch_group_lists(coll: Collection, plan: QueryPlan) -> list[GroupList]:
    """Msg2 equivalent: fetch every group's sublists and mini-merge."""
    out = []
    for g in plan.groups:
        cols = {"docids": [], "payload": [], "siterank": [], "langid": [],
                "sub": []}
        sub_dfs = [0]
        per_sub_df = np.zeros(max(len(g.sublists), 1), np.int64)
        for s_i, sub in enumerate(g.sublists):
            batch = coll.termlist_cache.get(sub.termid, coll.posdb.version)
            if batch is None:
                batch = coll.posdb.get_list(posdb.start_key(sub.termid),
                                            posdb.end_key(sub.termid))
                coll.termlist_cache.put(sub.termid, coll.posdb.version,
                                        batch)
            if not len(batch):
                continue
            f = posdb.unpack(batch.keys)
            payload = pack_payload(
                f, syn=1 if sub.kind == SUB_SYNONYM else 0)
            # postings arrive docid-ascending within the term, so the
            # distinct-doc count is a boundary count
            d_ = f["docid"]
            sub_dfs.append(int((d_[1:] != d_[:-1]).sum()) + 1)
            per_sub_df[s_i] = sub_dfs[-1]
            cols["docids"].append(d_)
            cols["payload"].append(payload)
            cols["siterank"].append(f["siterank"].astype(np.int32))
            cols["langid"].append(f["langid"].astype(np.int32))
            cols["sub"].append(np.full(len(batch), s_i, np.int32))
        if cols["docids"]:
            docids = np.concatenate(cols["docids"])
            # stable sort by docid: within a doc, postings stay
            # sublist-major, so (doc, sublist) runs are contiguous
            order = np.argsort(docids, kind="stable")
            out.append(GroupList(
                docids=docids[order],
                payload=np.concatenate(cols["payload"])[order],
                siterank=np.concatenate(cols["siterank"])[order],
                langid=np.concatenate(cols["langid"])[order],
                sub=np.concatenate(cols["sub"])[order],
                n_subs=max(len(g.sublists), 1),
                group_df=max(sub_dfs), sub_df=per_sub_df))
        else:
            out.append(GroupList(
                docids=np.empty(0, np.uint64),
                payload=np.empty(0, np.uint32),
                siterank=np.empty(0, np.int32),
                langid=np.empty(0, np.int32),
                sub=np.empty(0, np.int32),
                n_subs=max(len(g.sublists), 1), sub_df=per_sub_df))
    return out


def _pad1(a: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad a 1-D per-group array out to the T bucket."""
    if len(a) >= n:
        return a
    out = np.full(n, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


@dataclass
class PreparedQuery:
    """Fetch+intersect product, computed ONCE per query: multipass
    slices ``cand`` without re-reading the Rdb."""

    plan: QueryPlan
    lists: list[GroupList]
    cand: np.ndarray          # uint64, candidate docids (sorted; may be 0)
    driver: int               # -1 when cand is empty
    freq_weight: np.ndarray   # float32 [len(plan.groups)]
    unique_counts: np.ndarray  # int64 [len(plan.groups)]
    #: per-candidate numeric-operator arrays, None without the operators
    filt_all: np.ndarray | None = None
    sort_all: np.ndarray | None = None


def group_flags(plan: QueryPlan, T: int):
    """(required, negative, scored, counts) bool arrays padded to the T
    bucket. ``counts`` marks the groups whose scores enter the min:
    scored∧required normally, every scored group under a boolean plan."""
    boolean = plan.bool_table is not None
    return (
        _pad1(np.array([g.required and not g.negative
                        for g in plan.groups]), T, False),
        _pad1(np.array([g.negative for g in plan.groups]), T, False),
        _pad1(np.array([g.scored and not g.negative
                        for g in plan.groups]), T, False),
        _pad1(np.array([g.scored and not g.negative
                        and (boolean or g.required)
                        for g in plan.groups]), T, False),
    )


def _field_values(coll: Collection, fld: str,
                  cand: np.ndarray) -> np.ndarray:
    """Per-candidate float64 field values (NaN = the doc lacks the
    field) from the fielddb column."""
    docids, vals = coll.fielddb.column(fld)
    out = np.full(len(cand), np.nan)
    if len(docids):
        pos = np.searchsorted(docids, cand)
        ok = pos < len(docids)
        ok[ok] = docids[pos[ok]] == cand[ok]
        out[ok] = vals[pos[ok]]
    return out


def local_sort_base(coll: Collection, fld: str,
                    desc: bool) -> float | None:
    """This collection's minimum finite sort key (v descending, -v
    ascending): the shift that keeps the float32 keys positive and small
    (epoch seconds lose whole seconds in float32). None without a finite
    value."""
    _, allvals = coll.fielddb.column(fld)
    av = allvals if desc else -allvals
    fin = np.isfinite(av)
    return float(av[fin].min()) if fin.any() else None


def field_arrays(coll: Collection, plan: QueryPlan, cand: np.ndarray,
                 sort_base: float | None = None):
    """(filt, sortc) candidate arrays for the numeric operators: the AND
    of every field's range (NaN fails both bounds) and the sort key
    ``key - base + 1`` (0.25 for a missing field; ``base`` is
    ``sort_base``, the cross-shard minimum on the sharded paths, else
    the collection's minimum key), formed in float64 and cast to
    float32 once."""
    filt = sortc = None
    if plan.filters:
        filt = np.ones(len(cand), bool)
        for fld, (lo, hi) in plan.filters.items():
            dv = _field_values(coll, fld, cand)
            with np.errstate(invalid="ignore"):
                filt &= (dv >= lo) & (dv <= hi)
    if plan.sortby is not None:
        fld, desc = plan.sortby
        dv = _field_values(coll, fld, cand)
        key = dv if desc else -dv
        base = sort_base if sort_base is not None \
            else local_sort_base(coll, fld, desc)
        if base is None:
            base = 0.0  # no finite values anywhere: every key is 0.25
        sortc = np.where(np.isfinite(key), key - base + 1.0,
                         0.25).astype(np.float32)
    return filt, sortc


def prepare_query(coll: Collection, plan: QueryPlan,
                  sort_base: float | None = None) -> PreparedQuery:
    """Fetch termlists, pick the driver, intersect candidates. ``cand``
    comes back empty when no doc can match (an empty required list), but
    the fetched lists are kept: cluster-wide term frequencies count a
    shard's postings even where it has no candidate. ``sort_base``: see
    :func:`field_arrays`."""
    lists = fetch_group_lists(coll, plan)
    req = [i for i, g in enumerate(plan.groups)
           if g.required and not g.negative]
    # candidate sets: required groups only in conjunctive mode; every
    # group under a boolean plan (the union is the candidate space)
    need_uniq = (range(len(lists)) if plan.bool_table is not None
                 else req)
    uniques = {i: np.unique(lists[i].docids) for i in need_uniq}
    unique_counts = np.array([gl.group_df for gl in lists], dtype=np.int64)
    freqw = weights.term_freq_weight(unique_counts, max(coll.num_docs, 1))

    if plan.bool_table is not None:
        cand = (np.unique(np.concatenate(
            [uniques[i] for i in range(len(lists))]))
            if lists and any(len(u) for u in uniques.values())
            else np.empty(0, np.uint64))
        driver = (max(range(len(lists)), key=lambda i: len(uniques[i]))
                  if lists else -1)
        fa, sa = field_arrays(coll, plan, cand, sort_base=sort_base)
        return PreparedQuery(plan=plan, lists=lists, cand=cand,
                             driver=driver if len(cand) else -1,
                             freq_weight=freqw, unique_counts=unique_counts,
                             filt_all=fa, sort_all=sa)

    if not req or any(not len(uniques[i]) for i in req):
        return PreparedQuery(plan=plan, lists=lists,
                             cand=np.empty(0, np.uint64), driver=-1,
                             freq_weight=freqw, unique_counts=unique_counts)

    driver = min(req, key=lambda i: len(uniques[i]))
    cand = uniques[driver]
    for i in req:
        if i != driver and len(cand):
            cand = cand[np.isin(cand, uniques[i], assume_unique=True)]
    fa, sa = field_arrays(coll, plan, cand, sort_base=sort_base)
    return PreparedQuery(plan=plan, lists=lists, cand=cand, driver=driver,
                         freq_weight=freqw, unique_counts=unique_counts,
                         filt_all=fa, sort_all=sa)


def pack_pass(prep: PreparedQuery, doc_offset: int = 0,
              max_docs: int | None = None,
              max_positions: int = MAX_POSITIONS,
              budget_shrink: bool = False) -> PackedQuery | None:
    """The PackedQuery for one docid-range pass over the prepared
    candidates (slice [doc_offset : doc_offset+max_docs]); None when the
    slice is empty.

    The padded staging arrays are reserved against the process memory
    budget under the ``pack`` label. With ``budget_shrink=True`` a
    refused pass halves its doc slice until it fits or one doc is left,
    so callers advance by the returned ``PackedQuery.n_docs``, not by
    their stride. Without it a refusal is only counted and the pass goes
    on (single-pass callers that cannot slice again)."""
    plan, lists = prep.plan, prep.lists
    if max_docs is not None:
        cand = prep.cand[doc_offset:doc_offset + max_docs]
    else:
        cand = prep.cand[doc_offset:]
    if not len(cand):
        return None
    T = _bucket(len(plan.groups), T_FLOOR)
    required, negative, scored, counts = group_flags(plan, T)
    D = len(cand)
    D_pad = _bucket(D, D_FLOOR)

    per_group = []
    max_kept = 1
    for g_i, gl in enumerate(lists):
        if not len(gl.docids):
            per_group.append((np.empty(0, np.int32),
                              np.empty(0, np.uint32),
                              np.empty(0, np.int32)))
            continue
        pos_in_cand = np.clip(np.searchsorted(cand, gl.docids), 0, D - 1)
        hit = cand[pos_in_cand] == gl.docids
        didx = pos_in_cand[hit].astype(np.int32)
        payload = gl.payload[hit]
        sub = gl.sub[hit]
        # per-sublist slot quotas within each doc (TermGroup.slot_plan:
        # the primary word keeps ≥ half the budget, variants split the
        # rest); quotas only over sublists with postings
        if len(didx):
            have = np.zeros(len(plan.groups[g_i].sublists), bool)
            have[np.unique(gl.sub)] = True
            sp = plan.groups[g_i].slot_plan(
                max_positions, present=list(have),
                df=None if gl.sub_df is None
                else [int(x) for x in gl.sub_df])
            bases = np.array([b for b, _ in sp], np.int32)
            quotas = np.array([q for _, q in sp], np.int32)
            n = len(didx)
            boundary = np.ones(n, bool)
            boundary[1:] = (didx[1:] != didx[:-1]) | (sub[1:] != sub[:-1])
            idx = np.arange(n)
            rank = idx - np.maximum.accumulate(np.where(boundary, idx, 0))
            slot = (bases[sub] + rank).astype(np.int32)
            keep = (rank < quotas[sub]) & (slot < max_positions)
            didx, payload, slot = didx[keep], payload[keep], slot[keep]
            max_kept = max(max_kept, len(didx))
        else:
            slot = np.empty(0, np.int32)
        per_group.append((didx, payload, slot))

    L = _bucket(max_kept, L_FLOOR)
    # the padded [T, L] staging planes and the [D_pad] sidecars are the
    # pass's working set
    est = T * L * 13 + D_pad * 13
    granted = g_membudget.reserve("pack", est)
    if not granted and budget_shrink and D > 1:
        trace.tag(budget_shrunk=True)
        return pack_pass(prep, doc_offset, max(D // 2, 1), max_positions,
                         budget_shrink)
    try:
        trace.tag(T=int(T), L=int(L), D=int(D), bytes=int(est))
        return _pack_arrays(prep, cand, doc_offset, per_group, required,
                            negative, scored, counts, T, D, D_pad, L)
    finally:
        if granted:
            g_membudget.release("pack", est)


def _pack_arrays(prep, cand, doc_offset, per_group, required, negative,
                 scored, counts, T, D, D_pad, L):
    plan, lists = prep.plan, prep.lists
    doc_idx = np.full((T, L), D_pad, dtype=np.int32)  # D_pad = drop row
    payload = np.zeros((T, L), dtype=np.uint32)
    slot = np.zeros((T, L), dtype=np.int32)
    valid = np.zeros((T, L), dtype=bool)
    for t, (didx, pl, sl) in enumerate(per_group):
        n = len(didx)
        doc_idx[t, :n] = didx
        payload[t, :n] = pl
        slot[t, :n] = sl
        valid[t, :n] = True

    # per-candidate siterank/langid from the first posting of a group
    # containing the doc (getSiteRank(miniMergedList[0]),
    # Posdb.cpp:6989); under a boolean plan walk groups until every doc
    # is filled
    siterank = np.zeros(D_pad, dtype=np.int32)
    doclang = np.zeros(D_pad, dtype=np.int32)
    filled = np.zeros(D, dtype=bool)
    order = [prep.driver] + [i for i in range(len(lists))
                             if i != prep.driver]
    for g_i in order:
        gl = lists[g_i]
        if not len(gl.docids) or filled.all():
            continue
        first = np.clip(np.searchsorted(gl.docids, cand), 0,
                        len(gl.docids) - 1)
        hit = (gl.docids[first] == cand) & ~filled
        siterank[:D][hit] = gl.siterank[first[hit]]
        doclang[:D][hit] = gl.langid[first[hit]]
        filled |= hit
        if plan.bool_table is None:
            break  # driver covers every candidate in conjunctive mode
    filt = sortc = None
    if prep.filt_all is not None:
        filt = np.zeros(D_pad, bool)
        filt[:D] = prep.filt_all[doc_offset:doc_offset + D]
    if prep.sort_all is not None:
        sortc = np.zeros(D_pad, np.float32)
        sortc[:D] = prep.sort_all[doc_offset:doc_offset + D]
    return PackedQuery(
        doc_idx=doc_idx, payload=payload, slot=slot, valid=valid,
        freq_weight=_pad1(prep.freq_weight, T, 0.5),
        required=required, negative=negative, scored=scored,
        counts=counts, table=pad_table(plan.bool_table),
        cand_docids=cand, siterank=siterank, doclang=doclang,
        n_docs=D, qlang=plan.lang, filt=filt, sortc=sortc)

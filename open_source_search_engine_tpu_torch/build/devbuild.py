"""Device ingest plane — the posting merge, dedup and derive on the card.

Port of ``open_source_search_engine_tpu/build/devbuild.py``. The
reference's ``RdbDump``/``RdbMerge``/``Msg5`` stages (sorted runs,
N-way merge with newest-wins dedup and +/- annihilation) and the
``DeviceIndex`` column derivation run as torch code on the collection's
device, so a base build ships the runs' key words once and derives
every column where it will live:

1. **merge** (:func:`_base_program`): the runs' key words are
   concatenated on the host (nothing is sorted there) and sorted on the
   device by (key without the delete bit ascending, recency descending):
   successive stable sorts, least significant key first, as
   ``jnp.lexsort`` orders them, so ties resolve like
   ``rdblite._dedup_newest``. The first row of each key survives;
   surviving tombstones annihilate.
2. **docidx**: distinct docids rank by a second sort (the
   ``np.unique``/``searchsorted`` collapse).
3. **derive** (:func:`_derive`, shared with the delta fold): occurrence
   ranks (a cummax scan), the ``occ < P`` store cap, run starts, the
   term directory, packed payload and docc columns, and the exact
   per-(term, doc) impact bounds.

Bit-exactness contract: every output column is bitwise equal to the
host pipeline of ``query/devindex.py`` (``_build_base``/``_build_delta``,
the oracle) and to the reference's ``devbuild``.

* *Unsigned order.* torch has no ``>>``, ``+`` or ``max`` on uint32, and
  an int32 view orders words of 2^31 and above wrongly. The 64-bit key
  words ride as int64 with the sign bit flipped (``x ^ 2^63``), which
  orders them as unsigned; every field is extracted by a shift and a
  mask in int64; the rank key of a float is its bits as an int64 below
  2^32.
* *Scatters.* Integer sums go through ``index_add_`` (exact in any
  order), maxima and minima through ``scatter_reduce_`` ("amax",
  "amin"). The float impact sum is never a scatter-add: each pair's
  candidate scores are placed in unique ``[pair, position]`` slots and
  folded left to right with ``MAX_POSITIONS`` explicit float32 adds, the
  order of NumPy's ``add.reduceat`` (x + 0.0 is exact for x ≥ +0.0, so
  the interleaved zeros change nothing). A float scatter-add on the card
  sums in no fixed order.
* *Exact lengths.* The reference pads to power-of-two buckets so that
  XLA does not retrace; eager torch runs at the exact row count, and
  :func:`fit` zero-extends each column to the capacity its consumer
  holds (columns are zero past their counters).

These are tensor programs, not kernels: no Pallas kernel of the
reference runs here.

Telemetry: with devwatch on, a build's output columns register in the
HBM ledger as ``("(ingest)", "build")`` until the DeviceIndex that
consumes them drops the slice; the uploads report to jitwatch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..index import posdb
from ..query import weights
from ..query.packer import IMPACT_SCALE, MAX_POSITIONS
from ..utils import devwatch, jitwatch, trace
from ..utils.stats import g_stats

P = MAX_POSITIONS

#: int64 sign bit: ``x ^ _SIGN`` orders 64-bit words as unsigned
_SIGN = -(1 << 63)

#: mapped hashgroups per pair slot (the impact ranker's composite key)
_MHG_SPAN = int(weights.MAPPED_HASHGROUP.max()) + 1


def enabled() -> bool:
    """``OSSE_DEVBUILD`` gates the device ingest plane (on by default);
    the host NumPy pipeline stays as the oracle and as the path this
    switch selects when it is ``0``."""
    return os.environ.get("OSSE_DEVBUILD", "1") != "0"


# ---------------------------------------------------------------------------
# scan and sort helpers
# ---------------------------------------------------------------------------


def _neq_prev(*cols: torch.Tensor) -> torch.Tensor:
    """"Differs from the previous row" over parallel columns; row 0 is
    always True."""
    out = torch.zeros(cols[0].shape[0], dtype=torch.bool,
                      device=cols[0].device)
    out[:1] = True
    for c in cols:
        out[1:] |= c[1:] != c[:-1]
    return out


def _seg_pos(start_flags: torch.Tensor) -> torch.Tensor:
    """Position of each row within its segment (segments start where
    ``start_flags`` holds): the running-max scan of ``_occ_ranks``."""
    idx = torch.arange(start_flags.shape[0], device=start_flags.device)
    return idx - torch.cummax(torch.where(start_flags, idx, 0), dim=0)[0]


def _lex_order(*keys: torch.Tensor) -> torch.Tensor:
    """The permutation ``jnp.lexsort(keys)`` gives: the last key is the
    primary one; successive stable sorts, least significant first."""
    perm = None
    for k in keys:
        kk = k if perm is None else k[perm]
        o = torch.sort(kk, stable=True)[1]
        perm = o if perm is None else perm[o]
    return perm


def _count(m: torch.Tensor) -> int:
    return int(m.sum())


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """An int64 holding a uint32 value → the same 32 bits as int32 (the
    port's view of uint32 columns)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


# ---------------------------------------------------------------------------
# field math (bitwise ports of pack_payload / _posscore_np /
# demote_impacts)
# ---------------------------------------------------------------------------


def _table(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _posscore(hg, den, spam):
    """BASE · posw² per posting, with the table gathers and the multiply
    association of ``devindex._posscore_np`` (float32 throughout)."""
    dev = hg.device
    hgw = _table(weights.HASH_GROUP_WEIGHTS, dev)[hg]
    denw = _table(weights.IMPACT_DENSITY_WEIGHTS, dev)[den]
    is_il = hg == posdb.HASHGROUP_INLINKTEXT
    spamw = torch.where(is_il, _table(weights.LINKER_WEIGHTS, dev)[spam],
                        _table(weights.WORD_SPAM_WEIGHTS, dev)[spam])
    posw = hgw * denw * spamw
    base = torch.tensor(weights.BASE_SCORE, dtype=torch.float32, device=dev)
    return base * posw * posw, is_il


def _demote(a: torch.Tensor) -> torch.Tensor:
    """``packer.demote_impacts`` on the device: float32 → float16 at
    1/IMPACT_SCALE, rounded to nearest and then up one ulp where that
    landed low (the next float16 above a positive finite one is its bits
    + 1), floored at the smallest subnormal (bits 1) so that the 1e-30
    presence floor never becomes 0."""
    s = a * torch.tensor(1.0 / IMPACT_SCALE, dtype=torch.float32,
                         device=a.device)
    h = s.to(torch.float16)
    bits = h.view(torch.int16)
    bits = torch.where(h.to(torch.float32) < s, bits + 1, bits)
    return torch.clamp_min(bits, 1).view(torch.float16)


# ---------------------------------------------------------------------------
# the shared derive stage: sorted (term, doc) rows → columns
# ---------------------------------------------------------------------------


def _derive(tid, docidx, hg, den, spam, wp, sr, lg) -> dict:
    """Everything downstream of the sort, shared by base and delta:
    occurrence ranks, the store cap, run boundaries, the term directory,
    packed payload/docc and the exact impact bounds. Rows (int64 fields)
    must be sorted by (termid, docidx[, wordpos])."""
    dev = tid.device
    i32, f32 = torch.int32, torch.float32

    # pre-cap boundaries: term change, (term, doc) pair change
    tch0 = _neq_prev(tid)
    np0 = tch0 | _neq_prev(docidx)
    occ = _seg_pos(np0)
    # df before the store cap (the Msg36 termfreq precompute): distinct
    # (term, doc) pairs per term, an exact integer sum
    trank0 = torch.cumsum(tch0, 0) - 1
    n_terms = _count(tch0)
    df = torch.zeros(n_terms, dtype=torch.int64, device=dev).index_add_(
        0, trank0, np0.to(torch.int64))
    dir_tid = tid[tch0]

    # store cap: scoring reads at most P positions per pair
    keep = occ < P
    tid, docidx, hg, den, spam, wp, sr, lg, occ = (
        c[keep] for c in (tid, docidx, hg, den, spam, wp, sr, lg, occ))
    nk = tid.shape[0]
    idx = torch.arange(nk, device=dev)

    payload = _u32_bits(wp | (hg << 18) | (den << 22) | (spam << 27))
    docc = _u32_bits((docidx << 4) | occ)

    # doc-level runs: one entry per (term, doc) pair
    tch = _neq_prev(tid)
    newpair = tch | _neq_prev(docidx)
    pair_id = torch.cumsum(newpair, 0) - 1
    n_pairs = _count(newpair)
    runstart = idx[newpair]
    count = torch.zeros(n_pairs, dtype=torch.int64, device=dev).index_add_(
        0, pair_id, torch.ones_like(pair_id))
    dir_dstart = pair_id[tch]
    dir_pstart = idx[tch]

    # exact impacts: per pair, the top MAX_TOP of {per-mapped-hashgroup
    # position maxima} ∪ {every inlink-text occurrence}, summed
    ps, il = _posscore(hg, den, spam)
    mhg = _table(weights.MAPPED_HASHGROUP, dev).to(torch.int64)[hg]
    o = torch.sort(pair_id * _MHG_SPAN + mhg, stable=True)[1]
    ps_o, il_o, mh_o, pid_o = ps[o], il[o], mhg[o], pair_id[o]
    gch = _neq_prev(pid_o, mh_o)
    gid = torch.cumsum(gch, 0) - 1
    gmax = torch.zeros(_count(gch), dtype=f32, device=dev).scatter_reduce_(
        0, gid, ps_o, "amax")
    cand = il_o | gch
    cval = torch.where(il_o, ps_o, gmax[gid])
    pch = _neq_prev(pid_o)
    # rank candidates within each pair by descending cval: for float32
    # x ≥ 0 the order of x is the order of its bits, so the key is
    # 2^32 - 1 - bits, as the reference's ~bitcast
    ckey = (2 ** 32 - 1) - (cval.view(i32).to(torch.int64) & 0xFFFFFFFF)
    o3 = _lex_order(ckey, (~cand).to(torch.int64), pid_o)
    rank = torch.empty_like(o3)
    rank[o3] = _seg_pos(_neq_prev(pid_o[o3]))
    contrib = torch.where(cand & (rank < weights.MAX_TOP), cval, 0.0)
    # pair sums folded left to right like np.add.reduceat: row q of a
    # pair lands in slot [pair, q], then P sequential adds
    q = _seg_pos(pch)
    slots = torch.zeros(n_pairs * P, dtype=f32, device=dev)
    slots[pid_o * P + q] = contrib
    slots = slots.view(n_pairs, P)
    acc = torch.zeros(n_pairs, dtype=f32, device=dev)
    for j in range(P):
        acc = acc + slots[:, j]
    imp32 = torch.maximum(acc, torch.tensor(1e-30, dtype=f32, device=dev))

    return dict(
        payload=payload, docc=docc, docidx=docidx,
        siterank=sr.to(torch.uint8), langid=lg.to(torch.uint8),
        doc_col=docidx[newpair].to(i32), imp32=imp32,
        imp16=_demote(imp32), rs=runstart.to(i32),
        cnt=torch.clamp_max(count, P).to(torch.uint8),
        dir_tid=dir_tid, df=df, dir_dstart=dir_dstart,
        dir_pstart=dir_pstart, n=nk, n_pairs=n_pairs)


# ---------------------------------------------------------------------------
# base program: N-way run merge + annihilation + docidx + derive
# ---------------------------------------------------------------------------


def _base_program(n0, n1, n2, rec) -> dict | None:
    """Full base build from the concatenated runs' key words (int64:
    ``n0`` the 16-bit word, ``n1``/``n2`` the 64-bit words' bits, ``rec``
    the run index, oldest first). None when nothing survives."""
    # RdbMerge/Msg5: newest-wins dedup + tombstone annihilation, sorted
    # by (n2, n1, n0 without the delete bit, newest first)
    n0c = n0 & ~1
    order = _lex_order((n0c << 31) | (0x7FFFFFFF - rec), n1 ^ _SIGN,
                       n2 ^ _SIGN)
    n0, n0c, n1, n2 = n0[order], n0c[order], n1[order], n2[order]
    keep = _neq_prev(n0c, n1, n2) & ((n0 & 1) == 1)
    n0, n1, n2 = n0[keep], n1[keep], n2[keep]
    if n0.shape[0] == 0:
        return None

    # posdb.unpack on int64 words: shift, then mask off what an
    # arithmetic shift drags in
    tid = (n2 >> 16) & ((1 << 48) - 1)
    docid = ((n2 & 0xFFFF) << 22) | ((n1 >> 42) & 0x3FFFFF)
    sr = (n1 >> 37) & 0xF
    lg = ((n1 >> 32) & 0x1F) | (((n0 >> 3) & 1) << 5)
    wp = (n1 >> 14) & posdb.MAXWORDPOS
    hg = (n1 >> 10) & 0xF
    spam = (n1 >> 6) & 0xF
    den = (n0 >> 11) & 0x1F

    # docidx: rank of each distinct docid
    base_docids, docidx = torch.unique(docid, sorted=True,
                                       return_inverse=True)
    out = _derive(tid, docidx, hg, den, spam, wp, sr, lg)
    out["base_docids"] = base_docids
    return out


def _delta_program(tid, docidx, hg, den, spam, wp, sr, lg) -> dict:
    """Delta fold: the memtable positives sorted by (termid, docidx,
    wordpos) — new docs' indexes are not docid-monotonic, the host
    path's key — then the shared derive stage."""
    o = _lex_order((docidx << 18) | wp, tid)
    return _derive(*(c[o] for c in (tid, docidx, hg, den, spam, wp, sr,
                                    lg)))


# ---------------------------------------------------------------------------
# host-facing results
# ---------------------------------------------------------------------------


@dataclass
class DeviceBuild:
    """One derive-stage result: the directory tables fetched to the host
    (the host pipeline's dtypes), the heavy columns still on the
    device."""

    n: int                    # stored postings (after the store cap)
    n_pairs: int              # (term, doc) pairs
    dir_termids: np.ndarray   # uint64 [T]
    df: np.ndarray            # int64 [T] distinct docs per term (pre-cap)
    dir_dstart: np.ndarray    # int64 [T+1]
    dir_pstart: np.ndarray    # int64 [T+1]
    cols: dict                # device columns, exact lengths
    # base only (None for delta folds):
    base_docids: np.ndarray | None = None   # uint64 [Db]
    h_doc_col: np.ndarray | None = None     # int32 [n_pairs]


def fit(col: torch.Tensor, size: int) -> torch.Tensor:
    """A derived column cut or zero-extended to a capacity (columns are
    zero past their counters, the host ``_pad_col`` convention)."""
    n = col.shape[0]
    if n >= size:
        return col[:size]
    return torch.cat([col, col.new_zeros(size - n)])


def _fetch_dir(out: dict) -> dict:
    """Directory tables → host, in the host pipeline's dtypes."""
    with trace.span("devbuild.fetch"):
        nk, n_pairs = out["n"], out["n_pairs"]
        return dict(
            dir_termids=out["dir_tid"].cpu().numpy().astype(np.uint64),
            df=out["df"].cpu().numpy(),
            dir_dstart=np.r_[out["dir_dstart"].cpu().numpy(),
                             n_pairs].astype(np.int64),
            dir_pstart=np.r_[out["dir_pstart"].cpu().numpy(),
                             nk].astype(np.int64))


def _upload(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if jitwatch.g_jitwatch.enabled:
        jitwatch.note_transfer("_upload", "h2d", a.nbytes)
    return torch.from_numpy(a).to(device)


def _note_staging(out: dict) -> None:
    """The build's output columns in the HBM ledger (transient: the
    DeviceIndex drops the slice once it holds the columns)."""
    if devwatch.enabled():
        devwatch.note_columns("(ingest)", "build", {
            k: v for k, v in out.items() if isinstance(v, torch.Tensor)})


def build_base(run_keys: list[np.ndarray], device) -> DeviceBuild | None:
    """Merge and derive the base columns from the runs' key arrays
    (oldest → newest, the ``merge_batches`` recency order) on
    ``device``. None when the merged base is empty."""
    if sum(len(k) for k in run_keys) == 0:
        return None
    # plain concatenation is the only host work: every ordering runs on
    # the device
    with trace.span("devbuild.stage"):
        n0 = np.concatenate([k["n0"] for k in run_keys]).astype(np.int64)
        n1 = np.concatenate([k["n1"] for k in run_keys]).view(np.int64)
        n2 = np.concatenate([k["n2"] for k in run_keys]).view(np.int64)
        rec = np.concatenate([np.full(len(k), i, np.int64)
                              for i, k in enumerate(run_keys)])
    with trace.span("devbuild.upload"):
        words = [_upload(a, device) for a in (n0, n1, n2, rec)]
        sync_stream(device)
    with trace.span("devbuild.base"):
        out = _base_program(*words)
        sync_stream(device)
    del words
    if out is None:
        return None
    dirs = _fetch_dir(out)
    with trace.span("devbuild.fetch"):
        base_docids = out.pop("base_docids").cpu().numpy().astype(np.uint64)
        h_doc = out["doc_col"].cpu().numpy()
    g_stats.count("build.device_base")
    _note_staging(out)
    return DeviceBuild(n=out["n"], n_pairs=out["n_pairs"], cols=out,
                       base_docids=base_docids, h_doc_col=h_doc, **dirs)


def build_delta(fp_: dict, docidx: np.ndarray, device) -> DeviceBuild | None:
    """Sort and derive the delta tail from the memtable positives (fields
    unpacked, docidx already assigned against the base docid directory:
    the O(memtable) host prep stays on the host)."""
    if len(docidx) == 0:
        return None
    cols = [_upload(np.asarray(a).astype(np.int64), device) for a in (
        fp_["termid"], docidx, fp_["hashgroup"], fp_["densityrank"],
        fp_["wordspamrank"], fp_["wordpos"], fp_["siterank"],
        fp_["langid"])]
    out = _delta_program(*cols)
    dirs = _fetch_dir(out)
    g_stats.count("build.device_delta")
    _note_staging(out)
    return DeviceBuild(n=out["n"], n_pairs=out["n_pairs"], cols=out,
                       **dirs)


def doc_meta(sr_tab: torch.Tensor, dl_tab: torch.Tensor,
             dv: DeviceBuild) -> tuple[torch.Tensor, torch.Tensor]:
    """First-posting-per-doc siterank/langid (the reference's
    ``getSiteRank(miniMergedList[0])``) applied onto ``[D_cap]`` tables:
    zeros for a base build, the resident tables for a delta fold; docs
    with no rows keep their entry."""
    docidx = dv.cols["docidx"]
    n, D = docidx.shape[0], sr_tab.shape[0]
    firstrow = torch.full((D,), n, dtype=torch.int64,
                          device=docidx.device).scatter_reduce_(
        0, docidx, torch.arange(n, device=docidx.device), "amin")
    has = firstrow < n
    g = firstrow.clamp(max=max(n - 1, 0))
    return (torch.where(has, dv.cols["siterank"][g], sr_tab),
            torch.where(has, dv.cols["langid"][g], dl_tab))


def offset_runstarts(dv: DeviceBuild, offset: int, size: int
                     ) -> torch.Tensor:
    """Delta run starts rebased onto the combined column ``[Nb, Nb +
    n2)``, pad rows kept zero (the host ``rs2 = Nb + runstart2``)."""
    return fit(dv.cols["rs"] + offset, size)


def sync_stream(device) -> None:
    """Wait for this thread's stream on ``device`` (so that a stage's
    span holds its device time); a no-op on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()

"""Device-resident index: the shard's postings, per-(term, doc) impact
bounds and the heaviest terms' position cubes live on the device, and
the host only plans.

Port of ``open_source_search_engine_tpu/query/devindex.py`` (host build
oracle, plan, and the three query routes, with the lossless escalation):

* **F1** (``_run_batch``, the reference's ``_two_phase``): phase 1 adds
  the dense ``[V, D]`` impact rows (one selector product) and the sparse
  runs (one scatter-add) into per-group upper bounds over the whole doc
  axis, intersects, and keeps the top κ candidates by bound
  (``_block_topn``); phase 2 gathers the candidates' real postings into a
  ``[T, P, κ]`` cube and scores it exactly with the min-score chain (K1
  on the card).
* **F2** (``_run_batch_f2``, ``_full_cube``): corpus-wide drivers score
  the whole doc axis: the materialized cube rows are sliced in, the rest
  scattered at posting granularity, and K1 scores ``[T, P, D]``.
* **FD** (``_run_batch_fd``, ``_direct_cube``): when every group's cube
  runs are quarter-aligned, K2 (``fd_scores_kernel``) assembles the
  groups' planes straight from the resident cube's quarter rows and
  scores them, without a per-query cube in device memory; small non-cube
  sublists ride a bounded posting-scatter tail.

Escalation: a query whose best unscored bound beats its k-th exact score
(beyond the tie tolerance) reruns with a wider selection, up to the
whole doc axis, where the check passes by construction — the pruning is
lossless.

Build: on CUDA the base columns come from the device ingest plane
(``build/devbuild.py``). On the CPU, and wherever ``OSSE_DEVBUILD=0``
turns the device build off, the disk base cache of the run set
(``posdb/devcache/base_<hash>.npz``, the reference's file format and
name) is read first, as in the reference; else the device build runs (on
the CPU too); else the host NumPy pipeline below, its oracle, which
writes the cache. The delta always comes from the memtable.

Completion: ``issue_batch`` queues the waves and the copy of their
result rows into a pinned host buffer of the batch's own, and records an
event; ``collect_batch`` waits on that event only, so a loop with two
batches in flight collects the first without waiting for the second.

Plans: ``issue_batch`` keeps each query's ResidentPlan on the cache
plane (``devindex.plan.<collection>``), keyed on (raw, lang) and
generation-keyed on the posdb and fielddb versions, so a repeated query
skips the host planning pass until a write. An escalation widens a
cached plan's ``kappa_min``/``k2_min`` in place, so a hot query's
learned floor persists, as in the reference. The batch's misses are
planned together (``plan_batch``): their sublists' distinct termids meet
the term directories in one vectorized search per directory.

Guardrails (``devcheck``, opt-in): the top-k invariants on every emitted
wave row, and cube sanity on the resident cube before each FD wave.

Numeric operators (``gbmin:``/``gbmax:``/``gbsortby:``): the fielddb
columns become a ``[D_cap]`` range mask and a ``[D_cap]`` sort key, built
on the host (the key in float64, cast to float32 once) and kept on the
device per (spec, fielddb version). A wave never mixes specs: the mask
gates the match of every route, and under ``gbsortby:`` the key is the
score (in F1 it is also the phase-1 bound, so a sorted query escalates
only where the top-8-per-block selection misses a key).

Telemetry (``utils/devwatch.py``, ``utils/jitwatch.py``, off unless
``OSSE_DEVWATCH=1`` / ``OSSE_JITWATCH=1``): every base, delta and regrow
build registers its columns in the HBM ledger; each collect round is
noted for the wave flight recorder; each wave dispatch is a roofline
entry under the reference's kernel names and shape buckets, its work the
sum of its kernel launches' counts; ``_put`` and the wave fetch report
their copies.

Every tensor lives on ``self.device`` (the collection's device unless
given); the wrappers of K1 and K2 pick the kernel or its plain version
by that device.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
import zipfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..build import devbuild
from ..cache import g_cacheplane
from ..device import resolve_device
from ..index import clusterdb as clusterdb_mod
from ..index import posdb
from ..index.collection import Collection
from ..index.rdblite import merge_batches
from ..utils import devwatch, jitwatch, trace
from ..utils.log import get_logger
from ..utils.stats import g_stats
from . import devcheck, fd_scores_kernel, weights
from .compiler import SUB_SYNONYM, QueryPlan, compile_query
from .min_scores_kernel import BIG, MAX_PAIR_SPAN
from .packer import (IMPACT_SCALE, MAX_POSITIONS, T_FLOOR, _bucket, _pad1,
                     demote_impacts, group_flags, pack_payload, pad_table)
from .scorer import final_multipliers, match_gates, min_scores, top_k

log = get_logger("devindex")

# the device layer is the first import on every device path: turning the
# watchers on here means OSSE_JITWATCH=1 / OSSE_DEVWATCH=1 cover the
# tests, the chip smoke test and the server without each opting in
jitwatch.maybe_enable()
devwatch.maybe_enable()

# ---- tuning constants: the reference's, unchanged. The byte budgets
# are a 16 GB TPU's; they decide which terms get dense and cube rows and
# so which route a query takes, so they stay as they are until the port
# retunes them for the card (ROADMAP).

# (the reference's compile-shape bucket floors have no counterpart:
# torch runs eagerly, so waves take their exact shapes)

KAPPA_FLOOR = 256  # phase-2 candidate count

#: doc-capacity quantum (D_cap bucket unit)
DOC_QUANTUM = 2048

#: budget for dense [V, D_cap] impact + runstart + count rows
DENSE_BUDGET_BYTES = 1536 << 20

#: minimum df for a term to earn a dense impact row
DENSE_MIN_DF = 1024

#: sparse doc runs are chunked to this many lanes per row
LSP_MAX = 2048

#: hard cap for materialized [P, D_cap] cube rows
CUBE_BUDGET_BYTES = 5 << 30
#: usable device memory for the resident set
HBM_USABLE_BYTES = 13 << 30
#: head-room reserved for wave intermediates next to the resident set
WAVE_RESERVE_BYTES = 5 << 29

#: the arrays of a disk base cache file (the reference's names and order)
_CACHE_KEYS = ("dir_termids", "base_df", "dir_dstart", "dir_pstart",
               "base_docids", "docidx", "pocc", "payload", "doc_col",
               "imp_col", "rs_col", "cnt_col", "siterank", "langid")

#: the sparse-lane tile ladder of the reference's F1 wave (its
#: ``wave_bytes_per_query`` model and roofline buckets read it; torch
#: waves run at their exact lane count)
LSP_BUCKETS = (128, 512, 2048)


def _row_bucket(m: int) -> int:
    """The reference's F1 row ladder (dense Rd and sparse Rs rows)."""
    return 2 if m <= 2 else (4 if m <= 4 else (
        16 if m <= 16 else _bucket(m, 64)))


def _lsp_bucket(mls: int) -> int:
    """The smallest sparse-lane tile of ``LSP_BUCKETS`` holding ``mls``."""
    return next(b for b in LSP_BUCKETS if mls <= b)

#: FD scatter-tail budget: non-cube postings a query may scatter before
#: it falls back to the generic F2
FD_SCATTER_MAX_LANES = 32768
FD_SCATTER_MAX_ROWS = 32

#: routing: drivers at or below this df use phase-1 pruning (F1)
CUBE_MIN_DF = 2048

#: F2 eligibility: postings per scatter row
F2_SCATTER_MAX = 16384
F2_LPOST_FLOOR = 4096

#: posting/doc column padding quantum
COL_QUANTUM = 1 << 15

#: run starts are int32 column offsets
_MAX_POSTINGS = 1 << 31
#: posting doc + occurrence pack: docidx << 4 | occ in one uint32
_OCC_BITS = 4
_OCC_MASK = 15

#: escalation tie tolerance (× the 1e-5 admissibility inflation)
_TIE_TOL = 1.0001

#: bit 31 of a payload (the synonym flag) as an int32
_SYN_BIT = fd_scores_kernel.SYN_BIT


def _posscore_np(f: dict[str, np.ndarray]) -> np.ndarray:
    """Per-posting single-term score (BASE · posw², the initWeights
    tables — Posdb.cpp:1105-1252), vectorized numpy for build time."""
    hg = f["hashgroup"]
    hgw = weights.HASH_GROUP_WEIGHTS[hg]
    denw = weights.IMPACT_DENSITY_WEIGHTS[f["densityrank"]]
    spamw = np.where(hg == posdb.HASHGROUP_INLINKTEXT,
                     weights.LINKER_WEIGHTS[f["wordspamrank"]],
                     weights.WORD_SPAM_WEIGHTS[f["wordspamrank"]])
    posw = hgw * denw * spamw
    return weights.BASE_SCORE * posw * posw


def _impacts_np(f: dict[str, np.ndarray], termids: np.ndarray,
                docidx: np.ndarray, runstart: np.ndarray) -> np.ndarray:
    """Exact per-(term, doc) single-term score before the frequency
    weight: the sum of the top MAX_TOP of {per-mapped-hashgroup position
    maxima} ∪ {every inlink-text occurrence} — the candidate set
    getSingleTermScore tops and sums (Posdb.cpp:3087). An admissible and
    tight phase-1 bound."""
    n = len(termids)
    if n == 0:
        return np.empty(0, np.float32)
    ps = _posscore_np(f)
    mhg = weights.MAPPED_HASHGROUP[f["hashgroup"]].astype(np.int8)
    is_inlink = f["hashgroup"] == posdb.HASHGROUP_INLINKTEXT
    # candidates per (term, doc): one max per non-inlink mapped hashgroup
    # plus each inlink occurrence, ranked within the pair
    o = np.lexsort((mhg, docidx, termids))
    ps_o, mh_o, il_o = ps[o], mhg[o], is_inlink[o]
    t_o, d_o = termids[o], docidx[o]
    gch = np.ones(n, bool)
    gch[1:] = ((t_o[1:] != t_o[:-1]) | (d_o[1:] != d_o[:-1])
               | (mh_o[1:] != mh_o[:-1]))
    gid = np.cumsum(gch) - 1
    gstart = np.nonzero(gch)[0]
    gmax = np.maximum.reduceat(ps_o, gstart)
    cand_mask = il_o | gch
    cval = np.where(il_o, ps_o, gmax[gid])[cand_mask]
    ct = t_o[cand_mask]
    cd = d_o[cand_mask]
    m = len(cval)
    pch = np.ones(m, bool)
    pch[1:] = (ct[1:] != ct[:-1]) | (cd[1:] != cd[:-1])
    pstart = np.nonzero(pch)[0]
    pair_id = np.cumsum(pch) - 1
    order2 = np.lexsort((-cval, pair_id))
    ranked = np.empty(m, np.int64)
    pos_in_pair = np.arange(m) - pstart[pair_id[order2]]
    ranked[order2] = pos_in_pair
    cval_cut = np.where(ranked < weights.MAX_TOP, cval, 0.0)
    imp = np.add.reduceat(cval_cut, pstart)
    assert len(imp) == len(runstart)
    # a tiny floor keeps zero-weight hashgroups present but worthless
    return np.maximum(imp, 1e-30).astype(np.float32)


def _occ_ranks(termids: np.ndarray, docs: np.ndarray) -> np.ndarray:
    """Occurrence rank within each (termid, doc) run of the sorted
    columns."""
    n = len(termids)
    if n == 0:
        return np.empty(0, np.int64)
    newpair = np.ones(n, bool)
    newpair[1:] = (termids[1:] != termids[:-1]) | (docs[1:] != docs[:-1])
    idx = np.arange(n)
    first = np.maximum.accumulate(np.where(newpair, idx, 0))
    return idx - first


def _term_dfs(termids: np.ndarray, newpair: np.ndarray):
    """(dir_termids, dir_start, df): per-term run bounds and distinct-doc
    counts over sorted columns (the Msg36 termfreq precompute)."""
    n = len(termids)
    if n == 0:
        return (np.empty(0, np.uint64), np.zeros(1, np.int64),
                np.empty(0, np.int64))
    tchange = np.ones(n, bool)
    tchange[1:] = termids[1:] != termids[:-1]
    starts = np.nonzero(tchange)[0]
    df = np.add.reduceat(newpair.astype(np.int64), starts)
    return termids[starts].copy(), np.r_[starts, n].astype(np.int64), df


def base_fingerprint(runs) -> tuple:
    """The run set a base is built from: a dump or a merge moves it, a
    memtable write does not (``engine.get_device_index`` compares it
    with ``DeviceIndex._base_fp``). Each run's ``keys_crc`` makes a run
    rewritten under a name and a length it had before a new fingerprint.
    Plain ints and strs, so its ``repr`` (the disk cache's key) is the
    reference's."""
    return tuple((r.path.name, len(r), r.meta.get("keys_crc"))
                 for r in runs)


def _pad_col(a: np.ndarray, size: int) -> np.ndarray:
    out = np.zeros(size, a.dtype)
    out[: len(a)] = a
    return out


def _env_int(name: str, default: int) -> int:
    """Env-overridable tuning constant: tests scale the dense/cube
    thresholds down so tiny corpora build dense and cube rows and
    exercise every route."""
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _lanes(starts: np.ndarray, cum: np.ndarray, device):
    """(row, src) per lane of a flattened set of column runs: lane l of
    ``cum[-1]`` belongs to run ``row`` and reads column entry ``src``."""
    cum_t = torch.from_numpy(cum.astype(np.int64)).to(device)
    starts_t = torch.from_numpy(starts.astype(np.int64)).to(device)
    lane = torch.arange(int(cum[-1]), device=device)
    row = torch.searchsorted(cum_t, lane, right=True) - 1
    return row, starts_t[row] + lane - cum_t[row]


def _build_dense_rows(d_doc, d_imp, d_rs, d_cnt, starts: np.ndarray,
                      cum: np.ndarray, V: int, D: int):
    """Dense ``[V, D]`` impact rows and flat ``[V·D]`` runstart and
    count rows, by one scatter over the doc-pair columns (the host ships
    only the per-row (start, cumulative length) descriptors)."""
    dev = d_doc.device
    imp = torch.zeros(V * D, dtype=d_imp.dtype, device=dev)
    rs = torch.zeros(V * D, dtype=torch.int32, device=dev)
    cnt = torch.zeros(V * D, dtype=torch.uint8, device=dev)
    if cum[-1] > 0:
        row, src = _lanes(starts, cum, dev)
        dst = row * D + d_doc[src].long()
        imp[dst] = d_imp[src]
        rs[dst] = d_rs[src]
        cnt[dst] = d_cnt[src]
    return imp.view(V, D), rs, cnt


def _cube_rows(d_payload, d_docc, starts: np.ndarray, cum: np.ndarray,
               D: int, n_positions: int, total: int):
    """Materialized ``[Vc, P, D]`` cube rows (flat) by one scatter; the
    destination comes from the resident docc column (docidx << 4 | occ).
    Port of ``build/devbuild.py::_cube_rows``."""
    cube = torch.zeros(total, dtype=torch.int32, device=d_payload.device)
    if cum[-1] > 0:
        row, src = _lanes(starts, cum, d_payload.device)
        dv = d_docc[src]
        occ = (dv & _OCC_MASK).long()
        dxi = ((dv >> _OCC_BITS) & 0x0FFFFFFF).long()
        cube[(row * n_positions + occ) * D + dxi] = d_payload[src]
    return cube


def _block_topn(x: torch.Tensor, n_sel: int, per_block: int = 8):
    """Top-``per_block``-per-block candidate selection over the last
    axis of ``x [..., D]``: (vals [..., n], idx [..., n], missed_max
    [...]) with n = n_sel/per_block blocks × per_block; ``missed_max``
    is the best value NOT selected. Knock-outs use the first maximal
    index, as the reference's argmax does."""
    D = x.shape[-1]
    nb = max(n_sel // per_block, 1)
    while D % nb:
        nb //= 2
    R = D // nb
    cur = x.reshape(*x.shape[:-1], nb, R)
    iota = torch.arange(R, device=x.device)
    base = torch.arange(nb, device=x.device) * R
    vals_l, idx_l = [], []
    for t in range(per_block):
        m = cur.amax(dim=-1)
        a = cur.argmax(dim=-1)
        vals_l.append(m if t == 0 else torch.clamp(m, min=0.0))
        idx_l.append(base + a)
        cur = torch.where(iota == a[..., None], -torch.inf, cur)
    missed = torch.clamp(cur.amax(dim=(-2, -1)), min=0.0)
    return torch.cat(vals_l, dim=-1), torch.cat(idx_l, dim=-1), missed


def _out_rows(nm, missed, idx, scores) -> torch.Tensor:
    """The packed per-query result row ``[2 + 2·k2]`` int32: n_matched,
    the missed bound's bits, doc indices, the scores' bits."""
    return torch.cat([nm.to(torch.int32)[:, None],
                      missed.contiguous().view(torch.int32)[:, None],
                      idx.to(torch.int32),
                      scores.contiguous().view(torch.int32)], dim=1)


def _fold_rows(n_out: int, tgt: torch.Tensor,
               val: torch.Tensor) -> torch.Tensor:
    """``[B, n_out]`` float32 sums of ``val`` ``[B, R, L]`` at ``tgt``,
    folded one row at a time in row order. A sparse row is one term's doc
    run, so its targets are distinct (masked lanes add +0.0 to a dropped
    sentinel): every add is exact and collision free, and the sum at a
    target is taken in row order on every device, which is the order of
    one flat ``scatter_add_`` on the CPU. On the card a flat scatter-add
    sums in the order its atomics land."""
    out = torch.zeros((tgt.shape[0], n_out), dtype=torch.float32,
                      device=tgt.device)
    for r in range(tgt.shape[1]):
        out.scatter_add_(1, tgt[:, r], val[:, r])
    return out


def _spec(p) -> tuple:
    """A plan's numeric-operator spec: the waves partition on it."""
    return (p.filters, p.sortby, p.sort_base)


class _DeltaOverflow(Exception):
    def __init__(self, needed_docs: int = 0, needed_cols: int = 0):
        self.needed_docs = needed_docs
        self.needed_cols = needed_cols


@dataclass
class ResidentPlan:
    """Host-computed execution plan for one query (all tiny arrays)."""

    # dense rows: term's doc run lives as a dense [D_cap] impact row
    d_slot: np.ndarray       # int32 [Rd] dense matrix row (-1 = pad)
    d_group: np.ndarray      # int32 [Rd]
    d_base: np.ndarray       # int32 [Rd] slot base within the group's P
    d_quota: np.ndarray      # int32 [Rd]
    d_syn: np.ndarray        # uint32 [Rd]
    # sparse rows: contiguous run of the doc/impact/runstart columns
    s_start: np.ndarray      # int32 [Rs] absolute offset into doc cols
    s_len: np.ndarray        # int32 [Rs]
    s_group: np.ndarray      # int32 [Rs]
    s_base: np.ndarray       # int32 [Rs]
    s_quota: np.ndarray      # int32 [Rs]
    s_syn: np.ndarray        # uint32 [Rs]
    s_isbase: np.ndarray     # bool [Rs] (base postings dead-mask)
    # full-cube (F2) rows: materialized cube slices + posting scatters
    c_slot: np.ndarray       # int32 [Rc] cube matrix row (-1 = pad)
    c_dslot: np.ndarray      # int32 [Rc] dense row (count source)
    c_group: np.ndarray      # int32 [Rc]
    c_base: np.ndarray       # int32 [Rc]
    c_quota: np.ndarray      # int32 [Rc]
    c_syn: np.ndarray        # uint32 [Rc]
    p_start: np.ndarray      # int32 [Rp] absolute posting offset
    p_len: np.ndarray        # int32 [Rp]
    p_group: np.ndarray      # int32 [Rp]
    p_base: np.ndarray       # int32 [Rp]
    p_quota: np.ndarray      # int32 [Rp]
    p_syn: np.ndarray        # uint32 [Rp]
    p_isbase: np.ndarray     # bool [Rp]
    # per-group query state
    freq_weight: np.ndarray  # float32 [T]
    required: np.ndarray     # bool [T]
    negative: np.ndarray     # bool [T]
    scored: np.ndarray       # bool [T]
    counts: np.ndarray       # bool [T] groups entering the min-score
    table: np.ndarray        # bool [TABLE_SIZE] boolean truth table
    qlang: int
    matchable: bool
    driver_df: int = 0       # min required-group df (routes F1 vs F2)
    kappa_min: int = 0       # escalation floor (set on a pruning miss)
    k2_min: int = 0          # phase-2 width floor (escalates with κ)
    #: direct-cube (FD) eligibility: every group's cube runs are base
    #: rows whose slot-plan layout is quarter-aligned, so the group's
    #: [P, D] plane is four quarter-row gathers from the resident cube
    direct_ok: bool = False
    g_quarter: np.ndarray | None = None  # int32 [T, 4] absolute quarter
    g_qsyn: np.ndarray | None = None     # uint32 [T, 4] synonym flags
    #: True only for boolean queries (the truth-table gate runs only then)
    has_table: bool = False
    #: gbmin:/gbmax:/gbsortby: state; waves group by identical specs, the
    #: [D] filter and sort columns being per-wave arguments
    filters: tuple = ()
    sortby: tuple | None = None
    #: shift of the sort keys (they must stay positive for the match gate)
    sort_base: float = 0.0
    #: number of scored ∧ counted groups (routing, k2 and κ key on it)
    n_scored: int = 0


@dataclass
class PendingBatch:
    """One issued but unfetched batch: its waves are queued on the
    device, nothing has been fetched. ``issue_batch`` makes it,
    ``collect_batch`` resolves it (``search_batch`` is the two halves
    back to back)."""

    plans: list
    results: list
    waves: list
    k_req: int
    k2v: int
    f2_nsel: int
    bmax: int
    topk: int
    #: the first round's queued result copy (``_queue_fetch``)
    fetch: tuple | None = None


class DeviceIndex:
    """One collection's postings and impact bounds, resident on the
    device (``device``: the collection's unless given)."""

    def __init__(self, coll: Collection, max_positions: int = MAX_POSITIONS,
                 device=None):
        self.device = coll.device if device is None \
            else resolve_device(device)
        self.coll = coll
        if max_positions > (1 << _OCC_BITS):
            raise ValueError(
                f"max_positions > {1 << _OCC_BITS} overflows the 4-bit "
                "occurrence field of the docc pack")
        self.P = max_positions
        self._built_version = -1
        self._base_fp = None
        self.full_rebuilds = 0    # O(corpus) base rebuilds (run-set moved)
        self.delta_rebuilds = 0   # O(memtable) delta-only refreshes
        self.escalations = 0      # pruning misses rerun wider
        #: queries first routed to F1, FD and F2 (reruns not counted)
        self.route_counts = {"f1": 0, "fd": 0, "f2": 0}
        #: resident-plan cache (the termlist-cache role, RdbCache): the
        #: host planning pass repeats byte-identically for a repeated
        #: query until a write moves posdb or fielddb (a plan carries its
        #: filter spec and sort base)
        posdb_rdb, fielddb_rdb = coll.posdb, coll.fielddb.rdb
        self._plan_cache = g_cacheplane.register(
            f"devindex.plan.{coll.name}", ttl_s=300.0, max_entries=2048,
            gen_fn=lambda: (posdb_rdb.version, fielddb_rdb.version),
            desc="resident query plans (termlist-cache role)")
        #: fielddb columns and per-spec wave columns (re-derived when the
        #: doc axis moves)
        self._fcols: dict = {}
        self._fswave: dict = {}
        self.refresh()

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Host array → device tensor (uint32 as its int32 view). On the
        card the array is staged in pinned memory and copied without
        blocking: a blocking copy from pageable memory synchronizes the
        stream, which would make each wave's issue wait for every wave
        queued before it."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if jitwatch.g_jitwatch.enabled:
            jitwatch.note_transfer("_put", "h2d", a.nbytes)
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @contextlib.contextmanager
    def _stage(self, name: str):
        """A build stage's span, ended by a wait for this thread's stream
        so that the span holds the stage's device time (a background
        rebuild's stream is its own)."""
        with trace.span(name):
            yield
            devbuild.sync_stream(self.device)

    def _write_tail(self, buf: torch.Tensor, tail: np.ndarray,
                    offset: int) -> None:
        """In-place rewrite of the delta tail of a device column."""
        buf[offset:offset + len(tail)].copy_(self._put(tail))

    # --- build / refresh -------------------------------------------------

    def refresh(self) -> bool:
        """(Re)build the device columns if the posdb changed: the delta
        only while the run set is stable, a full base rebuild when a dump
        moved it."""
        rdb = self.coll.posdb
        if rdb.version == self._built_version:
            return False
        self._cluster = None     # clusterdb view refreshes lazily
        self._docid_view = None
        self._fcols = {}         # fielddb columns re-derive
        self._fswave = {}
        # one snapshot of the run list: a merge that swaps it meanwhile
        # leaves this build's runs readable (their mmaps outlive the
        # rmtree) and the fingerprint true to them
        runs = list(rdb.runs)
        fp = base_fingerprint(runs)
        if fp != self._base_fp:
            self._build_base(fp, runs)
        # the delta can outgrow the doc-capacity headroom and the column
        # tails independently — regrow and retry
        min_docs = min_delta = 0
        for _ in range(3):
            try:
                self._build_delta()
                break
            except _DeltaOverflow as e:
                min_docs = max(min_docs, e.needed_docs)
                min_delta = max(min_delta, e.needed_cols)
                self._build_base(fp, runs, min_docs=min_docs,
                                 min_delta=min_delta)
        else:
            self._build_delta()
        self._built_version = rdb.version
        if devwatch.enabled():
            # one registration point covers base, delta and regrow; the
            # device build's staging slice is consumed by now
            devwatch.drop("(ingest)", "build")
            devwatch.note_columns(self.coll.name, "devindex",
                                  self.columns())
        return True

    def _postings_overflow(self) -> ValueError:
        """The 2^31-postings runstart pack limit, counted
        (``build.postings_overflow``: ``/admin/perf``'s shard-split alert)
        before the raise."""
        g_stats.count("build.postings_overflow")
        return ValueError(
            f"shard exceeds {_MAX_POSTINGS} stored postings (runstart "
            "pack limit) — split the collection across more shards")

    #: bump when a derived column's computation changes (the cache's
    #: schema; the reference's value, so both packages share cache files)
    _CACHE_SCHEMA = 4

    def _cache_path(self, fp) -> Path:
        h = hashlib.sha1(repr((fp, self.P, self._CACHE_SCHEMA))
                         .encode()).hexdigest()[:16]
        return self.coll.posdb.dir / "devcache" / f"base_{h}.npz"

    def _load_base_cache(self, fp):
        """The host oracle's derived base columns for this run set, from
        ``posdb/devcache/base_<hash>.npz``; None when there is none or it
        cannot be read (a torn write)."""
        p = self._cache_path(fp)
        if not p.exists():
            return None
        try:
            with np.load(p) as z:
                return tuple(z[k] for k in _CACHE_KEYS)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return None

    def _save_base_cache(self, fp, cols: dict) -> None:
        """Write the cache (to a temporary name, renamed into place); the
        caches of other run sets go only after the new one landed, so a
        crash never leaves none."""
        p = self._cache_path(fp)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp.npz")
        np.savez(tmp, **cols)
        tmp.rename(p)
        for old in p.parent.glob("base_*.npz"):
            if old != p:
                old.unlink()

    def _build_base(self, fp, runs, min_docs: int = 0, min_delta: int = 0
                    ) -> None:
        """Base columns from the posdb runs ``runs`` (merged, tombstones
        annihilated), plus preallocated delta tails. Three sources
        (``base_source`` says which built it): the disk cache of this run
        set; the device ingest plane, which merges and derives on
        ``self.device`` and writes no cache; the host pipeline below
        (``OSSE_DEVBUILD=0``), the oracle, which writes the cache. On
        CUDA the device build comes first and the cache is not read: the
        cache holds the oracle's host columns, so reading it leaves the
        doc meta, the demotion and the docc pack to the host and uploads
        them (3.8-4.7 s against 1.0-1.2 s for the device build at
        100,000 pages on an H100 80GB HBM3 at 700 W). Elsewhere the
        reference's order holds: the cache, the device build, the
        oracle."""
        P = self.P
        dv = batch = None
        on_card = self.device.type == "cuda" and devbuild.enabled()
        cached = self._load_base_cache(fp) if runs and not on_card \
            else None
        if cached is None and devbuild.enabled() and runs:
            dv = devbuild.build_base([r.batch().keys for r in runs],
                                     self.device)
        if cached is None and dv is None and runs:
            batch = merge_batches([r.batch() for r in runs])
        self.base_source = ("cache" if cached is not None
                            else "device" if dv is not None
                            else "host" if runs else "empty")
        if cached is not None:
            (self.dir_termids, self.base_df, self.dir_dstart,
             self.dir_pstart, self.base_docids, docidx, pocc, payload,
             doc_col, imp_col, rs_col, cnt_col, siterank,
             langid) = cached
            n = len(docidx)
        elif dv is not None:
            # the columns stay on the device; the directory tables, the
            # docid map and the doc-pair column came back to the host
            self.dir_termids = dv.dir_termids
            self.base_df = dv.df
            self.dir_dstart = dv.dir_dstart
            self.dir_pstart = dv.dir_pstart
            self.base_docids = dv.base_docids
            doc_col = dv.h_doc_col
            n = dv.n
            if n >= _MAX_POSTINGS:
                raise self._postings_overflow()
        elif batch is not None and len(batch):
            f = posdb.unpack(batch.keys)
            termids, docids = f["termid"], f["docid"]
            occ = _occ_ranks(termids, docids)
            self.dir_termids, _, self.base_df = _term_dfs(termids, occ == 0)
            # store-cap: scoring reads at most P positions per (term, doc)
            keep = occ < P
            pocc = occ[keep].astype(np.uint8)
            f = {k: v[keep] for k, v in f.items()}
            termids, docids = f["termid"], f["docid"]
            if len(termids) >= _MAX_POSTINGS:
                raise self._postings_overflow()
            payload = pack_payload(f)
            self.base_docids = np.unique(docids)
            docidx = np.searchsorted(self.base_docids, docids).astype(
                np.int32)
            n = len(docidx)
            # doc-level runs: one entry per (term, doc) pair
            newpair = np.ones(n, bool)
            newpair[1:] = (termids[1:] != termids[:-1]) | \
                (docidx[1:] != docidx[:-1])
            runstart = np.nonzero(newpair)[0].astype(np.int64)
            doc_col = docidx[newpair]
            count = np.diff(np.r_[runstart, n])
            imp_col = _impacts_np(f, termids, docidx, runstart)
            rs_col = runstart.astype(np.int32)
            cnt_col = np.minimum(count, P).astype(np.uint8)
            tchange = np.ones(n, bool)
            tchange[1:] = termids[1:] != termids[:-1]
            tstarts = np.nonzero(tchange)[0]
            self.dir_dstart = np.r_[
                np.searchsorted(runstart, tstarts), len(runstart)
            ].astype(np.int64)
            self.dir_pstart = np.r_[tstarts, n].astype(np.int64)
            siterank = f["siterank"].astype(np.int32)
            langid = f["langid"].astype(np.int32)
            self._save_base_cache(fp, dict(
                dir_termids=self.dir_termids, base_df=self.base_df,
                dir_dstart=self.dir_dstart, dir_pstart=self.dir_pstart,
                base_docids=self.base_docids, docidx=docidx, pocc=pocc,
                payload=payload, doc_col=doc_col, imp_col=imp_col,
                rs_col=rs_col, cnt_col=cnt_col, siterank=siterank,
                langid=langid))
        else:
            self.dir_termids = np.empty(0, np.uint64)
            self.base_df = np.empty(0, np.int64)
            self.dir_dstart = np.zeros(1, np.int64)
            self.dir_pstart = np.zeros(1, np.int64)
            self.base_docids = np.empty(0, np.uint64)
            docidx = np.empty(0, np.int32)
            pocc = np.empty(0, np.uint8)
            payload = np.empty(0, np.uint32)
            doc_col = np.empty(0, np.int32)
            imp_col = np.empty(0, np.float32)
            rs_col = np.empty(0, np.int32)
            cnt_col = np.empty(0, np.uint8)
            siterank = langid = np.empty(0, np.int32)
            n = 0

        Db = len(self.base_docids)
        headroom = max(1024, Db // 4)
        self.D_cap = _bucket(max(Db + headroom, min_docs, 1), DOC_QUANTUM)
        if self.D_cap > (1 << 28):
            raise ValueError(
                "docc pack caps a shard at 2^28 docs — shard the corpus")

        # doc meta: the first posting per doc supplies siterank/langid
        # (getSiteRank(miniMergedList[0]), Posdb.cpp:6989)
        sr = np.zeros(self.D_cap, np.uint8)
        dl = np.zeros(self.D_cap, np.uint8)
        if n and dv is None:
            first = np.unique(docidx, return_index=True)[1]
            sr[docidx[first]] = siterank[first]
            dl[docidx[first]] = langid[first]

        # dense rows: the highest-df terms get a dense [D_cap] impact +
        # runstart + count row. The slot count V is bucketed to a power
        # of two, so the budget holds for the bucketed V.
        dfs = np.diff(self.dir_dstart)
        tau = max(_env_int("OSSE_DENSE_MIN_DF", DENSE_MIN_DF),
                  self.D_cap // 64)
        v_cap = 8
        while (2 * v_cap * 7 * self.D_cap <= DENSE_BUDGET_BYTES
               and 2 * v_cap * self.D_cap < (1 << 31)):
            v_cap *= 2
        eligible = np.nonzero(dfs > tau)[0]
        eligible = eligible[np.argsort(-dfs[eligible], kind="stable")]
        dense_terms = eligible[:v_cap]
        V = _bucket(max(len(dense_terms), 1), 8)
        self.dense_slot_of: dict[int, int] = {}
        dr_starts = np.zeros(max(len(dense_terms), 1), np.int32)
        dr_lens = np.zeros(max(len(dense_terms), 1), np.int64)
        for slot, ti in enumerate(dense_terms):
            a, b = int(self.dir_dstart[ti]), int(self.dir_dstart[ti + 1])
            dr_starts[slot] = a
            dr_lens[slot] = b - a
            self.dense_slot_of[int(self.dir_termids[ti])] = slot

        # cube rows: the heaviest terms' [P, D] position cubes. The
        # budget is what the columns and dense rows leave, up to the cap.
        nb_est = _bucket(max(n, 1), COL_QUANTUM)
        mb_est = _bucket(max(len(doc_col), 1), COL_QUANTUM)
        n2_est = max(_bucket(max(nb_est // 4, min_delta, 1),
                             COL_QUANTUM), COL_QUANTUM)
        cols_bytes = (nb_est + n2_est) * 8 + (mb_est + n2_est) * 11
        dense_bytes = V * self.D_cap * 7
        cube_bytes = min(
            CUBE_BUDGET_BYTES,
            max(1 << 30, HBM_USABLE_BYTES - cols_bytes - dense_bytes
                - WAVE_RESERVE_BYTES))
        vc_cap = 4
        while (2 * vc_cap * P * self.D_cap * 4 <= cube_bytes
               and 2 * vc_cap * P * self.D_cap < (1 << 31)):
            vc_cap *= 2
        # the last slot stays all-zero: FD's "absent quarter" target
        cube_terms = dense_terms[:vc_cap - 1]
        Vc = _bucket(len(cube_terms) + 1, 4)
        self.cube_zero_slot = Vc - 1
        self.cube_slot_of: dict[int, int] = {}
        c_starts = np.zeros(max(len(cube_terms), 1), np.int32)
        c_lens = np.zeros(max(len(cube_terms), 1), np.int64)
        for slot, ti in enumerate(cube_terms):
            a, b = int(self.dir_pstart[ti]), int(self.dir_pstart[ti + 1])
            c_starts[slot] = a
            c_lens[slot] = b - a
            self.cube_slot_of[int(self.dir_termids[ti])] = slot
        # the same slots by directory position, for the planner's
        # vectorized lookup (-1 where the term has none)
        self.dir_dense_slot = np.full(len(self.dir_termids), -1, np.int32)
        self.dir_dense_slot[dense_terms] = np.arange(len(dense_terms))
        self.dir_cube_slot = np.full(len(self.dir_termids), -1, np.int32)
        self.dir_cube_slot[cube_terms] = np.arange(len(cube_terms))

        # device columns: base + preallocated delta tail
        self.h_doc_col = doc_col
        self.Nb = _bucket(max(n, 1), COL_QUANTUM)
        self.Mb = _bucket(max(len(doc_col), 1), COL_QUANTUM)
        self.N2 = max(_bucket(max(self.Nb // 4, min_delta, 1),
                              COL_QUANTUM), COL_QUANTUM)
        self.M2 = self.N2
        if dv is not None:
            # device-built columns never left the device: zero-extend
            # them to the base + delta capacity
            self.d_payload = devbuild.fit(dv.cols["payload"],
                                          self.Nb + self.N2)
            self.d_docc = devbuild.fit(dv.cols["docc"], self.Nb + self.N2)
            self.d_doc = devbuild.fit(dv.cols["doc_col"], self.Mb + self.M2)
            self.d_imp = devbuild.fit(dv.cols["imp16"], self.Mb + self.M2)
            self.d_rs = devbuild.fit(dv.cols["rs"], self.Mb + self.M2)
            self.d_cnt = devbuild.fit(dv.cols["cnt"], self.Mb + self.M2)
        else:
            self.d_payload = self._put(_pad_col(payload, self.Nb + self.N2))
            docc = ((docidx.astype(np.uint32) << _OCC_BITS)
                    | pocc.astype(np.uint32))
            self.d_docc = self._put(_pad_col(docc, self.Nb + self.N2))
            self.d_doc = self._put(_pad_col(doc_col, self.Mb + self.M2))
            # impacts reside as round-up float16 at 1/IMPACT_SCALE
            self.d_imp = self._put(_pad_col(demote_impacts(imp_col),
                                            self.Mb + self.M2))
            self.d_rs = self._put(_pad_col(rs_col, self.Mb + self.M2))
            self.d_cnt = self._put(_pad_col(cnt_col, self.Mb + self.M2))
        dr_cum = np.r_[0, np.cumsum(dr_lens)].astype(np.int64)
        with self._stage("devindex.dense_rows"):
            (self.d_dense_imp, self.d_dense_rs,
             self.d_dense_cnt) = _build_dense_rows(
                self.d_doc, self.d_imp, self.d_rs, self.d_cnt, dr_starts,
                dr_cum, V=V, D=self.D_cap)
        with self._stage("devindex.doc_meta"):
            if dv is not None:
                self.d_siterank, self.d_doclang = devbuild.doc_meta(
                    self._put(sr), self._put(dl), dv)
            else:
                self.d_siterank = self._put(sr)
                self.d_doclang = self._put(dl)
        self.d_dead = self._put(np.zeros(self.D_cap, bool))
        self.Vc = Vc
        c_cum = np.r_[0, np.cumsum(c_lens)].astype(np.int64)
        with self._stage("devindex.cube_rows"):
            self.d_cube = _cube_rows(self.d_payload, self.d_docc, c_starts,
                                     c_cum, D=self.D_cap, n_positions=P,
                                     total=Vc * P * self.D_cap)
        self._base_fp = fp
        self.full_rebuilds += 1
        log.info("device base built: %d postings, %d docs, %d terms "
                 "(%d dense rows, %d cube rows, cap %d) on %s", n, Db,
                 len(self.dir_termids), len(dense_terms), len(cube_terms),
                 self.D_cap, self.device)

    def _build_delta(self) -> None:
        """Delta columns from the memtable — O(memtable) per refresh.
        Tombstones and re-adds mark their base doc dead and subtract from
        the per-term dfs; positives become delta postings and doc-pair
        entries written into the preallocated tails."""
        Db = len(self.base_docids)
        mem = self.coll.posdb.mem.batch()
        self.tomb_df = np.zeros(len(self.dir_termids), np.int64)
        dead = np.zeros(self.D_cap, bool)
        if not len(mem):
            self.live_base_df = self.base_df.astype(np.int64)
            self._set_empty_delta()
            self.d_dead = self._put(dead)
            self.delta_rebuilds += 1
            return
        f = posdb.unpack(mem.keys)
        pos = f["delbit"].astype(bool)

        def base_idx_of(docids_arr):
            di = np.searchsorted(self.base_docids, docids_arr)
            ok = di < Db
            ok[ok] = self.base_docids[di[ok]] == docids_arr[ok]
            return di, ok

        # superseded base docs: tombstoned, or re-added in the delta (an
        # identical re-index annihilates in the memtable, so the delta
        # positives are the only witness)
        t_di, t_ok = base_idx_of(f["docid"][~pos])
        p_di, p_ok = base_idx_of(f["docid"][pos])
        dead_idx = np.unique(np.concatenate([t_di[t_ok], p_di[p_ok]]))
        dead[dead_idx] = True

        # distinct (term, superseded-doc) pairs → df subtraction, where
        # the pair exists in the base
        pair_t = np.concatenate([f["termid"][~pos][t_ok],
                                 f["termid"][pos][p_ok]])
        pair_d = np.concatenate([t_di[t_ok], p_di[p_ok]]).astype(np.int64)
        if len(pair_t):
            order = np.lexsort((pair_d, pair_t))
            pair_t, pair_d = pair_t[order], pair_d[order]
            firstp = np.ones(len(pair_t), bool)
            firstp[1:] = (pair_t[1:] != pair_t[:-1]) | \
                (pair_d[1:] != pair_d[:-1])
            pair_t, pair_d = pair_t[firstp], pair_d[firstp]
            ti = np.searchsorted(self.dir_termids, pair_t)
            ok = ti < len(self.dir_termids)
            ok[ok] = self.dir_termids[ti[ok]] == pair_t[ok]
            # pair_t is sorted, so each term's pairs are one slice of the
            # ok pairs: a pass per term over its own pairs, not over all
            # of them (which made a memtable of re-indexed pages, as a
            # crawl leaves, quadratic)
            t_ok, d_ok = ti[ok], pair_d[ok]
            terms, lo = np.unique(t_ok, return_index=True)
            hi = np.append(lo[1:], len(t_ok))
            for term_i, a0, b0 in zip(terms.tolist(), lo.tolist(),
                                      hi.tolist()):
                a, b = int(self.dir_dstart[term_i]), \
                    int(self.dir_dstart[term_i + 1])
                run = self.h_doc_col[a:b]
                d = d_ok[a0:b0]
                ppos = np.searchsorted(run, d)
                inb = ppos < len(run)
                inb[inb] = run[ppos[inb]] == d[inb]
                self.tomb_df[term_i] = int(inb.sum())
        #: each base term's df with its superseded-doc pairs taken off
        self.live_base_df = self.base_df.astype(np.int64) - self.tomb_df

        upd_idx = np.empty(0, np.int32)
        upd_sr = upd_dl = upd_idx
        if pos.any():
            fp_ = {k: v[pos] for k, v in f.items()}
            p_doc = fp_["docid"]
            new_docids = np.unique(p_doc[~p_ok])
            if Db + len(new_docids) > self.D_cap:
                raise _DeltaOverflow(needed_docs=Db + len(new_docids))
            docidx = np.where(
                p_ok, p_di,
                Db + np.searchsorted(new_docids, p_doc)).astype(np.int32)
            if devbuild.enabled():
                self._fold_device_delta(fp_, docidx, new_docids)
                self.d_dead = self._put(dead)
                self.delta_rebuilds += 1
                return
            # delta sort key is (termid, doc index, wordpos): new docs'
            # indexes are not docid-monotonic
            order = np.lexsort((fp_["wordpos"], docidx, fp_["termid"]))
            fp_ = {k: v[order] for k, v in fp_.items()}
            docidx = docidx[order]
            occ = _occ_ranks(fp_["termid"], docidx)
            self.dir2_termids, _, self.delta_df = _term_dfs(
                fp_["termid"], occ == 0)
            keep = occ < self.P
            pocc2 = occ[keep].astype(np.uint8)
            fp_ = {k: v[keep] for k, v in fp_.items()}
            docidx = docidx[keep]
            n2 = len(docidx)
            newpair = np.ones(n2, bool)
            newpair[1:] = (fp_["termid"][1:] != fp_["termid"][:-1]) | \
                (docidx[1:] != docidx[:-1])
            runstart2 = np.nonzero(newpair)[0].astype(np.int64)
            doc2_col = docidx[newpair]
            if n2 > self.N2 or len(doc2_col) > self.M2:
                raise _DeltaOverflow(needed_cols=max(n2, len(doc2_col)))
            if self.Nb + n2 >= _MAX_POSTINGS:
                raise self._postings_overflow()
            count2 = np.diff(np.r_[runstart2, n2])
            imp2 = _impacts_np(fp_, fp_["termid"], docidx, runstart2)
            # runstarts index the combined column: delta postings live at
            # [Nb, Nb + n2)
            rs2 = (self.Nb + runstart2).astype(np.int32)
            cnt2 = np.minimum(count2, self.P).astype(np.uint8)
            tchange = np.ones(n2, bool)
            tchange[1:] = fp_["termid"][1:] != fp_["termid"][:-1]
            tstarts = np.nonzero(tchange)[0]
            self.dir2_dstart = np.r_[
                np.searchsorted(runstart2, tstarts), len(runstart2)
            ].astype(np.int64)
            self.dir2_pstart = np.r_[tstarts, n2].astype(np.int64)
            self.all_docids = np.concatenate([self.base_docids, new_docids])
            # doc-table updates from the first delta posting per doc
            first = np.unique(docidx, return_index=True)[1]
            upd_idx = docidx[first].astype(np.int32)
            upd_sr = fp_["siterank"][first].astype(np.uint8)
            upd_dl = fp_["langid"][first].astype(np.uint8)
            docc2 = ((docidx.astype(np.uint32) << _OCC_BITS)
                     | pocc2.astype(np.uint32))
            self._write_tail(self.d_payload,
                             _pad_col(pack_payload(fp_), self.N2), self.Nb)
            self._write_tail(self.d_docc, _pad_col(docc2, self.N2), self.Nb)
            self._write_tail(self.d_doc, _pad_col(doc2_col, self.M2),
                             self.Mb)
            self._write_tail(self.d_imp,
                             _pad_col(demote_impacts(imp2), self.M2),
                             self.Mb)
            self._write_tail(self.d_rs, _pad_col(rs2, self.M2), self.Mb)
            self._write_tail(self.d_cnt, _pad_col(cnt2, self.M2), self.Mb)
        else:
            self._set_empty_delta()
        if len(upd_idx):
            idx = self._put(upd_idx.astype(np.int64))
            self.d_siterank[idx] = self._put(upd_sr)
            self.d_doclang[idx] = self._put(upd_dl)
        self.d_dead = self._put(dead)
        self.delta_rebuilds += 1

    def _fold_device_delta(self, fp_, docidx, new_docids) -> None:
        """The memtable positives sorted and derived on the device
        (``devbuild.build_delta``), written straight into the column
        tails: the fold never round-trips through the host."""
        dv = devbuild.build_delta(fp_, docidx, self.device)
        if dv.n > self.N2 or dv.n_pairs > self.M2:
            raise _DeltaOverflow(needed_cols=max(dv.n, dv.n_pairs))
        if self.Nb + dv.n >= _MAX_POSTINGS:
            raise self._postings_overflow()
        self.dir2_termids = dv.dir_termids
        self.delta_df = dv.df
        self.dir2_dstart = dv.dir_dstart
        self.dir2_pstart = dv.dir_pstart
        self.all_docids = np.concatenate([self.base_docids, new_docids])
        fit = devbuild.fit
        self.d_payload[self.Nb:].copy_(fit(dv.cols["payload"], self.N2))
        self.d_docc[self.Nb:].copy_(fit(dv.cols["docc"], self.N2))
        self.d_doc[self.Mb:].copy_(fit(dv.cols["doc_col"], self.M2))
        self.d_imp[self.Mb:].copy_(fit(dv.cols["imp16"], self.M2))
        self.d_rs[self.Mb:].copy_(
            devbuild.offset_runstarts(dv, self.Nb, self.M2))
        self.d_cnt[self.Mb:].copy_(fit(dv.cols["cnt"], self.M2))
        self.d_siterank, self.d_doclang = devbuild.doc_meta(
            self.d_siterank, self.d_doclang, dv)

    def _set_empty_delta(self) -> None:
        self.dir2_termids = np.empty(0, np.uint64)
        self.dir2_dstart = np.zeros(1, np.int64)
        self.dir2_pstart = np.zeros(1, np.int64)
        self.delta_df = np.empty(0, np.int64)
        self.all_docids = self.base_docids
        # the delta tails keep whatever they hold: nothing references
        # them while dir2 is empty

    # --- per-doc lookups ---------------------------------------------------

    @property
    def n_docs(self) -> int:
        return len(self.all_docids)

    def columns(self) -> dict[str, torch.Tensor]:
        """The resident device columns by name."""
        return {"payload": self.d_payload, "docc": self.d_docc,
                "doc": self.d_doc, "imp": self.d_imp,
                "rs": self.d_rs, "cnt": self.d_cnt,
                "dense_imp": self.d_dense_imp,
                "dense_rs": self.d_dense_rs,
                "dense_cnt": self.d_dense_cnt, "cube": self.d_cube,
                "siterank": self.d_siterank,
                "doclang": self.d_doclang, "dead": self.d_dead}

    def resident_bytes(self) -> int:
        """Total device bytes this index holds resident."""
        return sum(t.numel() * t.element_size()
                   for t in self.columns().values())

    def _docid_pos(self, docids_arr: np.ndarray, all_docids=None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(row positions, found mask) of docids in ``all_docids`` (the
        index's doc axis unless a snapshot of it is given), which is
        [sorted base] + [sorted delta] and so needs a sorted view. The
        view is kept with the array it sorts: a page build reading it
        while the loop thread's refresh swaps the axis never pairs one
        axis's view with the other's rows."""
        ad = self.all_docids if all_docids is None else all_docids
        view = self._docid_view
        if view is None or view[0] is not ad:
            order = np.argsort(ad, kind="stable")
            view = self._docid_view = (ad, order, ad[order])
        _, order, srt = view
        pos = np.searchsorted(srt, docids_arr)
        ok = pos < len(srt)
        ok[ok] = srt[pos[ok]] == docids_arr[ok]
        rows = np.zeros(len(docids_arr), np.int64)
        rows[ok] = order[pos[ok]]
        return rows, ok

    def _cluster_cols(self):
        """(doc axis, sitehash, langid): the clusterdb columns aligned to
        the doc axis they were built for (Clusterdb.h:42), built lazily
        and again once a refresh has moved the axis."""
        ad = self.all_docids
        cc = self._cluster
        if cc is None or cc[0] is not ad:
            cl = self.coll.clusterdb.get_all()
            sh = np.zeros(len(ad), np.int64)
            lg = np.zeros(len(ad), np.int64)
            if len(cl):
                f = clusterdb_mod.unpack_key(cl.keys)
                rows, ok = self._docid_pos(f["docid"], ad)
                sh[rows[ok]] = f["sitehash"][ok].astype(np.int64)
                lg[rows[ok]] = f["langid"][ok].astype(np.int64)
            cc = self._cluster = (ad, sh, lg)
        return cc

    def sitehashes_of(self, docids) -> np.ndarray:
        """The docids' sitehashes from the clusterdb column (0 for a
        docid off the doc axis), with one search for all of them: site
        clustering runs off them without a titledb read (Msg51.h:96)."""
        ad, sh, _ = self._cluster_cols()
        rows, ok = self._docid_pos(np.asarray(docids, np.uint64), ad)
        return np.where(ok, sh[rows], 0)

    def sitehash_of(self, docid: int) -> int:
        """One docid's :meth:`sitehashes_of`."""
        return int(self.sitehashes_of([docid])[0])

    def langid_of(self, docid: int) -> int:
        """Docid → langid from the same clusterdb columns."""
        ad, _, lg = self._cluster_cols()
        rows, ok = self._docid_pos(np.array([docid], np.uint64), ad)
        return int(lg[rows[0]]) if ok[0] else 0

    # --- fielddb columns (gbmin/gbmax/gbsortby: the datedb role) ---------

    def _field_col(self, fld: str) -> np.ndarray:
        """Dense float64 [n_docs] column of one field aligned to
        all_docids (NaN = the doc has no value), cached per fielddb
        version."""
        ver = self.coll.fielddb.rdb.version
        hit = self._fcols.get((fld, ver))
        if hit is not None:
            return hit
        docids, vals = self.coll.fielddb.column(fld)
        col = np.full(len(self.all_docids), np.nan)
        if len(docids):
            rows, ok = self._docid_pos(docids)
            col[rows[ok]] = vals[ok]
        if len(self._fcols) > 32:
            self._fcols.clear()
        self._fcols[(fld, ver)] = col
        return col

    def sort_base_of(self, fld: str, desc: bool) -> float | None:
        """This index's minimum finite sort key of a field (v descending,
        -v ascending); None without a finite value."""
        col = self._field_col(fld)
        key = col if desc else -col
        fin = np.isfinite(key)
        return float(key[fin].min()) if fin.any() else None

    def _filter_sort_cols(self, p: ResidentPlan):
        """(d_filter bool [D_cap] or None, d_sort float32 [D_cap] or None)
        for one wave, kept on the device per (spec, fielddb version).
        The filter ANDs every field's range (NaN fails both bounds); the
        sort key is ``key - sort_base + 1`` in float64 (0.25 for a
        missing field), cast to float32 once."""
        ck = (_spec(p), self.coll.fielddb.rdb.version)
        hit = self._fswave.get(ck)
        if hit is not None:
            return hit
        d_filter = d_sort = None
        if p.filters:
            mask = np.ones(len(self.all_docids), bool)
            for fld, (lo, hi) in p.filters:
                col = self._field_col(fld)
                with np.errstate(invalid="ignore"):
                    mask &= (col >= lo) & (col <= hi)
            fpad = np.zeros(self.D_cap, bool)
            fpad[: len(mask)] = mask
            d_filter = self._put(fpad)
        if p.sortby is not None:
            fld, desc = p.sortby
            col = self._field_col(fld)
            key = col if desc else -col
            key = np.where(np.isfinite(key), key - p.sort_base + 1.0, 0.25)
            spad = np.zeros(self.D_cap, np.float32)
            spad[: len(key)] = key.astype(np.float32)
            d_sort = self._put(spad)
        if len(self._fswave) > 16:
            self._fswave.clear()
        self._fswave[ck] = (d_filter, d_sort)
        return d_filter, d_sort

    # --- planning ----------------------------------------------------------

    @property
    def df_generation(self):
        """The posdb version this resident base was built at: the memo
        key of a cluster-wide df cache (``MeshResident._global_df`` sums
        ``_df_of`` over the shards, and a shard's sum holds until its own
        base moves)."""
        return self._built_version

    def _resolve(self, termids: np.ndarray) -> tuple[list, list]:
        """Each of ``termids`` (uint64, any order) against both term
        directories, one vectorized search per directory. Returns per
        term its runs, ``[(is_base, dstart, dlen, dense_slot, cube_slot,
        pstart, plen)]`` (the base run before the delta run, each only
        where the term has doc pairs there; delta columns live past Mb /
        Nb; slots -1 where absent), and its exact document frequency
        under pending deletes and re-adds: base df − superseded-doc pairs
        + delta df, at least 0."""
        runs: list[list] = [[] for _ in range(len(termids))]
        df = np.zeros(len(termids), np.int64)
        for is_base, dirs, dstart, pstart, dir_df, d_off, p_off in (
                (True, self.dir_termids, self.dir_dstart, self.dir_pstart,
                 self.live_base_df, 0, 0),
                (False, self.dir2_termids, self.dir2_dstart,
                 self.dir2_pstart, self.delta_df, self.Mb, self.Nb)):
            i = np.searchsorted(dirs, termids)
            hit = i < len(dirs)
            hit[hit] = dirs[i[hit]] == termids[hit]
            u, i = np.nonzero(hit)[0], i[hit]
            df[u] += dir_df[i]
            # dense and cube rows hold base runs only
            none = np.full(len(i), -1, np.int32)
            dslot = self.dir_dense_slot[i] if is_base else none
            cslot = self.dir_cube_slot[i] if is_base else none
            dlen = dstart[i + 1] - dstart[i]
            has = dlen > 0
            for row in zip(u[has].tolist(), (dstart[i] + d_off)[has].tolist(),
                           dlen[has].tolist(), dslot[has].tolist(),
                           cslot[has].tolist(),
                           (pstart[i] + p_off)[has].tolist(),
                           (pstart[i + 1] - pstart[i])[has].tolist()):
                runs[row[0]].append((is_base, *row[1:]))
        return runs, np.maximum(df, 0).tolist()

    def _df_of(self, termid: int) -> int:
        """One term's exact document frequency (``_resolve``'s)."""
        return self._resolve(np.array([termid], np.uint64))[1][0]

    def plan(self, qplan: QueryPlan, df_of=None,
             total_docs: int | None = None,
             sort_base_of=None) -> ResidentPlan:
        """The host plan of one query: :meth:`plan_batch` of one."""
        return self.plan_batch([qplan], df_of=df_of, total_docs=total_docs,
                               sort_base_of=sort_base_of)[0]

    def plan_batch(self, qplans: list[QueryPlan], df_of=None,
                   total_docs: int | None = None,
                   sort_base_of=None) -> list[ResidentPlan]:
        """The host plans of a batch of queries: every sublist's distinct
        termid resolved against the term directories at once
        (``_resolve``), then each query planned from those arrays.
        ``df_of``, ``total_docs`` and ``sort_base_of`` override this
        index's term document frequencies, doc count and sort-key base: a
        mesh passes the cluster-wide values, so every shard weighs terms
        alike and cross-shard scores merge (the reference ships global
        termFreqWeights in the Msg39 request); ``df_of`` is called once
        per distinct termid."""
        tids = [s.termid for qp in qplans for g in qp.groups
                for s in g.sublists]
        terms, inv = np.unique(np.array(tids, np.uint64),
                               return_inverse=True)
        g_stats.count("devindex.plan.sublists", len(tids))
        g_stats.count("devindex.plan.terms", len(terms))
        runs, live_df = self._resolve(terms)
        gdfs = live_df if df_of is None else \
            [df_of(t) for t in terms.tolist()]
        inv = inv.tolist()
        plans, k = [], 0
        for qp in qplans:
            n = sum(len(g.sublists) for g in qp.groups)
            plans.append(self._plan_query(qp, inv[k:k + n], runs, live_df,
                                          gdfs, total_docs, sort_base_of))
            k += n
        return plans

    def _plan_query(self, qplan: QueryPlan, ks: list, runs: list,
                    live_df: list, gdfs: list, total_docs: int | None,
                    sort_base_of) -> ResidentPlan:
        """One query's plan: its dense, sparse, cube and posting-scatter
        rows, group flags, route eligibility and numeric operators.
        ``ks[j]`` indexes the resolved ``runs``, ``live_df`` and ``gdfs``
        (the df that weighs the group) of the query's j-th sublist."""
        T = _bucket(max(len(qplan.groups), 1), T_FLOOR)
        drows, srows, crows, prows = [], [], [], []
        dfs = np.zeros(max(len(qplan.groups), 1), np.int64)
        matchable = True
        any_required = False
        driver_df = 1 << 60
        groups_have_postings = []
        # direct-cube qualification: per group, the contributing runs
        zq = 4 * self.cube_zero_slot
        g_quarter = np.full((T, 4), zq, np.int32)
        g_qsyn = np.zeros((T, 4), np.uint32)
        direct_ok = True
        at = 0
        for g_i, g in enumerate(qplan.groups):
            subs = g.sublists
            g_ks = ks[at:at + len(subs)]
            at += len(subs)
            sub_druns = [runs[u] for u in g_ks]
            # quota only over sublists with LIVE postings (df under
            # tombstones), as the host packer's fetched-list mask, and
            # the local live dfs fund the variants on both paths (never
            # the cluster-wide df_of: the host path cannot see it)
            sub_live_df = [live_df[u] for u in g_ks]
            sp = g.slot_plan(
                self.P,
                present=[bool(d) and ldf > 0
                         for d, ldf in zip(sub_druns, sub_live_df)],
                df=sub_live_df)
            any_postings = False
            g_runs = []
            for s_i, sub in enumerate(subs):
                syn = 1 if sub.kind == SUB_SYNONYM else 0
                base, quota = sp[s_i]
                for is_base, a, ln, dslot, cslot, pa, pl in sub_druns[s_i]:
                    g_runs.append((is_base, dslot, cslot, syn, base, quota))
                    # F1 rows: dense [D] impact row, or sparse runs
                    # chunked at LSP_MAX lanes
                    if dslot >= 0:
                        drows.append((dslot, g_i, base, quota, syn))
                    else:
                        for off in range(0, ln, LSP_MAX):
                            srows.append((a + off, min(ln - off, LSP_MAX),
                                          g_i, base, quota, syn, is_base))
                    # F2 rows: materialized cube slice, or bounded
                    # posting-scatter rows
                    if cslot >= 0:
                        crows.append((cslot, dslot, g_i, base, quota, syn))
                    else:
                        for off in range(0, pl, F2_SCATTER_MAX):
                            prows.append((pa + off,
                                          min(pl - off, F2_SCATTER_MAX),
                                          g_i, base, quota, syn, is_base))
                    any_postings = True
            gdf = max([0] + [gdfs[u] for u in g_ks])
            dfs[g_i] = gdf
            groups_have_postings.append(any_postings)
            # FD: cube runs must be base runs at quarter-aligned (base,
            # quota); non-cube runs go to the bounded scatter tail
            P4 = self.P // 4
            for is_b, dsl, csl, syn, base, quota in g_runs:
                if csl < 0:
                    continue
                if not (is_b and base % P4 == 0 and quota % P4 == 0
                        and quota > 0 and base + quota <= self.P):
                    direct_ok = False
                    continue
                for k in range(min(quota, self.P - base) // P4):
                    g_quarter[g_i, base // P4 + k] = 4 * csl + k
                    g_qsyn[g_i, base // P4 + k] = syn
            if g.required and not g.negative:
                any_required = True
                driver_df = min(driver_df, gdf)
                if not any_postings:
                    matchable = False
        # FD needs the scatter tail bounded, and at most 8 groups
        if (len(prows) > FD_SCATTER_MAX_ROWS
                or sum(p[1] for p in prows) > FD_SCATTER_MAX_LANES):
            direct_ok = False
        if len(qplan.groups) > 8:
            direct_ok = False
        if qplan.bool_table is not None:
            # servable iff some satisfying presence assignment uses only
            # groups with postings; the match bound is the union
            tbl = qplan.bool_table
            bits = np.arange(len(tbl))
            havemask = sum(1 << i for i, h in
                           enumerate(groups_have_postings) if h)
            matchable = bool(tbl[(bits & ~havemask) == 0].any())
            driver_df = int(min(dfs.sum(), self.coll.num_docs or dfs.sum()))
        elif not any_required:
            matchable = False

        required, negative, scored, counts = group_flags(qplan, T)
        freqw = _pad1(weights.term_freq_weight(
            dfs[: len(qplan.groups)],
            max(total_docs if total_docs is not None
                else self.coll.num_docs, 1)), T, 0.5)
        da = np.array(drows, np.int64).reshape(-1, 5)
        sa = np.array(srows, np.int64).reshape(-1, 7)
        ca = np.array(crows, np.int64).reshape(-1, 6)
        pa_ = np.array(prows, np.int64).reshape(-1, 7)
        return ResidentPlan(
            d_slot=da[:, 0].astype(np.int32),
            d_group=da[:, 1].astype(np.int32),
            d_base=da[:, 2].astype(np.int32),
            d_quota=da[:, 3].astype(np.int32),
            d_syn=da[:, 4].astype(np.uint32),
            s_start=sa[:, 0].astype(np.int32),
            s_len=sa[:, 1].astype(np.int32),
            s_group=sa[:, 2].astype(np.int32),
            s_base=sa[:, 3].astype(np.int32),
            s_quota=sa[:, 4].astype(np.int32),
            s_syn=sa[:, 5].astype(np.uint32),
            s_isbase=sa[:, 6].astype(bool),
            c_slot=ca[:, 0].astype(np.int32),
            c_dslot=ca[:, 1].astype(np.int32),
            c_group=ca[:, 2].astype(np.int32),
            c_base=ca[:, 3].astype(np.int32),
            c_quota=ca[:, 4].astype(np.int32),
            c_syn=ca[:, 5].astype(np.uint32),
            p_start=pa_[:, 0].astype(np.int32),
            p_len=pa_[:, 1].astype(np.int32),
            p_group=pa_[:, 2].astype(np.int32),
            p_base=pa_[:, 3].astype(np.int32),
            p_quota=pa_[:, 4].astype(np.int32),
            p_syn=pa_[:, 5].astype(np.uint32),
            p_isbase=pa_[:, 6].astype(bool),
            freq_weight=freqw, required=required, negative=negative,
            scored=scored, counts=counts,
            table=pad_table(qplan.bool_table),
            qlang=qplan.lang, matchable=matchable,
            driver_df=0 if driver_df == 1 << 60 else int(driver_df),
            n_scored=int(np.sum(counts)),
            direct_ok=direct_ok, g_quarter=g_quarter, g_qsyn=g_qsyn,
            has_table=qplan.bool_table is not None,
            filters=tuple(sorted(
                (f, tuple(v)) for f, v in qplan.filters.items())),
            sortby=qplan.sortby,
            sort_base=(((sort_base_of or self.sort_base_of)(*qplan.sortby)
                        or 0.0) if qplan.sortby is not None else 0.0))

    # --- execution -------------------------------------------------------

    def search(self, q: str | QueryPlan, topk: int = 64, lang: int = 0):
        """One query → (docids, scores, n_matched)."""
        return self.search_batch([q], topk=topk, lang=lang)[0]

    def search_batch(self, queries, topk: int = 64, lang: int = 0,
                     df_of=None, total_docs: int | None = None,
                     sort_base_of=None):
        """B queries → [(docids uint64, scores float32, n_matched)].
        Drivers with a bounded doc set take F1; corpus-wide drivers take
        FD when their groups are quarter-aligned cube rows, else F2. The
        overrides are :meth:`plan`'s."""
        return self.collect_batch(self.issue_batch(
            queries, topk=topk, lang=lang, df_of=df_of,
            total_docs=total_docs, sort_base_of=sort_base_of))

    def issue_batch(self, queries, topk: int = 64, lang: int = 0,
                    df_of=None, total_docs: int | None = None,
                    sort_base_of=None) -> PendingBatch:
        """Plan, route and queue the first round of waves on the device,
        with the copy of their result rows to the host: nothing waits
        for the device. Plans with a cluster-wide override are not
        cached: their values belong to the caller."""
        with trace.span("devindex.plan", queries=len(queries)):
            qplans = [q if isinstance(q, QueryPlan)
                      else compile_query(q, lang) for q in queries]
            if df_of is None and total_docs is None \
                    and sort_base_of is None:
                # the generation is read before the plans build: a write
                # landing meanwhile leaves the stored entries dead, never
                # a pre-write plan passing as fresh
                pgen = self._plan_cache.current_gen()
                plans = [None] * len(qplans)
                # the misses, one plan per distinct key, planned together
                miss: dict[tuple, list[int]] = {}
                for i, qp in enumerate(qplans):
                    ck = (qp.raw, qp.lang)
                    hit, p = self._plan_cache.lookup(ck, gen=pgen)
                    if hit:
                        plans[i] = p
                    else:
                        miss.setdefault(ck, []).append(i)
                if miss:
                    fresh = self.plan_batch([qplans[ix[0]]
                                             for ix in miss.values()])
                    for (ck, ix), p in zip(miss.items(), fresh):
                        self._plan_cache.put(ck, p, gen=pgen)
                        for i in ix:
                            plans[i] = p
            else:
                plans = self.plan_batch(qplans, df_of=df_of,
                                        total_docs=total_docs,
                                        sort_base_of=sort_base_of)
        live = [i for i, p in enumerate(plans) if p.matchable]
        results = [(np.empty(0, np.uint64), np.empty(0, np.float32), 0)
                   ] * len(plans)
        if not live:
            return PendingBatch(plans=plans, results=results, waves=[],
                                k_req=0, k2v=0, f2_nsel=0, bmax=0,
                                topk=topk)
        # corpus-relative routing: a driver matching more than ~1/8 of
        # the corpus (capped at the κ ladder's top rung) prunes badly
        f2_cut = min(4 * _env_int("OSSE_CUBE_MIN_DF", CUBE_MIN_DF),
                     max(2 * KAPPA_FLOOR, self.n_docs // 8))

        def _route_f2(i):
            p = plans[i]
            if (p.n_scored <= 1 and not p.has_table
                    and len(p.s_start) <= 16):
                # one scored group with bounded sparse rows: the phase-1
                # bound IS the exact single-term score, so F1 at the
                # smallest κ is exact ordering at any driver df
                return False
            if p.driver_df > f2_cut:
                return True
            # heavy multi-group queries that can go direct should: FD
            # scores the whole corpus at flat cost and never escalates
            return (p.direct_ok and p.n_scored > 1
                    and self._kappa_of(p, topk) >= 8 * KAPPA_FLOOR)

        f2 = [i for i in live if _route_f2(i)]
        f1 = [i for i in live if i not in set(f2)]
        self.route_counts["f1"] += len(f1)
        self.route_counts["fd"] += sum(1 for i in f2 if plans[i].direct_ok)
        self.route_counts["f2"] += sum(1 for i in f2
                                       if not plans[i].direct_ok)
        # k is bucketed (floor 64); the phase-2 width k2 is 128 for
        # everyday requests, larger only for deep pages
        k_req = min(_bucket(max(topk, 1), 64), self.D_cap)
        k2v = min(max(128, k_req), self.D_cap)
        # the F2/FD selection rung starts at the requested depth
        f2_floor = 4096 if self.D_cap >= (1 << 19) else 2048
        f2_nsel = min(max(f2_floor, _bucket(k_req, 2048)), self.D_cap)
        bmax = self._f2_bmax()
        waves = self._issue_waves(plans, f1, f2, topk, k2v, f2_nsel, bmax)
        return PendingBatch(plans=plans, results=results, waves=waves,
                            k_req=k_req, k2v=k2v, f2_nsel=f2_nsel,
                            bmax=bmax, topk=topk,
                            fetch=self._queue_fetch([w[4] for w in waves]))

    def _issue_waves(self, plans, f1, f2, topk, k2v, f2_nsel, bmax):
        """Build and queue one round of waves; the caller fetches every
        wave's output at once."""
        waves = []
        with trace.span("devindex.issue"):
            # waves never mix filter/sort specs: the columns are per-wave
            groups: dict[tuple, list[int]] = {}
            for i in f1:
                kapi = self._kappa_of(plans[i], topk)
                # phase-2 truncation to the top-k2 by bound is sound in
                # practice only for single-scored-group plans, whose
                # bound ≈ the exact score; multi-group plans score every
                # selected candidate
                if plans[i].n_scored <= 1:
                    k2i = min(max(k2v, plans[i].k2_min), kapi)
                else:
                    k2i = kapi
                groups.setdefault((kapi, k2i, _spec(plans[i])),
                                  []).append(i)
            for (kappa, k2g, _), idxs in sorted(
                    groups.items(), key=lambda kv: (*kv[0][:2],
                                                    str(kv[0][2]))):
                # terminal rungs chunk small: the [B, T, P, k2] phase-2
                # intermediates stay bounded at k2 = D_cap
                step = self._f1_bmax() if k2g <= 32 * KAPPA_FLOOR \
                    else self._f1_step_terminal()
                for a in range(0, len(idxs), step):
                    chunk = idxs[a:a + step]
                    waves.append(("f1", kappa, k2g, chunk, self._costed_f1(
                        [plans[i] for i in chunk], kappa, k2g)))
            fd = [i for i in f2 if plans[i].direct_ok]
            fg = [i for i in f2 if not plans[i].direct_ok]

            # FD waves group by scatter-tail size, so pure quarter-row
            # queries run the no-tail kernel and one heavy tail does not
            # widen every lane of its wave
            def _lp_of(i):
                p = plans[i]
                ml = int(p.p_len.max()) if len(p.p_len) else 0
                if ml == 0:
                    return 0
                return 512 if ml <= 512 else (
                    F2_LPOST_FLOOR if ml <= F2_LPOST_FLOOR
                    else F2_SCATTER_MAX)
            # F2 and FD waves partition by (Lp, spec) and spec
            fd_parts: dict = {}
            for i in fd:
                fd_parts.setdefault((_lp_of(i), _spec(plans[i])),
                                    []).append(i)
            fd_step = self._fd_bmax()
            for _, idxs in sorted(fd_parts.items(),
                                  key=lambda kv: (kv[0][0], str(kv[0][1]))):
                for a in range(0, len(idxs), fd_step):
                    chunk = idxs[a:a + fd_step]
                    waves.append(("f2", 0, k2v, chunk, self._costed_fd(
                        [plans[i] for i in chunk], k2v, f2_nsel)))
            fg_parts: dict = {}
            for i in fg:
                fg_parts.setdefault(_spec(plans[i]), []).append(i)
            for _, idxs in sorted(fg_parts.items(),
                                  key=lambda kv: str(kv[0])):
                for a in range(0, len(idxs), bmax):
                    chunk = idxs[a:a + bmax]
                    waves.append(("f2", 0, k2v, chunk, self._costed_f2(
                        [plans[i] for i in chunk], k2v, f2_nsel)))
        return waves

    def _queue_fetch(self, outs: list[torch.Tensor]) -> tuple:
        """Queue every wave's packed rows for one device → host copy into
        a pinned buffer of their own (two batches in flight never share
        one), and record the event that marks it done. Returns what
        :meth:`_wait_fetch` takes."""
        shapes = [o.shape for o in outs]
        if not outs:
            return None, None, shapes
        flat = torch.cat([o.reshape(-1) for o in outs])
        if jitwatch.g_jitwatch.enabled:
            jitwatch.note_transfer("_queue_fetch", "d2h",
                                   flat.numel() * flat.element_size())
        if flat.device.type != "cuda":
            return flat, None, shapes
        host = torch.empty(flat.numel(), dtype=torch.int32, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(flat.device))
        return host, done, shapes

    def _wait_fetch(self, fetch: tuple) -> list[np.ndarray]:
        """Wait for one queued copy (its event only, not the stream) and
        split it back into the waves' rows."""
        host, done, shapes = fetch
        if done is not None:
            done.synchronize()
        arr = host.numpy() if host is not None else None
        res, off = [], 0
        for shape in shapes:
            n = int(np.prod(shape))
            res.append(arr[off:off + n].reshape(shape))
            off += n
        return res

    def collect_batch(self, pending: PendingBatch):
        """Fetch and parse every issued wave, re-issuing the escalation
        rungs until every query emits; one fetch per round."""
        plans, results = pending.plans, pending.results
        waves, f2_nsel = pending.waves, pending.f2_nsel
        k_req = pending.k_req
        fetch = pending.fetch
        while waves:
            t_fetch = time.perf_counter()
            with trace.span("devindex.device", waves=len(waves)):
                outs = self._wait_fetch(fetch)
            t_got = time.perf_counter()
            f1_next: list[int] = []
            f2_next: list[int] = []
            for (kind, kappa, k2g, idxs, _), out in zip(waves, outs):
                for row, i in zip(out, idxs):
                    k2p = min(k2g, f2_nsel, self.D_cap) if kind == "f2" \
                        else k2g
                    nm, missed, idx, scores = self._parse_out(row, k2p)
                    kth = float(scores[k_req - 1]) if (
                        k2p >= k_req and scores[k_req - 1] > 0.0) else 0.0
                    if missed > kth * _TIE_TOL:
                        if kind == "f1" and (kappa < self.D_cap
                                             or k2p < self.D_cap):
                            # pruning miss: widen κ and the phase-2
                            # width; terminal at κ = k2 = D_cap
                            plans[i].kappa_min = min(4 * kappa, self.D_cap)
                            plans[i].k2_min = min(
                                4 * max(k2p, KAPPA_FLOOR // 2), self.D_cap)
                            f1_next.append(i)
                            continue
                        if kind == "f2" and f2_nsel < self.D_cap:
                            f2_next.append(i)
                            continue
                    if devcheck.enabled():
                        # finite, sorted, in bounds; apply_fault is the
                        # injector of the tests and the chip smoke
                        idx, scores = devcheck.apply_fault(
                            idx, scores, self.n_docs)
                        devcheck.check_topk(scores, idx, self.n_docs,
                                            route=kind)
                    self._emit(results, i, nm, idx, scores)
            self.escalations += len(f1_next) + len(f2_next)
            if devwatch.enabled():
                # the flight recorder's round: the device wait and the
                # fetched bytes beside the modelled F1 wave bytes
                devwatch.note_round(
                    coll=self.coll.name,
                    kinds="+".join(sorted({w[0] for w in waves})),
                    waves=len(waves), device_s=t_got - t_fetch,
                    bytes_out=int(sum(o.nbytes for o in outs)),
                    modeled_f1_bytes=int(sum(
                        self.wave_bytes_per_query(
                            [plans[i] for i in w[3]]) * len(w[3])
                        for w in waves if w[0] == "f1")),
                    escalations=len(f1_next) + len(f2_next))
            f2_nsel = min(f2_nsel * 4, self.D_cap)
            waves = self._issue_waves(
                plans, f1_next, f2_next, pending.topk, pending.k2v,
                f2_nsel, pending.bmax) if (f1_next or f2_next) else []
            fetch = self._queue_fetch([w[4] for w in waves])
        return results

    def _parse_out(self, row: np.ndarray, k2: int):
        nm = int(row[0])
        missed = float(row[1:2].view(np.float32)[0])
        idx = row[2:2 + k2].astype(np.int64)
        scores = row[2 + k2:].view(np.float32)
        return nm, missed, idx, scores

    def _emit(self, results, i, nm, idx, scores):
        keep = scores > 0.0
        results[i] = (
            self.all_docids[np.clip(idx[keep], 0, max(self.n_docs - 1, 0))],
            scores[keep], nm)

    def _kappa_of(self, p: ResidentPlan, topk: int) -> int:
        """κ rung for a plan. One scored group gets the smallest rung (its
        bound is the exact score up to float association); multi-group
        plans rung by driver df, since their pair bounds are loose."""
        if p.n_scored <= 1:
            need = max(KAPPA_FLOOR, 2 * topk, p.kappa_min)
        else:
            need = max(KAPPA_FLOOR, 2 * topk, p.driver_df, p.kappa_min)
        for rung in (KAPPA_FLOOR, 8 * KAPPA_FLOOR, 32 * KAPPA_FLOOR):
            if need <= rung:
                return min(rung, self.D_cap)
        return min(_bucket(need, KAPPA_FLOOR), self.D_cap)

    def _f1_bmax(self) -> int:
        """Largest F1 wave (power of two ≤ 64): phase-1 intermediates run
        ~128·D bytes per query."""
        cap = max(4, (2 << 30) // (128 * self.D_cap))
        b = 4
        while b * 2 <= cap and b < 64:
            b *= 2
        return b

    def _f1_step_terminal(self) -> int:
        """Terminal-rung (k2 = D_cap) chunk: ~2048·D bytes per query."""
        return max(1, min(4, (2 << 30) // (2048 * self.D_cap)))

    def _f2_bmax(self) -> int:
        """F2 wave cap: ~48 bytes per doc and query of cube, validity and
        scores, bounded to ~1.5 GB."""
        per_q = 48 * MAX_POSITIONS * self.D_cap
        return max(4, min(16, (1536 << 20) // max(per_q, 1)))

    def _fd_bmax(self) -> int:
        """FD wave cap: K2 never materializes the per-query cube; the
        only [T, P, D]-scale tensor is the posting tail (T ≤ 8)."""
        per_q = 8 * MAX_POSITIONS * self.D_cap * 4
        return max(4, min(16, (4 << 30) // max(per_q, 1)))

    # --- roofline attribution ------------------------------------------

    def wave_bytes_per_query(self, plans: list[ResidentPlan],
                             packed: bool = True) -> float:
        """Modelled HBM bytes the F1 wave path streams per query, the
        reference's model as it stands (its packed layout: f16 impacts,
        uint8 doc meta, length-bucketed Lsp tiles; or the unpacked one:
        f32 impacts, int32 meta, flat 2048-lane tiles), with its bucket
        ladders, so that it reads the same for the same plans."""
        imp = 2 if packed else 4
        meta = 1 if packed else 4
        V = self.d_dense_imp.shape[0]
        D = self.D_cap
        B = max(len(plans), 1)
        total = 0.0
        for p in plans:
            Rs = _row_bucket(max(len(p.s_start), 1))
            mls = int(p.s_len.max()) if len(p.s_len) else 0
            Lsp = _lsp_bucket(mls) if packed else LSP_BUCKETS[-1]
            Rd = _row_bucket(max(len(p.d_slot), 1))
            T = max(len(p.required), 1)
            k2 = min(128, D)
            # sparse lane gathers: doc4 + imp + rs4 + cnt1 + dead1
            total += Rs * Lsp * (4 + imp + 4 + 1 + 1)
            # doc-meta columns the multiplier/alive gates stream [D]
            total += D * (meta + meta + 1)
            # phase-2 payload + dense rs/cnt gathers (layout-invariant)
            total += k2 * T * self.P * 4 + Rd * k2 * 5
        # the [V, D] dense impact matrix streams once per WAVE
        total += V * D * imp
        return total / B

    def _costed(self, name: str, bucket: tuple, modeled_bytes, fn,
                *args):
        """Run one wave, roofline-attributing its (kernel, shape bucket)
        on first sight: the work is the sum of the wave's kernel
        launches' counts (``work()`` beside each kernel), so every shape
        has a bandwidth or compute verdict next to the modelled wave
        bytes."""
        if not devwatch.enabled():
            return fn(*args)
        with devwatch.launches() as thunks:
            out = fn(*args)
        devwatch.note_cost(name, bucket, lambda: devwatch.sum_work(thunks),
                           modeled_bytes=modeled_bytes)
        return out

    def _costed_f1(self, plans, kappa: int, k2: int):
        """F1 under the reference's ``devindex._two_phase`` entry, bucket
        (B, Rd, Rs, Lsp, κ, k2) on its pinned ladders."""
        if not devwatch.enabled():
            return self._run_batch(plans, kappa, k2)
        Rd = _row_bucket(max([len(p.d_slot) for p in plans] + [1]))
        Rs = _row_bucket(max([len(p.s_start) for p in plans] + [1]))
        Lsp = _lsp_bucket(max([int(p.s_len.max()) if len(p.s_len) else 0
                               for p in plans] + [0]))
        B = next((b for b in (4, 8, 16, 32) if len(plans) <= b), 64)
        B = min(B, self._f1_bmax())
        bucket = (B, Rd, Rs, Lsp, kappa, k2)
        # the model is read at the bucket's first dispatch only
        modeled = None if ("devindex._two_phase", bucket) in \
            devwatch.g_devwatch.costs \
            else self.wave_bytes_per_query(plans) * B
        return self._costed("devindex._two_phase", bucket, modeled,
                            self._run_batch, plans, kappa, k2)

    def _costed_f2(self, plans, k2: int, n_sel: int):
        """F2 under ``devindex._full_cube``, bucket (B, Rc, Rp, Lp, k2,
        n_sel)."""
        if not devwatch.enabled():
            return self._run_batch_f2(plans, k2, n_sel)
        Rc = _bucket(max([len(p.c_slot) for p in plans] + [1]), 8)
        mrp = max([len(p.p_start) for p in plans] + [1])
        Rp = 8 if mrp <= 8 else (32 if mrp <= 32 else _bucket(mrp, 64))
        maxlen = max([int(p.p_len.max()) if len(p.p_len) else 1
                      for p in plans] + [1])
        Lp = F2_LPOST_FLOOR if maxlen <= F2_LPOST_FLOOR else F2_SCATTER_MAX
        B = 4 if len(plans) <= 4 else max(self._f2_bmax(), len(plans))
        return self._costed("devindex._full_cube",
                            (B, Rc, Rp, Lp, k2, min(n_sel, self.D_cap)),
                            None, self._run_batch_f2, plans, k2, n_sel)

    def _costed_fd(self, plans, k2: int, n_sel: int):
        """FD under ``devindex._direct_cube``, bucket (B, T, Rp, Lp, k2,
        n_sel)."""
        if not devwatch.enabled():
            return self._run_batch_fd(plans, k2, n_sel)
        T = max(len(p.required) for p in plans)
        mrp = max([len(p.p_start) for p in plans] + [1])
        Rp = 4 if mrp <= 4 else _bucket(mrp, 8)
        maxlen = max([int(p.p_len.max()) if len(p.p_len) else 0
                      for p in plans] + [0])
        Lp = 0 if maxlen == 0 else (512 if maxlen <= 512 else (
            F2_LPOST_FLOOR if maxlen <= F2_LPOST_FLOOR
            else F2_SCATTER_MAX))
        B = 4 if len(plans) <= 4 else max(self._fd_bmax(), len(plans))
        return self._costed("devindex._direct_cube",
                            (B, T, Rp, Lp, k2, min(n_sel, self.D_cap)),
                            None, self._run_batch_fd, plans, k2, n_sel)

    # --- the three wave programs ---------------------------------------

    def _stack(self, plans, name: str, n: int, fill, dtype=None):
        """Per-plan 1-D arrays padded to ``n`` and stacked ``[B, n]`` on
        the device."""
        a = np.stack([_pad1(getattr(p, name), n, fill) for p in plans])
        return self._put(a if dtype is None else a.astype(dtype))

    def _query_state(self, plans, T: int):
        """(freq_weight, required, negative, counts, table, qlang) of a
        wave, padded to its T."""
        return (self._stack(plans, "freq_weight", T, 0.5),
                self._stack(plans, "required", T, False),
                self._stack(plans, "negative", T, False),
                self._stack(plans, "counts", T, False),
                self._put(np.stack([p.table for p in plans])),
                self._put(np.array([[p.qlang] for p in plans], np.int64)))

    def _scatter_postings(self, plans, T: int, n_out: int):
        """Posting-granular scatter of the plans' p-rows (bigrams, delta
        postings, small terms) into a flat zero int32 cube of
        ``len(plans)·T·P·D`` words plus one dropped sentinel word. Its
        validity is payload ≠ 0 (every real posting's payload is
        nonzero). Base postings of dead docs are dropped."""
        P, D = self.P, self.D_cap
        N = self.d_payload.shape[0]
        dev = self.device
        cube = torch.zeros(n_out + 1, dtype=torch.int32, device=dev)
        cols = {k: [] for k in ("p_start", "p_len", "p_group", "p_base",
                                "p_quota", "p_syn", "p_isbase")}
        qb = []
        for b, p in enumerate(plans):
            for k in cols:
                cols[k].append(getattr(p, k))
            qb.append(np.full(len(p.p_start), b, np.int64))
        lp = max([int(p.p_len.max()) for p in plans if len(p.p_len)]
                 + [0])
        if lp == 0:
            return cube
        h = {k: self._put(np.concatenate(v).astype(np.int64))
             for k, v in cols.items()}
        qb = self._put(np.concatenate(qb))
        lane = torch.arange(lp, device=dev)
        idxc = (h["p_start"][:, None] + lane).clamp(0, N - 1)
        m = lane < h["p_len"][:, None]
        docc = self.d_docc[idxc]
        doc = ((docc >> _OCC_BITS) & 0x0FFFFFFF).long()
        occ = (docc & _OCC_MASK).long()
        synbit = torch.where(h["p_syn"] != 0, _SYN_BIT, 0).to(torch.int32)
        pay = self.d_payload[idxc] | synbit[:, None]
        dead_l = self.d_dead[doc.clamp(0, D - 1)]
        ok = (m & (occ < h["p_quota"][:, None])
              & ~(dead_l & (h["p_isbase"][:, None] != 0)))
        slot = h["p_base"][:, None] + occ
        tgt = torch.where(
            ok, ((qb[:, None] * T + h["p_group"][:, None]) * P + slot) * D
            + doc, n_out).reshape(-1)
        cube.index_add_(0, tgt, torch.where(ok, pay, 0).reshape(-1))
        return cube

    def _finish(self, p: ResidentPlan, match, ms, qlang, k2: int,
                n_sel: int):
        """F2/FD finish: the wave's range gate, the score (the sort key
        under gbsortby), then the selection."""
        d_filter, d_sort = self._filter_sort_cols(p)
        if d_filter is not None:
            match = match & d_filter
        if d_sort is not None:
            final = torch.where(match, d_sort, 0.0)
        else:
            final = torch.where(
                match, ms * final_multipliers(self.d_siterank,
                                              self.d_doclang, qlang), 0.0)
        return self._select(final, match.sum(dim=1), k2, n_sel)

    def _select(self, final, nm, k2: int, n_sel: int):
        """F2/FD selection: block winners, then an exact top-k2 over them;
        the packed rows."""
        D = self.D_cap
        w_vals, w_idx, missed = _block_topn(final, min(n_sel, D))
        ts, tl = top_k(w_vals, min(k2, n_sel, D))
        return _out_rows(nm, missed, torch.gather(w_idx, 1, tl), ts)

    def _run_batch(self, plans: list[ResidentPlan], kappa: int, k2: int):
        """F1 (the reference's ``_two_phase``) for a wave of plans: a
        batch dimension written out where the reference vmaps."""
        dev = self.device
        B = len(plans)
        T = max(len(p.required) for p in plans)
        P, D = self.P, self.D_cap
        N, M = self.d_payload.shape[0], self.d_doc.shape[0]
        V = self.d_dense_imp.shape[0]
        Rd = max([len(p.d_slot) for p in plans] + [1])
        Rs = max([len(p.s_start) for p in plans] + [1])
        Lsp = max([int(p.s_len.max()) for p in plans if len(p.s_len)]
                  + [1])
        freqw, required, negative, counts, table, qlang = \
            self._query_state(plans, T)
        use_table = any(p.has_table for p in plans)
        d_filter, d_sort = self._filter_sort_cols(plans[0])
        t_ax = torch.arange(T, device=dev)
        live = ~self.d_dead

        # ---- phase 1: dense rows. ubb[b, t] = Σ_v sel[b, t, v] ·
        # dense_imp[v] over the few dense rows the wave's selector
        # touches. The reference multiplies float16 by float16 with
        # float32 accumulation; here the touched rows are upcast to
        # float64 and the product is rounded once to float32: exact, and
        # bit for bit the reference's bound whenever a group has at most
        # two dense rows. A float32 product could take TF32 or reduced
        # precision under torch's global switches; float64 takes neither.
        used = sorted({int(s) for p in plans for s in p.d_slot if s >= 0})
        if used:
            col = {s: j for j, s in enumerate(used)}
            sel = np.zeros((B * T, len(used)), np.float64)
            for b, p in enumerate(plans):
                for slot, g in zip(p.d_slot, p.d_group):
                    if slot >= 0:
                        sel[b * T + g, col[int(slot)]] += 1.0
            rows = self.d_dense_imp[self._put(np.array(used, np.int64))]
            ubb = (self._put(sel) @ rows.to(torch.float64)).to(
                torch.float32).view(B, T, D) * IMPACT_SCALE
        else:
            ubb = torch.zeros((B, T, D), dtype=torch.float32, device=dev)

        # ---- phase 1: sparse rows, one gather, then a fold into [T, D]
        # one row at a time in row order; base lanes of dead docs drop at
        # gather time
        s_start = self._stack(plans, "s_start", Rs, 0, np.int64)
        s_len = self._stack(plans, "s_len", Rs, 0, np.int64)
        s_group = self._stack(plans, "s_group", Rs, 0, np.int64)
        s_isbase = self._stack(plans, "s_isbase", Rs, True)
        lane = torch.arange(Lsp, device=dev)
        sidxc = (s_start[:, :, None] + lane).clamp(0, M - 1)  # [B,Rs,L]
        smask = lane < s_len[:, :, None]
        sdoc = self.d_doc[sidxc].long()
        simp = self.d_imp[sidxc].to(torch.float32) * IMPACT_SCALE
        sdead = self.d_dead[sdoc.clamp(0, D - 1)]
        skeep = smask & ~(s_isbase[:, :, None] & sdead)
        tgt = torch.where(skeep, s_group[:, :, None] * D + sdoc, T * D)
        sval = torch.where(skeep, simp, 0.0)
        ubs = _fold_rows(T * D + 1, tgt, sval)
        ub = ubb * live + ubs[:, :T * D].view(B, T, D)
        # each sparse row's runstart and count per doc, for phase 2
        rstgt = torch.where(
            smask, torch.arange(Rs, device=dev)[None, :, None] * D + sdoc,
            Rs * D).view(B, -1)
        rsacc = torch.zeros((B, Rs * D + 1), dtype=torch.int32, device=dev)
        rsacc.scatter_(1, rstgt, torch.where(
            smask, self.d_rs[sidxc], 0).view(B, -1))
        cntacc = torch.zeros((B, Rs * D + 1), dtype=torch.uint8,
                             device=dev)
        cntacc.scatter_(1, rstgt, torch.where(
            smask, self.d_cnt[sidxc], 0).to(torch.uint8).view(B, -1))

        # ---- intersection + admissible min bound
        present = ub > 0.0                                    # [B, T, D]
        ubw = ub * (freqw * freqw)[:, :, None]
        alive = (match_gates(present, required, negative, table, use_table)
                 & (torch.arange(D, device=dev) < self.n_docs))
        if d_filter is not None:
            alive = alive & d_filter  # the gbmin:/gbmax: range gate
        m1 = present & counts[:, :, None]
        ubw_m = torch.where(m1, ubw, BIG)
        min_single_ub = ubw_m.amin(dim=1)
        if T <= MAX_PAIR_SPAN + 1:
            # every pair is within the span: the pair-bound min is
            # √(min1·min2) over the two smallest present scored bounds
            npres = m1.sum(dim=1)
            am = ubw_m.argmin(dim=1)
            min2 = torch.where(t_ax[None, :, None] == am[:, None, :], BIG,
                               ubw_m).amin(dim=1)
            min_pair_ub = torch.sqrt(min_single_ub * min2)
            any_pair = npres >= 2
        else:
            min_pair_ub = torch.full((B, D), BIG, device=dev)
            any_pair = torch.zeros((B, D), dtype=torch.bool, device=dev)
            for i in range(T):
                for j in range(i + 1, min(i + 1 + MAX_PAIR_SPAN, T)):
                    ok = (present[:, i] & present[:, j]
                          & (counts[:, i] & counts[:, j])[:, None])
                    pu = torch.sqrt(ubw[:, i] * ubw[:, j])
                    min_pair_ub = torch.where(
                        ok, torch.minimum(min_pair_ub, pu), min_pair_ub)
                    any_pair = any_pair | ok
        ubmin = torch.minimum(torch.where(any_pair, min_pair_ub, BIG),
                              min_single_ub)
        ubmin = torch.where(m1.any(dim=1), ubmin, 1.0)
        mult = final_multipliers(self.d_siterank, self.d_doclang, qlang)
        if d_sort is not None:
            # gbsortby: the per-doc bound is the exact sort key; a miss
            # can come only from the top-8-per-block selection
            ubfinal = torch.where(alive, d_sort, 0.0)
        else:
            ubfinal = torch.where(alive, ubmin * mult * 1.00001, 0.0)
        nm = alive.sum(dim=1)

        # ---- candidates: top-8 per block, then the top-k2 by bound;
        # the (k2+1)-th bound folds into the missed max
        cval, cand, ub_missed = _block_topn(ubfinal, kappa)
        if k2 < cval.shape[1]:
            vals, idxs = top_k(cval, k2 + 1)
            cand = torch.gather(cand, 1, idxs[:, :k2])
            cval = vals[:, :k2]
            ub_missed = torch.maximum(ub_missed, vals[:, k2])
        kap2 = cand.shape[1]

        # ---- phase 2: exact scoring of the candidates
        dead_c = self.d_dead[cand]                            # [B, κ]
        p_ax = torch.arange(P, device=dev)[None, :, None]     # [1, P, 1]
        cube = torch.zeros((B, T, P, kap2), dtype=torch.int32, device=dev)
        pv = torch.zeros((B, T, P, kap2), dtype=torch.bool, device=dev)
        ar = torch.arange(B, device=dev)

        def add_row(rs, cnt_c, group, base, quota, syn, is_base):
            cnt = torch.where(is_base[:, None] & dead_c, 0,
                              cnt_c.to(torch.int32))
            q = p_ax - base[:, None, None]                    # [B, P, 1]
            sel = (q >= 0) & (q < torch.minimum(
                cnt, quota[:, None])[:, None, :])             # [B, P, κ]
            src = (rs[:, None, :] + q).clamp(0, N - 1)
            synbit = torch.where(syn != 0, _SYN_BIT, 0).to(torch.int32)
            val = self.d_payload[src] | synbit[:, None, None]
            cube[ar, group] += torch.where(sel, val, 0)
            pv[ar, group] |= sel

        d_slot = self._stack(plans, "d_slot", Rd, -1, np.int64)
        d_group = self._stack(plans, "d_group", Rd, 0, np.int64)
        d_base = self._stack(plans, "d_base", Rd, 0, np.int64)
        d_quota = self._stack(plans, "d_quota", Rd, 1, np.int64)
        d_syn = self._stack(plans, "d_syn", Rd, 0, np.int64)
        dgate = d_slot >= 0
        dslotc = d_slot.clamp(0, V - 1)[:, :, None] * D + cand[:, None, :]
        dense_rs_c = self.d_dense_rs[dslotc]                  # [B, Rd, κ]
        dense_cnt_c = self.d_dense_cnt[dslotc]
        always = torch.ones(B, dtype=torch.bool, device=dev)
        for r in range(Rd):
            g = dgate[:, r, None]
            add_row(torch.where(g, dense_rs_c[:, r], 0),
                    torch.where(g, dense_cnt_c[:, r], 0),
                    d_group[:, r], d_base[:, r], d_quota[:, r],
                    d_syn[:, r], always)
        s_base = self._stack(plans, "s_base", Rs, 0, np.int64)
        s_quota = self._stack(plans, "s_quota", Rs, 1, np.int64)
        s_syn = self._stack(plans, "s_syn", Rs, 0, np.int64)
        for r in range(Rs):
            at = r * D + cand
            add_row(torch.gather(rsacc, 1, at),
                    torch.gather(cntacc, 1, at), s_group[:, r],
                    s_base[:, r], s_quota[:, r], s_syn[:, r],
                    s_isbase[:, r])

        # K1 on the card: the whole wave in one launch
        min_sc, present2 = min_scores(cube, pv, freqw, counts)  # [B, T, κ]
        match2 = (match_gates(present2, required, negative, table, use_table)
                  & (cval > 0.0) & (min_sc < BIG))
        if d_sort is not None:
            final = torch.where(match2, d_sort[cand], 0.0)
        else:
            final = torch.where(match2,
                                min_sc * torch.gather(mult, 1, cand), 0.0)
        ts, tl = top_k(final, k2)
        return _out_rows(nm, ub_missed, torch.gather(cand, 1, tl), ts)

    def _run_batch_f2(self, plans: list[ResidentPlan], k2: int,
                      n_sel: int):
        """F2 (the reference's ``_full_cube``): per query, the whole-doc
        ``[T, P, D]`` cube from the materialized cube rows (slices,
        count-masked) plus the posting scatter, scored by K1."""
        dev = self.device
        P, D = self.P, self.D_cap
        V = self.d_dense_imp.shape[0]
        T = max(len(p.required) for p in plans)
        freqw, required, negative, counts, table, qlang = \
            self._query_state(plans, T)
        live = ~self.d_dead
        p_ax = torch.arange(P, device=dev)[:, None]           # [P, 1]
        ms, pres = [], []
        for b, p in enumerate(plans):
            cube = self._scatter_postings([p], T, T * P * D)[:-1].view(
                T, P, D)
            pv = cube != 0
            for r in range(len(p.c_slot)):
                if p.c_slot[r] < 0:
                    continue
                slot = min(int(p.c_slot[r]), self.Vc - 1)
                dslot = min(max(int(p.c_dslot[r]), 0), V - 1)
                base = min(max(int(p.c_base[r]), 0), P)
                g = int(p.c_group[r])
                row = self.d_cube[slot * P * D:(slot + 1) * P * D].view(P, D)
                cnt = self.d_dense_cnt[dslot * D:(dslot + 1) * D].to(
                    torch.int32)
                # the sublist's slot range [base, base+quota):
                # out[p] = row[p - base]; cube rows are base postings,
                # so dead docs mask them
                shifted = torch.zeros_like(row)
                shifted[base:] = row[:P - base]
                q = p_ax - base
                pvr = ((q >= 0) & (q < torch.clamp(
                    cnt, max=int(p.c_quota[r]))[None, :]) & live[None, :])
                if p.c_syn[r]:
                    shifted = shifted | _SYN_BIT
                cube[g] += torch.where(pvr, shifted, 0)
                pv[g] |= pvr
            ms.append(min_scores(cube, pv, freqw[b], counts[b])[0])
            pres.append(pv.any(dim=1))
        ms = torch.stack(ms)
        match = (match_gates(torch.stack(pres), required, negative, table,
                        any(p.has_table for p in plans))
                 & (torch.arange(D, device=dev) < self.n_docs)
                 & (ms < BIG))
        return self._finish(plans[0], match, ms, qlang, k2, n_sel)

    def _run_batch_fd(self, plans: list[ResidentPlan], k2: int,
                      n_sel: int):
        """FD (the reference's ``_direct_cube_fused``): the posting tail
        scattered in torch, assembly and scoring in K2, then the match
        gates and selection."""
        dev = self.device
        P, D = self.P, self.D_cap
        B = len(plans)
        T = max(len(p.required) for p in plans)
        cs = np.full((B, T, 4), 4 * self.cube_zero_slot, np.int32)
        sy = np.zeros((B, T, 4), np.int32)
        for b, p in enumerate(plans):
            cs[b, : len(p.g_quarter)] = p.g_quarter
            sy[b, : len(p.g_qsyn)] = p.g_qsyn
        freqw, required, negative, counts, table, qlang = \
            self._query_state(plans, T)
        tail = None
        if any(len(p.p_len) and p.p_len.max() > 0 for p in plans):
            # base tail postings of dead docs drop here; the kernel masks
            # only the resident quarters
            tail = self._scatter_postings(plans, T, B * T * P * D)[
                :-1].view(B, T, P, D)
        d_cube = self.d_cube
        if devcheck.enabled():
            # the resident cube before the wave reads it: nonzero
            # payloads must decode to a legal hashgroup
            d_cube = devcheck.apply_cube_fault(d_cube)
            devcheck.check_cube(d_cube, route="fd")
        ms, bits = fd_scores_kernel.fd_scores(
            self._put(cs.reshape(B, T * 4)), self._put(sy.reshape(B, T * 4)),
            d_cube, self.d_dead, freqw, counts, tail)
        t_ax = torch.arange(T, dtype=torch.int32, device=dev)
        present = ((bits[:, None, :] >> t_ax[None, :, None]) & 1) > 0
        match = (match_gates(present, required, negative, table,
                        any(p.has_table for p in plans))
                 & (torch.arange(D, device=dev) < self.n_docs)
                 & (ms < BIG))
        return self._finish(plans[0], match, ms, qlang, k2, n_sel)

"""Device scorer — the ``PosdbTable::intersectLists10_r`` replacement
(``Posdb.cpp:5437``) in PyTorch.

Postings scatter into a dense ``[T, P, D]`` position cube (T term
groups × P position slots × D candidate docs, doc axis minor); the
min-score chain scores it (the hand-written CUDA kernel on the card,
its plain torch version on the CPU); the match mask, the siterank /
language multipliers (``Posdb.cpp:7226-7257``) and a stable descending
sort replace TopTree. The numeric operators gate the match mask with a
range column (``gbmin:``/``gbmax:``) and, under ``gbsortby:``, make a
sort column the score.

Payloads travel as int32 views of the uint32 words: PyTorch lacks
shifts and arithmetic on uint32, and decode is shift-then-mask.
Every scoring tensor is float32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import weights
from .min_scores_kernel import BIG, min_scores_fused
from .packer import MAX_POSITIONS, TABLE_SIZE, PackedQuery


def scatter_cube(doc_idx, payload, slot, valid, n_docs_padded: int,
                 n_positions: int):
    """Scatter posting rows (1 row = 1 group) into the dense position
    cube ``[T, P, D]`` + validity; ``[N, T, L]`` rows (N queries or
    shards) give ``[N, T, P, D]``. Padding rows carry ``doc_idx = D``
    and land in an extra column that is dropped."""
    *lead, T, L = doc_idx.shape
    D, P = n_docs_padded, n_positions
    dev = doc_idx.device
    g_of = torch.arange(T, device=dev)[:, None].expand(*lead, T, L)
    idx = (g_of, slot.long(), doc_idx.long())
    if lead:
        idx = (torch.arange(lead[0], device=dev)[:, None, None]
               .expand(*lead, T, L),) + idx
    cube = torch.zeros((*lead, T, P, D + 1), dtype=torch.int32, device=dev)
    cube.index_put_(idx, payload)
    pvalid = torch.zeros((*lead, T, P, D + 1), dtype=torch.bool,
                         device=dev)
    pvalid.index_put_(idx, valid)
    return cube[..., :D].contiguous(), pvalid[..., :D]


def min_scores(cube, pvalid, freq_weight, single_counts):
    """(min_score [D] before multipliers, present [T, D]) for a
    ``[T, P, D]`` cube, or (min_score [B, D], present [B, T, D]) for a
    wave's ``[B, T, P, D]`` (one kernel launch); the kernel wrapper picks
    the kernel or the plain version by the cube's device."""
    return (min_scores_fused(cube, freq_weight, single_counts, pvalid),
            pvalid.any(dim=-2))


def final_multipliers(siterank, doclang, qlang):
    """Siterank/language multipliers (Posdb.cpp:7250-7257): [D] for an
    int ``qlang``, [B, D] for a [B, 1] tensor of query languages."""
    same = (doclang == 0) | (doclang == qlang) | (qlang == 0)
    lang_mult = torch.where(
        same, torch.tensor(weights.SAME_LANG_WEIGHT, device=same.device),
        torch.tensor(1.0, device=same.device))
    return (siterank.to(torch.float32) * weights.SITERANKMULTIPLIER
            + 1.0) * lang_mult


def presence_table_ok(present, table):
    """Boolean-expression gate: pack per-doc presence bits ``[..., T, D]``
    and index the query's truth table ``[..., TABLE_SIZE]``
    (Query.h:266)."""
    T = present.shape[-2]
    powers = (1 << torch.arange(T, dtype=torch.int64,
                                device=present.device))[:, None]
    idx = (present.to(torch.int64) * powers).sum(dim=-2)
    return torch.gather(table, -1, idx.clamp(0, TABLE_SIZE - 1))


def match_gates(present, required, negative, table, use_table=True):
    """Per doc: every required group present, no negative group present,
    and (with ``use_table``) the truth table satisfied. ``present``
    ``[..., T, D]``, flags ``[..., T]``, table ``[..., TABLE_SIZE]``."""
    ok = torch.where(required[..., None], present, True).all(dim=-2)
    ok = ok & ~torch.where(negative[..., None], present, False).any(dim=-2)
    if use_table:
        ok = ok & presence_table_ok(present, table)
    return ok


def top_k(final: torch.Tensor, k: int):
    """(scores, indices) of the k largest along the last axis, ties by
    the lower index — ``lax.top_k``'s order, through a stable descending
    sort."""
    s, i = torch.sort(final, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def score_cube(cube, pvalid, freq_weight, required, negative, scored,
               counts, table, siterank, doclang, qlang, n_docs,
               topk: int = 64, filt=None, sortc=None):
    """Score the dense position cube. Shapes: cube/pvalid [T, P, D];
    freq_weight/required/negative/scored/counts [T]; table
    [TABLE_SIZE]; siterank/doclang [D]; ``filt`` bool [D] (the range
    gate) and ``sortc`` float32 [D] (the sort keys), each None when the
    query has no such operator. Returns (match count, top scores [k],
    top doc indices [k]). With a leading N axis on every array, and
    ``qlang``/``n_docs`` as [N] tensors, N rows score at once with one
    min-score launch, each row bitwise what it gives alone."""
    D = cube.shape[-1]
    min_score, present = min_scores(cube, pvalid, freq_weight, counts)
    if torch.is_tensor(n_docs):
        n_docs, qlang = n_docs[:, None], qlang[:, None]
    # match: every required group present, no negative present, truth
    # table satisfied, inside the real candidate range
    in_range = torch.arange(D, device=cube.device) < n_docs
    match = (match_gates(present, required, negative, table)
             & in_range & (min_score < BIG))
    if filt is not None:
        match = match & filt
    if sortc is not None:
        # gbsortby: the positive sort key is the ranking score
        final = torch.where(match, sortc, 0.0)
    else:
        final = min_score * final_multipliers(siterank, doclang, qlang)
        final = torch.where(match, final, 0.0)
    top_scores, top_idx = top_k(final, min(topk, D))
    return match.sum(dim=-1), top_scores, top_idx


def score_core(doc_idx, payload, slot, valid, freq_weight, required,
               negative, scored, counts, table, siterank, doclang,
               qlang, n_docs, n_positions: int = MAX_POSITIONS,
               topk: int = 64, filt=None, sortc=None):
    """Host-packed entry: scatter rows (1 row = 1 group), then score
    (one query, or N with a leading axis: see :func:`score_cube`)."""
    cube, pvalid = scatter_cube(doc_idx, payload, slot, valid,
                                siterank.shape[-1], n_positions)
    return score_cube(cube, pvalid, freq_weight, required, negative,
                      scored, counts, table, siterank, doclang, qlang,
                      n_docs, topk=topk, filt=filt, sortc=sortc)


def merge_dedup_topk(g_scores, g_docids, g_sh, out_k: int,
                     max_per_site: int = 2):
    """The Msg3a merge tail for a batch of queries: the global top-k over
    each query's gathered ``[S, k]`` per-shard blocks, then the clusterdb
    2-per-site dedup (Msg51) in the same pass, so the recall decision
    needs no host round trip.

    ``g_scores``/``g_docids``/``g_sh`` are ``[B, S, k]`` (scores, int64
    docids, int64 sitehash). Over each query's merged window ``kk =
    min(out_k, S·k)``, survivors compacted to a prefix in score order,
    returns (n_kept [B], n_dropped [B], docids, sitehash, scores,
    cumdrop), the last four ``[B, kk]``; ``cumdrop[i]`` counts the
    clustered-away rows above survivor row i (exclusive), so the host
    can rebuild the greedy walk's clustered counter at any page cut.

    The greedy accept-walk of ``engine.build_results`` keeps a row iff
    fewer than ``max_per_site`` same-site rows were accepted above it;
    since only a site's first ``max_per_site`` rows are ever accepted,
    that is "fewer than ``max_per_site`` same-site live rows above it",
    one masked ``[kk, kk]`` triangular count. Sitehash 0 (no clusterdb
    record) is exempt, like the walk's ``if sh`` gate. Ties take the
    lower gather position first (``lax.top_k``'s order)."""
    B = g_scores.shape[0]
    flat = g_scores.reshape(B, -1)
    kk = min(out_k, flat.shape[1])
    m_sc, m_pos = top_k(flat, kk)
    m_doc = torch.gather(g_docids.reshape(B, -1), 1, m_pos)
    m_sh = torch.gather(g_sh.reshape(B, -1), 1, m_pos)
    live = m_sc > 0.0
    same = (m_sh[:, :, None] == m_sh[:, None, :]) & live[:, None, :]
    earlier = torch.tril(torch.ones((kk, kk), dtype=torch.bool,
                                    device=flat.device), diagonal=-1)
    occ = (same & earlier).sum(dim=-1)
    keep = live & ((m_sh == 0) | (occ < max_per_site))
    dropped = (live & ~keep).to(torch.int64)
    cumdrop = torch.cumsum(dropped, dim=1) - dropped
    rank = torch.arange(kk, device=flat.device)[None, :]
    # stable compaction: survivors first in score order, then the
    # clustered and dead rows
    order = torch.argsort(torch.where(keep, rank, kk + rank), dim=1)
    sc_s = torch.where(torch.gather(keep, 1, order),
                       torch.gather(m_sc, 1, order), 0.0)
    return (keep.sum(dim=1), dropped.sum(dim=1),
            torch.gather(m_doc, 1, order), torch.gather(m_sh, 1, order),
            sc_s, torch.gather(cumdrop, 1, order))


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                       non_blocking=True)


def to_device(pq: PackedQuery, device: torch.device) -> list:
    """The PackedQuery's arrays as tensors on ``device`` (payloads as
    the int32 view of their uint32 words)."""
    arrays = [pq.doc_idx, pq.payload.view(np.int32), pq.slot, pq.valid,
              pq.freq_weight, pq.required, pq.negative, pq.scored,
              pq.counts, pq.table, pq.siterank, pq.doclang]
    return [_tensor(a, device) for a in arrays]


def run_query(pq: PackedQuery, device: torch.device, topk: int = 64):
    """PackedQuery → (docids, scores, total matched), scored on
    ``device``."""
    k = min(topk, len(pq.siterank))
    n_matched, top_scores, top_idx = score_core(
        *to_device(pq, device), pq.qlang, pq.n_docs, topk=k,
        filt=None if pq.filt is None else _tensor(pq.filt, device),
        sortc=None if pq.sortc is None else _tensor(pq.sortc, device))
    scores = top_scores.cpu().numpy()
    idx = top_idx.cpu().numpy()
    keep = scores > 0.0
    return pq.cand_docids[idx[keep]], scores[keep], int(n_matched)

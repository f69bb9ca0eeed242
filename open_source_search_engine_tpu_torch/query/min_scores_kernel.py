"""The min-score chain: the hand-written CUDA kernel
(``csrc/min_scores.cu``), its plain PyTorch version, and the wrapper
that picks between them by the tensors' device.

Port of ``open_source_search_engine_tpu/query/pallas_scores.py``
``_min_scores_fused`` / ``_ms_kernel`` / ``_score_tile`` (K1): a
``[T, P, D]`` payload cube → ``min_score [D]`` float32, the docIdLoop
scoring core (``Posdb.cpp:5437``): payload decode, position weights,
single-term top-``MAX_TOP`` sums, the P×P pair cross products within
``MAX_PAIR_SPAN``, and the min over both.

* :func:`min_scores_plain` is the torch transcription of the reference's
  jnp chain (``scorer.py:191-242``). The CPU path and the tests use it;
  with a card present the main path never does.
* :func:`min_scores_fused` is the wrapper, for one query's ``[T, P, D]``
  cube or a wave's ``[B, T, P, D]`` (the reference vmaps over the wave;
  here the kernel has the batch axis, so a wave is one launch). A CPU
  cube takes the plain version, once per query; a CUDA cube launches the
  kernel or raises — nothing falls back. Payload validity is "payload ≠
  0", the build-side invariant (every real posting has densityrank ≥ 1
  or a non-body hashgroup).
* :func:`work` counts the bytes the chain must move and the fp32
  operations it must do on given inputs: the roofline of ``devwatch``
  and the chip smoke test's bound both read it.
* The kernel builds at first use with ``nvcc`` into
  ``build/torch_kernels/`` at the repository root (rebuilt when the
  source changes) and is bound through ``ctypes`` (:mod:`.cuda_build`).
"""

from __future__ import annotations

import ctypes

import torch

from ..index.posdb import HASHGROUP_END, HASHGROUP_INLINKTEXT
from ..utils import devwatch
from . import cuda_build, devcheck, weights
from .packer import _HG_SHIFT, _DEN_SHIFT, _SPAM_SHIFT, _SYN_SHIFT

QDIST = 2.0  # default query-distance (Posdb.cpp:6886)

#: max query-term index distance for pair scoring
MAX_PAIR_SPAN = 4

BIG = 9.99e8  # the reference's 999999999.0 sentinel

#: position slots per term group the kernel is built for (any T works)
KERNEL_P = 16

#: launches of the CUDA kernel (one per call that reached the card,
#: whatever its batch)
launches = 0
#: calls of the plain version, whatever the device
plain_calls = 0

# ---------------------------------------------------------------- plain

def _tables(device):
    return (torch.as_tensor(weights.HASH_GROUP_WEIGHTS, device=device),
            torch.as_tensor(weights.MAPPED_HASHGROUP, device=device),
            torch.as_tensor(weights.IN_BODY, device=device),
            torch.as_tensor(weights.DENSITY_WEIGHTS, device=device))


def _decode(payload: torch.Tensor):
    """Unpack the int32 view of the uint32 posting payload (packer bit
    layout): shift, then mask — exact for bit 31 too."""
    wordpos = payload & 0x3FFFF
    hg = (payload >> _HG_SHIFT) & 0xF
    den = (payload >> _DEN_SHIFT) & 0x1F
    spam = (payload >> _SPAM_SHIFT) & 0xF
    syn = (payload >> _SYN_SHIFT) & 1
    return wordpos, hg, den, spam, syn


def position_weights(cube: torch.Tensor, pvalid: torch.Tensor):
    """Decode payloads → (posscore, posw, wordpos, hg), each [T, P, D].
    posw is the per-position weight product (hashgroup × density × spam
    × synonym); posscore applies it squared on BASE_SCORE."""
    wordpos, hg, den, spam, syn = _decode(cube)
    hgw_t, _, _, denw_t = _tables(cube.device)
    hgw = hgw_t[hg]
    denw = denw_t[den]
    spamf = spam.to(torch.float32)
    spamw = torch.where(hg == HASHGROUP_INLINKTEXT,
                        torch.sqrt(1.0 + spamf),     # Posdb.cpp:1136
                        (spamf + 1.0) * (1.0 / 16.0))
    synw = torch.where(syn == 1, torch.tensor(
        weights.SYNONYM_WEIGHT, dtype=torch.float32, device=cube.device),
        torch.tensor(1.0, dtype=torch.float32, device=cube.device))
    posw = hgw * denw * spamw * synw
    posscore = weights.BASE_SCORE * posw * posw * pvalid
    return posscore, posw, wordpos, hg


def pair_best(posw_i, wordpos_i, in_body_i, pv_i,
              posw_j, wordpos_j, in_body_j, pv_j):
    """Best pair placement for one term pair: max over the P×P position
    cross product of BASE·posw_i·posw_j/(dist+1) with the reference's
    distance semantics (getTermPairScoreForWindow/NonBody unified).
    Inputs are per-side [P, D]; returns [D]."""
    delta = (wordpos_j[None, :, :]
             - wordpos_i[:, None, :]).to(torch.float32)
    d_plain = torch.clamp(torch.abs(delta), min=2.0)      # [P, P, D]
    body_i = in_body_i[:, None, :]
    body_j = in_body_j[None, :, :]
    mixed = body_i != body_j
    both_nb = (~body_i) & (~body_j)
    d_base = torch.where(both_nb & (d_plain > weights.NONBODY_DIST_CAP),
                         weights.FIXED_DISTANCE, d_plain)
    d_adj = (torch.where(d_base >= QDIST, d_base - QDIST, d_base)
             + (delta < 0))
    dist = torch.where(mixed, weights.FIXED_DISTANCE, d_adj)
    pv = pv_i[:, None, :] & pv_j[None, :, :]
    ps = (weights.BASE_SCORE
          * posw_i[:, None, :] * posw_j[None, :, :]
          / (dist + 1.0)) * pv
    return ps.amax(dim=(0, 1))


def min_scores_plain(cube: torch.Tensor, pvalid: torch.Tensor,
                     freq_weight: torch.Tensor,
                     single_counts: torch.Tensor) -> torch.Tensor:
    """``[T, P, D]`` int32 cube + validity → ``min_score [D]`` float32,
    before the siterank/language multipliers. ``single_counts`` [T] bool:
    groups participating in the min."""
    global plain_calls
    plain_calls += 1
    T, P, D = cube.shape
    posscore, posw, wordpos, hg = position_weights(cube, pvalid)
    present = pvalid.any(dim=1)                             # [T, D]
    _, mhg_t, in_body_t, _ = _tables(cube.device)

    # single-term scores (getSingleTermScore): one best position per
    # mapped hashgroup, except INLINKTEXT where every occurrence competes
    mhg = mhg_t[hg]
    zero = torch.zeros((), dtype=torch.float32, device=cube.device)
    grp_max = [
        torch.where(mhg == g, posscore, zero).amax(dim=1)
        if g != HASHGROUP_INLINKTEXT
        else torch.zeros((T, D), dtype=torch.float32, device=cube.device)
        for g in range(HASHGROUP_END)]
    inlink = torch.where(hg == HASHGROUP_INLINKTEXT, posscore, zero)
    cand = torch.cat([torch.stack(grp_max, dim=1), inlink], dim=1)
    srt = torch.sort(cand, dim=1).values
    k10 = min(weights.MAX_TOP, cand.shape[1])
    top_sum = srt[:, -k10]
    for k in range(k10 - 1, 0, -1):   # ascending, left to right
        top_sum = top_sum + srt[:, -k]
    single = top_sum * (freq_weight * freq_weight)[:, None]

    big = torch.tensor(BIG, dtype=torch.float32, device=cube.device)
    s_mask = present & single_counts[:, None]
    min_single = torch.where(s_mask, single, big).amin(dim=0)

    # pair scores: exact max over P×P per (i, j) within MAX_PAIR_SPAN.
    # A pair with a group outside the min changes nothing, so its cross
    # product is not computed.
    in_body = in_body_t[hg]
    counted = single_counts.tolist()
    min_pair = big.expand(D)
    any_pair = torch.zeros(D, dtype=torch.bool, device=cube.device)
    for i in range(T):
        for j in range(i + 1, min(i + 1 + MAX_PAIR_SPAN, T)):
            if not (counted[i] and counted[j]):
                continue
            best = pair_best(posw[i], wordpos[i], in_body[i], pvalid[i],
                             posw[j], wordpos[j], in_body[j], pvalid[j])
            wts = best * freq_weight[i] * freq_weight[j]
            pair_ok = present[i] & present[j]
            min_pair = torch.where(pair_ok, torch.minimum(min_pair, wts),
                                   min_pair)
            any_pair = any_pair | pair_ok

    min_score = torch.minimum(torch.where(any_pair, min_pair, big),
                              min_single)
    # a doc with NO present scored group scores the filter-only 1.0
    return torch.where(s_mask.any(dim=0), min_score,
                       torch.ones((), dtype=torch.float32,
                                  device=cube.device))


def work(cube: torch.Tensor, counts: torch.Tensor) -> tuple[int, float]:
    """(bytes, fp32 operations) the chain must spend on one query's
    ``[T, P, D]`` cube or a wave's ``[B, T, P, D]``, counted from what
    these inputs need. Bytes: the cube rows of the counted groups (no
    slot of a group outside the min is read: a padding group, a
    negative), freq_weight and counts read once, min_score written once.
    Operations: 6 per valid slot of a counted term (weights, squared
    score), 330 per present counted term-doc (the top-10 knock-out over
    32 candidates and its sum), and 15 per valid position pair of a
    counted term pair within MAX_PAIR_SPAN (distance rules, product, one
    division, max). Every partial count is an integer below 2^53, so the
    float64 sums are exact in any order."""
    if cube.dim() == 3:
        cube, counts = cube[None], counts[None]
    B, T, P, D = cube.shape
    nbytes = int(counts.sum()) * P * D * 4 + B * (T * 4 + T + D * 4)
    nv = (cube != 0).sum(dim=2).to(torch.float64)          # [B, T, D]
    live = counts[:, :, None] & (nv > 0)
    nv = torch.where(live, nv, torch.zeros_like(nv))
    pair_evals = torch.zeros((), dtype=torch.float64, device=cube.device)
    for i in range(T):
        j1 = min(i + 1 + MAX_PAIR_SPAN, T)
        if j1 > i + 1:
            pair_evals = pair_evals + (nv[:, i:i + 1] * nv[:, i + 1:j1]).sum()
    ops = 6 * nv.sum() + 330 * live.sum() + 15 * pair_evals
    return nbytes, float(ops)


# --------------------------------------------------------------- kernel

def build():
    """Compile ``csrc/min_scores.cu`` (see :func:`cuda_build.build`)."""
    return cuda_build.build("min_scores")


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def min_scores_fused(cube: torch.Tensor, freq_weight: torch.Tensor,
                     counts: torch.Tensor,
                     pvalid: torch.Tensor | None = None) -> torch.Tensor:
    """One query's ``[T, P, D]`` int32 cube (validity = payload ≠ 0),
    float32 ``freq_weight [T]`` and bool ``counts [T]`` → ``min_score
    [D]``; or a wave's ``[B, T, P, D]`` cube with ``[B, T]`` weights and
    counts → ``min_score [B, D]``.

    This wrapper alone decides where the chain runs. A CPU cube takes
    :func:`min_scores_plain` once per query (with ``pvalid``, the
    scatter's validity, when given; else ``cube != 0``). A CUDA cube makes
    one launch of the kernel on the current stream, whatever B; any other
    device, a shape or type the kernel does not take, or a refused launch
    raises. With the device guardrails on (``devcheck``), the cube's
    payloads are checked first. With devwatch on, each call is a
    dispatch of the ``min_scores`` roofline entry of its shape."""
    global launches
    if devcheck.enabled():
        cube = devcheck.apply_cube_fault(cube)
        devcheck.check_cube(cube, route="k1")
    batched = cube.dim() == 4
    if cube.device.type == "cpu":
        pv = cube != 0 if pvalid is None else pvalid
        if not batched:
            out = min_scores_plain(cube, pv, freq_weight, counts)
        else:
            out = torch.stack([
                min_scores_plain(cube[b], pv[b], freq_weight[b], counts[b])
                for b in range(cube.shape[0])])
        _note_cost(cube, counts)
        return out
    if cube.device.type != "cuda":
        raise ValueError(f"min_scores_fused: unsupported device {cube.device}")
    if cube.dim() not in (3, 4):
        raise ValueError(f"cube must be [T, P, D] or [B, T, P, D], got "
                         f"{tuple(cube.shape)}")
    B, T, P, D = cube.shape if batched else (1, *cube.shape)
    if P != KERNEL_P or T < 1 or B < 1:
        raise ValueError(f"kernel takes B >= 1, T >= 1 and P = {KERNEL_P}, "
                         f"got B={B} T={T} P={P}")
    lead = (B,) if batched else ()
    cuda_build.check_inputs(cube.device, (
        ("cube", cube, torch.int32, tuple(cube.shape)),
        ("freq_weight", freq_weight, torch.float32, lead + (T,)),
        ("counts", counts, torch.bool, lead + (T,))))
    out = torch.empty(lead + (D,), dtype=torch.float32, device=cube.device)
    if D == 0:
        return out
    fn = cuda_build.load("min_scores", "osse_min_scores", _ARGTYPES)
    tables = cuda_build.kernel_tables(cube.device)
    with torch.cuda.device(cube.device):
        stream = torch.cuda.current_stream(cube.device).cuda_stream
        rc = fn(cube.data_ptr(), freq_weight.data_ptr(), counts.data_ptr(),
                tables.data_ptr(), cuda_build.IN_BODY_MASK, B, T, D,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"min_scores kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    _note_cost(cube, counts)
    return out


def _note_cost(cube: torch.Tensor, counts: torch.Tensor) -> None:
    """One dispatch of the ``min_scores`` roofline entry keyed by the
    cube's ``(B, T, P, D)``; the work is counted at the shape's first."""
    if devwatch.g_devwatch.enabled:
        shape = tuple(cube.shape) if cube.dim() == 4 else (1, *cube.shape)

        def cost():
            nbytes, ops = work(cube, counts)
            return {"flops": ops, "bytes accessed": nbytes}
        devwatch.note_cost("min_scores", shape, cost)

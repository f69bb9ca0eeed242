"""The yardstick of the two scoring kernels' rooflines: the bytes and
fp32 operations each launch must spend on its inputs, and the card's
published peaks.

The counts are frozen copies of the work models the port carried when
this benchmark was written (``min_scores_kernel.work`` for K1,
``fd_scores_kernel.work`` with its ``assemble`` for K2), so a later
change to a kernel cannot move its own yardstick. Each input byte is
counted once and each output byte once, and only the work these inputs
need (the slots that hold a posting, the pairs of them), so a launch's
bound never exceeds what the card must spend on it.
"""

from __future__ import annotations

import torch

#: position slots per term group
P = 16
#: query-term index distance within which groups are scored as a pair
PAIR_SPAN = 4
#: bit 31 of a payload (the synonym flag) as an int32
SYN_BIT = -(1 << 31)

#: published peaks, by a fragment of ``torch.cuda.get_device_name()``:
#: HBM bytes/s and fp32 FLOP/s outside the tensor cores (NVIDIA's H100
#: SXM data sheet, at the 700 W limit)
PEAKS = {"H100": (3.35e12, 67e12)}


def peaks(device_name: str):
    """(bytes/s, FLOP/s) of the card, or None for a card not listed."""
    for frag, pk in PEAKS.items():
        if frag in device_name:
            return pk
    return None


def k1_work(cube: torch.Tensor, counts: torch.Tensor) -> tuple[int, float]:
    """(bytes, fp32 operations) of K1 on one query's ``[T, P, D]`` payload
    cube or a wave's ``[B, T, P, D]``, with ``counts`` the groups entering
    the min. Bytes: the counted groups' cube rows, the weights and flags
    read once, the scores written once. Operations: 6 per valid slot of a
    counted group, 330 per present counted group and page (the top-10 over
    32 candidates and its sum), 15 per valid position pair of counted
    groups at most PAIR_SPAN apart."""
    if cube.dim() == 3:
        cube, counts = cube[None], counts[None]
    B, T, Pc, D = cube.shape
    nbytes = int(counts.sum()) * Pc * D * 4 + B * (T * 4 + T + D * 4)
    nv = (cube != 0).sum(dim=2).to(torch.float64)          # [B, T, D]
    live = counts[:, :, None] & (nv > 0)
    nv = torch.where(live, nv, torch.zeros_like(nv))
    pairs = torch.zeros((), dtype=torch.float64, device=cube.device)
    for i in range(T):
        j1 = min(i + 1 + PAIR_SPAN, T)
        if j1 > i + 1:
            pairs = pairs + (nv[:, i:i + 1] * nv[:, i + 1:j1]).sum()
    ops = 6 * nv.sum() + 330 * live.sum() + 15 * pairs
    return nbytes, float(ops)


def _assemble(g_quarter, g_qsyn, cube, dead, tail, b: int):
    """Query b's ``[T, P, D]`` slot cube as K2 assembles it: its quarter
    rows of the resident cube, the synonym bit, dead pages zeroed, the
    posting tail OR-ed in."""
    D = dead.shape[0]
    T = g_quarter.shape[1] // 4
    quarter_rows = cube.view(-1, P // 4, D)
    q = g_quarter[b].long().clamp(0, quarter_rows.shape[0] - 1)
    rows = quarter_rows[q]
    synbit = torch.where(g_qsyn[b] != 0, SYN_BIT, 0).to(torch.int32)
    rows = torch.where(rows != 0, rows | synbit[:, None, None], rows)
    rows = torch.where(dead[None, None, :], 0, rows).view(T, P, D)
    if tail is not None:
        rows = rows | tail[b]
    return rows


def k2_work(g_quarter, g_qsyn, cube, dead, freq_weight, counts,
            tail=None) -> tuple[int, float]:
    """(bytes, fp32 operations) of K2 on one launch's inputs (its
    arguments in order). Bytes: each distinct quarter row the wave
    gathers read once, the tail, the dead mask, the small per-query
    arrays, the scores and the presence mask written once. Operations:
    K1's count over each query's assembled cube."""
    B, TQ = g_quarter.shape
    T, D = TQ // 4, dead.shape[0]
    n_quarters = int(torch.unique(g_quarter).numel())
    nbytes = (n_quarters * 4 * D * 4
              + (tail.numel() * 4 if tail is not None else 0)
              + D + B * TQ * 8 + B * T * 5 + B * D * 8)
    ops = 0.0
    for b in range(B):
        c = _assemble(g_quarter, g_qsyn, cube, dead, tail, b)
        ops += k1_work(c, counts[b])[1]
    return nbytes, ops


def bound_s(nbytes: float, ops: float, pk) -> float:
    """The least seconds the card could take: the larger of bytes over
    the HBM rate and operations over the fp32 peak."""
    return max(nbytes / pk[0], ops / pk[1])

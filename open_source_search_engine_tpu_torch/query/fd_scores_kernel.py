"""The direct-cube (FD) scoring route: the hand-written CUDA kernel K2
(``csrc/fd_scores.cu``), its plain PyTorch version, and the wrapper that
picks between them by the tensors' device.

Port of ``open_source_search_engine_tpu/query/pallas_scores.py``
``_fd_kernel`` (:226) / ``_fd_call`` (:318), reached from
``devindex._direct_cube_fused``. Per query b and doc d: gather the
query's T·4 quarter-rows of the resident cube ``[Vc·4 quarters, 4, D]``
(quarter q of a term's ``[P, D]`` cube row holds its occurrences
4q..4q+3), OR the synonym bit into every nonzero word of a synonym
quarter, zero dead docs, OR in the optional posting tail ``[B, T, P, D]``
(after the dead mask: delta postings of re-added docs live in the tail),
and score the assembled ``[T, P]`` slots with K1's body. Outputs
``min_score [B, D]`` float32 and a presence bitmask ``[B, D]`` int32
(bit t set when group t has a nonzero slot, for every t < T ≤ 8).

K2's bound on the H100 is bytes: the wave's distinct quarter rows and
the dense tail, against a few hundred float32 operations per query and
doc. A block stages its query's distinct quarters and its tail rows for
a tile of docs in shared memory with asynchronous copies, gates and
scores them there, and never writes the assembled cube back to device
memory; what then sets its pace is the scoring body's instruction
stream (``csrc/fd_scores.cu`` has the design and the measurement).

* :func:`fd_scores_plain` is the torch transcription of the unfused
  ``_direct_cube`` assembly (``devindex.py:2738-2746``) plus the tail
  OR, followed by :func:`min_scores_plain` and the bitmask. The CPU path
  and the tests use it; with a card present the main path never does.
* :func:`fd_scores` is the wrapper. CPU tensors take the plain version;
  CUDA tensors launch the kernel or raise — nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import devwatch
from . import cuda_build
from .min_scores_kernel import KERNEL_P, min_scores_plain
from .min_scores_kernel import work as k1_work

#: term-group buckets the FD route takes (the planner caps FD at 8 groups)
KERNEL_T = (4, 8)

#: launches of the CUDA kernel, with and without a posting tail
launches_tail = 0
launches_notail = 0
#: calls of the plain version, whatever the device
plain_calls = 0

#: bit 31 of a payload (the synonym flag) as an int32
SYN_BIT = -(1 << 31)


def assemble(g_quarter: torch.Tensor, g_qsyn: torch.Tensor,
             cube: torch.Tensor, dead: torch.Tensor,
             tail: torch.Tensor | None, b: int) -> torch.Tensor:
    """Query b's ``[T, P, D]`` slot cube (int32 view of the payloads),
    assembled as the kernel assembles it."""
    D = dead.shape[0]
    P4 = KERNEL_P // 4
    T = g_quarter.shape[1] // 4
    quarter_rows = cube.view(-1, P4, D)
    q = g_quarter[b].long().clamp(0, quarter_rows.shape[0] - 1)
    rows = quarter_rows[q]                                 # [T·4, P4, D]
    synbit = torch.where(g_qsyn[b] != 0, SYN_BIT, 0).to(torch.int32)
    rows = torch.where(rows != 0, rows | synbit[:, None, None], rows)
    rows = torch.where(dead[None, None, :], 0, rows).view(T, KERNEL_P, D)
    if tail is not None:
        rows = rows | tail[b]
    return rows


def fd_scores_plain(g_quarter, g_qsyn, cube, dead, freq_weight, counts,
                    tail=None):
    """Plain version of K2: ``(min_score [B, D] float32, presence
    bitmask [B, D] int32)``."""
    global plain_calls
    plain_calls += 1
    B = g_quarter.shape[0]
    T = g_quarter.shape[1] // 4
    bit = (1 << torch.arange(T, dtype=torch.int32,
                             device=cube.device))[:, None]
    ms, pres = [], []
    for b in range(B):
        c = assemble(g_quarter, g_qsyn, cube, dead, tail, b)
        valid = c != 0
        ms.append(min_scores_plain(c, valid, freq_weight[b], counts[b]))
        pres.append((valid.any(dim=1).to(torch.int32) * bit).sum(dim=0,
                    dtype=torch.int32))
    return torch.stack(ms), torch.stack(pres)


def work(g_quarter, g_qsyn, cube, dead, counts, tail=None
         ) -> tuple[int, float]:
    """(bytes, fp32 operations) K2 must spend on these inputs. Bytes:
    each distinct quarter row the wave gathers read once (4 slots of D
    words: padded groups and the quarters a term leaves empty all point
    at the one zero slot), the tail when there is one, the dead mask, the
    small per-query arrays, and min_score and the bitmask written once.
    Operations: K1's count (:func:`min_scores_kernel.work`) over each
    query's assembled cube."""
    B, TQ = g_quarter.shape
    T, D = TQ // 4, dead.shape[0]
    n_quarters = int(torch.unique(g_quarter).numel())
    nbytes = (n_quarters * 4 * D * 4
              + (tail.numel() * 4 if tail is not None else 0)
              + D + B * TQ * 8 + B * T * 5 + B * D * 8)
    ops = 0.0
    for b in range(B):
        c = assemble(g_quarter, g_qsyn, cube, dead, tail, b)
        ops += k1_work(c, counts[b])[1]
    return nbytes, ops


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def build():
    """Compile ``csrc/fd_scores.cu`` (see :func:`cuda_build.build`)."""
    return cuda_build.build("fd_scores")


def fd_scores(g_quarter: torch.Tensor, g_qsyn: torch.Tensor,
              cube: torch.Tensor, dead: torch.Tensor,
              freq_weight: torch.Tensor, counts: torch.Tensor,
              tail: torch.Tensor | None = None):
    """K2: ``g_quarter``/``g_qsyn`` int32 ``[B, T·4]`` (absolute
    quarter-row indices into the resident cube, synonym flags), ``cube``
    the flat resident cube int32 ``[Vc·P·D]``, ``dead`` bool ``[D]``,
    ``freq_weight`` float32 ``[B, T]``, ``counts`` bool ``[B, T]``,
    ``tail`` int32 ``[B, T, P, D]`` or None → ``(min_score [B, D],
    presence [B, D] int32)``.

    This wrapper alone decides where the route scores: CPU tensors take
    :func:`fd_scores_plain`; CUDA tensors launch the kernel on the
    current stream, and a device, type, shape or launch the kernel does
    not take raises. With devwatch on, each call is a dispatch of the
    ``fd_scores`` roofline entry of its ``(B, T, D, tail)``."""
    global launches_tail, launches_notail
    if cube.device.type == "cpu":
        out = fd_scores_plain(g_quarter, g_qsyn, cube, dead, freq_weight,
                              counts, tail)
        _note_cost(g_quarter, g_qsyn, cube, dead, counts, tail)
        return out
    if cube.device.type != "cuda":
        raise ValueError(f"fd_scores: unsupported device {cube.device}")
    B, TQ = g_quarter.shape
    T, D = TQ // 4, dead.shape[0]
    if TQ != 4 * T or T not in KERNEL_T or B < 1:
        raise ValueError(f"kernel takes B >= 1 and T in {KERNEL_T}, got "
                         f"g_quarter {tuple(g_quarter.shape)}")
    if D < 1 or cube.dim() != 1 or cube.shape[0] % (KERNEL_P * D):
        raise ValueError(f"cube must be flat [Vc*{KERNEL_P}*{D}], got "
                         f"{tuple(cube.shape)}")
    specs = [("g_quarter", g_quarter, torch.int32, (B, TQ)),
             ("g_qsyn", g_qsyn, torch.int32, (B, TQ)),
             ("cube", cube, torch.int32, cube.shape),
             ("dead", dead, torch.bool, (D,)),
             ("freq_weight", freq_weight, torch.float32, (B, T)),
             ("counts", counts, torch.bool, (B, T))]
    if tail is not None:
        specs.append(("tail", tail, torch.int32, (B, T, KERNEL_P, D)))
    cuda_build.check_inputs(cube.device, specs)
    ms = torch.empty((B, D), dtype=torch.float32, device=cube.device)
    pres = torch.empty((B, D), dtype=torch.int32, device=cube.device)
    fn = cuda_build.load("fd_scores", "osse_fd_scores", _ARGTYPES)
    tables = cuda_build.kernel_tables(cube.device)
    with torch.cuda.device(cube.device):
        stream = torch.cuda.current_stream(cube.device).cuda_stream
        rc = fn(g_quarter.data_ptr(), g_qsyn.data_ptr(), cube.data_ptr(),
                cube.shape[0] // (KERNEL_P // 4 * D),
                tail.data_ptr() if tail is not None else None,
                dead.data_ptr(), freq_weight.data_ptr(), counts.data_ptr(),
                tables.data_ptr(), cuda_build.IN_BODY_MASK, B, T, D,
                ms.data_ptr(), pres.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fd_scores kernel launch failed: CUDA error {rc}")
    if tail is not None:
        launches_tail += 1
    else:
        launches_notail += 1
    _note_cost(g_quarter, g_qsyn, cube, dead, counts, tail)
    return ms, pres


def _note_cost(g_quarter, g_qsyn, cube, dead, counts, tail) -> None:
    if devwatch.g_devwatch.enabled:
        B, TQ = g_quarter.shape

        def cost():
            nbytes, ops = work(g_quarter, g_qsyn, cube, dead, counts, tail)
            return {"flops": ops, "bytes accessed": nbytes}
        devwatch.note_cost("fd_scores", (B, TQ // 4, dead.shape[0],
                                         int(tail is not None)), cost)

// fd_scores.cu — the direct-cube (FD) scoring route as a hand-written
// Hopper kernel (K2).
//
// Replaces open_source_search_engine_tpu/query/pallas_scores.py
// ::_fd_kernel (:226), reached through _fd_call (:318) from
// devindex._direct_cube_fused. Per (query b, doc d) it assembles the
// query's [T, P] slots of doc d straight from the resident cube, without
// materializing a per-query [T, P, D] cube in device memory:
//   1. u = cube[(g_quarter[b, 4t + p/4] * 4 + p%4) * D + d] — quarter q of
//      a term's [P, D] cube row holds its occurrences 4q..4q+3;
//   2. a nonzero word of a synonym quarter gets bit 31 (the synonym flag);
//   3. a dead doc (deleted or re-added since the base build) reads 0;
//   4. with a tail, u |= tail[b, t, p, d] AFTER the dead mask: the tail
//      holds the query's small non-cube sublists, and delta postings of a
//      re-added doc live there, past the mask (slot ranges are disjoint by
//      the slot plan, so OR and add agree).
// Then it scores with K1's body (score_body.cuh) and writes min_score and
// a presence bitmask (bit t = group t has a nonzero slot, for every
// t < T <= 8, counted or not) for the caller's required / negative /
// boolean gates.
//
// What bounds it on the H100. The bytes it must move are the wave's
// distinct quarter rows (most of a wave's T*4 quarters per query repeat:
// padded groups and unfilled quarters all point at the one zero slot, and
// the queries of a wave share terms) plus the dense tail [B, T, 16, D]
// when there is one (537 MB of the 640 MB on the main path's largest
// wave, B = 16, T = 4, D = 131,072). Its fp32 operations, counted on the
// valid slots only, take a tenth of that time at the peak rate, so bytes
// bound it. What sets its pace is neither: the body evaluates each
// counted pair's 16 positions of term i (one IEEE division each) for
// every valid slot of term j, empty positions included, and runs a
// 10-round knock-out per present term. On the main path's largest wave
// the copies, gates and presence bits take about a sixth of the kernel's
// time and the body the rest (chip_smoke.py measures both).
// The first design (one thread per (query, doc), every slot a global load
// inside the scoring loops, ~270 dependent loads per doc at T = 4) was
// bound by load latency as well.
//
// The design, the Pallas kernel's scalar prefetch plus DMAs into scratch
// rethought for Hopper:
//   * a block scores TD docs of one query (TD = 128 at T = 4, 64 at T = 8,
//     one thread per doc; stage.cuh) and the grid is 1-D with the query
//     fastest, so the B blocks of one doc tile run close together in time
//     and a quarter row that several queries share comes from HBM once and
//     from L2 after that;
//   * the block copies its query's T*4 quarter indices (64-bit: Vc*P*D
//     passes 2^31 at large D) and synonym flags into shared memory and
//     maps each repeated quarter index to its first occurrence; then it
//     issues one asynchronous copy (cp.async, stage.cuh) per DISTINCT
//     quarter, 4 rows x TD words, into the tile rows of its first
//     occurrence, and with a tail the copy of group 0's tail rows (16
//     rows x TD) into a one-group tail buffer;
//   * after the copies land, each thread gates its own doc column of the
//     tile in place, in the order above: a repeated quarter takes its
//     first occurrence's raw words (the quarters are walked from the last
//     to the first, so a first occurrence is gated only after every
//     repeat has read it raw), the synonym bit, the dead mask; then, with
//     a tail, group by group, it ORs in the buffered tail rows, and the
//     block refills the buffer with the next group's; the presence bits
//     fall out of the same passes;
//   * presence and score_doc then read shared memory only.
// Shared memory per block: the tile, T*16*TD*4 bytes (32 KB), plus 16*TD*4
// (8 KB at T = 4, 4 KB at T = 8) with a tail. Since the body sets the
// pace, occupancy matters: a tile-sized tail buffer (64 KB a block) would
// leave three blocks, 12 warps, on an SM at T = 4; the one-group buffer
// keeps the tail variant at the no-tail variant's occupancy (five blocks,
// 20 warps, bound by registers) for T - 1 extra barriers. At T = 8 the
// 32 KB tile holds 64 docs, so an SM holds at most six blocks, 12 warps.
// One stage of quarters per block, no double buffering across doc tiles:
// several blocks share an SM, so one block's copies overlap another's
// scoring. Every block stays under the 48 KB of shared memory a kernel
// may take without opting in (cudaFuncSetAttribute), 41,440 bytes at
// most.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_body.cuh"
#include "stage.cuh"

namespace {

constexpr int kP = 16;
constexpr int kP4 = kP / 4;

// the tile [kT * 16, TD], and with a tail one group's tail rows [16, TD]
template <int kT, bool kTail>
constexpr int smem_bytes() {
  return (kT + (kTail ? 1 : 0)) * kP * osse::tile_docs<kT>() * 4;
}

template <int kT, bool kTail>
__global__ void __launch_bounds__(osse::tile_docs<kT>())
fd_scores_kernel(const int32_t* __restrict__ g_quarter,
                 const int32_t* __restrict__ g_qsyn,
                 const uint32_t* __restrict__ cube, long long n_quarters,
                 const uint32_t* __restrict__ tail,
                 const uint8_t* __restrict__ dead,
                 const float* __restrict__ freq_weight,
                 const uint8_t* __restrict__ counts,
                 const float* __restrict__ tables, unsigned in_body_mask,
                 int B, int D, float* __restrict__ ms_out,
                 int32_t* __restrict__ pres_out) {
  constexpr int TD = osse::tile_docs<kT>();
  constexpr int kTQ = kT * 4;
  constexpr int kRows = kT * kP;
  static_assert(kTQ <= TD, "one thread per quarter index");
  extern __shared__ __align__(16) uint32_t s_tile[];  // [kRows, TD]
  uint32_t* s_tail = s_tile + kRows * TD;  // [kP, TD]: one group's tail
  __shared__ osse::Tables s_tab;
  __shared__ long long s_quarter[kTQ];
  __shared__ uint32_t s_syn[kTQ];
  __shared__ int s_first[kTQ];
  __shared__ float s_fw[kT];
  __shared__ uint8_t s_cnt[kT];

  const int b = blockIdx.x % B;
  const int d0 = (blockIdx.x / B) * TD;
  const int lane = threadIdx.x;
  osse::load_tables(tables, &s_tab);
  if (lane < kTQ) {
    long long q = g_quarter[b * kTQ + lane];
    q = q < 0 ? 0 : (q >= n_quarters ? n_quarters - 1 : q);
    s_quarter[lane] = q;
    s_syn[lane] = g_qsyn[b * kTQ + lane] ? 0x80000000u : 0u;
  }
  if (lane < kT) {
    s_fw[lane] = freq_weight[b * kT + lane];
    s_cnt[lane] = counts[b * kT + lane];
  }
  __syncthreads();
  if (lane < kTQ) {
    int f = lane;
    for (int k = 0; k < lane; ++k) {
      if (s_quarter[k] == s_quarter[lane]) {
        f = k;
        break;
      }
    }
    s_first[lane] = f;
  }
  __syncthreads();

  const int n_valid = min(TD, D - d0);
  const size_t stride = (size_t)D;
  const auto tail_rows = [&](int t) {  // group t's tail rows -> s_tail
    osse::stage_rows<TD>(s_tail, kP, n_valid,
                         [&](int row) -> const uint32_t* {
                           return tail + ((size_t)b * kRows + t * kP + row) *
                                             stride +
                                  d0;
                         });
  };
  osse::stage_rows<TD>(s_tile, kRows, n_valid,
                       [&](int row) -> const uint32_t* {
                         const int tq = row / kP4;
                         if (s_first[tq] != tq) return nullptr;
                         return cube +
                                (size_t)(s_quarter[tq] * kP4 + row % kP4) *
                                    stride +
                                d0;
                       });
  if (kTail) tail_rows(0);
  osse::stage_wait();

  // each thread gates its own doc column in place: a repeat takes its
  // first occurrence's raw words, walking from the last quarter to the
  // first so that a first occurrence is gated after its repeats read it
  const int d = d0 + lane;
  const bool live = d < D && dead[d] == 0;
  int32_t pres = 0;
#pragma unroll 1
  for (int tq = kTQ - 1; tq >= 0; --tq) {
    const int f = s_first[tq];
    const uint32_t syn = s_syn[tq];
    uint32_t any = 0u;
#pragma unroll
    for (int r = 0; r < kP4; ++r) {
      uint32_t u = live ? s_tile[(f * kP4 + r) * TD + lane] : 0u;
      if (u != 0u) u |= syn;
      s_tile[(tq * kP4 + r) * TD + lane] = u;
      any |= u;
    }
    if (any != 0u) pres |= 1 << (tq / 4);
  }
  // then the tail, one group at a time through s_tail, after the gates
  if (kTail) {
#pragma unroll 1
    for (int t = 0; t < kT; ++t) {
      uint32_t any = 0u;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const uint32_t u = s_tail[p * TD + lane];
        s_tile[(t * kP + p) * TD + lane] |= u;
        any |= u;
      }
      if (any != 0u) pres |= 1 << t;
      if (t + 1 < kT) {
        __syncthreads();  // every thread has read s_tail
        tail_rows(t + 1);
        osse::stage_wait();
      }
    }
  }
  if (d >= D) return;

  const uint32_t* col = s_tile + lane;
  const auto slot = [&](int t, int p) -> uint32_t {
    return col[(t * kP + p) * TD];
  };
  ms_out[(size_t)b * stride + d] = osse::score_doc<kT, kP>(
      slot, kT, s_fw, s_cnt, s_tab, in_body_mask);
  pres_out[(size_t)b * stride + d] = pres;
}

template <int kT, bool kTail>
int launch(const int32_t* gq, const int32_t* gs, const uint32_t* cube,
           long long n_quarters, const uint32_t* tail, const uint8_t* dead,
           const float* fw, const uint8_t* counts, const float* tables,
           unsigned in_body_mask, int B, int D, float* ms, int32_t* pres,
           cudaStream_t stream) {
  constexpr int TD = osse::tile_docs<kT>();
  constexpr int kSmem = smem_bytes<kT, kTail>();
  // under the 48 KB a block may take without opting in
  static_assert(kSmem <= 48 * 1024, "opt in with cudaFuncSetAttribute");
  const long long tiles = (D + TD - 1) / TD;
  if (tiles * B > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fd_scores_kernel<kT, kTail><<<(unsigned)(tiles * B), TD, kSmem, stream>>>(
      gq, gs, cube, n_quarters, tail, dead, fw, counts, tables,
      in_body_mask, B, D, ms, pres);
  return 0;
}

template <int kT>
int launch_t(const int32_t* gq, const int32_t* gs, const uint32_t* cube,
             long long n_quarters, const uint32_t* tail, const uint8_t* dead,
             const float* fw, const uint8_t* counts, const float* tables,
             unsigned in_body_mask, int B, int D, float* ms, int32_t* pres,
             cudaStream_t stream) {
  if (tail != nullptr)
    return launch<kT, true>(gq, gs, cube, n_quarters, tail, dead, fw, counts,
                            tables, in_body_mask, B, D, ms, pres, stream);
  return launch<kT, false>(gq, gs, cube, n_quarters, tail, dead, fw, counts,
                           tables, in_body_mask, B, D, ms, pres, stream);
}

}  // namespace

// g_quarter, g_qsyn: [B, T*4] int32 — absolute quarter-row indices into the
// resident cube and per-quarter synonym flags; cube: the flat resident cube
// [n_quarters * 4 * D] uint32 (quarter q = rows 4q..4q+3 of D words); tail:
// [B, T, 16, D] uint32 or NULL; dead: [D] bool; freq_weight: [B, T]
// float32; counts: [B, T] bool; tables: 16 hashgroup weights then 32
// density weights; in_body_mask: bit h set when hashgroup h is body-ish;
// ms: [B, D] float32 and pres: [B, D] int32 outputs. Launches on `stream`
// and returns cudaGetLastError() (0 = launched); a T other than 4 or 8, B
// < 1, or more than 2^31 - 1 blocks returns cudaErrorInvalidValue without
// launching.
extern "C" int osse_fd_scores(const void* g_quarter, const void* g_qsyn,
                              const void* cube, long long n_quarters,
                              const void* tail, const void* dead,
                              const void* freq_weight, const void* counts,
                              const void* tables, unsigned in_body_mask,
                              int B, int T, int D, void* ms, void* pres,
                              void* stream) {
  const int32_t* gq = static_cast<const int32_t*>(g_quarter);
  const int32_t* gs = static_cast<const int32_t*>(g_qsyn);
  const uint32_t* c = static_cast<const uint32_t*>(cube);
  const uint32_t* tl = static_cast<const uint32_t*>(tail);
  const uint8_t* dd = static_cast<const uint8_t*>(dead);
  const float* fw = static_cast<const float*>(freq_weight);
  const uint8_t* cnt = static_cast<const uint8_t*>(counts);
  const float* tab = static_cast<const float*>(tables);
  float* m = static_cast<float*>(ms);
  int32_t* pr = static_cast<int32_t*>(pres);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || n_quarters < 1) return (int)cudaErrorInvalidValue;
  if (D <= 0) return 0;
  int rc;
  switch (T) {
    case 4:
      rc = launch_t<4>(gq, gs, c, n_quarters, tl, dd, fw, cnt, tab,
                       in_body_mask, B, D, m, pr, s);
      break;
    case 8:
      rc = launch_t<8>(gq, gs, c, n_quarters, tl, dd, fw, cnt, tab,
                       in_body_mask, B, D, m, pr, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

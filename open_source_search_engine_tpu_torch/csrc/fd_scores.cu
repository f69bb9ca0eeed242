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
// What bounds it on the H100: bytes. The work per (query, doc) is a few
// hundred fp32 operations on 1-4 valid slots per term (see
// min_scores.cu), while the assembly reads T*16 words of the resident
// cube per query and doc (B*T*16*D*4 bytes: 268 MB for a wave of 16
// queries at T = 8, D = 131,072, ~80 us at 3.35 TB/s), plus the tail when
// there is one. The design keeps every read coalesced and reads nothing
// twice from device memory that L1 can serve:
//   * one thread per (query, doc); grid (ceil(D/256), B), 256-thread
//     blocks, the ragged edge masked;
//   * each block copies its query's T*4 quarter indices and synonym flags
//     into shared memory (the Pallas kernel's scalar prefetch);
//   * a warp's 32 threads read 32 neighbouring docs of one quarter row, so
//     every load is one 128-byte transaction; quarter offsets are 64-bit
//     (Vc*P*D passes 2^31 at large D);
//   * T (4 or 8, the FD route's group buckets) and the tail are template
//     parameters, so the no-tail variant reads no tail at all.
// Staging the quarter rows with cp.async/TMA and sharing decoded slots
// across a warp are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_body.cuh"

namespace {

using osse::kBlock;

constexpr int kP = 16;
constexpr int kP4 = kP / 4;

template <int kT, bool kTail>
__global__ void __launch_bounds__(kBlock)
fd_scores_kernel(const int32_t* __restrict__ g_quarter,
                 const int32_t* __restrict__ g_qsyn,
                 const uint32_t* __restrict__ cube, long long n_quarters,
                 const uint32_t* __restrict__ tail,
                 const uint8_t* __restrict__ dead,
                 const float* __restrict__ freq_weight,
                 const uint8_t* __restrict__ counts,
                 const float* __restrict__ tables, unsigned in_body_mask,
                 int D, float* __restrict__ ms_out,
                 int32_t* __restrict__ pres_out) {
  constexpr int kTQ = kT * 4;
  __shared__ osse::Tables s_tab;
  __shared__ long long s_quarter[kTQ];
  __shared__ uint32_t s_syn[kTQ];
  const int b = blockIdx.y;
  osse::load_tables(tables, &s_tab);
  if (threadIdx.x < kTQ) {
    long long q = g_quarter[b * kTQ + threadIdx.x];
    q = q < 0 ? 0 : (q >= n_quarters ? n_quarters - 1 : q);
    s_quarter[threadIdx.x] = q;
    s_syn[threadIdx.x] = g_qsyn[b * kTQ + threadIdx.x] ? 0x80000000u : 0u;
  }
  __syncthreads();

  const int d = blockIdx.x * kBlock + threadIdx.x;
  if (d >= D) return;
  const bool live = dead[d] == 0;
  const size_t stride = (size_t)D;
  const uint32_t* tcol =
      kTail ? tail + (size_t)b * kT * kP * stride + d : nullptr;
  const auto slot = [&](int t, int p) -> uint32_t {
    uint32_t u = 0u;
    if (live) {
      const int tq = t * 4 + p / kP4;
      u = cube[(size_t)(s_quarter[tq] * kP4 + p % kP4) * stride + d];
      if (u != 0u) u |= s_syn[tq];
    }
    if (kTail) u |= tcol[(size_t)(t * kP + p) * stride];
    return u;
  };

  int32_t pres = 0;
#pragma unroll 1
  for (int t = 0; t < kT; ++t) {
#pragma unroll 1
    for (int p = 0; p < kP; ++p) {
      if (slot(t, p) != 0u) {
        pres |= 1 << t;
        break;
      }
    }
  }
  ms_out[(size_t)b * stride + d] = osse::score_doc<kT, kP>(
      slot, kT, freq_weight + b * kT, counts + b * kT, s_tab, in_body_mask);
  pres_out[(size_t)b * stride + d] = pres;
}

template <int kT, bool kTail>
void launch(const int32_t* gq, const int32_t* gs, const uint32_t* cube,
            long long n_quarters, const uint32_t* tail, const uint8_t* dead,
            const float* fw, const uint8_t* counts, const float* tables,
            unsigned in_body_mask, int B, int D, float* ms, int32_t* pres,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((D + kBlock - 1) / kBlock), (unsigned)B);
  fd_scores_kernel<kT, kTail><<<grid, kBlock, 0, stream>>>(
      gq, gs, cube, n_quarters, tail, dead, fw, counts, tables,
      in_body_mask, D, ms, pres);
}

template <int kT>
void launch_t(const int32_t* gq, const int32_t* gs, const uint32_t* cube,
              long long n_quarters, const uint32_t* tail,
              const uint8_t* dead, const float* fw, const uint8_t* counts,
              const float* tables, unsigned in_body_mask, int B, int D,
              float* ms, int32_t* pres, cudaStream_t stream) {
  if (tail != nullptr)
    launch<kT, true>(gq, gs, cube, n_quarters, tail, dead, fw, counts, tables,
                     in_body_mask, B, D, ms, pres, stream);
  else
    launch<kT, false>(gq, gs, cube, n_quarters, tail, dead, fw, counts,
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
// and returns cudaGetLastError() (0 = launched); a T other than 4 or 8, or
// B outside [1, 65535], returns cudaErrorInvalidValue without launching.
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
  if (B < 1 || B > 65535 || n_quarters < 1) return (int)cudaErrorInvalidValue;
  if (D <= 0) return 0;
  switch (T) {
    case 4:
      launch_t<4>(gq, gs, c, n_quarters, tl, dd, fw, cnt, tab, in_body_mask,
                  B, D, m, pr, s);
      break;
    case 8:
      launch_t<8>(gq, gs, c, n_quarters, tl, dd, fw, cnt, tab, in_body_mask,
                  B, D, m, pr, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

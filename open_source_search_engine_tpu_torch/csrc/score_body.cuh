// score_body.cuh — the min-score chain for one doc column, shared by K1
// (min_scores.cu) and K2 (fd_scores.cu), so the two kernels cannot
// drift apart.
//
// Port of open_source_search_engine_tpu/query/pallas_scores.py
// ::_score_tile, the docIdLoop scoring core of Posdb.cpp. A kernel hands
// score_doc a slot loader, slot(t, p) -> the uint32 payload of term group
// t at position slot p of this thread's doc (0 = empty slot), and gets
// back min_score. Per doc:
//   * decode each payload (wordpos 18 bits, hashgroup 4, density 5,
//     spam 4, syn 1) into a position weight
//       posw = hg_weight[hg] * density_weight[den] * spamw * synw;
//   * singles: per counted term, the top-MAX_TOP sum over the per-mapped-
//     hashgroup maxima of BASE*posw^2 plus every inlink-text occurrence,
//     times freq_weight^2;
//   * pairs: per counted term pair (i, j) with j - i <= MAX_PAIR_SPAN, the
//     max over the P x P position cross product of
//     BASE*posw_i*posw_j/(dist+1), dist by the body/non-body rules,
//     times freq_weight_i*freq_weight_j;
//   * min over singles and pairs; 1.0 when no counted term is present.
// Validity is payload != 0 (the build-side invariant).
//
// The staged kernels (K1 at T in {4, 8, 16}, K2) hand it a loader that
// reads their shared-memory tile, tile[(t * P + p) * TD + lane]
// (stage.cuh), so the re-reads below cost a shared-memory load each, not
// a global one; K1's wide direct-load instantiations read the cube in
// global memory.
// Registers, not the slots, are the scarce resource (T*P payloads per
// doc), so the singles decode one term's 16 slots at a time, and each pair
// holds only term i's 16 decoded slots in registers while it re-reads
// term j's slots through the loader and skips empty ones. The weight
// tables arrive from the caller (the port's weights.py) and sit in shared
// memory; no exp() runs on the card. Division and sqrt are the IEEE ones
// (build with -fmad=false, no fast math), and the top-10 sum runs in the
// plain version's order, so the result is bitwise that of
// min_scores_kernel.min_scores_plain on the same slots.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace osse {

constexpr int kBlock = 256;
constexpr int kMaxTop = 10;
constexpr int kMaxPairSpan = 4;
constexpr int kHgInlink = 5;       // HASHGROUP_INLINKTEXT
constexpr int kHgValues = 16;      // every value of the 4-bit field
constexpr int kDenValues = 32;     // every value of the 5-bit field
constexpr float kBaseScore = 100.0f;
constexpr float kSynonymWeight = 0.9f;
constexpr float kFixedDistance = 400.0f;
constexpr float kNonbodyDistCap = 50.0f;
constexpr float kQdist = 2.0f;
constexpr float kBig = 9.99e8f;

struct Pos {
  float posw;
  int wordpos;
  int hg;
  bool body;
};

// The weight tables in shared memory: 16 hashgroup weights, then 32
// density weights.
struct Tables {
  float hgw[kHgValues];
  float denw[kDenValues];
};

// Every thread of the block calls this before any early return; the block
// has at least 32 threads.
__device__ __forceinline__ void load_tables(const float* tables, Tables* s) {
  if (threadIdx.x < kHgValues) s->hgw[threadIdx.x] = tables[threadIdx.x];
  if (threadIdx.x < kDenValues)
    s->denw[threadIdx.x] = tables[kHgValues + threadIdx.x];
}

__device__ __forceinline__ Pos decode(uint32_t u, const Tables& s,
                                      unsigned in_body_mask) {
  Pos x;
  x.wordpos = (int)(u & 0x3FFFFu);
  x.hg = (int)((u >> 18) & 0xFu);
  const int den = (int)((u >> 22) & 0x1Fu);
  const float spamf = (float)((u >> 27) & 0xFu);
  const bool syn = (u >> 31) != 0u;
  const float spamw = (x.hg == kHgInlink) ? sqrtf(1.0f + spamf)
                                          : (spamf + 1.0f) * (1.0f / 16.0f);
  x.posw = s.hgw[x.hg] * s.denw[den] * spamw * (syn ? kSynonymWeight : 1.0f);
  x.body = ((in_body_mask >> x.hg) & 1u) != 0u;
  return x;
}

// min_score of one doc. kT > 0 fixes the term count at compile time;
// kT == 0 takes it from t_runtime. freq_weight and counts are the query's
// [T] arrays.
template <int kT, int P, typename Slot>
__device__ __forceinline__ float score_doc(const Slot& slot, int t_runtime,
                                           const float* freq_weight,
                                           const uint8_t* counts,
                                           const Tables& s,
                                           unsigned in_body_mask) {
  const int T = kT > 0 ? kT : t_runtime;

  // ---- singles (getSingleTermScore) ----
  float min_single = kBig;
  bool any_scored = false;  // some counted term present in this doc
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    if (!counts[t]) continue;
    float gmax[kHgValues];  // per mapped hashgroup; slot 5 stays 0
    float inlink[P];        // inlink text: every occurrence competes
#pragma unroll
    for (int g = 0; g < kHgValues; ++g) gmax[g] = 0.0f;
    bool present = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t u = slot(t, p);
      inlink[p] = 0.0f;
      if (u == 0u) continue;
      present = true;
      const Pos x = decode(u, s, in_body_mask);
      const float ps = kBaseScore * x.posw * x.posw;
      if (x.hg == kHgInlink) {
        inlink[p] = ps;
      } else {
        const int mhg = x.body ? 0 : x.hg;
#pragma unroll
        for (int g = 0; g < kHgValues; ++g)
          if (g == mhg) gmax[g] = fmaxf(gmax[g], ps);
      }
    }
    if (!present) continue;
    any_scored = true;
    // top-MAX_TOP sum by repeated max knock-out over the candidates
    // (all >= 0; -1 marks a candidate already taken)
    float tops[kMaxTop];  // descending
#pragma unroll
    for (int k = 0; k < kMaxTop; ++k) {
      float m = gmax[0];
      int am = 0;
#pragma unroll
      for (int c = 1; c < kHgValues + P; ++c) {
        const float v = c < kHgValues ? gmax[c] : inlink[c - kHgValues];
        if (v > m) { m = v; am = c; }
      }
      tops[k] = m;
#pragma unroll
      for (int c = 0; c < kHgValues + P; ++c) {
        if (c != am) continue;
        if (c < kHgValues) gmax[c] = -1.0f; else inlink[c - kHgValues] = -1.0f;
      }
    }
    // summed smallest first, the plain version's order
    float top = tops[kMaxTop - 1];
#pragma unroll
    for (int k = kMaxTop - 2; k >= 0; --k) top += tops[k];
    const float fw = freq_weight[t];
    min_single = fminf(min_single, top * (fw * fw));
  }
  if (!any_scored) return 1.0f;  // no counted term present: filter-only

  // ---- pairs: exact max over P x P per nearby counted (i, j), both
  // present in this doc ----
  float min_pair = kBig;
#pragma unroll 1
  for (int i = 0; i < T - 1; ++i) {
    if (!counts[i]) continue;
    float pw_i[P];
    int wp_i[P];
    unsigned body_i = 0u;
    bool present_i = false;
#pragma unroll
    for (int a = 0; a < P; ++a) {
      const uint32_t u = slot(i, a);
      const Pos x = decode(u, s, in_body_mask);
      present_i |= u != 0u;
      pw_i[a] = (u != 0u) ? x.posw : 0.0f;  // an empty slot scores 0
      wp_i[a] = x.wordpos;
      body_i |= (x.body ? 1u : 0u) << a;
    }
    if (!present_i) continue;
    const int j_end = min(i + kMaxPairSpan, T - 1);
#pragma unroll 1
    for (int j = i + 1; j <= j_end; ++j) {
      if (!counts[j]) continue;
      float best = 0.0f;
      bool present_j = false;
#pragma unroll 1
      for (int b = 0; b < P; ++b) {
        const uint32_t u = slot(j, b);
        if (u == 0u) continue;
        present_j = true;
        const Pos y = decode(u, s, in_body_mask);
#pragma unroll
        for (int a = 0; a < P; ++a) {
          const float delta = (float)(y.wordpos - wp_i[a]);
          const float d_plain = fmaxf(fabsf(delta), 2.0f);
          const bool bi = ((body_i >> a) & 1u) != 0u;
          const bool mixed = bi != y.body;
          const bool both_nb = !bi && !y.body;
          const float d_base =
              (both_nb && d_plain > kNonbodyDistCap) ? kFixedDistance : d_plain;
          const float d_adj = ((d_base >= kQdist) ? d_base - kQdist : d_base) +
                              (delta < 0.0f ? 1.0f : 0.0f);
          const float dist = mixed ? kFixedDistance : d_adj;
          best = fmaxf(best, kBaseScore * pw_i[a] * y.posw / (dist + 1.0f));
        }
      }
      if (present_j)
        min_pair = fminf(min_pair, best * freq_weight[i] * freq_weight[j]);
    }
  }
  return fminf(min_pair, min_single);
}

}  // namespace osse

// min_scores.cu — the min-score chain as a hand-written Hopper kernel.
//
// Replaces open_source_search_engine_tpu/query/pallas_scores.py
// ::_ms_kernel/_score_tile (K1, reached through _min_scores_fused):
// a batch of [T, P, D] cubes of uint32 posting payloads, [B, T, P, D]
// (P = 16 position slots per term group and doc; doc axis minor) ->
// min_score [B, D] float32, the docIdLoop scoring core of Posdb.cpp. The
// reference vmaps the kernel over a wave of queries and Pallas lifts the
// batch axis into the grid; here the batch axis is the kernel's own, so a
// whole F1 wave is one launch. The scoring body (decode, singles, pairs,
// min) is score_body.cuh, shared with K2 (fd_scores.cu), so the two
// kernels cannot drift; K1 only supplies the slot loader.
//
// What bounds it on the H100 depends on how full the cube is. The cube is
// read once (B*T*P*D*4 bytes: 16.8 MB at T = 4, D = 65,536, ~5 us at
// 3.35 TB/s). Every counted term pair costs valid_i * valid_j position
// pairs of ~15 fp32 operations and one IEEE division per doc: with all 16
// slots full that is 256 pairs and the arithmetic bounds it (~1.5 GFLOP a
// pass at T = 4); at the 1-4 valid slots per term and doc of real and
// random cubes, the cube read does. The first design (one thread per doc,
// every slot a global load inside the scoring loops, one launch per
// query) was bound by load latency and, on the route's small F1 cubes, by
// a grid of 8 blocks on a 132-SM card. Where the body sets the pace (as
// in fd_scores.cu) the docs an SM holds at once count. A staged doc
// takes T * 64 bytes of shared memory, so an SM holds at most ~3,500 / T
// docs whatever the tile's width: 20 warps at T = 4 (bound by
// registers), 12 at T = 8, 6 at T = 16, against the direct kernel's 16.
// A grid of one round of blocks does not feel it, and the real cubes
// measured run faster staged; a grid of just over one round does: a
// dense random [8, 16, 65536] cube is 1,024 blocks of 64 docs, two rounds
// of 792 blocks, where the direct kernel's 256 blocks are one.
//
// Design: one thread per doc; the grid is 1-D over (doc tile, query) with
// the query fastest, the ragged edge masked, so any B and D work. T is a
// template parameter (the packer's term buckets).
//   * T in {4, 8, 16} stage: a block of TD = 128 / 64 / 32 docs copies its
//     query's [T*16, TD] tile (32 KB) into shared memory with asynchronous
//     copies (stage.cuh: 16 bytes a copy where the row is aligned, word by
//     word where it is not and on the ragged last tile), then scores from
//     shared memory only. The rows of a group outside the min (counts[t]
//     false: the padding of a short query, a negative term) are not
//     copied: the body never reads them, and a one-term query padded to
//     T = 4 then moves a quarter of its cube.
//   * T in {32, 64}, and one instantiation that takes any other T at run
//     time, read the cube in global memory: their tiles would not fit.
//     Only the flat path's long queries reach them. The doc axis is
//     minor, so a warp's loads of cube[b, t, p, d0:d0+32] coalesce.
// Presence is tested per term where it is needed, so no per-doc bit mask
// caps T.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_body.cuh"
#include "stage.cuh"

namespace {

constexpr int kP = 16;

template <int kT>
constexpr int smem_bytes() {
  return kT * kP * osse::tile_docs<kT>() * 4;
}

template <int kT>
__global__ void __launch_bounds__(osse::tile_docs<kT>())
min_scores_staged(const uint32_t* __restrict__ cube,
                  const float* __restrict__ freq_weight,
                  const uint8_t* __restrict__ counts,
                  const float* __restrict__ tables, unsigned in_body_mask,
                  int B, int D, float* __restrict__ out) {
  constexpr int TD = osse::tile_docs<kT>();
  constexpr int kRows = kT * kP;
  extern __shared__ __align__(16) uint32_t s_tile[];  // [kRows, TD]
  __shared__ osse::Tables s_tab;
  __shared__ float s_fw[kT];
  __shared__ uint8_t s_cnt[kT];

  const int b = blockIdx.x % B;
  const int d0 = (blockIdx.x / B) * TD;
  const int lane = threadIdx.x;
  osse::load_tables(tables, &s_tab);
  if (lane < kT) {
    s_fw[lane] = freq_weight[b * kT + lane];
    s_cnt[lane] = counts[b * kT + lane];
  }
  __syncthreads();
  // the body reads no slot of a group outside the min (a padded group,
  // a negative), so those rows stay unstaged
  const size_t stride = (size_t)D;
  osse::stage_rows<TD>(s_tile, kRows, min(TD, D - d0),
                       [&](int row) -> const uint32_t* {
                         if (!s_cnt[row / kP]) return nullptr;
                         return cube + ((size_t)b * kRows + row) * stride +
                                d0;
                       });
  osse::stage_wait();

  const int d = d0 + lane;
  if (d >= D) return;
  const uint32_t* col = s_tile + lane;
  const auto slot = [&](int t, int p) -> uint32_t {
    return col[(t * kP + p) * TD];
  };
  out[(size_t)b * stride + d] = osse::score_doc<kT, kP>(
      slot, kT, s_fw, s_cnt, s_tab, in_body_mask);
}

template <int kT>
__global__ void __launch_bounds__(osse::kBlock)
min_scores_direct(const uint32_t* __restrict__ cube,
                  const float* __restrict__ freq_weight,
                  const uint8_t* __restrict__ counts,
                  const float* __restrict__ tables, unsigned in_body_mask,
                  int B, int t_runtime, int D, float* __restrict__ out) {
  __shared__ osse::Tables s_tab;
  osse::load_tables(tables, &s_tab);
  __syncthreads();

  const int T = kT > 0 ? kT : t_runtime;
  const int b = blockIdx.x % B;
  const int d = (blockIdx.x / B) * osse::kBlock + threadIdx.x;
  if (d >= D) return;
  const size_t stride = (size_t)D;  // between consecutive (t, p) rows
  const uint32_t* col = cube + (size_t)b * T * kP * stride + d;
  const auto slot = [&](int t, int p) -> uint32_t {
    return col[(size_t)(t * kP + p) * stride];
  };
  out[(size_t)b * stride + d] = osse::score_doc<kT, kP>(
      slot, t_runtime, freq_weight + (size_t)b * T, counts + (size_t)b * T,
      s_tab, in_body_mask);
}

struct Args {
  const uint32_t* cube;
  const float* fw;
  const uint8_t* counts;
  const float* tables;
  unsigned in_body_mask;
  int B, T, D;
  float* out;
  cudaStream_t stream;
};

template <int kT>
int launch_staged(const Args& a) {
  constexpr int TD = osse::tile_docs<kT>();
  constexpr int kSmem = smem_bytes<kT>();
  // under the 48 KB a block may take without opting in
  static_assert(kSmem <= 48 * 1024, "opt in with cudaFuncSetAttribute");
  const long long blocks = (long long)((a.D + TD - 1) / TD) * a.B;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  min_scores_staged<kT><<<(unsigned)blocks, TD, kSmem, a.stream>>>(
      a.cube, a.fw, a.counts, a.tables, a.in_body_mask, a.B, a.D, a.out);
  return 0;
}

template <int kT>
int launch_direct(const Args& a) {
  const long long blocks =
      (long long)((a.D + osse::kBlock - 1) / osse::kBlock) * a.B;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  min_scores_direct<kT><<<(unsigned)blocks, osse::kBlock, 0, a.stream>>>(
      a.cube, a.fw, a.counts, a.tables, a.in_body_mask, a.B, a.T, a.D,
      a.out);
  return 0;
}

}  // namespace

// cube: [B, T, 16, D] uint32 payloads (passed as an int32 view);
// freq_weight: [B, T] float32; counts: [B, T] bool; tables: 16 hashgroup
// weights then 32 density weights, float32; in_body_mask: bit h set when
// hashgroup h is body-ish; out: [B, D] float32. Launches on `stream` and
// returns cudaGetLastError() (0 = launched); B < 1, T < 1 or more than
// 2^31 - 1 blocks returns cudaErrorInvalidValue without launching.
extern "C" int osse_min_scores(const void* cube, const void* freq_weight,
                               const void* counts, const void* tables,
                               unsigned in_body_mask, int B, int T, int D,
                               void* out, void* stream) {
  const Args a{static_cast<const uint32_t*>(cube),
               static_cast<const float*>(freq_weight),
               static_cast<const uint8_t*>(counts),
               static_cast<const float*>(tables),
               in_body_mask, B, T, D,
               static_cast<float*>(out),
               static_cast<cudaStream_t>(stream)};
  if (B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (D <= 0) return 0;
  int rc;
  switch (T) {
    case 4: rc = launch_staged<4>(a); break;
    case 8: rc = launch_staged<8>(a); break;
    case 16: rc = launch_staged<16>(a); break;
    case 32: rc = launch_direct<32>(a); break;
    case 64: rc = launch_direct<64>(a); break;
    default: rc = launch_direct<0>(a); break;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

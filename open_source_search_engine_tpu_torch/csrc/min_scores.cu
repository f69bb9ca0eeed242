// min_scores.cu — the min-score chain as a hand-written Hopper kernel.
//
// Replaces open_source_search_engine_tpu/query/pallas_scores.py
// ::_ms_kernel/_score_tile (K1, reached through _min_scores_fused):
// a [T, P, D] cube of uint32 posting payloads (P = 16 position slots per
// term group and doc; doc axis minor) -> min_score[D] float32, the
// docIdLoop scoring core of Posdb.cpp. The scoring body (decode, singles,
// pairs, min) is score_body.cuh, shared with K2 (fd_scores.cu), so the
// two kernels cannot drift; K1 only supplies the slot loader.
//
// What bounds it on the H100 depends on how full the cube is. The cube is
// read once (T*P*D*4 bytes: 16.8 MB at T = 4, D = 65,536, ~5 us at
// 3.35 TB/s). Every counted term pair costs valid_i * valid_j position
// pairs of ~15 fp32 operations and one IEEE division per doc: with all 16
// slots full that is 256 pairs and the arithmetic bounds it (~1.5 GFLOP a
// pass at T = 4); at the 1-4 valid slots per term and doc of real and
// random cubes, the cube read does.
//
// Design: one thread per doc column, 256-thread blocks, grid
// ceil(D/256) with the ragged edge masked, so any D works. The doc axis
// is minor, so a warp's loads of cube[t, p, d0:d0+32] coalesce. T and P
// are template parameters (T in {4, 8, 16, 32, 64}, the packer's term
// buckets; one instantiation reads any larger T at run time; P = 16).
// Presence is tested per term where it is needed, so no per-doc bit mask
// caps T. cp.async/TMA staging and warp-level sharing of term rows are
// left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_body.cuh"

namespace {

using osse::kBlock;

template <int kT, int P>
__global__ void __launch_bounds__(kBlock)
min_scores_kernel(const uint32_t* __restrict__ cube,
                  const float* __restrict__ freq_weight,
                  const uint8_t* __restrict__ counts,
                  const float* __restrict__ tables,
                  unsigned in_body_mask, int t_runtime, int D,
                  float* __restrict__ out) {
  __shared__ osse::Tables s_tab;
  osse::load_tables(tables, &s_tab);
  __syncthreads();

  const int d = blockIdx.x * kBlock + threadIdx.x;
  if (d >= D) return;
  const uint32_t* col = cube + d;
  const size_t stride = (size_t)D;  // between consecutive (t, p) rows
  const auto slot = [&](int t, int p) -> uint32_t {
    return col[(size_t)(t * P + p) * stride];
  };
  out[d] = osse::score_doc<kT, P>(slot, t_runtime, freq_weight, counts,
                                  s_tab, in_body_mask);
}

template <int kT>
void launch(const uint32_t* cube, const float* fw, const uint8_t* counts,
            const float* tables, unsigned in_body_mask, int T, int D,
            float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((D + kBlock - 1) / kBlock));
  min_scores_kernel<kT, 16><<<grid, kBlock, 0, stream>>>(
      cube, fw, counts, tables, in_body_mask, T, D, out);
}

}  // namespace

// cube: [T, 16, D] uint32 payloads (passed as an int32 view); freq_weight:
// [T] float32; counts: [T] bool; tables: 16 hashgroup weights then 32
// density weights, float32; in_body_mask: bit h set when hashgroup h is
// body-ish; out: [D] float32. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); T < 1 returns cudaErrorInvalidValue
// without launching.
extern "C" int osse_min_scores(const void* cube, const void* freq_weight,
                               const void* counts, const void* tables,
                               unsigned in_body_mask, int T, int D, void* out,
                               void* stream) {
  const uint32_t* c = static_cast<const uint32_t*>(cube);
  const float* fw = static_cast<const float*>(freq_weight);
  const uint8_t* cnt = static_cast<const uint8_t*>(counts);
  const float* tab = static_cast<const float*>(tables);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (D <= 0) return 0;
  switch (T) {
    case 4: launch<4>(c, fw, cnt, tab, in_body_mask, T, D, o, s); break;
    case 8: launch<8>(c, fw, cnt, tab, in_body_mask, T, D, o, s); break;
    case 16: launch<16>(c, fw, cnt, tab, in_body_mask, T, D, o, s); break;
    case 32: launch<32>(c, fw, cnt, tab, in_body_mask, T, D, o, s); break;
    case 64: launch<64>(c, fw, cnt, tab, in_body_mask, T, D, o, s); break;
    default: launch<0>(c, fw, cnt, tab, in_body_mask, T, D, o, s); break;
  }
  return (int)cudaGetLastError();
}

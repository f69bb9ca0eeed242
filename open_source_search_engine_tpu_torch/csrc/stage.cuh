// stage.cuh — staging a block's slot tile in shared memory, shared by K1
// (min_scores.cu) and K2 (fd_scores.cu).
//
// A block scores TD neighbouring docs of one query, one thread per doc.
// Before it scores, it copies the rows it needs (TD words of each
// [row, D] row, starting at doc d0) into a shared-memory tile [rows, TD]
// with asynchronous copies, so that every global load of the block is in
// flight at once instead of one dependent load at a time inside the
// scoring loops. The scoring body then reads tile[row * TD + lane]:
// neighbouring threads read neighbouring words, one bank each.
//
// Each row is cut into 16-byte chunks spread over the block's threads:
//   * a chunk whose source is 16-byte aligned and lies wholly inside the
//     doc axis is one cp.async of 16 bytes (.cg: through L2, not L1);
//   * otherwise (a row whose start is not 16-byte aligned, as every row
//     but some is when D % 4 != 0, and the ragged last tile of any D) the
//     chunk goes word by word: a cp.async of 4 bytes for each word inside
//     the doc axis, a plain zero store for each word past it.
// stage_wait() then waits for the thread's own copies and joins the block,
// after which every thread may read the whole tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace osse {

// Docs per block (= threads per block) of a staged kernel with kT term
// groups: the tile [kT * 16, TD] of uint32 stays at 32 KB.
template <int kT>
__host__ __device__ constexpr int tile_docs() {
  return kT <= 4 ? 128 : (kT <= 8 ? 64 : 32);
}

__device__ __forceinline__ void cp_async16(uint32_t* dst_smem,
                                           const uint32_t* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst_smem,
                                          const uint32_t* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Issue the copies of n_rows rows into tile [n_rows, TD]. row_src(row)
// gives the address of the row's word at doc d0 (a pointer into global
// memory), or nullptr to leave that tile row unwritten. n_valid
// (1..TD) is the number of docs of the tile inside the doc axis; the
// tile's words past it are written 0. The block has TD threads, and every
// one of them calls this; the copies complete at stage_wait().
template <int TD, typename RowSrc>
__device__ __forceinline__ void stage_rows(uint32_t* tile, int n_rows,
                                           int n_valid,
                                           const RowSrc& row_src) {
  static_assert(TD % 4 == 0, "a tile row is whole 16-byte chunks");
  constexpr int kChunks = TD / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < n_rows * kChunks; i += TD) {
    const int row = i / kChunks;
    const int w = (i % kChunks) * 4;
    const uint32_t* src = row_src(row);
    if (src == nullptr) continue;
    uint32_t* dst = tile + row * TD + w;
    if (w + 4 <= n_valid &&
        (reinterpret_cast<uintptr_t>(src) & 15u) == 0u) {
      cp_async16(dst, src + w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (w + k < n_valid)
          cp_async4(dst + k, src + w + k);
        else
          dst[k] = 0u;
      }
    }
  }
}

// Wait for this thread's copies, then for the block: the tile is whole.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

}  // namespace osse

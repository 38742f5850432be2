// A block-level matrix product for the kernels that project a tile of rows
// through a weight matrix (dgcnn_eval.cu, pointer_ff.cu):
//
//   C[64, n_out] = A[64, depth] @ W[depth, n_out]      (bf16 in, f32 accumulate)
//
// A is a row tile held in shared memory, W lies in device memory (row-major,
// [in, out]) and is streamed through shared memory in [64, 128] tiles, each
// read once per block. Eight warps form a 4 x 2 grid over a [64, 128] pass of
// C: a warp owns 16 rows and 64 columns (four warp-level mma accumulators,
// nvcuda::wmma). Every output element is handed once, in f32, to the
// caller's epilogue (bias, activation, rounding, where it goes). Shared-memory
// rows are padded by 8 elements so that the mma loads of successive rows fall
// on different banks.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace vcr {
namespace gemm {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTM = 64;   // rows of A and C per block
constexpr int kTN = 128;  // columns of C per pass
constexpr int kTK = 64;   // depth of one staged tile of W
constexpr int kPad = 8;   // bf16 elements of padding per shared-memory row
constexpr int kWLd = kTN + kPad;
constexpr size_t kWTileBytes = sizeof(__nv_bfloat16) * kTK * kWLd;
constexpr size_t kStageBytes = sizeof(float) * kWarps * 16 * 16;
constexpr size_t kScratchBytes = kWTileBytes + kStageBytes;  // what block_gemm needs

__host__ __device__ constexpr int padded(int width) { return width + kPad; }
__host__ __device__ constexpr size_t tile_bytes(int width) {
  return sizeof(__nv_bfloat16) * kTM * padded(width);
}

// The block copies rows [row0, row0 + 64) of a bf16 matrix [rows, width] in
// device memory into a padded shared-memory tile (16-byte copies); rows at or
// beyond ``rows`` become zeros. width % 8 == 0.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ src, size_t row0,
                                          size_t rows, int width, __nv_bfloat16* tile) {
  const int per_row = width / 8;
  const int ld = padded(width);
  for (int t = threadIdx.x; t < kTM * per_row; t += blockDim.x) {
    const int r = t / per_row, c8 = (t - r * per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) v = *reinterpret_cast<const uint4*>(src + (row0 + r) * width + c8);
    *reinterpret_cast<uint4*>(tile + r * ld + c8) = v;
  }
}

// C = A @ W for the block's 64 rows; see the header comment. ``a`` is the
// shared-memory tile (row stride lda), ``w`` [depth, n_out] in device memory,
// ``scratch`` kScratchBytes of shared memory. ``ep(row, col, value)`` is
// called once per element of C, row in [0, 64), by some thread of the block.
// Requires depth % 64 == 0, n_out % 128 == 0, blockDim.x == 256; begins and
// ends with a block-wide barrier.
template <class Epilogue>
__device__ __forceinline__ void block_gemm(const __nv_bfloat16* a, int lda,
                                           const __nv_bfloat16* __restrict__ w, int depth,
                                           int n_out, unsigned char* scratch, Epilogue ep) {
  using namespace nvcuda;
  __nv_bfloat16* wtile = reinterpret_cast<__nv_bfloat16*>(scratch);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(scratch + kWTileBytes) + warp * 16 * 16;
  const int wr = warp & 3;   // 16-row group
  const int wc = warp >> 2;  // 64-column half of the pass
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
  for (int n0 = 0; n0 < n_out; n0 += kTN) {
#pragma unroll
    for (int c = 0; c < 4; ++c) wmma::fill_fragment(acc[c], 0.f);
    for (int k0 = 0; k0 < depth; k0 += kTK) {
      __syncthreads();  // the previous tile of W is consumed (and A is written)
      for (int t = threadIdx.x; t < kTK * kTN / 8; t += kThreads) {
        const int r = t / (kTN / 8), c8 = (t % (kTN / 8)) * 8;
        *reinterpret_cast<uint4*>(wtile + r * kWLd + c8) = *reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(k0 + r) * n_out + n0 + c8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        wmma::load_matrix_sync(af, a + wr * 16 * lda + k0 + kk * 16, lda);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wmma::load_matrix_sync(bf, wtile + kk * 16 * kWLd + wc * 64 + c * 16, kWLd);
          wmma::mma_sync(acc[c], af, bf, acc[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wmma::store_matrix_sync(stage, acc[c], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = lane; e < 16 * 16; e += 32)
        ep(wr * 16 + (e >> 4), n0 + wc * 64 + c * 16 + (e & 15), stage[e]);
      __syncwarp();
    }
  }
  __syncthreads();
}

}  // namespace gemm
}  // namespace vcr

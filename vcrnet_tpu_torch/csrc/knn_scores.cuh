// The score stage of the kNN kernels, one device function per input kind.
// The xyz stage is shared by knn_gather_max.cu, which fuses the selection
// with a gather-max, and knn.cu, which returns the selection alone, so that
// the same cloud gives the same score bits, and through
// common.cuh:warp_select_topk the same neighbours, in both. The bf16 stage
// is edge_conv.cu's.
//
//   scores[i, j] = 2 x_i . x_j - |x_j|^2   (f32; j == i at -inf, NaN -> -inf)
#pragma once

#include <mma.h>

#include "common.cuh"

namespace vcr {
namespace knn {

constexpr int kTileQ = 16;  // queries per block on the tensor-core path

// One warp writes the score row of query i of an xyz cloud (f32, C = 3) into
// row[0..n) (shared memory). Fixed evaluation order, no contraction into FMAs.
__device__ __forceinline__ void warp_xyz_score_row(const float* __restrict__ xb,
                                                   const float* __restrict__ nb, int i, int n,
                                                   float* row) {
  const int lane = threadIdx.x & 31;
  const float qx = xb[3 * i], qy = xb[3 * i + 1], qz = xb[3 * i + 2];
  for (int j = lane; j < n; j += 32) {
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(qx, xb[3 * j]),
                                        __fmul_rn(qy, xb[3 * j + 1])),
                              __fmul_rn(qz, xb[3 * j + 2]));
    const float s = __fsub_rn(__fmul_rn(2.f, d), nb[j]);
    row[j] = j == i ? -CUDART_INF_F : vcr::finite_or_neg_inf(s);
  }
  __syncwarp();
}

// The block writes the [kTileQ, n] score tile of queries q0.. of a bf16
// cloud [n, C] into ``scores`` (shared memory): the inner products on the
// tensor cores (warp-level mma, f32 accumulation), 16 keys per tile, tiles
// split by warp. ``qs`` is shared memory for the kTileQ staged query rows.
// Requires n % 16 == 0 and C % 16 == 0; ends with a block-wide barrier.
template <int C>
__device__ __forceinline__ void block_bf16_score_tile(const __nv_bfloat16* __restrict__ xb,
                                                      const float* __restrict__ nb, int q0,
                                                      int n, __nv_bfloat16* qs, float* scores) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // stage this block's query rows (16-byte copies)
  for (int t = threadIdx.x; t < kTileQ * C / 8; t += blockDim.x)
    reinterpret_cast<uint4*>(qs)[t] =
        reinterpret_cast<const uint4*>(xb + static_cast<size_t>(q0) * C)[t];
  __syncthreads();
  {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[C / 16];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) wmma::load_matrix_sync(qa[kk], qs + kk * 16, C);
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    for (int tile = warp; tile < n / 16; tile += n_warps) {
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        wmma::load_matrix_sync(kb, xb + static_cast<size_t>(tile) * 16 * C + kk * 16, C);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(scores + tile * 16, acc, n, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTileQ * n; t += blockDim.x) {
    const int q = t / n, j = t - q * n;
    const float s = 2.f * scores[t] - nb[j];
    scores[t] = q0 + q == j ? -CUDART_INF_F : vcr::finite_or_neg_inf(s);
  }
  __syncthreads();
}

}  // namespace knn
}  // namespace vcr

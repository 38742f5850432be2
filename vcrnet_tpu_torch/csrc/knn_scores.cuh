// The xyz score stage of the kNN kernels, shared by knn_gather_max.cu,
// which fuses the selection with a gather-max, and knn.cu, which returns
// the selection alone, so that the same cloud gives the same score bits,
// and through common.cuh:warp_select_topk the same neighbours, in both.
// (edge_conv.cu computes its bf16 scores with wgmma on its own tiles.)
//
//   scores[i, j] = 2 x_i . x_j - |x_j|^2   (f32; j == i at -inf, NaN -> -inf)
#pragma once

#include "common.cuh"

namespace vcr {
namespace knn {

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

}  // namespace knn
}  // namespace vcr

// Shared device helpers for the Hopper kernels of vcrnet_tpu_torch.
//
// Selection rule of every kNN kernel here (the JAX package's exact,
// non-packed rule, vcrnet_tpu/ops/pallas_edgeconv.py:_select_knn_idx):
// the k largest scores in descending order, ties to the SMALLER column,
// compared exactly in f32. The TPU kernels' packed-int32 selection
// (_pack_scores, ~13-22 mantissa bits) was a VPU trick and is not copied.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace vcr {

constexpr unsigned kFullMask = 0xffffffffu;

// (s, j) ranks before (bs, bj) in (score descending, column ascending) order.
__device__ __forceinline__ bool ranks_before(float s, int j, float bs, int bj) {
  return s > bs || (s == bs && j < bj);
}

// One warp selects the k top entries of a score row held in shared memory
// and writes their columns to out[0..k) (shared memory). The row is only
// read: round r takes the best entry ranking strictly after round r-1's
// winner, so nothing is masked and -inf entries (the diagonal) stay
// selectable in their own order. Callers map NaN scores to -inf and keep
// k < n, so every round finds an entry.
__device__ __forceinline__ void warp_select_topk(const float* row, int n, int k,
                                                 int* out) {
  const int lane = threadIdx.x & 31;
  float prev_s = CUDART_INF_F;
  int prev_j = -1;
  for (int r = 0; r < k; ++r) {
    float bs = -CUDART_INF_F;
    int bj = INT_MAX;
    for (int j = lane; j < n; j += 32) {
      const float s = row[j];
      if (ranks_before(prev_s, prev_j, s, j) && ranks_before(s, j, bs, bj)) {
        bs = s;
        bj = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFullMask, bs, off);
      const int oj = __shfl_xor_sync(kFullMask, bj, off);
      if (ranks_before(os, oj, bs, bj)) {
        bs = os;
        bj = oj;
      }
    }
    if (lane == 0) out[r] = bj;
    prev_s = bs;
    prev_j = bj;
  }
  __syncwarp();
}

// Score fix-up shared by the kNN kernels: NaN scores never win.
__device__ __forceinline__ float finite_or_neg_inf(float s) {
  return s != s ? -CUDART_INF_F : s;
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

}  // namespace vcr

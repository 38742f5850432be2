// Shared device helpers for the Hopper kernels of vcrnet_tpu_torch.
//
// Selection rule of every kNN kernel here (the JAX package's exact,
// non-packed rule, vcrnet_tpu/ops/pallas_edgeconv.py:_select_knn_idx):
// the k largest scores in descending order, ties to the SMALLER column,
// compared exactly in f32. The TPU kernels' packed-int32 selection
// (_pack_scores, ~13-22 mantissa bits) was a VPU trick and is not copied.
#pragma once

#include <climits>
#include <cstdint>

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

// One warp reduces k gathered rows of a bf16 table channel by channel:
// out_row[c] = max_r table[sel[r] * f + c], by 16-byte indexed loads with the
// running max in registers. With a non-null win_row it also writes the
// position r that won each channel (the first on ties: strict > in the
// order of sel). Requires f % 8 == 0 and 16-byte aligned rows.
__device__ __forceinline__ void warp_gather_max(const __nv_bfloat16* table, const int* sel,
                                                int k, int f, __nv_bfloat16* out_row,
                                                uint8_t* win_row) {
  const int lane = threadIdx.x & 31;
  for (int c = lane * 8; c < f; c += 32 * 8) {
    float m[8];
    uint8_t w[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      m[t] = -CUDART_INF_F;
      w[t] = 0;
    }
    for (int r = 0; r < k; ++r) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          table + static_cast<size_t>(sel[r]) * f + c);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 v = __bfloat1622float2(v2[t]);
        if (v.x > m[2 * t]) {
          m[2 * t] = v.x;
          w[2 * t] = static_cast<uint8_t>(r);
        }
        if (v.y > m[2 * t + 1]) {
          m[2 * t + 1] = v.y;
          w[2 * t + 1] = static_cast<uint8_t>(r);
        }
      }
    }
    if (win_row != nullptr) {
      uint2 wp;
      uint8_t* wb = reinterpret_cast<uint8_t*>(&wp);
#pragma unroll
      for (int t = 0; t < 8; ++t) wb[t] = w[t];
      *reinterpret_cast<uint2*>(win_row + c) = wp;
    }
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int t = 0; t < 4; ++t) p2[t] = __floats2bfloat162_rn(m[2 * t], m[2 * t + 1]);
    *reinterpret_cast<uint4*>(out_row + c) = packed;
  }
}

// Score fix-up shared by the kNN kernels: NaN scores never win.
__device__ __forceinline__ float finite_or_neg_inf(float s) {
  return s != s ? -CUDART_INF_F : s;
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

}  // namespace vcr

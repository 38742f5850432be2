// LPDNet SN block: xyz kNN fused with a channel-wise gather-max.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:fused_knn_gather_max
// (_fused_gather_max_impl -> _gather_max_kernel / _gather_max_deferred_kernel).
//
//   scores[i, j] = 2 x_i . x_j - |x_j|^2   (f32, j == i masked to -inf)
//   idx[i]       = top-k columns of scores[i], ties to the smaller column
//   out[i, c]    = max_{j in idx[i]} values[j, c]
//
// Bound on the H100: bytes. The kernel reads x (12 B/point) and the value
// table (2F B/point, gathered k times but from L2) and writes out + idx;
// the C=3 score product is ~6N flops per query, far below the tensor-core
// rate, so it runs on the CUDA cores. The design keeps the [N, N] scores
// out of device memory: one warp owns one query, builds its score row in
// shared memory, selects by exact f32 comparison (common.cuh), and gathers
// its k value rows with 16-byte indexed loads. The TPU's one-hot matmul
// gather and its int8 table are not carried over: a plain indexed load is
// exact and cheap here.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // queries per block, one per warp

__global__ void __launch_bounds__(kWarps * 32)
knn_gather_max_kernel(const float* __restrict__ x,       // [B, N, 3]
                      const float* __restrict__ norms,   // [B, N]
                      const __nv_bfloat16* __restrict__ values,  // [B, N, F]
                      __nv_bfloat16* __restrict__ out,   // [B, N, F]
                      int* __restrict__ idx,             // [B, N, k]
                      int n, int f, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // no block-wide barrier below

  float* row = reinterpret_cast<float*>(smem) + warp * n;
  int* sel = reinterpret_cast<int*>(smem + sizeof(float) * kWarps * n) + warp * 32;

  const float* xb = x + static_cast<size_t>(b) * n * 3;
  const float* nb = norms + static_cast<size_t>(b) * n;
  const float qx = xb[3 * i], qy = xb[3 * i + 1], qz = xb[3 * i + 2];
  for (int j = lane; j < n; j += 32) {
    // fixed evaluation order, no contraction into FMAs
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(qx, xb[3 * j]),
                                        __fmul_rn(qy, xb[3 * j + 1])),
                              __fmul_rn(qz, xb[3 * j + 2]));
    const float s = __fsub_rn(__fmul_rn(2.f, d), nb[j]);
    row[j] = j == i ? -CUDART_INF_F : vcr::finite_or_neg_inf(s);
  }
  __syncwarp();
  vcr::warp_select_topk(row, n, k, sel);

  int* qidx = idx + (static_cast<size_t>(b) * n + i) * k;
  if (lane < k) qidx[lane] = sel[lane];

  const __nv_bfloat16* vb = values + static_cast<size_t>(b) * n * f;
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * n + i) * f;
  for (int c = lane * 8; c < f; c += 32 * 8) {
    float m[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) m[t] = -CUDART_INF_F;
    for (int r = 0; r < k; ++r) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          vb + static_cast<size_t>(sel[r]) * f + c);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 v = __bfloat1622float2(v2[t]);
        m[2 * t] = fmaxf(m[2 * t], v.x);
        m[2 * t + 1] = fmaxf(m[2 * t + 1], v.y);
      }
    }
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int t = 0; t < 4; ++t) p2[t] = __floats2bfloat162_rn(m[2 * t], m[2 * t + 1]);
    *reinterpret_cast<uint4*>(ob + c) = packed;
  }
}

}  // namespace

// x f32 [B,N,3], norms f32 [B,N], values bf16 [B,N,F] -> out bf16 [B,N,F],
// idx int32 [B,N,k]. Requires F % 8 == 0, 16-byte aligned values/out, k <= 32,
// k < N. Returns the launch status.
cudaError_t vcr_knn_gather_max(const float* x, const float* norms,
                               const void* values, void* out, int* idx,
                               int batch, int n, int f, int k,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * n + sizeof(int) * kWarps * 32;
  cudaError_t err = cudaFuncSetAttribute(
      knn_gather_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kWarps - 1) / kWarps, batch);
  knn_gather_max_kernel<<<grid, kWarps * 32, smem, stream>>>(
      x, norms, static_cast<const __nv_bfloat16*>(values),
      static_cast<__nv_bfloat16*>(out), idx, n, f, k);
  return cudaGetLastError();
}

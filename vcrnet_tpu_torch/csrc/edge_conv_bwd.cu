// Backward of the LPDNet DG block (edge conv), routed by saved winners.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:_fused_edge_conv_bwd
// (-> _edge_conv_bwd_kernel). Per query point i with neighbours idx[i, :]:
//
//   z[j]   = act(a[idx[i, j]] + h[i])                 (recomputed, f32)
//   dp[c]  = ct2[i, c] * act'(x2[i, c])               (nonzero only at the
//                                                      winner row win2[i, c])
//   dz[j]  = [win1 == j] ct1[i] + bf16(dp)[j] @ W2^T  (f32)
//   dq[j]  = dz[j] * act'(z[j])
//   da[idx[i, j]] += bf16(dq[j]);  dh[i] = sum_j dq[j]
//   dW2   += z^T dp;  db2 += sum dp                   (over all 2B*N queries)
//
// act' is taken from the post-activation sign (1 where it is > 0, else the
// slope), as the Pallas kernel does. Bound on the H100: operations, just:
// at k = 20, F = 128 a query needs about 73 KFLOP of f32 work (the two
// routed 128 x 128 passes) against 2.6 KB moved once each. The
// TPU kernel built a [k*TQ, N] one-hot and ran the gathers, the two
// products and the scatter as matmuls, with da, dW2 and db2 carried across
// a sequential grid. Here a fixed grid of blocks each loops over queries
// (one query at a time, 256 threads) and uses the winners directly: dp is
// one value per output channel, so bf16(dp) @ W2^T and z^T dp are two
// 128 x 128 sparse-by-routing passes on the CUDA cores, against W2^T
// staged once per block in shared memory. Cross-block sums:
//   * dW2 and db2: each block keeps its partial sum in registers and writes
//     it out; a second kernel adds the partials in block order
//     (deterministic);
//   * da: f32 atomics into a zeroed buffer (a row receives on average k
//     additions per channel, in an order that changes from run to run).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kF = 128;  // edge-conv width (LPDNet convDG1/convDG2)
constexpr int kMaxK = 32;
constexpr int kZStride = kF + 1;  // z rows padded: winner-row reads spread over banks
constexpr int kPartial = kF * kF + kF;  // one block's dW2 then db2

constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) * kF * kF +        // W2^T
    sizeof(float) * kMaxK * kZStride +       // z
    sizeof(float) * 2 * kMaxK * kF +         // dz, two halves of the outputs
    sizeof(float) * 4 * kF +                 // dp, bf16(dp), ct1, h
    sizeof(int) * (2 * kF + kMaxK);          // win1, win2, neighbour ids

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads, 2)
edge_conv_bwd_kernel(const int* __restrict__ idx,             // [B, N, k]
                     const uint8_t* __restrict__ win1,        // [B, N, F]
                     const uint8_t* __restrict__ win2,        // [B, N, F]
                     const __nv_bfloat16* __restrict__ a,     // [B, N, F]
                     const __nv_bfloat16* __restrict__ h,     // [B, N, F]
                     const __nv_bfloat16* __restrict__ w2,    // [F, F] (in, out)
                     const __nv_bfloat16* __restrict__ x2,    // [B, N, F]
                     const __nv_bfloat16* __restrict__ ct1g,  // [B, N, F]
                     const __nv_bfloat16* __restrict__ ct2g,  // [B, N, F]
                     float* __restrict__ da,                  // [B, N, F], zeroed
                     float* __restrict__ dh,                  // [B, N, F]
                     float* __restrict__ partial,             // [grid, kPartial]
                     int rows, int n, int k, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2t = reinterpret_cast<__nv_bfloat16*>(smem);
  float* zs = reinterpret_cast<float*>(smem + sizeof(__nv_bfloat16) * kF * kF);
  float* dz = zs + kMaxK * kZStride;
  float* dp = dz + 2 * kMaxK * kF;
  float* dpb = dp + kF;
  float* ct1 = dpb + kF;
  float* hrow = ct1 + kF;
  int* w1w = reinterpret_cast<int*>(hrow + kF);
  int* w2w = w1w + kF;
  int* sel = w2w + kF;

  const int tid = threadIdx.x;
  for (int e = tid; e < kF * kF; e += kThreads) w2t[(e % kF) * kF + e / kF] = w2[e];

  // thread (lo, half): dz column lo over outputs [half*64, half*64 + 64), and
  // dW2[half*64 + ii][lo] for ii < 64 in registers
  const int lo = tid & (kF - 1), half = tid >> 7;
  float acc[kF / 2];
#pragma unroll
  for (int ii = 0; ii < kF / 2; ++ii) acc[ii] = 0.f;
  float db = 0.f;
  __syncthreads();

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row / n) * n;  // first row of this cloud
    if (tid < k) sel[tid] = idx[static_cast<size_t>(row) * k + tid];
    if (tid < kF) {
      const size_t e = static_cast<size_t>(row) * kF + tid;
      hrow[tid] = __bfloat162float(h[e]);
      ct1[tid] = __bfloat162float(ct1g[e]);
      const float d = __bfloat162float(ct2g[e]) * (__bfloat162float(x2[e]) > 0.f ? 1.f : slope);
      dp[tid] = d;
      dpb[tid] = round_bf16(d);
      w1w[tid] = win1[e];
      w2w[tid] = win2[e];
    }
    __syncthreads();

    for (int e = tid; e < k * kF; e += kThreads) {
      const int j = e / kF, c = e % kF;
      zs[j * kZStride + c] =
          vcr::leaky(__bfloat162float(a[(base + sel[j]) * kF + c]) + hrow[c], slope);
      dz[j * kF + c] = w1w[c] == j ? ct1[c] : 0.f;
      dz[(kMaxK + j) * kF + c] = 0.f;
    }
    __syncthreads();

    {
      float* dzh = dz + half * kMaxK * kF;
      for (int o = half * (kF / 2); o < (half + 1) * (kF / 2); ++o) {
        const float d = dpb[o];  // the same for the whole warp
        if (d != 0.f) dzh[w2w[o] * kF + lo] += d * __bfloat162float(w2t[o * kF + lo]);
      }
      const float d = dp[lo];
      const float* zr = zs + w2w[lo] * kZStride + half * (kF / 2);
#pragma unroll
      for (int ii = 0; ii < kF / 2; ++ii) acc[ii] += zr[ii] * d;
      if (half == 0) db += d;
    }
    __syncthreads();

    for (int e = tid; e < k * kF; e += kThreads) {
      const int j = e / kF, c = e % kF;
      const float zv = zs[j * kZStride + c];
      const float q = (dz[j * kF + c] + dz[(kMaxK + j) * kF + c]) * (zv > 0.f ? 1.f : slope);
      dz[j * kF + c] = q;
      atomicAdd(da + (base + sel[j]) * kF + c, round_bf16(q));
    }
    __syncthreads();
    if (tid < kF) {
      float s = 0.f;
      for (int j = 0; j < k; ++j) s += dz[j * kF + tid];
      dh[static_cast<size_t>(row) * kF + tid] = s;
    }
    // the next query's first barrier orders these reads before dz is rewritten
  }

  float* pb = partial + static_cast<size_t>(blockIdx.x) * kPartial;
#pragma unroll
  for (int ii = 0; ii < kF / 2; ++ii) pb[(half * (kF / 2) + ii) * kF + lo] = acc[ii];
  if (half == 0) pb[kF * kF + lo] = db;
}

// dW2 and db2: the blocks' partial sums added in block order
__global__ void edge_conv_bwd_reduce_kernel(const float* __restrict__ partial, int blocks,
                                            float* __restrict__ dw2, float* __restrict__ db2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kPartial) return;
  float s = 0.f;
  for (int blk = 0; blk < blocks; ++blk) s += partial[static_cast<size_t>(blk) * kPartial + e];
  if (e < kF * kF)
    dw2[e] = s;
  else
    db2[e - kF * kF] = s;
}

}  // namespace

// The grid for `rows` = B*N queries on the current device: as many blocks
// as are resident at once (kSmemBytes of shared memory each), at most one
// per query -> blocks, and the f32 scratch that vcr_edge_conv_bwd takes,
// blocks * (128*128+128) floats. Returns the query status.
cudaError_t vcr_edge_conv_bwd_grid(int rows, int* blocks, int64_t* scratch_floats) {
  cudaError_t err = cudaFuncSetAttribute(edge_conv_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_conv_bwd_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms < rows ? per_sm * sms : rows;
  *scratch_floats = static_cast<int64_t>(*blocks) * kPartial;
  return *blocks < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// idx int32 [B,N,k], win1/win2 uint8 [B,N,128], a/h/x2/ct1/ct2 bf16 [B,N,128],
// w2 bf16 [128,128] (in, out) -> da f32 [B,N,128] (zeroed by the caller,
// added into), dh f32 [B,N,128], dw2 f32 [128,128], db2 f32 [128], on the
// grid and with the scratch `partial` that vcr_edge_conv_bwd_grid gave.
// Requires k <= 32 and every idx < N, win < k. Returns the launch status.
cudaError_t vcr_edge_conv_bwd(const int* idx, const void* win1, const void* win2,
                              const void* a, const void* h, const void* w2, const void* x2,
                              const void* ct1, const void* ct2, float* da, float* dh,
                              float* dw2, float* db2, float* partial, int blocks, int batch,
                              int n, int k, float slope, cudaStream_t stream) {
  if (k > kMaxK || blocks < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  using bf = const __nv_bfloat16*;
  edge_conv_bwd_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      idx, static_cast<const uint8_t*>(win1), static_cast<const uint8_t*>(win2),
      static_cast<bf>(a), static_cast<bf>(h), static_cast<bf>(w2), static_cast<bf>(x2),
      static_cast<bf>(ct1), static_cast<bf>(ct2), da, dh, partial, batch * n, n, k, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge_conv_bwd_reduce_kernel<<<(kPartial + 255) / 256, 256, 0, stream>>>(partial, blocks,
                                                                          dw2, db2);
  return cudaGetLastError();
}

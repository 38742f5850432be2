// Backward of the LPDNet SN block's gather-max, routed by saved winners.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:_gather_max_bwd_from_winners
// (-> _gather_max_bwd_kernel).
//
//   dv[b, idx[b, i, win[b, i, c]], c] += ct[b, i, c]      (f32)
//
// Bound on the H100: bytes. Each (i, c) adds one value to one place; the
// kernel reads idx (4k B/point), win (F B/point) and ct (2F B/point) once
// and read-modify-writes the f32 dv. The TPU kernel ran the scatter as a
// one-hot matmul with the sum carried across its sequential query-tile
// grid; blocks on the card run in no order, so each thread adds its 8
// channels into dv with f32 atomics. The wrapper zeroes dv. A target row
// receives one addition per (query, channel) whose winner it is -- on
// average one per element -- so contention is low. The order of the
// additions changes from run to run: an element with several
// contributions may differ from the plain version in the last f32 bits.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_max_bwd_kernel(const int* __restrict__ idx,            // [B, N, k]
                      const uint8_t* __restrict__ win,        // [B, N, F]
                      const __nv_bfloat16* __restrict__ ct,   // [B, N, F]
                      float* __restrict__ dv,                 // [B, N, F]
                      int batch, int n, int f, int k) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int groups = f / 8;  // 8 channels per thread
  if (t >= static_cast<size_t>(batch) * n * groups) return;
  const size_t row = t / groups;  // b * n + i
  const int c = static_cast<int>(t % groups) * 8;
  const size_t b = row / n;

  const uint2 wraw = *reinterpret_cast<const uint2*>(win + row * f + c);
  const uint8_t* w = reinterpret_cast<const uint8_t*>(&wraw);
  const uint4 craw = *reinterpret_cast<const uint4*>(ct + row * f + c);
  const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&craw);
  const int* qidx = idx + row * k;
  float* dvb = dv + b * n * f + c;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 g = __bfloat1622float2(c2[p]);
    atomicAdd(dvb + static_cast<size_t>(qidx[w[2 * p]]) * f + 2 * p, g.x);
    atomicAdd(dvb + static_cast<size_t>(qidx[w[2 * p + 1]]) * f + 2 * p + 1, g.y);
  }
}

}  // namespace

// idx int32 [B,N,k], win uint8 [B,N,F], ct bf16 [B,N,F] -> dv f32 [B,N,F]
// (zeroed by the caller, added into). Requires F % 8 == 0, 16-byte aligned
// ct, 8-byte aligned win, every win < k and every idx < N. Returns the
// launch status.
cudaError_t vcr_gather_max_bwd(const int* idx, const void* win, const void* ct, float* dv,
                               int batch, int n, int f, int k, cudaStream_t stream) {
  const size_t threads = static_cast<size_t>(batch) * n * (f / 8);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  gather_max_bwd_kernel<<<blocks, kThreads, 0, stream>>>(
      idx, static_cast<const uint8_t*>(win), static_cast<const __nv_bfloat16*>(ct), dv,
      batch, n, f, k);
  return cudaGetLastError();
}

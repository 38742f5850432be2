// Backward of the LPDNet SN block's gather-max, routed by saved winners.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:_gather_max_bwd_from_winners
// (-> _gather_max_bwd_kernel).
//
//   dv[b, idx[b, i, win[b, i, c]], c] += ct[b, i, c]      (f32)
//
// Bound on the H100: bytes. Each (i, c) adds one value to one place; the
// function reads idx (4k B/point), win (F B/point) and ct (2F B/point) once
// and writes the f32 dv once. The TPU kernel ran the scatter as a one-hot
// matmul with the sum carried across its sequential query-tile grid. Here
// a block owns one cloud and one slice of S channels and keeps that slice
// of dv, [N, S] f32, in shared memory: S = 32 (128 KB) at N = 1024, 16 at
// N = 3072, the widest of 32, 16, 8 that divides F and fits. Its warps walk
// every query of the cloud, 32 / S queries a warp at a time (lane l on
// channel l % S), each lane with kUnroll queries' loads in flight (its win
// byte and ct value, then the winning neighbour's index), and add into the
// slice with shared-memory atomics: with S = 32 a warp's 32 lanes hit 32
// banks. The block then writes the slice with 16-byte stores. No
// device-memory atomics and no zero fill: every element of dv is written
// once, so the caller need not clear it. The order of the additions into
// one element changes from run to run (shared-memory atomics): an element
// with several contributions may differ from the plain version in the last
// f32 bits.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;             // queries a lane has in flight
constexpr size_t kSliceBudget = 232448;  // shared memory a block can use on sm_90

// log2 of the slice width S: the widest of 32, 16, 8 that divides f and
// whose [n, S] f32 accumulator fits kSliceBudget; -1 when none does.
int slice_shift(int n, int f) {
  for (int shift = 5; shift >= 3; --shift)
    if (f % (1 << shift) == 0 && sizeof(float) * static_cast<size_t>(n) << shift <= kSliceBudget)
      return shift;
  return -1;
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

__global__ void __launch_bounds__(kThreads)
gather_max_bwd_kernel(const int* __restrict__ idx,            // [B, N, k]
                      const uint8_t* __restrict__ win,        // [B, N, F]
                      const __nv_bfloat16* __restrict__ ct,   // [B, N, F]
                      float* __restrict__ dv,                 // [B, N, F]
                      int n, int f, int k, int shift) {
  extern __shared__ float4 acc4[];  // [n, S] f32
  float* acc = reinterpret_cast<float*>(acc4);
  const int b = blockIdx.y, c0 = blockIdx.x << shift;
  const int slice4 = (n << shift) >> 2;  // float4s of the slice
  for (int e = threadIdx.x; e < slice4; e += kThreads) acc4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & ((1 << shift) - 1);
  const int stride = kWarps << (5 - shift);  // queries the block takes at once
  const size_t base = static_cast<size_t>(b) * n;
  const uint8_t* winc = win + base * f + c0 + c;
  const unsigned short* ctc = reinterpret_cast<const unsigned short*>(ct + base * f + c0 + c);
  const int* idxb = idx + base * k;
  int i = (warp << (5 - shift)) + (lane >> shift);
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    int w[kUnroll];
    float g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t q = static_cast<size_t>(i + u * stride) * f;
      w[u] = __ldg(winc + q);
      g[u] = bf16_bits_to_float(__ldg(ctc + q));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(idxb + static_cast<size_t>(i + u * stride) * k + w[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) atomicAdd(acc + (w[u] << shift) + c, g[u]);
  }
  for (; i < n; i += stride) {
    const size_t q = static_cast<size_t>(i) * f;
    const int t = __ldg(idxb + static_cast<size_t>(i) * k + __ldg(winc + q));
    atomicAdd(acc + (t << shift) + c, bf16_bits_to_float(__ldg(ctc + q)));
  }
  __syncthreads();

  // the slice's rows are S f32 apart here and F apart in dv
  const int row_shift = shift - 2;  // float4s of a row, as a shift
  for (int e = threadIdx.x; e < slice4; e += kThreads) {
    const int t = e >> row_shift, cc = (e & ((1 << row_shift) - 1)) << 2;
    *reinterpret_cast<float4*>(dv + (base + t) * f + c0 + cc) = acc4[e];
  }
}

}  // namespace

// idx int32 [B,N,k], win uint8 [B,N,F], ct bf16 [B,N,F] -> dv f32 [B,N,F]
// (every element written). Requires F % 8 == 0, 8 N f32 of shared memory
// (N <= 7264), 16-byte aligned dv, every win < k and every idx < N.
// Returns the launch status (cudaErrorInvalidValue for another F or N).
cudaError_t vcr_gather_max_bwd(const int* idx, const void* win, const void* ct, float* dv,
                               int batch, int n, int f, int k, cudaStream_t stream) {
  const int shift = slice_shift(n, f);
  if (shift < 0 || k < 1 || k > 32) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * static_cast<size_t>(n) << shift;
  cudaError_t err = cudaFuncSetAttribute(
      gather_max_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gather_max_bwd_kernel<<<dim3(f >> shift, batch), kThreads, smem, stream>>>(
      idx, static_cast<const uint8_t*>(win), static_cast<const __nv_bfloat16*>(ct), dv,
      n, f, k, shift);
  return cudaGetLastError();
}

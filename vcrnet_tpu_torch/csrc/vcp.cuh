// Pieces shared by the soft-correspondence kernels (vcp_stream.cu,
// vcp_bwd.cu): the limits of their tiling and the small passes that pack
// each key's and each source row's values into one float4, so the main
// kernels bring a tile's values in with one bulk copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace vcr {
namespace vcp {

constexpr int kTile = 64;      // rows of a streamed tile, and of an owned block
constexpr int kMaxBoxes = 8;   // [64, 64] bf16 boxes across E: E <= 512
constexpr int kMaxE = 64 * kMaxBoxes;
// vcp_stream.cu's kernel for 512 < E <= 1024 (the backward keeps kMaxE)
constexpr int kMaxWideBoxes = 16;
constexpr int kMaxWideE = 64 * kMaxWideBoxes;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// keys[b, j] = (x, y, z, |f_j|^2) for the nt rows of each target item: f
// the bf16 embedding row [E] (its squares summed in f32), xyz from tgt
// [B, nt, 3]; keys has nt_pad >= nt entries an item, and those past nt are
// (0, 0, 0, +inf): a key of infinite norm, which scores -inf against any
// row, so a tile reaching past nt (the next item's rows, or zeros) needs no
// mask. One warp an entry.
static __global__ void vcp_keys_kernel(const __nv_bfloat16* __restrict__ tgt_emb,
                                       const float* __restrict__ tgt, float4* __restrict__ keys,
                                       int nt, int nt_pad, int entries, int e) {
  const int w = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= entries) return;
  const int b = w / nt_pad, j = w - b * nt_pad;
  if (j >= nt) {
    if (lane == 0) keys[w] = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
    return;
  }
  const size_t row = static_cast<size_t>(b) * nt + j;
  const __nv_bfloat162* f = reinterpret_cast<const __nv_bfloat162*>(tgt_emb + row * e);
  float s = 0.f;
  for (int c = lane; c < e / 2; c += 32) {
    const float2 v = __bfloat1622float2(f[c]);
    s = fmaf(v.x, v.x, fmaf(v.y, v.y, s));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
  if (lane == 0) {
    const float* t = tgt + 3 * row;
    keys[w] = make_float4(t[0], t[1], t[2], s);
  }
}

// keys [batch, nt_pad, 4] for tgt_emb [batch, nt, e] and tgt [batch, nt, 3].
inline cudaError_t launch_keys(const void* tgt_emb, const float* tgt, float* keys, int batch,
                               int nt, int nt_pad, int e, cudaStream_t stream) {
  const int entries = batch * nt_pad;
  const size_t threads = static_cast<size_t>(entries) * 32;
  vcp_keys_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(tgt_emb), tgt, reinterpret_cast<float4*>(keys), nt,
      nt_pad, entries, e);
  return cudaGetLastError();
}

}  // namespace vcp
}  // namespace vcr

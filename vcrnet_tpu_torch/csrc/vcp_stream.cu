// Whole-cloud soft correspondence, streamed with an online softmax.
//
// Replaces vcrnet_tpu/ops/pallas_vcp.py:streaming_soft_correspondence
// (_run_streaming -> _vcp_kernel).
//
//   s_ij    = 2 e_i . f_j - |f_j|^2           (bf16 embeddings, f32 accumulation)
//   corr_i  = sum_j softmax_j(s_ij) * tgt_j   (f32)
//
// Bound on the H100: operations (2 * Ns * Nt * E flops for the scores;
// the embeddings are read once). The score product runs on the tensor
// cores through warp-level mma (nvcuda::wmma, bf16 in, f32 accumulate).
// A block owns 64 source rows (16 per warp) and streams 64-key tiles of
// the target embedding through shared memory; two lanes share a row and
// keep its running max, sum and xyz accumulators in registers, so no
// [Ns, Nt] tensor reaches device memory. The TPU kernel's hi/lo bf16 split
// of the target xyz (an MXU trick, pallas_vcp.py:105-109) is not needed:
// the weighted xyz sum stays in f32 on the CUDA cores.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kTileQ = 16 * kWarps;
constexpr int kTileK = 64;

__global__ void __launch_bounds__(kWarps * 32)
vcp_stream_kernel(const __nv_bfloat16* __restrict__ src_emb,  // [B, Ns, E]
                  const __nv_bfloat16* __restrict__ tgt_emb,  // [B, Nt, E]
                  const float* __restrict__ norms,            // [B, Nt]
                  const float* __restrict__ tgt,              // [B, Nt, 3]
                  float* __restrict__ out,                    // [B, Ns, 3]
                  int ns, int nt, int e) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  const size_t k_bytes = sizeof(__nv_bfloat16) * kTileK * e;
  float* vals = reinterpret_cast<float*>(smem + k_bytes);  // [64, 4]: xyz, norm
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sp = reinterpret_cast<float*>(smem + k_bytes + sizeof(float) * kTileK * 4) +
              warp * 16 * kTileK;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileQ + warp * 16;
  const __nv_bfloat16* qb = src_emb + (static_cast<size_t>(b) * ns + row0) * e;
  const __nv_bfloat16* kb = tgt_emb + static_cast<size_t>(b) * nt * e;

  const int r = lane >> 1, c0 = (lane & 1) * (kTileK / 2);
  float m = -CUDART_INF_F, l = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
  for (int t0 = 0; t0 < nt; t0 += kTileK) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTileK * e / 8; t += blockDim.x)
      reinterpret_cast<uint4*>(ks)[t] =
          reinterpret_cast<const uint4*>(kb + static_cast<size_t>(t0) * e)[t];
    for (int t = threadIdx.x; t < kTileK; t += blockDim.x) {
      const size_t j = static_cast<size_t>(b) * nt + t0 + t;
      vals[4 * t] = tgt[3 * j];
      vals[4 * t + 1] = tgt[3 * j + 1];
      vals[4 * t + 2] = tgt[3 * j + 2];
      vals[4 * t + 3] = norms[j];
    }
    __syncthreads();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    for (int nb = 0; nb < kTileK / 16; ++nb) {
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < e / 16; ++kk) {
        wmma::load_matrix_sync(qa, qb + kk * 16, e);
        wmma::load_matrix_sync(kf, ks + nb * 16 * e + kk * 16, e);
        wmma::mma_sync(acc, qa, kf, acc);
      }
      wmma::store_matrix_sync(sp + nb * 16, acc, kTileK, wmma::mem_row_major);
    }
    __syncwarp();

    float tmax = -CUDART_INF_F;
    for (int c = 0; c < kTileK / 2; ++c)
      tmax = fmaxf(tmax, 2.f * sp[r * kTileK + c0 + c] - vals[4 * (c0 + c) + 3]);
    tmax = fmaxf(tmax, __shfl_xor_sync(vcr::kFullMask, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
    ax *= alpha;
    ay *= alpha;
    az *= alpha;
    for (int c = 0; c < kTileK / 2; ++c) {
      const int j = c0 + c;
      const float p = expf(2.f * sp[r * kTileK + j] - vals[4 * j + 3] - m_new);
      l += p;
      ax += p * vals[4 * j];
      ay += p * vals[4 * j + 1];
      az += p * vals[4 * j + 2];
    }
    m = m_new;
    __syncwarp();
  }
  l += __shfl_xor_sync(vcr::kFullMask, l, 1);
  ax += __shfl_xor_sync(vcr::kFullMask, ax, 1);
  ay += __shfl_xor_sync(vcr::kFullMask, ay, 1);
  az += __shfl_xor_sync(vcr::kFullMask, az, 1);
  if ((lane & 1) == 0) {
    float* o = out + (static_cast<size_t>(b) * ns + row0 + r) * 3;
    o[0] = ax / l;
    o[1] = ay / l;
    o[2] = az / l;
  }
}

}  // namespace

// src_emb bf16 [B,Ns,E], tgt_emb bf16 [B,Nt,E], norms f32 [B,Nt] (|tgt_emb|^2),
// tgt f32 [B,Nt,3] -> out f32 [B,Ns,3]. Requires Ns % 64 == 0, Nt % 64 == 0,
// E % 16 == 0, 32-byte aligned embeddings.
cudaError_t vcr_vcp_stream(const void* src_emb, const void* tgt_emb, const float* norms,
                           const float* tgt, float* out, int batch, int ns, int nt, int e,
                           cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * kTileK * e + sizeof(float) * kTileK * 4 +
                      sizeof(float) * kWarps * 16 * kTileK;
  cudaError_t err = cudaFuncSetAttribute(
      vcp_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(ns / kTileQ, batch);
  vcp_stream_kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(src_emb), static_cast<const __nv_bfloat16*>(tgt_emb),
      norms, tgt, out, ns, nt, e);
  return cudaGetLastError();
}

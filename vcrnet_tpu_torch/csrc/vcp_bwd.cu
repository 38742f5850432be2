// Backward of the whole-cloud soft correspondence, from the saved lse.
//
// Replaces vcrnet_tpu/ops/pallas_vcp.py:_vcp_bwd (-> _vcp_bwd_kernel).
// With s_ij = 2 e_i . f_j - |f_j|^2, p = exp(s - lse_i) (lse saved by
// vcp_stream.cu's forward), g = dcorr and corr the forward's output:
//
//   delta_i = g_i . corr_i,   dp_ij = g_i . tgt_j                 (f32)
//   ds      = bf16(p * (dp - delta))
//   de_i    = 2 sum_j ds_ij f_j
//   df_j    = 2 sum_i ds_ij e_i - 2 colsum_j(ds) f_j               (f32)
//   dtgt_j  = sum_i bf16(p_ij) g_i
//
// dp and dtgt stay in f32 on the CUDA cores: tgt is only 3 wide, and ds =
// p (dp - delta) cancels. Bound on the H100: operations (three Ns x Nt x E
// products). The TPU kernel kept the whole key set resident and carried
// df, dtgt and the column sums across its sequential q-tile grid, adding
// the -2 colsum f term once at the last step. Here the two sides are two
// kernels, each owning its rows, with no atomics:
//   * vcp_bwd_de_kernel owns 64 source rows and streams 64-key tiles;
//   * vcp_bwd_df_kernel owns 64 target rows, streams 64-source tiles,
//     keeps colsum and dtgt in registers and adds the -2 colsum f term
//     once at the end.
// s and ds @ (f or e) run on the tensor cores (nvcuda::wmma, bf16 in, f32
// accumulate); each warp keeps its [16, E] f32 accumulator in shared
// memory (E <= 512 fits: ~218 KB per block).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;
constexpr int kMaxE = 512;
constexpr int kStats = 5;  // lse, delta, g.x, g.y, g.z of a source row

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) / 128 * 128; }

struct Layout {  // the same for both kernels: a [64, E] bf16 tile, then per warp
  size_t tile, rows, warp0, warp_bytes, sp, ds, acc, total;
  __host__ __device__ explicit Layout(int e) {
    tile = 0;
    rows = align128(sizeof(__nv_bfloat16) * kTile * e);      // per-row values of the tile
    warp0 = rows + align128(sizeof(float) * kTile * kStats);
    sp = 0;                                                   // f32 [16, 64] scores
    ds = sizeof(float) * 16 * kTile;                          // bf16 [16, 64]
    acc = ds + sizeof(__nv_bfloat16) * 16 * kTile;            // f32 [16, E]
    warp_bytes = align128(acc + sizeof(float) * 16 * e + sizeof(float) * 16);
    total = warp0 + kWarps * warp_bytes;
  }
};

__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int e) {
  for (int t = threadIdx.x; t < kTile * e / 8; t += blockDim.x)
    reinterpret_cast<uint4*>(dst)[t] = reinterpret_cast<const uint4*>(src)[t];
}

// s [16, 64] = A[16, E] (device memory, row-major) . T[64, E]^T (shared)
__device__ __forceinline__ void scores(float* sp, const __nv_bfloat16* a,
                                       const __nv_bfloat16* tile, int e) {
  FragA fa;
  FragBCol fb;
  FragC acc;
  for (int nb = 0; nb < kTile / 16; ++nb) {
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < e / 16; ++kk) {
      wmma::load_matrix_sync(fa, a + kk * 16, e);
      wmma::load_matrix_sync(fb, tile + nb * 16 * e + kk * 16, e);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sp + nb * 16, acc, kTile, wmma::mem_row_major);
  }
}

// acc [16, E] (shared, f32) += ds [16, 64] (bf16) . T[64, E]
__device__ __forceinline__ void accumulate(float* acc, const __nv_bfloat16* ds,
                                           const __nv_bfloat16* tile, int e) {
  FragA fa;
  FragBRow fb;
  FragC c;
  for (int nb = 0; nb < e / 16; ++nb) {
    wmma::load_matrix_sync(c, acc + nb * 16, e, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::load_matrix_sync(fa, ds + kk * 16, kTile);
      wmma::load_matrix_sync(fb, tile + kk * 16 * e + nb * 16, e);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + nb * 16, c, e, wmma::mem_row_major);
  }
}

// the per-source-row values the backward needs: lse, delta = g . corr, g
__device__ __forceinline__ void source_stats(float* st, const float* lse, const float* corr,
                                             const float* dcorr, size_t row) {
  const float gx = dcorr[3 * row], gy = dcorr[3 * row + 1], gz = dcorr[3 * row + 2];
  st[0] = lse[row];
  st[1] = gx * corr[3 * row] + gy * corr[3 * row + 1] + gz * corr[3 * row + 2];
  st[2] = gx;
  st[3] = gy;
  st[4] = gz;
}

__global__ void __launch_bounds__(kWarps * 32)
vcp_bwd_de_kernel(const __nv_bfloat16* __restrict__ src_emb,  // [B, Ns, E]
                  const __nv_bfloat16* __restrict__ tgt_emb,  // [B, Nt, E]
                  const float* __restrict__ norms,            // [B, Nt]
                  const float* __restrict__ tgt,              // [B, Nt, 3]
                  const float* __restrict__ corr,             // [B, Ns, 3]
                  const float* __restrict__ dcorr,            // [B, Ns, 3]
                  const float* __restrict__ lse,              // [B, Ns]
                  float* __restrict__ d_src,                  // [B, Ns, E]
                  int ns, int nt, int e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(e);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.tile);
  float* vals = reinterpret_cast<float*>(smem + L.rows);  // [64, 4]: tgt xyz, norm
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wb = smem + L.warp0 + warp * L.warp_bytes;
  float* sp = reinterpret_cast<float*>(wb + L.sp);
  __nv_bfloat16* dsb = reinterpret_cast<__nv_bfloat16*>(wb + L.ds);
  float* acc = reinterpret_cast<float*>(wb + L.acc);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTile + warp * 16;
  const __nv_bfloat16* qb = src_emb + (static_cast<size_t>(b) * ns + row0) * e;
  for (int t = lane; t < 16 * e; t += 32) acc[t] = 0.f;
  const int r = lane >> 1, c0 = (lane & 1) * (kTile / 2);
  float st[kStats];
  source_stats(st, lse, corr, dcorr, static_cast<size_t>(b) * ns + row0 + r);

  for (int t0 = 0; t0 < nt; t0 += kTile) {
    __syncthreads();
    load_rows(ks, tgt_emb + (static_cast<size_t>(b) * nt + t0) * e, e);
    for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
      const size_t j = static_cast<size_t>(b) * nt + t0 + t;
      vals[4 * t] = tgt[3 * j];
      vals[4 * t + 1] = tgt[3 * j + 1];
      vals[4 * t + 2] = tgt[3 * j + 2];
      vals[4 * t + 3] = norms[j];
    }
    __syncthreads();
    scores(sp, qb, ks, e);
    __syncwarp();
    for (int j = c0; j < c0 + kTile / 2; ++j) {
      const float p = expf(2.f * sp[r * kTile + j] - vals[4 * j + 3] - st[0]);
      const float dp = st[2] * vals[4 * j] + st[3] * vals[4 * j + 1] + st[4] * vals[4 * j + 2];
      dsb[r * kTile + j] = __float2bfloat16_rn(p * (dp - st[1]));
    }
    __syncwarp();
    accumulate(acc, dsb, ks, e);
    __syncwarp();
  }
  float* out = d_src + (static_cast<size_t>(b) * ns + row0) * e;
  for (int t = lane; t < 16 * e; t += 32) out[t] = 2.f * acc[t];
}

__global__ void __launch_bounds__(kWarps * 32)
vcp_bwd_df_kernel(const __nv_bfloat16* __restrict__ src_emb,  // [B, Ns, E]
                  const __nv_bfloat16* __restrict__ tgt_emb,  // [B, Nt, E]
                  const float* __restrict__ norms,            // [B, Nt]
                  const float* __restrict__ tgt,              // [B, Nt, 3]
                  const float* __restrict__ corr,             // [B, Ns, 3]
                  const float* __restrict__ dcorr,            // [B, Ns, 3]
                  const float* __restrict__ lse,              // [B, Ns]
                  float* __restrict__ d_tgt_emb,              // [B, Nt, E]
                  float* __restrict__ d_tgt,                  // [B, Nt, 3]
                  int ns, int nt, int e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(e);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.tile);
  float* stats = reinterpret_cast<float*>(smem + L.rows);  // [64, kStats] source rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wb = smem + L.warp0 + warp * L.warp_bytes;
  float* sp = reinterpret_cast<float*>(wb + L.sp);
  __nv_bfloat16* dsb = reinterpret_cast<__nv_bfloat16*>(wb + L.ds);
  float* acc = reinterpret_cast<float*>(wb + L.acc);
  float* colsum = acc + 16 * e;

  const int b = blockIdx.y;
  const int key0 = blockIdx.x * kTile + warp * 16;
  const __nv_bfloat16* kb = tgt_emb + (static_cast<size_t>(b) * nt + key0) * e;
  for (int t = lane; t < 16 * e; t += 32) acc[t] = 0.f;
  const int r = lane >> 1, c0 = (lane & 1) * (kTile / 2);
  const size_t key = static_cast<size_t>(b) * nt + key0 + r;
  const float tx = tgt[3 * key], ty = tgt[3 * key + 1], tz = tgt[3 * key + 2];
  const float knorm = norms[key];
  float cs = 0.f, dtx = 0.f, dty = 0.f, dtz = 0.f;

  for (int t0 = 0; t0 < ns; t0 += kTile) {
    __syncthreads();
    load_rows(qs, src_emb + (static_cast<size_t>(b) * ns + t0) * e, e);
    for (int t = threadIdx.x; t < kTile; t += blockDim.x)
      source_stats(stats + kStats * t, lse, corr, dcorr, static_cast<size_t>(b) * ns + t0 + t);
    __syncthreads();
    scores(sp, kb, qs, e);  // s^T [16 keys, 64 sources]
    __syncwarp();
    for (int i = c0; i < c0 + kTile / 2; ++i) {
      const float* st = stats + kStats * i;
      const float p = expf(2.f * sp[r * kTile + i] - knorm - st[0]);
      const float dp = st[2] * tx + st[3] * ty + st[4] * tz;
      const __nv_bfloat16 ds = __float2bfloat16_rn(p * (dp - st[1]));
      dsb[r * kTile + i] = ds;
      cs += __bfloat162float(ds);
      const float pb = __bfloat162float(__float2bfloat16_rn(p));
      dtx += pb * st[2];
      dty += pb * st[3];
      dtz += pb * st[4];
    }
    __syncwarp();
    accumulate(acc, dsb, qs, e);
    __syncwarp();
  }
  cs += __shfl_xor_sync(vcr::kFullMask, cs, 1);
  dtx += __shfl_xor_sync(vcr::kFullMask, dtx, 1);
  dty += __shfl_xor_sync(vcr::kFullMask, dty, 1);
  dtz += __shfl_xor_sync(vcr::kFullMask, dtz, 1);
  if ((lane & 1) == 0) {
    colsum[r] = cs;
    d_tgt[3 * key] = dtx;
    d_tgt[3 * key + 1] = dty;
    d_tgt[3 * key + 2] = dtz;
  }
  __syncwarp();
  float* out = d_tgt_emb + (static_cast<size_t>(b) * nt + key0) * e;
  for (int t = lane; t < 16 * e; t += 32)
    out[t] = 2.f * acc[t] - 2.f * colsum[t / e] * __bfloat162float(kb[t]);
}

}  // namespace

// src_emb/tgt_emb bf16 [B,N,E], norms f32 [B,Nt] (|tgt_emb|^2), tgt f32
// [B,Nt,3], corr/dcorr f32 [B,Ns,3], lse f32 [B,Ns] -> d_src f32 [B,Ns,E],
// d_tgt_emb f32 [B,Nt,E], d_tgt f32 [B,Nt,3]. Requires Ns % 64 == 0,
// Nt % 64 == 0, E % 16 == 0, E <= 512, 32-byte aligned embeddings. Returns
// the launch status.
cudaError_t vcr_vcp_bwd(const void* src_emb, const void* tgt_emb, const float* norms,
                        const float* tgt, const float* corr, const float* dcorr,
                        const float* lse, float* d_src, float* d_tgt_emb, float* d_tgt,
                        int batch, int ns, int nt, int e, cudaStream_t stream) {
  if (e % 16 || e > kMaxE) return cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  const Layout L(e);
  cudaError_t err = cudaFuncSetAttribute(
      vcp_bwd_de_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  vcp_bwd_de_kernel<<<dim3(ns / kTile, batch), kWarps * 32, L.total, stream>>>(
      static_cast<bf>(src_emb), static_cast<bf>(tgt_emb), norms, tgt, corr, dcorr, lse, d_src,
      ns, nt, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(vcp_bwd_df_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  vcp_bwd_df_kernel<<<dim3(nt / kTile, batch), kWarps * 32, L.total, stream>>>(
      static_cast<bf>(src_emb), static_cast<bf>(tgt_emb), norms, tgt, corr, dcorr, lse,
      d_tgt_emb, d_tgt, ns, nt, e);
  return cudaGetLastError();
}

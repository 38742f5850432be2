// Backward of attention over packed heads (q/k/v/o/do [B, N, H*128]).
//
// Replaces vcrnet_tpu/ops/pallas_attention.py:_bwd_fused (-> _bwd_kernel).
// With s = (q . k^T) * scale and p = exp(s - lse) (lse saved by
// flash_packed.cu's forward):
//
//   delta_i = sum_d do_id o_id                          (f32)
//   ds      = bf16(p * (do . v^T - delta) * scale)
//   dq = ds @ k,  dk = ds^T @ q,  dv = bf16(p)^T @ do   (f32 accumulation,
//                                                        written in bf16)
//
// Bound on the H100: operations (five N x N x 128 products per head
// against 7 * N * 128 * 2 bytes moved). The TPU kernel held one whole q
// tile's [TQ, NK] score block in VMEM and accumulated dk/dv across its
// sequential q-tile grid. Blocks on the card run in no order, so the work
// is split by what each block owns instead, with no atomics:
//   * flash_bwd_dkdv_kernel owns 64 keys of one head and loops over every
//     64-row q tile, keeping dk and dv in wmma accumulators;
//   * flash_bwd_dq_kernel owns 64 query rows and loops over the key tiles;
//   * a small kernel computes delta first.
// Both main kernels recompute s and p (and dp) from lse instead of
// reading row statistics back; the products run on the tensor cores
// through warp-level mma (nvcuda::wmma, bf16 in, f32 accumulate), 16 rows
// per warp, four warps per block.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kDk = 128;
constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // rows a block owns = rows of a streamed tile

constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kTile * kDk;
// per warp: s and dp (f32 [16, 64]), bf16(p) and ds (bf16 [16, 64])
constexpr size_t kWarpBytes =
    2 * sizeof(float) * 16 * kTile + 2 * sizeof(__nv_bfloat16) * 16 * kTile;
constexpr size_t kStatBytes = 2 * sizeof(float) * kTile;  // lse, delta of 64 rows
constexpr size_t kSmemBytes = 4 * kTileBytes + kWarps * kWarpBytes + kStatBytes;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows [row0, row0 + 64) of one head's 128 columns -> dst [64, 128]
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row0, int d_model) {
  for (int t = threadIdx.x; t < kTile * kDk / 8; t += blockDim.x) {
    const int row = t / (kDk / 8), c8 = (t % (kDk / 8)) * 8;
    reinterpret_cast<uint4*>(dst)[t] =
        *reinterpret_cast<const uint4*>(src + (row0 + row) * d_model + c8);
  }
}

// [16, 64] = A[16, 128] . B[64, 128]^T, both row-major in shared memory
__device__ __forceinline__ void rows_by_rows_t(float* out, const __nv_bfloat16* a,
                                               const __nv_bfloat16* b) {
  FragA fa;
  FragBCol fb;
  FragC acc;
  for (int nb = 0; nb < kTile / 16; ++nb) {
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk) {
      wmma::load_matrix_sync(fa, a + kk * 16, kDk);
      wmma::load_matrix_sync(fb, b + nb * 16 * kDk + kk * 16, kDk);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + nb * 16, acc, kTile, wmma::mem_row_major);
  }
}

// acc[16, 128] += A[16, 64] (bf16, row-major, ld 64) . B[64, 128] (row-major)
__device__ __forceinline__ void accumulate(FragC* acc, const __nv_bfloat16* a,
                                           const __nv_bfloat16* b) {
  FragA fa;
  FragBRow fb;
#pragma unroll
  for (int nb = 0; nb < kDk / 16; ++nb) {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::load_matrix_sync(fa, a + kk * 16, kTile);
      wmma::load_matrix_sync(fb, b + kk * 16 * kDk + nb * 16, kDk);
      wmma::mma_sync(acc[nb], fa, fb, acc[nb]);
    }
  }
}

// a warp's [16, 128] accumulators -> bf16 rows of the packed output
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, FragC* acc, float* stage,
                                           int d_model) {
  const int lane = threadIdx.x & 31;
  for (int nb = 0; nb < kDk / 16; ++nb) {
    wmma::store_matrix_sync(stage, acc[nb], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      dst[static_cast<size_t>(e / 16) * d_model + nb * 16 + e % 16] =
          __float2bfloat16_rn(stage[e]);
    __syncwarp();
  }
}

__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                                       const __nv_bfloat16* __restrict__ dout,
                                       float* __restrict__ delta,  // [B, H, N]
                                       int batch, int n, int n_heads) {
  const size_t w = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= static_cast<size_t>(batch) * n * n_heads) return;
  const size_t bi = w / n_heads;  // b * n + i
  const int head = static_cast<int>(w % n_heads);
  const size_t off = bi * n_heads * kDk + head * kDk + lane * 4;
  const uint2 oraw = *reinterpret_cast<const uint2*>(o + off);
  const uint2 draw = *reinterpret_cast<const uint2*>(dout + off);
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&oraw);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&draw);
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float2 of = __bfloat1622float2(o2[t]), df = __bfloat1622float2(d2[t]);
    s += of.x * df.x + of.y * df.y;
  }
#pragma unroll
  for (int off2 = 16; off2 > 0; off2 >>= 1) s += __shfl_xor_sync(vcr::kFullMask, s, off2);
  if (lane == 0) {
    const size_t b = bi / n, i = bi % n;
    delta[(b * n_heads + head) * n + i] = s;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int nq,
                      int nk, int d_model, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile * kDk;
  __nv_bfloat16* qs = vs + kTile * kDk;
  __nv_bfloat16* dos = qs + kTile * kDk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wbase = smem + 4 * kTileBytes + warp * kWarpBytes;
  float* st = reinterpret_cast<float*>(wbase);     // s^T, then staging
  float* dpt = st + 16 * kTile;                    // dp^T
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(dpt + 16 * kTile);  // bf16(p)^T
  __nv_bfloat16* dst = pt + 16 * kTile;                                     // ds^T
  float* lse_s = reinterpret_cast<float*>(smem + 4 * kTileBytes + kWarps * kWarpBytes);
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.z, head = blockIdx.y, n_heads = gridDim.y;
  const size_t key0 = blockIdx.x * kTile;
  const size_t col0 = static_cast<size_t>(head) * kDk;
  load_tile(ks, k + static_cast<size_t>(b) * nk * d_model + col0, key0, d_model);
  load_tile(vs, v + static_cast<size_t>(b) * nk * d_model + col0, key0, d_model);
  const float* lse_b = lse + (static_cast<size_t>(b) * n_heads + head) * nq;
  const float* delta_b = delta + (static_cast<size_t>(b) * n_heads + head) * nq;

  FragC dk_acc[kDk / 16], dv_acc[kDk / 16];
#pragma unroll
  for (int nb = 0; nb < kDk / 16; ++nb) {
    wmma::fill_fragment(dk_acc[nb], 0.f);
    wmma::fill_fragment(dv_acc[nb], 0.f);
  }
  const int r = lane >> 1, c0 = (lane & 1) * (kTile / 2);
  for (int t0 = 0; t0 < nq; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous q tile
    load_tile(qs, q + static_cast<size_t>(b) * nq * d_model + col0, t0, d_model);
    load_tile(dos, dout + static_cast<size_t>(b) * nq * d_model + col0, t0, d_model);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse_b[t0 + threadIdx.x];
      delta_s[threadIdx.x] = delta_b[t0 + threadIdx.x];
    }
    __syncthreads();

    rows_by_rows_t(st, ks + warp * 16 * kDk, qs);    // s^T  [16 keys, 64 queries]
    rows_by_rows_t(dpt, vs + warp * 16 * kDk, dos);  // dp^T
    __syncwarp();
    for (int c = c0; c < c0 + kTile / 2; ++c) {
      const int e = r * kTile + c;
      const float p = expf(st[e] * sm_scale - lse_s[c]);
      pt[e] = __float2bfloat16_rn(p);
      dst[e] = __float2bfloat16_rn(p * (dpt[e] - delta_s[c]) * sm_scale);
    }
    __syncwarp();
    accumulate(dv_acc, pt, dos);  // dv += bf16(p)^T do
    accumulate(dk_acc, dst, qs);  // dk += ds^T q
  }
  const size_t out0 = (static_cast<size_t>(b) * nk + key0 + warp * 16) * d_model + col0;
  store_rows(dk + out0, dk_acc, st, d_model);
  store_rows(dv + out0, dv_acc, st, d_model);
}

__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int nq, int nk, int d_model,
                    float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kTile * kDk;
  __nv_bfloat16* ks = dos + kTile * kDk;
  __nv_bfloat16* vs = ks + kTile * kDk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wbase = smem + 4 * kTileBytes + warp * kWarpBytes;
  float* sp = reinterpret_cast<float*>(wbase);  // s, then staging
  float* dpf = sp + 16 * kTile;                 // dp
  __nv_bfloat16* dsb = reinterpret_cast<__nv_bfloat16*>(dpf + 16 * kTile);  // ds
  float* lse_s = reinterpret_cast<float*>(smem + 4 * kTileBytes + kWarps * kWarpBytes);
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.z, head = blockIdx.y, n_heads = gridDim.y;
  const size_t row0 = blockIdx.x * kTile;
  const size_t col0 = static_cast<size_t>(head) * kDk;
  load_tile(qs, q + static_cast<size_t>(b) * nq * d_model + col0, row0, d_model);
  load_tile(dos, dout + static_cast<size_t>(b) * nq * d_model + col0, row0, d_model);
  if (threadIdx.x < kTile) {
    const size_t s = (static_cast<size_t>(b) * n_heads + head) * nq + row0 + threadIdx.x;
    lse_s[threadIdx.x] = lse[s];
    delta_s[threadIdx.x] = delta[s];
  }

  FragC dq_acc[kDk / 16];
#pragma unroll
  for (int nb = 0; nb < kDk / 16; ++nb) wmma::fill_fragment(dq_acc[nb], 0.f);
  const int r = lane >> 1, c0 = (lane & 1) * (kTile / 2);
  for (int t0 = 0; t0 < nk; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous key tile
    load_tile(ks, k + static_cast<size_t>(b) * nk * d_model + col0, t0, d_model);
    load_tile(vs, v + static_cast<size_t>(b) * nk * d_model + col0, t0, d_model);
    __syncthreads();

    rows_by_rows_t(sp, qs + warp * 16 * kDk, ks);    // s  [16 queries, 64 keys]
    rows_by_rows_t(dpf, dos + warp * 16 * kDk, vs);  // dp
    __syncwarp();
    const float l = lse_s[warp * 16 + r], dl = delta_s[warp * 16 + r];
    for (int c = c0; c < c0 + kTile / 2; ++c) {
      const int e = r * kTile + c;
      const float p = expf(sp[e] * sm_scale - l);
      dsb[e] = __float2bfloat16_rn(p * (dpf[e] - dl) * sm_scale);
    }
    __syncwarp();
    accumulate(dq_acc, dsb, ks);  // dq += ds k
  }
  store_rows(dq + (static_cast<size_t>(b) * nq + row0 + warp * 16) * d_model + col0, dq_acc, sp,
             d_model);
}

}  // namespace

// q/k/v/o/do bf16 [B,N,H*128] (packed heads), lse f32 [B,H,Nq] from the
// forward -> dq/dk/dv bf16 [B,N,H*128], with delta f32 [B,H,Nq] as scratch.
// Requires Nq % 64 == 0, Nk % 64 == 0, 32-byte aligned pointers. Returns
// the launch status.
cudaError_t vcr_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, void* dq, void* dk,
                          void* dv, int batch, int nq, int nk, int n_heads, float sm_scale,
                          cudaStream_t stream) {
  using bf = const __nv_bfloat16*;
  const int d_model = n_heads * kDk;
  const size_t warps = static_cast<size_t>(batch) * nq * n_heads;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((warps * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<bf>(o), static_cast<bf>(dout), delta, batch, nq, n_heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<<<dim3(nk / kTile, n_heads, batch), kWarps * 32, kSmemBytes, stream>>>(
      static_cast<bf>(q), static_cast<bf>(k), static_cast<bf>(v), static_cast<bf>(dout), lse,
      delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), nq, nk, d_model,
      sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<<<dim3(nq / kTile, n_heads, batch), kWarps * 32, kSmemBytes, stream>>>(
      static_cast<bf>(q), static_cast<bf>(k), static_cast<bf>(v), static_cast<bf>(dout), lse,
      delta, static_cast<__nv_bfloat16*>(dq), nq, nk, d_model, sm_scale);
  return cudaGetLastError();
}

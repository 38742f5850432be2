// The transformer pointer's multi-head attention sublayer by hand: the q, k
// and v projections, per-head softmax(q k^T / sqrt(dk)) v, the out projection.
//
// Replaces vcrnet_tpu/ops/pallas_pointer.py:fused_mha (_mha_kernel).
//
//   K = bf16(ykv @ Wk + bk),  V = bf16(ykv @ Wv + bv)      (once per batch item)
//   Q = bf16(yq @ Wq + bq)
//   per head:  s = (Q_h K_h^T) * sm_scale,  m = rowmax(s),  e = exp(s - m),
//              l = rowsum(e),  O_h = bf16((bf16(e) @ V_h) / l)
//   out = bf16(O @ Wo + bo)
//
// with f32 accumulation, scores and softmax, and the biases in bf16: the
// Pallas kernel's rounding points. Bound on the H100: operations (8 D^2 flops
// of projections and 4 Nk D of attention per query row against 6 D bytes of
// activations). All products run on the tensor cores through warp-level mma
// (nvcuda::wmma; the projections are gemm_tile.cuh).
//
// On the TPU the K and V of one batch item persist in VMEM across the query
// tiles. Here they do not fit a block's shared memory (2 x 1 MB at Nk = 1024,
// D = 512), and blocks run in no order, so a first kernel projects K and V
// into a scratch in device memory (2 x [B, Nk, D] bf16, allocated by the
// binding; it stays in the 50 MB L2 at small batches) and a second kernel
// owns 64 query rows of one batch item: it projects its Q tile, attends over
// the scratch, and applies Wo, so that Q, the scores, the probabilities and
// the per-head outputs never reach device memory. Attention makes two passes
// over the keys, in 32-key tiles of two heads: the first finds each row's
// max, the second recomputes the scores and accumulates e @ V in registers
// against that final max. This costs a second score product but reproduces
// the Pallas kernel's rounding of e (against the row's final max, not a
// running one) and needs no rescaling.
#include "gemm_tile.cuh"

namespace {

using namespace nvcuda;
using namespace vcr::gemm;

constexpr int kDk = 128;     // head width
constexpr int kTileK = 32;   // keys per tile
constexpr int kPair = 2;     // heads in flight per block (warps 0-3 and 4-7)
constexpr int kKvLd = kPair * kDk + kPad;
constexpr int kSLd = kTileK + 8;  // f32 score tile and bf16 probability tile row stride
constexpr size_t kKvTileBytes = sizeof(__nv_bfloat16) * kTileK * kKvLd;
constexpr size_t kWarpSBytes = sizeof(float) * 16 * kSLd;
constexpr size_t kWarpPBytes = sizeof(__nv_bfloat16) * 16 * kSLd;
constexpr size_t kWarpStatBytes = sizeof(float) * 32;
constexpr size_t kWarpBytes = kWarpSBytes + kWarpPBytes + kWarpStatBytes;
constexpr size_t kAttnBytes = 2 * kKvTileBytes + kWarps * kWarpBytes;
constexpr size_t kPhaseBytes = kAttnBytes > kScratchBytes ? kAttnBytes : kScratchBytes;

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) / 128 * 128; }

__global__ void __launch_bounds__(kThreads)
kv_project_kernel(const __nv_bfloat16* __restrict__ ykv,  // [rows, D]
                  const __nv_bfloat16* __restrict__ wk, const __nv_bfloat16* __restrict__ bk,
                  const __nv_bfloat16* __restrict__ wv, const __nv_bfloat16* __restrict__ bv,
                  __nv_bfloat16* __restrict__ kout,       // [rows, D]
                  __nv_bfloat16* __restrict__ vout,       // [rows, D]
                  long long rows, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* scratch = smem + align128(tile_bytes(d));
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTM;
  const size_t n_rows = static_cast<size_t>(rows);
  load_rows(ykv, row0, n_rows, d, ys);
  block_gemm(ys, padded(d), wk, d, d, scratch, [&](int r, int c, float v) {
    if (row0 + r < n_rows)
      kout[(row0 + r) * d + c] = __float2bfloat16_rn(v + __bfloat162float(bk[c]));
  });
  block_gemm(ys, padded(d), wv, d, d, scratch, [&](int r, int c, float v) {
    if (row0 + r < n_rows)
      vout[(row0 + r) * d + c] = __float2bfloat16_rn(v + __bfloat162float(bv[c]));
  });
}

// The block copies keys [t0, t0 + 32) x columns [col0, col0 + width) of a
// batch item's [nk, d] matrix into a [32, kKvLd] shared-memory tile.
__device__ __forceinline__ void load_kv_tile(const __nv_bfloat16* __restrict__ src, int t0,
                                             int d, int col0, int width,
                                             __nv_bfloat16* tile) {
  const int per_row = width / 8;
  for (int t = threadIdx.x; t < kTileK * per_row; t += blockDim.x) {
    const int r = t / per_row, c8 = (t - r * per_row) * 8;
    *reinterpret_cast<uint4*>(tile + r * kKvLd + c8) = *reinterpret_cast<const uint4*>(
        src + static_cast<size_t>(t0 + r) * d + col0 + c8);
  }
}

// One warp: the [16, 32] score tile of its 16 query rows (fragments qa) and
// the tile's 32 keys of its head (columns hh * 128.. of kt), raw, into sp.
__device__ __forceinline__ void warp_score_tile(
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>* qa,
    const __nv_bfloat16* kt, int hh, float* sp) {
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
  for (int nb = 0; nb < kTileK / 16; ++nb) {
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk) {
      wmma::load_matrix_sync(kf, kt + nb * 16 * kKvLd + hh * kDk + kk * 16, kKvLd);
      wmma::mma_sync(acc, qa[kk], kf, acc);
    }
    wmma::store_matrix_sync(sp + nb * 16, acc, kSLd, wmma::mem_row_major);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
mha_attend_kernel(const __nv_bfloat16* __restrict__ yq,    // [B, Nq, D]
                  const __nv_bfloat16* __restrict__ kscr,  // [B, Nk, D]
                  const __nv_bfloat16* __restrict__ vscr,  // [B, Nk, D]
                  const __nv_bfloat16* __restrict__ wq, const __nv_bfloat16* __restrict__ bq,
                  const __nv_bfloat16* __restrict__ wo, const __nv_bfloat16* __restrict__ bo,
                  __nv_bfloat16* __restrict__ out,         // [B, Nq, D]
                  int nq, int nk, int d, int n_heads, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t tile = align128(tile_bytes(d));
  __nv_bfloat16* qo = reinterpret_cast<__nv_bfloat16*>(smem);         // yq, then O
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + tile);  // Q
  unsigned char* phase = smem + 2 * tile;  // the projections' scratch, or the attention's
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(phase);
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(phase + kKvTileBytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wbase = phase + 2 * kKvTileBytes + warp * kWarpBytes;
  float* sp = reinterpret_cast<float*>(wbase);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(wbase + kWarpSBytes);
  float* l_s = reinterpret_cast<float*>(wbase + kWarpSBytes + kWarpPBytes);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTM;
  const int ld = padded(d);
  const __nv_bfloat16* kb = kscr + static_cast<size_t>(b) * nk * d;
  const __nv_bfloat16* vb = vscr + static_cast<size_t>(b) * nk * d;

  load_rows(yq + static_cast<size_t>(b) * nq * d, q0, nq, d, qo);
  block_gemm(qo, ld, wq, d, d, phase, [&](int r, int c, float v) {
    qs[r * ld + c] = __float2bfloat16_rn(v + __bfloat162float(bq[c]));
  });

  const int rg = warp & 3;   // this warp's 16 query rows
  const int hh = warp >> 2;  // its head within the pair
  const int r = lane >> 1, c0 = (lane & 1) * (kTileK / 2);  // its softmax row and columns
  for (int h0 = 0; h0 < n_heads; h0 += kPair) {
    const int head = h0 + hh;
    const bool active = head < n_heads;
    const int width = (n_heads - h0 < kPair ? n_heads - h0 : kPair) * kDk;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[kDk / 16];
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kDk / 16; ++kk)
        wmma::load_matrix_sync(qa[kk], qs + rg * 16 * ld + head * kDk + kk * 16, ld);
    }

    // pass 1: the row max of the scaled scores
    float m = -CUDART_INF_F;
    for (int t0 = 0; t0 < nk; t0 += kTileK) {
      __syncthreads();  // every warp is done with the previous tile
      load_kv_tile(kb, t0, d, h0 * kDk, width, kt);
      __syncthreads();
      if (active) {
        warp_score_tile(qa, kt, hh, sp);
        float tmax = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < kTileK / 2; ++c) tmax = fmaxf(tmax, sp[r * kSLd + c0 + c] * sm_scale);
        tmax = fmaxf(tmax, __shfl_xor_sync(vcr::kFullMask, tmax, 1));
        m = fmaxf(m, tmax);
        __syncwarp();
      }
    }

    // pass 2: e = exp(s - m) against the final max, l = rowsum(e), O = bf16(e) @ V
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[kDk / 16];
#pragma unroll
    for (int nb = 0; nb < kDk / 16; ++nb) wmma::fill_fragment(oacc[nb], 0.f);
    float l = 0.f;
    for (int t0 = 0; t0 < nk; t0 += kTileK) {
      __syncthreads();
      load_kv_tile(kb, t0, d, h0 * kDk, width, kt);
      load_kv_tile(vb, t0, d, h0 * kDk, width, vt);
      __syncthreads();
      if (active) {
        warp_score_tile(qa, kt, hh, sp);
#pragma unroll
        for (int c = 0; c < kTileK / 2; ++c) {
          const float e = expf(sp[r * kSLd + c0 + c] * sm_scale - m);
          l += e;
          ps[r * kSLd + c0 + c] = __float2bfloat16_rn(e);
        }
        __syncwarp();
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk) {
          wmma::load_matrix_sync(pa, ps + kk * 16, kSLd);
#pragma unroll
          for (int nb = 0; nb < kDk / 16; ++nb) {
            wmma::load_matrix_sync(vf, vt + kk * 16 * kKvLd + hh * kDk + nb * 16, kKvLd);
            wmma::mma_sync(oacc[nb], pa, vf, oacc[nb]);
          }
        }
        __syncwarp();
      }
    }

    if (active) {
      l += __shfl_xor_sync(vcr::kFullMask, l, 1);
      if ((lane & 1) == 0) l_s[r] = l;
      __syncwarp();
#pragma unroll
      for (int nb = 0; nb < kDk / 16; ++nb) {
        wmma::store_matrix_sync(sp, oacc[nb], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 16 * 16; e += 32) {
          const int row = e >> 4;
          qo[(rg * 16 + row) * ld + head * kDk + nb * 16 + (e & 15)] =
              __float2bfloat16_rn(sp[e] / l_s[row]);
        }
        __syncwarp();
      }
    }
  }

  const size_t out_row0 = static_cast<size_t>(b) * nq + q0;
  block_gemm(qo, ld, wo, d, d, phase, [&](int row, int c, float v) {
    out[(out_row0 + row) * d + c] = __float2bfloat16_rn(v + __bfloat162float(bo[c]));
  });
}

}  // namespace

// Shared memory of the attention kernel at model width d.
size_t vcr_pointer_mha_smem(int d) { return 2 * align128(tile_bytes(d)) + kPhaseBytes; }

// yq bf16 [B,Nq,D], ykv bf16 [B,Nk,D], wq/wk/wv/wo bf16 [D,D] (in, out),
// bq/bk/bv/bo bf16 [D], kscr/vscr bf16 [B,Nk,D] scratch -> out bf16 [B,Nq,D].
// Requires D = n_heads * 128 <= 512, Nq % 64 == 0, Nk % 32 == 0, 32-byte
// aligned pointers. Returns the launch status.
cudaError_t vcr_pointer_mha(const void* yq, const void* ykv, const void* wq, const void* bq,
                            const void* wk, const void* bk, const void* wv, const void* bv,
                            const void* wo, const void* bo, void* kscr, void* vscr, void* out,
                            int batch, int nq, int nk, int d, int n_heads,
                            cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t proj_smem = align128(tile_bytes(d)) + kScratchBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kv_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(proj_smem));
  if (err != cudaSuccess) return err;
  const long long kv_rows = static_cast<long long>(batch) * nk;
  kv_project_kernel<<<static_cast<unsigned>((kv_rows + kTM - 1) / kTM), kThreads, proj_smem,
                      stream>>>(
      static_cast<const bf*>(ykv), static_cast<const bf*>(wk), static_cast<const bf*>(bk),
      static_cast<const bf*>(wv), static_cast<const bf*>(bv), static_cast<bf*>(kscr),
      static_cast<bf*>(vscr), kv_rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = vcr_pointer_mha_smem(d);
  err = cudaFuncSetAttribute(mha_attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mha_attend_kernel<<<dim3(nq / kTM, batch), kThreads, smem, stream>>>(
      static_cast<const bf*>(yq), static_cast<const bf*>(kscr), static_cast<const bf*>(vscr),
      static_cast<const bf*>(wq), static_cast<const bf*>(bq), static_cast<const bf*>(wo),
      static_cast<const bf*>(bo), static_cast<bf*>(out), nq, nk, d, n_heads,
      1.0f / sqrtf(static_cast<float>(kDk)));
  return cudaGetLastError();
}

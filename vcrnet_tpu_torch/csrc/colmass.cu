// Column masses of a row softmax over packed heads, without the score tensor:
//
//   out[b, h, j] = sum_i softmax_j'(q_i . k_j' * sm_scale)[j]
//
// for q [B, Nq, H*128], k [B, Nk, H*128], head h = columns [h*128, (h+1)*128).
//
// Replaces vcrnet_tpu/ops/pallas_colmass.py:softmax_colmass (two
// pallas_calls: _stats_kernel, _colmass_kernel). The partial-overlap
// re-mask of the decoder's cross attention keeps the keys with the largest
// masses; at thousands of keys the [B, H, Nq, Nk] probabilities are too
// large to write out just to be summed.
//
// Two kernels, as on the TPU, but with other owners. The TPU kernels
// carried (m, l) and the column sums in scratch across a sequential grid
// axis; here
//   1. row_lse_kernel: a block owns 64 query rows of one head (16 per
//      warp), streams 64-key tiles through shared memory and keeps each
//      row's running max and sum in registers; it writes one logsumexp per
//      row (m + log l serves as well as the pair);
//   2. colmass_kernel: a block owns 64 keys of one head, keeps them in
//      shared memory, loops over all query tiles in ascending order and
//      adds exp(s - lse_i) into per-lane column sums in registers; the four
//      warps' sums are added in warp order at the end. No atomics: the
//      result is the same from run to run.
// Both score products run on the tensor cores through warp-level mma
// (nvcuda::wmma, bf16 in, f32 accumulate).
//
// Bound on the H100: operations (two score passes, 4 * Nq * Nk * 128 flops
// per head, against q and k read once and [B, H, Nk] written).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kDk = 128;
constexpr int kWarps = 4;
constexpr int kTileQ = 16 * kWarps;
constexpr int kTileK = 64;

constexpr size_t kKBytes = sizeof(__nv_bfloat16) * kTileK * kDk;  // one key tile
constexpr size_t kSBytes = sizeof(float) * 16 * kTileK;           // a warp's score tile
constexpr size_t kLseBytes = sizeof(float) * 16;                  // a warp's row statistics
constexpr size_t kRedBytes = sizeof(float) * kWarps * kTileK;     // the warps' column sums
constexpr size_t kSmemBytes = kKBytes + kWarps * (kSBytes + kLseBytes) + kRedBytes;

using QFrags = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

// The block copies 64 key rows of one head into shared memory.
__device__ __forceinline__ void stage_keys(const __nv_bfloat16* __restrict__ kb, int d_model,
                                           __nv_bfloat16* ks) {
  for (int t = threadIdx.x; t < kTileK * kDk / 8; t += blockDim.x) {
    const int row = t / (kDk / 8), c8 = (t % (kDk / 8)) * 8;
    reinterpret_cast<uint4*>(ks)[t] =
        *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(row) * d_model + c8);
  }
}

// One warp: sp[16, 64] = q rows (fragments qa) times the staged keys^T.
__device__ __forceinline__ void warp_scores(const QFrags* qa, const __nv_bfloat16* ks,
                                            float* sp) {
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int nb = 0; nb < kTileK / 16; ++nb) {
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk) {
      wmma::load_matrix_sync(kf, ks + nb * 16 * kDk + kk * 16, kDk);
      wmma::mma_sync(acc, qa[kk], kf, acc);
    }
    wmma::store_matrix_sync(sp + nb * 16, acc, kTileK, wmma::mem_row_major);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32)
row_lse_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               float* __restrict__ lse,  // [B, H, Nq]
               int nq, int nk, int d_model, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sp = reinterpret_cast<float*>(smem + kKBytes + warp * kSBytes);

  const int b = blockIdx.z, head = blockIdx.y;
  const int row0 = blockIdx.x * kTileQ + warp * 16;
  const size_t col0 = static_cast<size_t>(head) * kDk;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * nq + row0) * d_model + col0;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * nk * d_model + col0;

  QFrags qa[kDk / 16];
#pragma unroll
  for (int kk = 0; kk < kDk / 16; ++kk) wmma::load_matrix_sync(qa[kk], qb + kk * 16, d_model);

  // two lanes per row, 32 columns each; a lane starts at its own column so
  // the 32 lanes read 32 different banks
  const int r = lane >> 1, c0 = (lane & 1) * (kTileK / 2);
  float m = -CUDART_INF_F, l = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kTileK) {
    __syncthreads();  // every warp is done with the previous key tile
    stage_keys(kb + static_cast<size_t>(t0) * d_model, d_model, ks);
    __syncthreads();
    warp_scores(qa, ks, sp);

    const float* srow = sp + r * kTileK + c0;
    float tmax = -CUDART_INF_F;
    for (int j = 0; j < kTileK / 2; ++j) tmax = fmaxf(tmax, srow[(j + lane) & 31] * sm_scale);
    tmax = fmaxf(tmax, __shfl_xor_sync(vcr::kFullMask, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float lsum = 0.f;
    for (int j = 0; j < kTileK / 2; ++j) lsum += expf(srow[(j + lane) & 31] * sm_scale - m_new);
    lsum += __shfl_xor_sync(vcr::kFullMask, lsum, 1);
    l = l * expf(m - m_new) + lsum;
    m = m_new;
    __syncwarp();  // the score tile is rewritten next round
  }
  if ((lane & 1) == 0)
    lse[(static_cast<size_t>(b) * gridDim.y + head) * nq + row0 + r] = m + logf(l);
}

__global__ void __launch_bounds__(kWarps * 32)
colmass_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const float* __restrict__ lse,  // [B, H, Nq]
               float* __restrict__ out,        // [B, H, Nk]
               int nq, int nk, int d_model, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sp = reinterpret_cast<float*>(smem + kKBytes + warp * kSBytes);
  float* lse_s = reinterpret_cast<float*>(smem + kKBytes + kWarps * kSBytes + warp * kLseBytes);
  float* red = reinterpret_cast<float*>(smem + kKBytes + kWarps * (kSBytes + kLseBytes));

  const int b = blockIdx.z, head = blockIdx.y;
  const int key0 = blockIdx.x * kTileK;
  const size_t col0 = static_cast<size_t>(head) * kDk;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * nq * d_model + col0;
  const float* lb = lse + (static_cast<size_t>(b) * gridDim.y + head) * nq;

  stage_keys(k + (static_cast<size_t>(b) * nk + key0) * d_model + col0, d_model, ks);
  __syncthreads();

  float acc0 = 0.f, acc1 = 0.f;  // columns lane and lane + 32 of the key tile
  QFrags qa[kDk / 16];
  for (int row0 = warp * 16; row0 < nq; row0 += kTileQ) {
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], qb + static_cast<size_t>(row0) * d_model + kk * 16,
                             d_model);
    if (lane < 16) lse_s[lane] = lb[row0 + lane];
    warp_scores(qa, ks, sp);  // ends in a __syncwarp: lse_s is visible too
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      acc0 += expf(sp[r * kTileK + lane] * sm_scale - lse_s[r]);
      acc1 += expf(sp[r * kTileK + lane + 32] * sm_scale - lse_s[r]);
    }
    __syncwarp();  // the score tile and lse_s are rewritten next round
  }
  red[warp * kTileK + lane] = acc0;
  red[warp * kTileK + lane + 32] = acc1;
  __syncthreads();
  if (threadIdx.x < kTileK) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w * kTileK + threadIdx.x];
    out[(static_cast<size_t>(b) * gridDim.y + head) * nk + key0 + threadIdx.x] = sum;
  }
}

}  // namespace

// q bf16 [B,Nq,H*128], k bf16 [B,Nk,H*128] -> out f32 [B,H,Nk]; lse f32
// [B,H,Nq] is scratch that the first kernel writes and the second reads.
// Requires Nq % 64 == 0, Nk % 64 == 0, 32-byte aligned pointers. Returns the
// launch status.
cudaError_t vcr_softmax_colmass(const void* q, const void* k, float* lse, float* out,
                                int batch, int nq, int nk, int n_heads, float sm_scale,
                                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      row_lse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(colmass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const int d_model = n_heads * kDk;
  row_lse_kernel<<<dim3(nq / kTileQ, n_heads, batch), kWarps * 32, kSmemBytes, stream>>>(
      qp, kp, lse, nq, nk, d_model, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colmass_kernel<<<dim3(nk / kTileK, n_heads, batch), kWarps * 32, kSmemBytes, stream>>>(
      qp, kp, lse, out, nq, nk, d_model, sm_scale);
  return cudaGetLastError();
}

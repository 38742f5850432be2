// Attention over packed heads: q/k/v [B, N, H*128], head h = columns
// [h*128, (h+1)*128), output in the same packed layout.
//
// Replaces vcrnet_tpu/ops/pallas_attention.py:flash_mha_packed
// (_flash_packed_impl -> _fwd_packed_kernel).
//
//   s = (q . k^T) * sm_scale              (f32 accumulation)
//   o = (bf16(exp(s - m)) @ v) / l,  l = sum exp(s - m)   (f32)
//
// Bound on the H100: operations (4 * N^2 * 128 flops per head against
// 4 * N * 128 * 2 bytes in and out). Both products run on the tensor
// cores through warp-level mma (nvcuda::wmma, bf16 in, f32 accumulate).
// A block owns 64 query rows of one head (16 per warp) and streams 64-key
// tiles of k and v through shared memory with an online softmax (running
// max m and sum l per row), so no [N, N] score tensor reaches device
// memory. The TPU kernel saw the whole key range at once; here the
// probabilities are rounded to bf16 against the running max, and the
// accumulator is rescaled when the max moves.
//
// ``nk_valid`` <= Nk is the count of real keys: keys at or beyond it are
// padding (the wrapper pads K and V with zero rows up to a multiple of 64)
// and are masked out of the row max and sum (the counterpart of nk_valid in
// pallas_attention.py:_fwd_packed_kernel); whole tiles of padding are not
// visited.
//
// Training: with a non-null ``lse`` the kernel also writes each row's
// logsumexp m + log(l) of the scaled scores ([B, H, Nq] f32), from which
// flash_bwd.cu recomputes the probabilities.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kDk = 128;
constexpr int kWarps = 4;
constexpr int kTileQ = 16 * kWarps;
constexpr int kTileK = 64;

constexpr size_t kKvBytes = sizeof(__nv_bfloat16) * kTileK * kDk;
constexpr size_t kSpBytes = sizeof(float) * 16 * kDk;          // S, then P.V
constexpr size_t kPBytes = sizeof(__nv_bfloat16) * 16 * kTileK;
constexpr size_t kOBytes = sizeof(float) * 16 * kDk;
constexpr size_t kStatBytes = sizeof(float) * 16 * 4;           // m, l, alpha
constexpr size_t kWarpBytes = kSpBytes + kPBytes + kOBytes + kStatBytes;
constexpr size_t kSmemBytes = 2 * kKvBytes + kWarps * kWarpBytes;

__global__ void __launch_bounds__(kWarps * 32)
flash_packed_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse,  // [B, H, Nq] or null
                    int nq, int nk, int nk_valid, int d_model, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + kKvBytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wbase = smem + 2 * kKvBytes + warp * kWarpBytes;
  float* sp = reinterpret_cast<float*>(wbase);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(wbase + kSpBytes);
  float* os = reinterpret_cast<float*>(wbase + kSpBytes + kPBytes);
  float* m_s = reinterpret_cast<float*>(wbase + kSpBytes + kPBytes + kOBytes);
  float* l_s = m_s + 16;
  float* alpha_s = l_s + 16;

  const int b = blockIdx.z, head = blockIdx.y;
  const int row0 = blockIdx.x * kTileQ + warp * 16;
  const size_t col0 = static_cast<size_t>(head) * kDk;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * nq + row0) * d_model + col0;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * nk * d_model + col0;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * nk * d_model + col0;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[kDk / 16];
#pragma unroll
  for (int kk = 0; kk < kDk / 16; ++kk) wmma::load_matrix_sync(qa[kk], qb + kk * 16, d_model);
  for (int e = lane; e < 16 * kDk; e += 32) os[e] = 0.f;
  if (lane < 16) {
    m_s[lane] = -CUDART_INF_F;
    l_s[lane] = 0.f;
  }
  __syncwarp();

  const int r = lane >> 1, c0 = (lane & 1) * (kTileK / 2);
  for (int t0 = 0; t0 < nk_valid; t0 += kTileK) {
    __syncthreads();  // every warp is done with the previous k/v tile
    for (int t = threadIdx.x; t < kTileK * kDk / 8; t += blockDim.x) {
      const int row = t / (kDk / 8), c8 = (t % (kDk / 8)) * 8;
      const size_t g = static_cast<size_t>(t0 + row) * d_model + c8;
      reinterpret_cast<uint4*>(ks)[t] = *reinterpret_cast<const uint4*>(kb + g);
      reinterpret_cast<uint4*>(vs)[t] = *reinterpret_cast<const uint4*>(vb + g);
    }
    __syncthreads();

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

    // online softmax: two lanes per row, 32 columns each, of which the
    // first ``valid`` are real keys (all of them but in the last tile)
    const int valid = min(kTileK / 2, max(0, nk_valid - t0 - c0));
    const float* srow = sp + r * kTileK + c0;
    __nv_bfloat16* prow = ps + r * kTileK + c0;
    float tmax = -CUDART_INF_F;
    for (int c = 0; c < valid; ++c) tmax = fmaxf(tmax, srow[c] * sm_scale);
    tmax = fmaxf(tmax, __shfl_xor_sync(vcr::kFullMask, tmax, 1));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, tmax);
    float lsum = 0.f;
    for (int c = 0; c < valid; ++c) {
      const float p = expf(srow[c] * sm_scale - m_new);
      lsum += p;
      prow[c] = __float2bfloat16_rn(p);
    }
    for (int c = valid; c < kTileK / 2; ++c) prow[c] = __float2bfloat16_rn(0.f);
    lsum += __shfl_xor_sync(vcr::kFullMask, lsum, 1);
    __syncwarp();
    if ((lane & 1) == 0) {
      const float alpha = expf(m_old - m_new);
      alpha_s[r] = alpha;
      l_s[r] = l_s[r] * alpha + lsum;
      m_s[r] = m_new;
    }
    __syncwarp();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
    for (int nb = 0; nb < kDk / 16; ++nb) {
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        wmma::load_matrix_sync(pa, ps + kk * 16, kTileK);
        wmma::load_matrix_sync(vf, vs + kk * 16 * kDk + nb * 16, kDk);
        wmma::mma_sync(acc, pa, vf, acc);
      }
      wmma::store_matrix_sync(sp + nb * 16, acc, kDk, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * kDk; e += 32) os[e] = os[e] * alpha_s[e / kDk] + sp[e];
    __syncwarp();
  }

  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * nq + row0) * d_model + col0;
  for (int e = lane; e < 16 * kDk; e += 32) {
    const int row = e / kDk, c = e % kDk;
    ob[static_cast<size_t>(row) * d_model + c] = __float2bfloat16_rn(os[e] / l_s[row]);
  }
  if (lse != nullptr && lane < 16)
    lse[(static_cast<size_t>(b) * gridDim.y + head) * nq + row0 + lane] =
        m_s[lane] + logf(l_s[lane]);
}

}  // namespace

// q bf16 [B,Nq,H*128], k/v bf16 [B,Nk,H*128] -> out bf16 [B,Nq,H*128], and
// with a non-null lse the row logsumexp f32 [B,H,Nq], over the first
// nk_valid keys (1 <= nk_valid <= Nk; finite K and V rows beyond it).
// Requires Nq % 64 == 0, Nk % 64 == 0, 32-byte aligned pointers.
cudaError_t vcr_flash_packed(const void* q, const void* k, const void* v, void* out,
                             float* lse, int batch, int nq, int nk, int nk_valid,
                             int n_heads, float sm_scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(nq / kTileQ, n_heads, batch);
  flash_packed_kernel<<<grid, kWarps * 32, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, nq,
      nk, nk_valid, n_heads * kDk, sm_scale);
  return cudaGetLastError();
}

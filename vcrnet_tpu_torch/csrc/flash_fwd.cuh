// The forward pass over packed heads, shared by the attention kernel
// (flash_packed.cu), the attention of the pointer's sublayer
// (pointer_mha.cu) and the row logsumexps of the column masses (colmass.cu):
//
//   s = (q . k^T) * sm_scale              (f32 accumulation)
//   o = (bf16(exp(s - m)) @ v) / l,  l = sum exp(s - m)   (f32)
//
// for q [B, Nq, H*128], k/v [B, Nk, H*128], head h = columns
// [h*128, (h+1)*128), output in the same packed layout. ``fwd_kernel``
// computes o (and, with a non-null ``lse``, each row's logsumexp);
// ``lse_kernel`` runs the same loop without the P . V product and writes
// only the logsumexp. The two share the layout of their shared memory
// (``carve``) and the online softmax of a 64-key tile (``softmax_tile``:
// the mask of keys past nk_valid, the running max, the rescale factor, the
// exps and their sums); each has its own producer loop and its own loop
// around softmax_tile. The attention's time moves with small changes of
// its code that leave the instructions nearly the same (ptxas orders them
// otherwise): the loop written once for both kernels (a template over "with
// or without P . V") measured slower than the attention kernel it replaced,
// and so did a producer shared as a function; this form measured as fast.
// Time fwd_kernel against the parent's (train/attention_parts.py --csrc)
// after any change here.
//
// Bound on the H100: operations (4 * N^2 * 128 flops per head with P . V,
// half of that and one exp a score without, against 4 * N * 128 * 2 bytes
// in and out), so the design keeps the tensor cores fed and everything else
// off their path:
//   * a block owns 128 query rows of one head: two consumer warpgroups of
//     64 rows each and one producer warp (warp specialisation);
//   * the producer loads the block's Q once and streams 64-key tiles of K
//     (and V) through a ring in shared memory with TMA (128-byte swizzle),
//     one full/empty mbarrier pair per stage; both consumers read each tile,
//     so K and V cross from L2 once per 128 query rows;
//   * S = Q . K^T is wgmma m64n64k16 with both operands in shared memory
//     and the accumulator in registers;
//   * the online softmax runs in registers (a row's 64 scores sit in the
//     four lanes of a quad: max and sum reduce over __shfl_xor 1 and 2),
//     in base 2 with the scale folded into log2(e); the running max m and
//     sum l stay in registers, and the O accumulator is rescaled there;
//   * P is rounded to bf16 in registers and is wgmma's A operand against V
//     in shared memory (m64n128k16; V is [keys, d], so B is read MN-major,
//     trans-b = 1); O is a [64, 128] f32 accumulator in registers.
// Nothing of S, P or O is stored to shared memory. fwd_kernel: 288
// threads, ~97 KB of shared memory and ~160 registers a thread (O 64, S 32,
// P 16), one block per SM. A consumer warpgroup waits for each product
// before its softmax, so its own products and exps do not overlap; the two
// warpgroups (and, for lse_kernel, the two blocks an SM holds) are
// scheduled around each other's waits. lse_kernel's stage holds only the K
// tile and is released as soon as the scores are in registers.
//
// Numerics: the TPU kernel saw the whole key range at once; here the
// probabilities are rounded to bf16 against the running max of 64-key
// tiles, and O is rescaled when the max moves (ROADMAP C, "Online softmax").
//
// ``nk`` is the row stride of a batch item in K and V, ``nk_valid`` <= nk
// the count of real keys: keys at or beyond it (padding rows, or the next
// item's rows where nk % 64 != 0, or zeros past the end of the tensor) are
// set to -inf before the row max in the last visited tile (the counterpart
// of nk_valid in pallas_attention.py:_fwd_packed_kernel); tiles wholly past
// it are neither loaded nor visited. Their V rows must be finite.
//
// Any Nq: the last query block of an item owns rows past Nq (all of its
// second warpgroup's where Nq % 128 <= 64). They run the same loop on
// whatever the TMA box holds (the next batch item's rows, or zeros past the
// end of the tensor), arrive on every barrier like the others, and store
// nothing: a warpgroup that left early would leave the producer waiting on
// its empty barriers. Query rows are independent, so the real rows' results
// do not depend on them. Likewise any Nk: a key count that is no multiple
// of 64 (nk_valid == nk) masks the rows of the next item in the last tile.
//
// The logsumexp ([B, H, Nq] f32) is m + log(l) of the scaled scores in
// natural units from fwd_kernel, from which flash_bwd.cu recomputes the
// probabilities, and in base 2 from lse_kernel (log2 of the row sum of
// exp2(s * sm_scale * log2(e))), as colmass.cu's second kernel reads it.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vcr {
namespace flash {
namespace {

using namespace vcr::hopper;
using bf16 = __nv_bfloat16;

constexpr int kDk = 128;
constexpr int kConsumers = 2;                 // warpgroups, 64 query rows each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kTileQ = 64 * kConsumers;
constexpr int kTileK = 64;
constexpr uint32_t kQBytes = kConsumers * kHeadTileBytes;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kStages = 2;                               // fwd_kernel: K and V tiles
constexpr uint32_t kStageBytes = 2 * kHeadTileBytes;
constexpr size_t kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
constexpr int kLseStages = 4;                            // lse_kernel: K tiles
constexpr uint32_t kLseStageBytes = kHeadTileBytes;
constexpr size_t kLseSmemBytes =
    1024 + kQBytes + kLseStages * kLseStageBytes + (2 * kLseStages + 1) * 8;

// The online softmax of tile t (of n_tiles) of a lane's two rows g, g + 8:
// keys at or beyond nk_valid set to -inf in the last tile, the running maxima
// m (of s * scale_log2) moved, and the scores replaced by p = exp2(s *
// scale_log2 - m). Returns the rescale factors exp2(m_old - m_new) of the
// two rows in alpha and this lane's sums of p in sum.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], int t, int n_tiles, int nk_valid,
                                             int qd, float scale_log2, float& m_g, float& m_g8,
                                             float& alpha_g, float& alpha_g8, float& sum_g,
                                             float& sum_g8) {
  if (t == n_tiles - 1 && nk_valid % kTileK) {  // keys at or beyond nk_valid
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (t * kTileK + 8 * j + 2 * qd + c >= nk_valid) {
          sc[4 * j + c] = -CUDART_INF_F;
          sc[4 * j + 2 + c] = -CUDART_INF_F;
        }
  }
  float mx_g = -CUDART_INF_F, mx_g8 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx_g = fmaxf(mx_g, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_g8 = fmaxf(mx_g8, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  // every row has a real key in every visited tile, so the max is finite
  const float mn_g = fmaxf(m_g, quad_max(mx_g) * scale_log2);
  const float mn_g8 = fmaxf(m_g8, quad_max(mx_g8) * scale_log2);
  alpha_g = exp2f(m_g - mn_g);
  alpha_g8 = exp2f(m_g8 - mn_g8);
  m_g = mn_g;
  m_g8 = mn_g8;
  sum_g = 0.f;
  sum_g8 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, -mn_g));
    sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, -mn_g));
    sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, -mn_g8));
    sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, -mn_g8));
    sum_g += sc[4 * j] + sc[4 * j + 1];
    sum_g8 += sc[4 * j + 2] + sc[4 * j + 3];
  }
}

// Shared memory of either kernel: Q (two boxes a consumer), the ring, the
// barriers (q_full, full[ring], empty[ring]), initialised by thread 0.
struct Smem {
  bf16* q_s;
  uint8_t* ring;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;
};

template <int kRing, uint32_t kBytes>
__device__ __forceinline__ Smem carve(uint8_t* smem_raw) {
  uint8_t* smem = align_1024(smem_raw);
  Smem m;
  m.q_s = reinterpret_cast<bf16*>(smem);
  m.ring = smem + kQBytes;
  m.q_full = reinterpret_cast<uint64_t*>(m.ring + kRing * kBytes);
  m.full = m.q_full + 1;
  m.empty = m.q_full + 1 + kRing;
  if (threadIdx.x == 0) {
    mbar_init(m.q_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&m.full[s], 1);
      mbar_init(&m.empty[s], kConsumerWarps);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
           float* __restrict__ lse,  // [B, H, Nq] or null
           int nq, int nk, int nk_valid, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<kStages, kStageBytes>(smem_raw);
  const int b = blockIdx.z, head = blockIdx.y, n_heads = gridDim.y;
  const int q0 = blockIdx.x * kTileQ;
  const int col = head * kDk;
  const int n_tiles = (nk_valid + kTileK - 1) / kTileK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kConsumerWarps) {  // ---- producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(sm.q_full, kQBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int h = 0; h < 2; ++h)
          tma_load_box(sm.q_s + (2 * c + h) * kBox * kBox, &q_map, sm.q_full, col + h * kBox,
                       b * nq + q0 + c * 64);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        bf16* k_s = reinterpret_cast<bf16*>(sm.ring + s * kStageBytes);
        bf16* v_s = k_s + 2 * kBox * kBox;
        const int row = b * nk + t * kTileK;
        mbar_expect_tx(&sm.full[s], kStageBytes);
        for (int h = 0; h < 2; ++h) {
          tma_load_box(k_s + h * kBox * kBox, &k_map, &sm.full[s], col + h * kBox, row);
          tma_load_box(v_s + h * kBox * kBox, &v_map, &sm.full[s], col + h * kBox, row);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* q_tile = sm.q_s + wg * 2 * kBox * kBox;
  const float scale_log2 = sm_scale * kLog2e;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_g = -CUDART_INF_F, m_g8 = -CUDART_INF_F;  // running max of s * scale * log2(e)
  float l_g = 0.f, l_g8 = 0.f;                     // this lane's part of the row sums

  mbar_wait(sm.q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const bf16* k_s = reinterpret_cast<const bf16*>(sm.ring + s * kStageBytes);
    const bf16* v_s = k_s + 2 * kBox * kBox;

    float sc[32];  // S of the tile; the first k step overwrites it
    wgmma_fence();
    scores_64x64(sc, q_tile, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    float alpha_g, alpha_g8, sum_g, sum_g8;
    softmax_tile(sc, t, n_tiles, nk_valid, qd, scale_log2, m_g, m_g8, alpha_g, alpha_g8, sum_g,
                 sum_g8);
    uint32_t pa[16];  // bf16(P), the A fragments of P . V
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
    l_g = l_g * alpha_g + sum_g;
    l_g8 = l_g8 * alpha_g8 + sum_g8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j] *= alpha_g;
      o[4 * j + 1] *= alpha_g;
      o[4 * j + 2] *= alpha_g8;
      o[4 * j + 3] *= alpha_g8;
    }

    fence_regs(o);
    wgmma_fence();  // the A fragments and the rescaled O are read by wgmma
    accumulate_64x128(o, pa, v_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);  // this warp is done with the stage
  }

  l_g = quad_sum(l_g);
  l_g8 = quad_sum(l_g8);
  const int r_g = q0 + wg * 64 + (warp & 3) * 16 + g, r_g8 = r_g + 8;
  const int d_model = n_heads * kDk;
  bf16* out_b = out + static_cast<size_t>(b) * nq * d_model + col;
  store_rows_bf16(r_g < nq ? out_b + static_cast<size_t>(r_g) * d_model : nullptr,
                  r_g8 < nq ? out_b + static_cast<size_t>(r_g8) * d_model : nullptr, o,
                  1.f / l_g, 1.f / l_g8, qd);
  if (lse != nullptr && qd == 0) {
    float* lse_bh = lse + (static_cast<size_t>(b) * n_heads + head) * nq;
    if (r_g < nq) lse_bh[r_g] = m_g * kLn2 + logf(l_g);
    if (r_g8 < nq) lse_bh[r_g8] = m_g8 * kLn2 + logf(l_g8);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
lse_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           float* __restrict__ lse2,  // [B, H, lse_stride >= Nq], base 2
           int nq, int nk, int nk_valid, int lse_stride, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<kLseStages, kLseStageBytes>(smem_raw);
  const int b = blockIdx.z, head = blockIdx.y, n_heads = gridDim.y;
  const int q0 = blockIdx.x * kTileQ;
  const int col = head * kDk;
  const int n_tiles = (nk_valid + kTileK - 1) / kTileK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      mbar_expect_tx(sm.q_full, kQBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int h = 0; h < 2; ++h)
          tma_load_box(sm.q_s + (2 * c + h) * kBox * kBox, &q_map, sm.q_full, col + h * kBox,
                       b * nq + q0 + c * 64);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kLseStages;
        if (t >= kLseStages) mbar_wait(&sm.empty[s], ((t / kLseStages) & 1) ^ 1);
        bf16* k_s = reinterpret_cast<bf16*>(sm.ring + s * kLseStageBytes);
        mbar_expect_tx(&sm.full[s], kLseStageBytes);
        for (int h = 0; h < 2; ++h)
          tma_load_box(k_s + h * kBox * kBox, &k_map, &sm.full[s], col + h * kBox,
                       b * nk + t * kTileK);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* q_tile = sm.q_s + wg * 2 * kBox * kBox;
  const float scale_log2 = sm_scale * kLog2e;
  float m_g = -CUDART_INF_F, m_g8 = -CUDART_INF_F;
  float l_g = 0.f, l_g8 = 0.f;

  mbar_wait(sm.q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kLseStages;
    mbar_wait(&sm.full[s], (t / kLseStages) & 1);
    float sc[32];
    wgmma_fence();
    scores_64x64(sc, q_tile, reinterpret_cast<const bf16*>(sm.ring + s * kLseStageBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);  // the K tile is no longer read

    float alpha_g, alpha_g8, sum_g, sum_g8;
    softmax_tile(sc, t, n_tiles, nk_valid, qd, scale_log2, m_g, m_g8, alpha_g, alpha_g8, sum_g,
                 sum_g8);
    l_g = l_g * alpha_g + sum_g;
    l_g8 = l_g8 * alpha_g8 + sum_g8;
  }

  l_g = quad_sum(l_g);
  l_g8 = quad_sum(l_g8);
  const int r_g = q0 + wg * 64 + (warp & 3) * 16 + g, r_g8 = r_g + 8;
  if (qd == 0) {
    float* lse_bh = lse2 + (static_cast<size_t>(b) * n_heads + head) * lse_stride;
    if (r_g < nq) lse_bh[r_g] = m_g + log2f(l_g);
    if (r_g8 < nq) lse_bh[r_g8] = m_g8 + log2f(l_g8);
  }
}

// fwd_kernel over the maps of q [batch*nq, H*128] and k, v [batch*nk,
// H*128]. Any nq and nk.
inline cudaError_t launch_fwd(const CUtensorMap& q_map, const CUtensorMap& k_map,
                              const CUtensorMap& v_map, bf16* out, float* lse, int batch, int nq,
                              int nk, int nk_valid, int n_heads, float sm_scale,
                              cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kTileQ - 1) / kTileQ, n_heads, batch);
  fwd_kernel<<<grid, kThreads, kSmemBytes, stream>>>(q_map, k_map, v_map, out, lse, nq, nk,
                                                     nk_valid, sm_scale);
  return cudaGetLastError();
}

// lse_kernel likewise (base-2 logsumexps into lse2 [batch, H, lse_stride],
// the first nq of each row written).
inline cudaError_t launch_lse(const CUtensorMap& q_map, const CUtensorMap& k_map, float* lse2,
                              int batch, int nq, int nk, int nk_valid, int lse_stride,
                              int n_heads, float sm_scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      lse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kLseSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kTileQ - 1) / kTileQ, n_heads, batch);
  lse_kernel<<<grid, kThreads, kLseSmemBytes, stream>>>(q_map, k_map, lse2, nq, nk, nk_valid,
                                                        lse_stride, sm_scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash
}  // namespace vcr

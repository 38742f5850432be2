// Attention over packed heads: q/k/v [B, N, H*128], head h = columns
// [h*128, (h+1)*128), output in the same packed layout.
//
// Replaces vcrnet_tpu/ops/pallas_attention.py:flash_mha_packed
// (_flash_packed_impl -> _fwd_packed_kernel, :239) and, with the row
// logsumexp written out, the training forward _fwd_library (:66).
//
//   s = (q . k^T) * sm_scale              (f32 accumulation)
//   o = (bf16(exp(s - m)) @ v) / l,  l = sum exp(s - m)   (f32)
//
// Bound on the H100: operations (4 * N^2 * 128 flops per head against
// 4 * N * 128 * 2 bytes in and out), so the design keeps the tensor cores
// fed and everything else off their path:
//   * a block owns 128 query rows of one head: two consumer warpgroups of
//     64 rows each and one producer warp (warp specialisation);
//   * the producer loads the block's Q once and streams 64-key tiles of K
//     and V through a two-stage ring in shared memory with TMA (128-byte
//     swizzle), one full/empty mbarrier pair per stage; both consumers
//     read each tile, so K and V cross from L2 once per 128 query rows;
//   * S = Q . K^T is wgmma m64n64k16 with both operands in shared memory
//     and the accumulator in registers;
//   * the online softmax runs in registers (a row's 64 scores sit in the
//     four lanes of a quad: max and sum reduce over __shfl_xor 1 and 2),
//     the running max m and sum l stay in registers, and the O accumulator
//     is rescaled there;
//   * P is rounded to bf16 in registers and is wgmma's A operand against V
//     in shared memory (m64n128k16; V is [keys, d], so B is read MN-major,
//     trans-b = 1); O is a [64, 128] f32 accumulator in registers.
// Nothing of S, P or O is stored to shared memory. 288 threads, ~97 KB of
// shared memory and ~160 registers a thread (O 64, S 32, P 16): one block
// per SM, whose two consumer warpgroups overlap each other's softmax with
// their products.
//
// Numerics: the TPU kernel saw the whole key range at once; here the
// probabilities are rounded to bf16 against the running max of 64-key
// tiles, and O is rescaled when the max moves (ROADMAP C, "Online softmax").
//
// ``nk_valid`` <= Nk is the count of real keys: keys at or beyond it are
// padding (the wrapper pads K and V with zero rows up to a multiple of 64)
// and are set to -inf before the row max in the last visited tile (the
// counterpart of nk_valid in pallas_attention.py:_fwd_packed_kernel); tiles
// wholly past it are neither loaded nor visited.
//
// Nq % 128 == 64: the second warpgroup of the last query block owns rows
// past Nq. It runs the same loop on whatever its TMA box holds (the next
// batch item's rows, or zeros past the end of the tensor), arrives on every
// barrier like the other, and stores nothing: a warpgroup that left early
// would leave the producer waiting on its empty barriers.
//
// Training: with a non-null ``lse`` the kernel also writes each row's
// logsumexp m + log(l) of the scaled scores ([B, H, Nq] f32), from which
// flash_bwd.cu recomputes the probabilities.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace vcr::hopper;
using bf16 = __nv_bfloat16;

constexpr int kDk = 128;
constexpr int kConsumers = 2;                 // warpgroups, 64 query rows each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kTileQ = 64 * kConsumers;
constexpr int kTileK = 64;
constexpr int kStages = 2;
constexpr uint32_t kQBytes = kConsumers * kHeadTileBytes;
constexpr uint32_t kStageBytes = 2 * kHeadTileBytes;  // K and V tiles of 64 keys
constexpr size_t kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__global__ void __launch_bounds__(kThreads, 1)
flash_packed_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                    float* __restrict__ lse,  // [B, H, Nq] or null
                    int nq, int nk, int nk_valid, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem);                  // [consumer][2 boxes]
  uint8_t* ring = smem + kQBytes;                             // [stage]{K 2 boxes, V 2 boxes}
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int b = blockIdx.z, head = blockIdx.y, n_heads = gridDim.y;
  const int q0 = blockIdx.x * kTileQ;
  const int col = head * kDk;
  const int n_tiles = (nk_valid + kTileK - 1) / kTileK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // ---- producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int h = 0; h < 2; ++h)
          tma_load_box(q_s + (2 * c + h) * kBox * kBox, &q_map, q_full, col + h * kBox,
                       b * nq + q0 + c * 64);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        bf16* k_s = reinterpret_cast<bf16*>(ring + s * kStageBytes);
        bf16* v_s = k_s + 2 * kBox * kBox;
        const int row = b * nk + t * kTileK;
        mbar_expect_tx(&full[s], kStageBytes);
        for (int h = 0; h < 2; ++h) {
          tma_load_box(k_s + h * kBox * kBox, &k_map, &full[s], col + h * kBox, row);
          tma_load_box(v_s + h * kBox * kBox, &v_map, &full[s], col + h * kBox, row);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* q_tile = q_s + wg * 2 * kBox * kBox;
  const float scale_log2 = sm_scale * kLog2e;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_g = -CUDART_INF_F, m_g8 = -CUDART_INF_F;  // running max of s * scale * log2(e)
  float l_g = 0.f, l_g8 = 0.f;                     // this lane's part of the row sums

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const bf16* k_s = reinterpret_cast<const bf16*>(ring + s * kStageBytes);
    const bf16* v_s = k_s + 2 * kBox * kBox;

    float sc[32];  // S of the tile; the first k step overwrites it
    wgmma_fence();
    scores_64x64(sc, q_tile, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

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
    const float alpha_g = exp2f(m_g - mn_g), alpha_g8 = exp2f(m_g8 - mn_g8);
    m_g = mn_g;
    m_g8 = mn_g8;

    uint32_t pa[16];  // bf16(P), the A fragments of P . V
    float sum_g = 0.f, sum_g8 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(fmaf(sc[4 * j], scale_log2, -mn_g));
      const float p1 = exp2f(fmaf(sc[4 * j + 1], scale_log2, -mn_g));
      const float p2 = exp2f(fmaf(sc[4 * j + 2], scale_log2, -mn_g8));
      const float p3 = exp2f(fmaf(sc[4 * j + 3], scale_log2, -mn_g8));
      sum_g += p0 + p1;
      sum_g8 += p2 + p3;
      pa[2 * j] = pack_bf16(p0, p1);
      pa[2 * j + 1] = pack_bf16(p2, p3);
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
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
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

}  // namespace

// q bf16 [B,Nq,H*128], k/v bf16 [B,Nk,H*128] -> out bf16 [B,Nq,H*128], and
// with a non-null lse the row logsumexp f32 [B,H,Nq], over the first
// nk_valid keys (1 <= nk_valid <= Nk; finite K and V rows beyond it).
// Requires Nq % 64 == 0, Nk % 64 == 0, 16-byte aligned pointers.
cudaError_t vcr_flash_packed(const void* q, const void* k, const void* v, void* out,
                             float* lse, int batch, int nq, int nk, int nk_valid,
                             int n_heads, float sm_scale, cudaStream_t stream) {
  const uint64_t d_model = static_cast<uint64_t>(n_heads) * kDk;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_box_map(&q_map, q, static_cast<uint64_t>(batch) * nq, d_model);
  if (err == cudaSuccess) err = make_box_map(&k_map, k, static_cast<uint64_t>(batch) * nk, d_model);
  if (err == cudaSuccess) err = make_box_map(&v_map, v, static_cast<uint64_t>(batch) * nk, d_model);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kTileQ - 1) / kTileQ, n_heads, batch);
  flash_packed_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), lse, nq, nk, nk_valid, sm_scale);
  return cudaGetLastError();
}

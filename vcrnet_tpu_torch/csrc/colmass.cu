// Column masses of a row softmax over packed heads, without the score tensor:
//
//   out[b, h, j] = sum_i softmax_j'(q_i . k_j' * sm_scale)[j]
//
// for q [B, Nq, H*dk], k [B, Nk, H*dk], head h = columns [h*dk, (h+1)*dk), at
// dk = 128, 64 or 256 (both kernels templates over dk, chosen by d_model /
// n_heads).
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
//   1. the row logsumexps: flash_fwd.cuh's lse_kernel, the attention
//      forward's loop without its P . V product (the same producer and
//      online softmax of a tile in registers; a stage holds only a K tile).
//      A block owns 128 query rows of one head and writes one base-2
//      logsumexp a row, lse2_i = log2 sum_j exp2(s_ij * sm_scale * log2(e));
//   2. colmass_kernel: a block owns 128 keys of one head, 64 for each of
//      two consumer warpgroups, and a producer warp streams 64-query tiles
//      of Q, with their lse2, through a TMA ring. Each warpgroup computes
//      S^T = K . Q^T (wgmma m64n64k16, keys as the M rows, both operands
//      K-major in shared memory), so a key's column mass is a row sum of
//      the accumulator: each lane adds exp2(s * sm_scale * log2(e) - lse2_i)
//      over its 16 columns in registers, across all query tiles in
//      ascending order, and the quad's four sums are added by two shuffles
//      at the end. No score tile in shared memory and no atomics: the
//      result is the same from run to run.
//
// Bound on the H100: the function needs one score product (2 * Nq * Nk *
// dk flops per head) and one exp a score; the design takes two of each.
// At dk = 128 the exp unit's rate (16 a clock an SM) is about that of the
// tensor cores for a score (128 multiply-adds), so each pass is held by
// both; the two consumer warpgroups, and the two blocks an SM holds (about
// 100 KB of shared memory and few registers each), overlap one's products
// with another's exps. At dk = 64 a score costs half the products and the
// same exp: both passes are held by the exps, at about twice the products'
// time, and each block's shared memory halves (a head tile is one box). At
// dk = 256 a score costs twice the products of dk = 128 and the same exp,
// so both passes are held by the products; the K block (64 KB) and four
// stages of 32 KB take ~194 KB, one block an SM (the instance's launch
// bounds ask for one, so that ptxas does not hold it to the registers of
// two). exp2f with the scale folded into log2(e) costs one fma a score
// before the exp, as in FA3.
//
// Any Nk: the last key block of an item owns keys past Nk (all of its
// second warpgroup's where Nk % 128 <= 64). They run the same loop on
// whatever the TMA box holds (the next batch item's keys, or zeros past the
// end of the tensor) and store nothing, so that every consumer warp arrives
// on every barrier. Any Nq: the last query tile of an item holds rows past
// Nq (the next item's, or zeros); by a count, their columns are given a
// score of 0 and an lse of +inf, so each adds exp2(-inf) = 0 and the masses
// are those of the real queries, bit for bit. The row logsumexps are
// written with a row stride of Nq rounded up to 64, so that a tile's 64
// values are one aligned bulk copy inside the scratch. lse_kernel masks the
// keys past Nk by its valid-key count (flash_fwd.cuh).
#include "flash_fwd.cuh"

namespace {

using namespace vcr::hopper;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;  // warpgroups, 64 keys each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kTileKeys = 64 * kConsumers;
constexpr int kTileQ = 64;
constexpr int kStages = 4;
constexpr uint32_t kLseBytes = kTileQ * sizeof(float);
constexpr float kLog2e = 1.4426950408889634f;

// colmass_kernel's shared memory at head dim kDk: a head tile is kDk / 64 boxes.
template <int kDk>
struct Mass {
  static_assert(kDk == 64 || kDk == 128 || kDk == 256, "the head dims the kernels take");
  static constexpr int kBoxes = kDk / kBox;
  static constexpr uint32_t kHeadBytes = head_tile_bytes(kDk);
  static constexpr uint32_t kKBytes = kConsumers * kHeadBytes;
  static constexpr uint32_t kStageBytes = kHeadBytes + kLseBytes;  // a stage's copies deliver
  static constexpr size_t kSmemBytes =
      1024 + kKBytes + kStages * (kHeadBytes + kLseBytes) + (2 * kStages + 1) * 8;
  // blocks an SM: two where their shared memory fits twice
  static constexpr int kBlocks = 2 * kSmemBytes + 2048 <= 233472 ? 2 : 1;
};

template <int kDk>
__global__ void __launch_bounds__(kThreads, Mass<kDk>::kBlocks)
colmass_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const float* __restrict__ lse2,  // [B, H, n_tiles * 64], base 2
               float* __restrict__ out,         // [B, H, Nk]
               int nq, int nk, float scale_log2) {
  using L = Mass<kDk>;
  constexpr int kBoxes = L::kBoxes;
  constexpr uint32_t kKBytes = L::kKBytes, kStageBytes = L::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(smem);                   // [consumer][kBoxes boxes]
  bf16* q_ring = reinterpret_cast<bf16*>(smem + kKBytes);      // [stage][kBoxes boxes]
  float* lse_ring = reinterpret_cast<float*>(smem + kKBytes + kStages * L::kHeadBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(lse_ring + kStages * kTileQ);
  uint64_t* k_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int b = blockIdx.z, head = blockIdx.y, n_heads = gridDim.y;
  const int key0 = blockIdx.x * kTileKeys;
  const int col = head * kDk;
  const int n_tiles = (nq + kTileQ - 1) / kTileQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = static_cast<size_t>(b) * n_heads + head;

  if (threadIdx.x == 0) {
    mbar_init(k_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // ---- producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(k_full, kKBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int h = 0; h < kBoxes; ++h)
          tma_load_box(k_s + (kBoxes * c + h) * kBox * kBox, &k_map, k_full, col + h * kBox,
                       b * nk + key0 + c * 64);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        bf16* q_s = q_ring + s * kBoxes * kBox * kBox;
        mbar_expect_tx(&full[s], kStageBytes);
        for (int h = 0; h < kBoxes; ++h)
          tma_load_box(q_s + h * kBox * kBox, &q_map, &full[s], col + h * kBox,
                       b * nq + t * kTileQ);
        bulk_load(lse_ring + s * kTileQ, lse2 + (bh * n_tiles + t) * kTileQ, kLseBytes,
                  &full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys key0 + 64 wg .. + 63; lane (g, qd)
  // of warp w holds keys 16 w + g and 16 w + g + 8 against query columns
  // 8 j + 2 qd + {0, 1} of each tile
  const int wg = warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* k_tile = k_s + wg * kBoxes * kBox * kBox;
  float mass_g = 0.f, mass_g8 = 0.f;

  mbar_wait(k_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    float sc[32];  // S^T of the tile: 64 keys by 64 queries
    wgmma_fence();
    scores_64x64<kDk>(sc, k_tile, q_ring + s * kBoxes * kBox * kBox);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    float2 l2[8];
    const float* lse_s = lse_ring + s * kTileQ;
#pragma unroll
    for (int j = 0; j < 8; ++j) l2[j] = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * qd);
    // the producer's next bulk copy into this stage (the async proxy) must
    // not overtake these reads (the generic proxy): without the fence it
    // did, on the card, and a few masses took another tile's lse2
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read: Q by wgmma, lse2 above
    if (t == n_tiles - 1 && nq % kTileQ) {  // query columns past Nq add exp2(-inf) = 0
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (t * kTileQ + 8 * j + 2 * qd + c >= nq) {
            sc[4 * j + c] = 0.f;
            sc[4 * j + 2 + c] = 0.f;
            if (c) l2[j].y = CUDART_INF_F;
            else l2[j].x = CUDART_INF_F;
          }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mass_g += exp2f(fmaf(sc[4 * j], scale_log2, -l2[j].x));
      mass_g += exp2f(fmaf(sc[4 * j + 1], scale_log2, -l2[j].y));
      mass_g8 += exp2f(fmaf(sc[4 * j + 2], scale_log2, -l2[j].x));
      mass_g8 += exp2f(fmaf(sc[4 * j + 3], scale_log2, -l2[j].y));
    }
  }
  mass_g = quad_sum(mass_g);
  mass_g8 = quad_sum(mass_g8);
  const int key_g = key0 + wg * 64 + (warp & 3) * 16 + g;
  if (qd == 0) {
    if (key_g < nk) out[bh * nk + key_g] = mass_g;
    if (key_g + 8 < nk) out[bh * nk + key_g + 8] = mass_g8;
  }
}

template <int kDk>
cudaError_t launch_colmass(const CUtensorMap& q_map, const CUtensorMap& k_map, float* lse,
                           float* out, int batch, int nq, int nk, int n_heads, float sm_scale,
                           cudaStream_t stream) {
  constexpr size_t kSmemBytes = Mass<kDk>::kSmemBytes;
  cudaError_t err = vcr::flash::launch_lse<kDk>(q_map, k_map, lse, batch, nq, nk, nk,
                                                (nq + kTileQ - 1) / kTileQ * kTileQ, n_heads,
                                                sm_scale, stream);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(colmass_kernel<kDk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  colmass_kernel<kDk><<<dim3((nk + kTileKeys - 1) / kTileKeys, n_heads, batch), kThreads,
                        kSmemBytes, stream>>>(q_map, k_map, lse, out, nq, nk, sm_scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q bf16 [B,Nq,D], k bf16 [B,Nk,D] (D = n_heads * dk, dk = 64, 128 or 256) -> out
// f32 [B,H,Nk]; lse f32 [B,H,Nq'] (Nq' = Nq rounded up to 64) is scratch
// that the first kernel writes (base 2) and the second reads. Any Nq, Nk;
// 16-byte aligned pointers. Another dk is refused (cudaErrorInvalidValue)
// before anything is launched. Returns the launch status.
cudaError_t vcr_softmax_colmass(const void* q, const void* k, float* lse, float* out,
                                int batch, int nq, int nk, int d_model, int n_heads,
                                float sm_scale, cudaStream_t stream) {
  return dispatch_head_dim<256>(d_model, n_heads, [&](auto dk) {
    CUtensorMap q_map, k_map;
    cudaError_t err = make_box_map(&q_map, q, static_cast<uint64_t>(batch) * nq, d_model);
    if (err == cudaSuccess)
      err = make_box_map(&k_map, k, static_cast<uint64_t>(batch) * nk, d_model);
    if (err != cudaSuccess) return err;
    return launch_colmass<decltype(dk)::value>(q_map, k_map, lse, out, batch, nq, nk, n_heads,
                                               sm_scale, stream);
  });
}

// Backward of attention over packed heads (q/k/v/o/do [B, N, H*128]).
//
// Replaces vcrnet_tpu/ops/pallas_attention.py:_bwd_fused (-> _bwd_kernel,
// :76, call :188). With s = (q . k^T) * scale and p = exp(s - lse) (lse
// saved by flash_packed.cu's forward):
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
// is split by what each block owns instead, and no sum needs atomics (the
// results are the same from run to run):
//   * flash_bwd_dkdv_kernel owns 64 keys of one head per consumer
//     warpgroup (128 a block). TMA loads its K and V once; Q, dO and the
//     tile's lse and delta stream through a two-stage ring. Per 64-row q
//     tile: S^T = K . Q^T and dP^T = V . dO^T are wgmma from shared memory
//     (K-major both), P^T = exp(S^T * scale - lse) and dS^T =
//     bf16(P^T (dP^T - delta) * scale) are computed in registers, and
//     dV += bf16(P^T) . dO, dK += dS^T . Q take A from registers and B from
//     shared memory read MN-major (trans-b = 1: the contraction runs over
//     the q rows of the [q, 128] tiles). dK and dV accumulate in registers:
//     two [64, 128] f32 accumulators beside S^T and dP^T, more than the 168
//     registers a thread of a 384-thread block starts with, so the producer
//     warpgroup hands its registers to the consumers (setmaxnreg 24 / 240);
//   * flash_bwd_dq_kernel owns 64 query rows per consumer warpgroup and
//     streams the key tiles: S = Q . K^T, dP = dO . V^T, then dQ += dS . K
//     (K read MN-major);
//   * a small kernel computes delta first.
// The split costs seven products where five are needed (S and dP in both
// kernels); it buys the owner-per-sum order. Each block is a producer
// warpgroup (one lane issues the copies) and two consumer warpgroups, with
// one full/empty mbarrier pair per ring stage, as in flash_packed.cu.
// Nothing of S, P, dP or dS goes to shared memory.
//
// Any Nq and Nk. The TMA maps cover [B * N, D] as one matrix, so the last
// tiles of an item hold the next item's rows (zeros past the end of the
// tensor):
//   * owned rows past Nk (dK/dV) or Nq (dQ) run the same loop on whatever
//     their boxes hold, arrive on every barrier, and are not stored;
//   * streamed q rows past Nq (dK/dV) get P^T = 0, hence dS^T = 0, with no
//     instruction in the loop: the per-tile statistics are laid out per
//     (b, h) in whole 64-value tiles, ld = Nq rounded up to 64, with lse
//     +inf and delta 0 past Nq (the wrapper pads lse; the delta pass writes
//     its zeros). A count in the kernel would not do: the tile's 64 values
//     reach the ring by one bulk copy, which needs a 16-byte aligned source
//     and must not run into the next head's row;
//   * streamed keys past Nk (dQ) are masked to p = 0 by the count of real
//     keys in the last tile, as flash_fwd.cuh masks its keys past nk_valid
//     (a branch taken in that tile alone).
// Ring slots: every value the consumers read from a slot (the q tiles by
// wgmma, lse and delta by the CUDA cores) feeds a product that has
// completed (wgmma_wait<0>) before the slot is released, so no read of the
// slot is outstanding when the bulk copy refills it; unlike colmass.cu's
// lse2, whose values fed no product before the release, no
// fence.proxy.async is needed.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace vcr::hopper;
using bf16 = __nv_bfloat16;

constexpr int kDk = 128;
constexpr int kConsumers = 2;  // warpgroups, 64 rows (keys or queries) each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 32 * (kConsumerWarps + 4);  // and a producer warpgroup
// Registers a thread: 168 at launch (65536 over 384 threads); then the
// producer warpgroup drops to 24 and the consumers rise to 240, which the
// dK/dV kernel needs (two [64, 128] f32 accumulators beside S^T and dP^T).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRows = 64 * kConsumers;  // rows a block owns
constexpr int kTile = 64;               // rows of a streamed tile
constexpr int kStages = 2;
constexpr uint32_t kOwnedBytes = kConsumers * kHeadTileBytes;  // one operand of the owned rows
constexpr uint32_t kStatBytes = 2 * kTile * sizeof(float);    // lse and delta of a q tile
constexpr uint32_t kStageBytes = 2 * kHeadTileBytes;           // two streamed [64, 128] tiles
constexpr size_t kSmemBytes =
    1024 + 2 * kOwnedBytes + kStages * (kStageBytes + kStatBytes) + (2 * kStages + 1) * 8;
constexpr float kLog2e = 1.4426950408889634f;

// delta [B, H, ld] (ld = n rounded up to 64), 0 past n; one warp an entry
// (32-bit index arithmetic: vcr_flash_bwd launches it with fewer than 2^32
// threads or refuses the call)
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                       float* __restrict__ delta, int batch, int n, int ld,
                                       int n_heads) {
  const unsigned w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= static_cast<unsigned>(batch * ld * n_heads)) return;
  const unsigned bi = w / n_heads;  // b * ld + i
  const unsigned head = w - bi * n_heads;
  const unsigned b = bi / ld, i = bi - b * ld;
  const size_t out = (static_cast<size_t>(b) * n_heads + head) * ld + i;
  if (i >= static_cast<unsigned>(n)) {
    if (lane == 0) delta[out] = 0.f;
    return;
  }
  const size_t off = (static_cast<size_t>(b) * n + i) * n_heads * kDk + head * kDk + lane * 4;
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
  if (lane == 0) delta[out] = s;
}

// Shared memory of both kernels: the owned rows' two operands (K and V, or
// Q and dO), the ring, the dK/dV kernel's per-tile lse and delta, barriers.
struct Smem {
  bf16* own_a;  // [consumer][2 boxes]
  bf16* own_b;
  uint8_t* ring;  // [stage]{2 boxes, 2 boxes}
  float* stats;   // [stage]{lse[64], delta[64]}
  uint64_t* own_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Smem(uint8_t* raw) {
    uint8_t* p = align_1024(raw);
    own_a = reinterpret_cast<bf16*>(p);
    own_b = reinterpret_cast<bf16*>(p + kOwnedBytes);
    ring = p + 2 * kOwnedBytes;
    stats = reinterpret_cast<float*>(ring + kStages * kStageBytes);
    own_full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(stats) + kStages * kStatBytes);
    full = own_full + 1;
    empty = full + kStages;
  }
  __device__ bf16* stage_a(int s) const { return reinterpret_cast<bf16*>(ring + s * kStageBytes); }
  __device__ bf16* stage_b(int s) const { return stage_a(s) + 2 * kBox * kBox; }
};

__device__ __forceinline__ void init_barriers(const Smem& sm) {
  if (threadIdx.x == 0) {
    mbar_init(sm.own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer lane: the owned rows' two operands once, then ``n_tiles``
// streamed pairs of [64, 128] tiles (and, with stat pointers, 64 lse and
// delta values each) through the ring.
__device__ __forceinline__ void produce(const Smem& sm, const CUtensorMap* own_a_map,
                                       const CUtensorMap* own_b_map, int own_row,
                                       const CUtensorMap* a_map, const CUtensorMap* b_map,
                                       int row0, int n_tiles, int col, const float* lse_bh,
                                       const float* delta_bh) {
  mbar_expect_tx(sm.own_full, 2 * kOwnedBytes);
  for (int c = 0; c < kConsumers; ++c)
    for (int h = 0; h < 2; ++h) {
      const int box = (2 * c + h) * kBox * kBox;
      tma_load_box(sm.own_a + box, own_a_map, sm.own_full, col + h * kBox, own_row + c * 64);
      tma_load_box(sm.own_b + box, own_b_map, sm.own_full, col + h * kBox, own_row + c * 64);
    }
  const uint32_t bytes = kStageBytes + (lse_bh != nullptr ? kStatBytes : 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], bytes);
    for (int h = 0; h < 2; ++h) {
      tma_load_box(sm.stage_a(s) + h * kBox * kBox, a_map, &sm.full[s], col + h * kBox,
                   row0 + t * kTile);
      tma_load_box(sm.stage_b(s) + h * kBox * kBox, b_map, &sm.full[s], col + h * kBox,
                   row0 + t * kTile);
    }
    if (lse_bh != nullptr) {
      float* st = sm.stats + s * 2 * kTile;
      bulk_load(st, lse_bh + t * kTile, kTile * sizeof(float), &sm.full[s]);
      bulk_load(st + kTile, delta_bh + t * kTile, kTile * sizeof(float), &sm.full[s]);
    }
  }
}

// ---- dK/dV consumers: warpgroup wg owns keys key0 + 64 wg .. + 63
__device__ __forceinline__ void dkdv_consumer(const Smem& sm, bf16* dk, bf16* dv, int nq, int nk,
                                              float sm_scale) {
  const int b = blockIdx.z, head = blockIdx.y, n_heads = gridDim.y;
  const int key0 = blockIdx.x * kRows, col = head * kDk;
  const int n_tiles = (nq + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* k_w = sm.own_a + wg * 2 * kBox * kBox;
  const bf16* v_w = sm.own_b + wg * 2 * kBox * kBox;
  const float scale_log2 = sm_scale * kLog2e;

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(sm.own_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const bf16* q_t = sm.stage_a(s);
    const bf16* do_t = sm.stage_b(s);
    const float* lse_t = sm.stats + s * 2 * kTile;
    const float* delta_t = lse_t + kTile;

    float st[32], dpt[32];  // S^T and dP^T: rows = keys, columns = the tile's queries
    wgmma_fence();
    scores_64x64(st, k_w, q_t);
    wgmma_commit();
    scores_64x64(dpt, v_w, do_t);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float nl = -lse_t[8 * j + 2 * qd + c] * kLog2e;
        st[4 * j + c] = exp2f(fmaf(st[4 * j + c], scale_log2, nl));
        st[4 * j + 2 + c] = exp2f(fmaf(st[4 * j + 2 + c], scale_log2, nl));
      }
    wgmma_wait<0>();
    fence_regs(dpt);
    uint32_t pa[16], dsa[16];  // bf16(P^T) and dS^T as A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d0 = delta_t[8 * j + 2 * qd], d1 = delta_t[8 * j + 2 * qd + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // rows g and g + 8
        const float p0 = st[4 * j + 2 * r], p1 = st[4 * j + 2 * r + 1];
        pa[2 * j + r] = pack_bf16(p0, p1);
        dsa[2 * j + r] = pack_bf16(p0 * (dpt[4 * j + 2 * r] - d0) * sm_scale,
                                   p1 * (dpt[4 * j + 2 * r + 1] - d1) * sm_scale);
      }
    }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    accumulate_64x128(dv_acc, pa, do_t);   // dV += bf16(P^T) . dO
    accumulate_64x128(dk_acc, dsa, q_t);   // dK += dS^T . Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  const int r_g = key0 + wg * 64 + (warp & 3) * 16 + g, r_g8 = r_g + 8;
  const size_t d_model = static_cast<size_t>(n_heads) * kDk;
  const size_t base = static_cast<size_t>(b) * nk * d_model + col;
  store_rows_bf16(r_g < nk ? dk + base + r_g * d_model : nullptr,
                  r_g8 < nk ? dk + base + r_g8 * d_model : nullptr, dk_acc, 1.f, 1.f, qd);
  store_rows_bf16(r_g < nk ? dv + base + r_g * d_model : nullptr,
                  r_g8 < nk ? dv + base + r_g8 * d_model : nullptr, dv_acc, 1.f, 1.f, qd);
}

// ---- dQ consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; the
// last key tile's keys past Nk get p = 0
__device__ __forceinline__ void dq_consumer(const Smem& sm, const float* lse, const float* delta,
                                            bf16* dq, int nq, int nk, float sm_scale) {
  const int b = blockIdx.z, head = blockIdx.y, n_heads = gridDim.y;
  const int q0 = blockIdx.x * kRows, col = head * kDk;
  const int n_tiles = (nk + kTile - 1) / kTile;
  const int ld = (nq + kTile - 1) / kTile * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* q_w = sm.own_a + wg * 2 * kBox * kBox;
  const bf16* do_w = sm.own_b + wg * 2 * kBox * kBox;
  const float scale_log2 = sm_scale * kLog2e;
  const int r_g = q0 + wg * 64 + (warp & 3) * 16 + g, r_g8 = r_g + 8;
  const size_t bh = static_cast<size_t>(b) * n_heads + head;
  // rows past Nq (they are not stored) read row 0's statistics
  const float nl_g = -lse[bh * ld + (r_g < nq ? r_g : 0)] * kLog2e;
  const float nl_g8 = -lse[bh * ld + (r_g8 < nq ? r_g8 : 0)] * kLog2e;
  const float dl_g = delta[bh * ld + (r_g < nq ? r_g : 0)];
  const float dl_g8 = delta[bh * ld + (r_g8 < nq ? r_g8 : 0)];

  float dq_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;

  mbar_wait(sm.own_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const bf16* k_t = sm.stage_a(s);
    const bf16* v_t = sm.stage_b(s);

    float sc[32], dp[32];
    wgmma_fence();
    scores_64x64(sc, q_w, k_t);
    wgmma_commit();
    scores_64x64(dp, do_w, v_t);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, nl_g));
      sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, nl_g));
      sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, nl_g8));
      sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, nl_g8));
    }
    const int valid = nk - t * kTile;  // >= 64 but in a ragged last tile
    if (valid < kTile) {  // keys at or past Nk: the next item's, or zeros
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sc[4 * j + c] = 8 * j + 2 * qd + (c & 1) < valid ? sc[4 * j + c] : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t dsa[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dsa[2 * j] = pack_bf16(sc[4 * j] * (dp[4 * j] - dl_g) * sm_scale,
                             sc[4 * j + 1] * (dp[4 * j + 1] - dl_g) * sm_scale);
      dsa[2 * j + 1] = pack_bf16(sc[4 * j + 2] * (dp[4 * j + 2] - dl_g8) * sm_scale,
                                 sc[4 * j + 3] * (dp[4 * j + 3] - dl_g8) * sm_scale);
    }
    fence_regs(dq_acc);
    wgmma_fence();
    accumulate_64x128(dq_acc, dsa, k_t);  // dQ += dS . K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  const size_t d_model = static_cast<size_t>(n_heads) * kDk;
  bf16* dq_b = dq + static_cast<size_t>(b) * nq * d_model + col;
  store_rows_bf16(r_g < nq ? dq_b + r_g * d_model : nullptr,
                  r_g8 < nq ? dq_b + r_g8 * d_model : nullptr, dq_acc, 1.f, 1.f, qd);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int nq, int nk, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);  // own_a = K, own_b = V; stage_a = Q, stage_b = dO
  init_barriers(sm);
  if (threadIdx.x >= 32 * kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 32 * kConsumerWarps) {
      const int b = blockIdx.z, head = blockIdx.y;
      const int n_tiles = (nq + kTile - 1) / kTile;
      const size_t row = (static_cast<size_t>(b) * gridDim.y + head) * n_tiles * kTile;
      produce(sm, &k_map, &v_map, b * nk + blockIdx.x * kRows, &q_map, &do_map, b * nq,
              n_tiles, head * kDk, lse + row, delta + row);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dkdv_consumer(sm, dk, dv, nq, nk, sm_scale);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int nq, int nk,
                    float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);  // own_a = Q, own_b = dO; stage_a = K, stage_b = V
  init_barriers(sm);
  if (threadIdx.x >= 32 * kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 32 * kConsumerWarps) {
      const int b = blockIdx.z;
      produce(sm, &q_map, &do_map, b * nq + blockIdx.x * kRows, &k_map, &v_map, b * nk,
              (nk + kTile - 1) / kTile, blockIdx.y * kDk, nullptr, nullptr);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dq_consumer(sm, lse, delta, dq, nq, nk, sm_scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

}  // namespace

// q/k/v/o/do bf16 [B,N,H*128] (packed heads), lse f32 [B,H,ld] from the
// forward, ld = Nq rounded up to 64 and +inf past Nq -> dq/dk/dv bf16
// [B,N,H*128], with delta f32 [B,H,ld] as scratch. Any Nq, Nk > 0 with
// B * ld * H * 32 < 2^32 (the delta pass's threads); 16-byte aligned
// pointers. Returns the launch status.
cudaError_t vcr_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, void* dq, void* dk,
                          void* dv, int batch, int nq, int nk, int n_heads, float sm_scale,
                          cudaStream_t stream) {
  using cbf = const bf16*;
  const uint64_t d_model = static_cast<uint64_t>(n_heads) * kDk;
  const uint64_t rows_q = static_cast<uint64_t>(batch) * nq, rows_k = static_cast<uint64_t>(batch) * nk;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = make_box_map(&q_map, q, rows_q, d_model);
  if (err == cudaSuccess) err = make_box_map(&k_map, k, rows_k, d_model);
  if (err == cudaSuccess) err = make_box_map(&v_map, v, rows_k, d_model);
  if (err == cudaSuccess) err = make_box_map(&do_map, dout, rows_q, d_model);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkdv_kernel);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel);
  if (err != cudaSuccess) return err;

  const int ld = (nq + kTile - 1) / kTile * kTile;
  const size_t warps = static_cast<size_t>(batch) * ld * n_heads;
  if (warps * 32 > UINT32_MAX) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((warps * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<cbf>(o), static_cast<cbf>(dout), delta, batch, nq, ld, n_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<<<dim3((nk + kRows - 1) / kRows, n_heads, batch), kThreads, kSmemBytes,
                          stream>>>(q_map, k_map, v_map, do_map, lse, delta,
                                    static_cast<bf16*>(dk), static_cast<bf16*>(dv), nq, nk,
                                    sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<<<dim3((nq + kRows - 1) / kRows, n_heads, batch), kThreads, kSmemBytes,
                        stream>>>(q_map, k_map, v_map, do_map, lse, delta,
                                  static_cast<bf16*>(dq), nq, nk, sm_scale);
  return cudaGetLastError();
}

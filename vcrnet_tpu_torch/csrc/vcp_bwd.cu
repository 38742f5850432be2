// Backward of the whole-cloud soft correspondence, from the saved lse.
//
// Replaces vcrnet_tpu/ops/pallas_vcp.py:_vcp_bwd (-> _vcp_bwd_kernel,
// :174, call :267). With s_ij = 2 e_i . f_j - |f_j|^2, p = exp(s - lse_i)
// (lse saved by vcp_stream.cu's forward), g = dcorr and corr the
// forward's output:
//
//   delta_i = g_i . corr_i,   dp_ij = g_i . tgt_j                 (f32)
//   ds      = bf16(p * (dp - delta))
//   de_i    = 2 sum_j ds_ij f_j
//   df_j    = 2 sum_i ds_ij e_i - 2 colsum_j(ds) f_j               (f32)
//   dtgt_j  = sum_i bf16(p_ij) g_i
//
// dp and dtgt stay in f32 on the CUDA cores: tgt is only 3 wide, and ds =
// p (dp - delta) cancels. Bound on the H100: operations (three Ns x Nt x E
// products against the embeddings read once and the f32 gradients written
// once). The TPU kernel kept the whole key set resident and carried df,
// dtgt and the column sums across its sequential q-tile grid. Blocks on the
// card run in no order, so the work is split by what each block owns, and
// no sum needs atomics (the results are the same from run to run):
//   * vcp_bwd_de_kernel owns 64 source rows and streams 64-key tiles:
//     S = E_own . F_tile^T, then de += ds . F_tile;
//   * vcp_bwd_df_kernel owns 64 target rows and streams 64-row source
//     tiles: S^T = F_own . E_tile^T directly, then df += ds^T . E_tile,
//     with colsum and dtgt summed in registers and the -2 colsum f term
//     added once at the end;
//   * two small passes pack first each key's (x, y, z, |f|^2)
//     (vcp_keys_kernel, vcp.cuh) and each source row's (g, delta).
// The split costs four products where the TPU kernel did three (S in both
// kernels); it buys the owner-per-sum order.
//
// Each block is a producer warpgroup (one lane issues the copies; it gives
// its registers away, setmaxnreg 24) and two consumer warpgroups (240
// registers each). TMA loads the owned rows' [64, E] embedding once (eight
// 128-byte-swizzled [64, 64] boxes at E = 512) and streams each tile's
// [64, E] through a two-stage ring, with its 64 packed values (1 KB, and
// the 64 lse values of a source tile) by bulk copy, one full/empty
// mbarrier pair per stage.
//
// The register budget is the design problem: the block's [64, E] f32
// accumulator is 256 registers a thread for one warpgroup at E = 512, so
// each consumer warpgroup w owns half of E, columns 256 w .. 256 w + 255
// (two m64n128 accumulators, 128 registers), and per tile:
//   1. computes the partial scores over its half of E for all 64 columns
//      of the tile (wgmma m64n64k16, both operands from shared memory,
//      K-major, 16 steps);
//   2. hands the other warpgroup its partials for that one's 32 columns
//      through shared memory (8 KB a warpgroup; named barrier 1) and adds
//      the other's partials for its own 32 columns, so each score is
//      finished once: three products' worth of work a tile;
//   3. computes ds (and, for df, bf16(p), colsum and dtgt) for its own 32
//      columns only, packs them as bf16 A fragments, and starts the
//      accumulation with those two k steps;
//   4. swaps the packed fragments (4 KB a warpgroup; named barrier 2) and
//      finishes the accumulation with the other two k steps: wgmma
//      m64n128k16, ds (or ds^T) from registers as A, the warpgroup's half
//      of the tile read MN-major as B (trans-b = 1).
// Nothing of S, P or ds is stored but these swaps, and every ds is computed
// once.
//
// Shared memory per block: owned rows 65536 + ring 2 * 65536 + tile values
// 2 * 1280 + score swap 16384 + ds swap 8192 + barriers 40, plus 1024
// bytes of alignment slack = 224808 bytes (<= 227 KB): one block per SM.
// Registers: `-Xptxas -v` (chip_smoke.py prints it) reports no spills
// (the accumulators 128, the partial scores 32, ds 8, the own scores 16).
//
// E < 512: the last loaded box of a row is partly past E (TMA fills
// zeros); boxes wholly past E are zeroed once in the owned rows and in
// every stage and never loaded, so every product runs over eight boxes,
// and the accumulator columns past E are not stored.
//
// Any Ns and Nt. The TMA maps cover [B * N, E] as one matrix, so an
// item's last tile holds the next item's rows (zeros past the end of the
// tensor), and the packed values are laid out per item in whole 64-row
// tiles (Ns' and Nt', Ns and Nt rounded up to 64), so that each tile's
// values arrive by one aligned bulk copy: keys past Nt are (0, 0, 0, +inf)
// (vcp.cuh's packing pass) and source rows past Ns (g, delta) = 0 with lse
// +inf (the rows pass writes the zeros, the wrapper pads lse). Either gives
// p = 0, hence ds = 0 and bf16(p) = 0, with no instruction in the loops:
// the rows past the end add nothing to de, df, colsum or dtgt. Owned rows
// past Ns (de) or Nt (df) are computed and not stored.
// Ring slots: every value the consumers read from a slot (the tiles by
// wgmma, the packed values and lse by the CUDA cores) feeds the ds
// fragments of a product that has completed (wgmma_wait<0>) before the
// slot is released, so no read of the slot is outstanding when the bulk
// copy refills it, and no fence.proxy.async is needed (colmass.cu's lse2
// fed no product before its release and needed one).
#include "common.cuh"
#include "hopper.cuh"
#include "vcp.cuh"

namespace {

using namespace vcr::hopper;
using vcr::vcp::kLog2e;
using vcr::vcp::kMaxBoxes;
using vcr::vcp::kTile;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;  // warpgroups, half of E each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kThreads = kConsumerThreads + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 2;
constexpr int kHalfSteps = 2 * kMaxBoxes;               // k16 steps over half of E
constexpr uint32_t kRowsBytes = kMaxBoxes * kBoxBytes;  // a [64, E] bf16 block
constexpr uint32_t kValBytes = kTile * (sizeof(float4) + sizeof(float));
constexpr uint32_t kScoreSwapBytes = kConsumers * 4 * 128 * sizeof(float4);
constexpr uint32_t kDsSwapBytes = kConsumers * 2 * 128 * sizeof(uint4);
constexpr size_t kSmemBytes = 1024 + kRowsBytes + kStages * kRowsBytes + kStages * kValBytes +
                              kScoreSwapBytes + kDsSwapBytes + (1 + 2 * kStages) * 8;
constexpr int kScoresSwapped = 1, kDsSwapped = 2;  // named barriers of the consumers

// rows[b, i] = (g, g . corr) of source row i of item b, for i < ns_pad: 0
// past ns; one thread an entry
__global__ void vcp_rows_kernel(const float* __restrict__ corr, const float* __restrict__ dcorr,
                                float4* __restrict__ rows, int ns, int ns_pad, int entries) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= entries) return;
  const int b = w / ns_pad, r = w - b * ns_pad;
  if (r >= ns) {
    rows[w] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const size_t i = static_cast<size_t>(b) * ns + r;
  const float gx = dcorr[3 * i], gy = dcorr[3 * i + 1], gz = dcorr[3 * i + 2];
  rows[w] = make_float4(gx, gy, gz, gx * corr[3 * i] + gy * corr[3 * i + 1] + gz * corr[3 * i + 2]);
}

__host__ __device__ __forceinline__ int whole_tiles(int n) { return (n + kTile - 1) / kTile * kTile; }

struct Smem {
  bf16* own;            // [kMaxBoxes boxes]
  uint8_t* tiles;       // [stage][kMaxBoxes boxes]
  uint8_t* vals;        // [stage]{float4[64], float[64]}
  float4* score_swap;   // [consumer][4][128 threads]: partial scores for the other
  uint4* ds_swap;       // [consumer][2][128 threads]: packed ds fragments
  uint64_t* own_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Smem(uint8_t* raw) {
    uint8_t* p = align_1024(raw);
    own = reinterpret_cast<bf16*>(p);
    tiles = p + kRowsBytes;
    vals = tiles + kStages * kRowsBytes;
    score_swap = reinterpret_cast<float4*>(vals + kStages * kValBytes);
    ds_swap = reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(score_swap) + kScoreSwapBytes);
    own_full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(ds_swap) + kDsSwapBytes);
    full = own_full + 1;
    empty = full + kStages;
  }
  __device__ const bf16* tile(int s) const {
    return reinterpret_cast<const bf16*>(tiles + s * kRowsBytes);
  }
  __device__ const float4* vals4(int s) const {
    return reinterpret_cast<const float4*>(vals + s * kValBytes);
  }
  __device__ const float* vals1(int s) const {
    return reinterpret_cast<const float*>(vals4(s) + kTile);
  }
};

// The barriers, and the boxes wholly past E zeroed in the owned rows and in
// every stage (they are never loaded), before any thread uses either.
__device__ __forceinline__ void setup(const Smem& sm, int n_boxes) {
  if (threadIdx.x == 0) {
    mbar_init(sm.own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  const int per_block = (kMaxBoxes - n_boxes) * kBoxBytes / sizeof(uint4);
  for (int i = threadIdx.x; i < (1 + kStages) * per_block; i += kThreads) {
    const int blk = i / per_block;
    uint8_t* base = blk == 0 ? reinterpret_cast<uint8_t*>(sm.own) : sm.tiles + (blk - 1) * kRowsBytes;
    reinterpret_cast<uint4*>(base + n_boxes * kBoxBytes)[i % per_block] = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();  // the zeros, before wgmma reads them
  __syncthreads();
}

// The producer lane: the owned rows once, then ``n_tiles`` streamed
// [64, E] tiles with 64 packed values each (and 64 lse values with a
// non-null ``v1``) through the ring.
__device__ __forceinline__ void produce(const Smem& sm, const CUtensorMap* own_map, int own_row,
                                        const CUtensorMap* tile_map, int row0, int n_tiles,
                                        int n_boxes, const float4* v4, const float* v1) {
  mbar_expect_tx(sm.own_full, n_boxes * kBoxBytes);
  for (int x = 0; x < n_boxes; ++x)
    tma_load_box(sm.own + x * kBox * kBox, own_map, sm.own_full, x * kBox, own_row);
  const uint32_t bytes =
      n_boxes * kBoxBytes + kTile * sizeof(float4) + (v1 != nullptr ? kTile * sizeof(float) : 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], bytes);
    bf16* tile = const_cast<bf16*>(sm.tile(s));
    for (int x = 0; x < n_boxes; ++x)
      tma_load_box(tile + x * kBox * kBox, tile_map, &sm.full[s], x * kBox, row0 + t * kTile);
    bulk_load(const_cast<float4*>(sm.vals4(s)), v4 + t * kTile, kTile * sizeof(float4),
              &sm.full[s]);
    if (v1 != nullptr)
      bulk_load(const_cast<float*>(sm.vals1(s)), v1 + t * kTile, kTile * sizeof(float),
                &sm.full[s]);
  }
}

// Steps 1 and 2: the finished scores of the warpgroup's own 32 columns of
// the tile, own . tile^T, as sc[4k + i] = the m64n64 accumulator's
// d[4 (4 wg + k) + i] (columns 8 (4 wg + k) + 2 qd + {0, 1}, rows g, g + 8).
__device__ __forceinline__ void own_scores(float (&sc)[16], const Smem& sm, const bf16* tile,
                                           int wg) {
  const int tid = threadIdx.x & 127;
  float part[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHalfSteps; ++kk) {
    const int k = kHalfSteps * wg + kk;
    wgmma_m64n64_ss(part, desc_k_major(sm.own, k), desc_k_major(tile, k), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
  float4* to_other = sm.score_swap + wg * 4 * 128;
  const float4* from_other = sm.score_swap + (1 - wg) * 4 * 128;
#pragma unroll
  for (int k = 0; k < 4; ++k)  // the other's columns: j = 4 (1 - wg) + k
    to_other[k * 128 + tid] = wg == 0 ? make_float4(part[16 + 4 * k], part[17 + 4 * k],
                                                    part[18 + 4 * k], part[19 + 4 * k])
                                      : make_float4(part[4 * k], part[4 * k + 1],
                                                    part[4 * k + 2], part[4 * k + 3]);
  named_bar_sync(kScoresSwapped, kConsumerThreads);
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // own columns: j = 4 wg + k, own half of E + the other's
    const float4 v = from_other[k * 128 + tid];
    sc[4 * k] = (wg == 0 ? part[4 * k] : part[16 + 4 * k]) + v.x;
    sc[4 * k + 1] = (wg == 0 ? part[4 * k + 1] : part[17 + 4 * k]) + v.y;
    sc[4 * k + 2] = (wg == 0 ? part[4 * k + 2] : part[18 + 4 * k]) + v.z;
    sc[4 * k + 3] = (wg == 0 ? part[4 * k + 3] : part[19 + 4 * k]) + v.w;
  }
}

// Steps 3 and 4: acc[half h] += ds . tile[:, 256 wg + 128 h ..] over the
// tile's 64 columns (the k16 steps of the contraction), the own two k steps
// (2 wg, 2 wg + 1: ``mine``, packed A fragments) first, then the other
// warpgroup's, swapped through shared memory.
__device__ __forceinline__ void accumulate(float (&acc0)[64], float (&acc1)[64],
                                           uint32_t (&mine)[8], const Smem& sm,
                                           const bf16* tile, int wg) {
  const int tid = threadIdx.x & 127;
  const bf16* b0 = tile + (4 * wg) * kBox * kBox;      // columns 256 wg ..
  const bf16* b1 = tile + (4 * wg + 2) * kBox * kBox;  // columns 256 wg + 128 ..
  fence_regs(mine);
  fence_regs(acc0);
  fence_regs(acc1);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kk = 2 * wg + i;
    wgmma_m64n128_rs(acc0, mine[4 * i], mine[4 * i + 1], mine[4 * i + 2], mine[4 * i + 3],
                     desc_mn_major(b0, kk));
    wgmma_m64n128_rs(acc1, mine[4 * i], mine[4 * i + 1], mine[4 * i + 2], mine[4 * i + 3],
                     desc_mn_major(b1, kk));
  }
  wgmma_commit();
  uint4* to_other = sm.ds_swap + wg * 2 * 128;
  const uint4* from_other = sm.ds_swap + (1 - wg) * 2 * 128;
  to_other[tid] = make_uint4(mine[0], mine[1], mine[2], mine[3]);
  to_other[128 + tid] = make_uint4(mine[4], mine[5], mine[6], mine[7]);
  named_bar_sync(kDsSwapped, kConsumerThreads);
  const uint4 o0 = from_other[tid], o1 = from_other[128 + tid];
  uint32_t other[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
  fence_regs(other);
  fence_regs(acc0);
  fence_regs(acc1);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kk = 2 * (1 - wg) + i;
    wgmma_m64n128_rs(acc0, other[4 * i], other[4 * i + 1], other[4 * i + 2], other[4 * i + 3],
                     desc_mn_major(b0, kk));
    wgmma_m64n128_rs(acc1, other[4 * i], other[4 * i + 1], other[4 * i + 2], other[4 * i + 3],
                     desc_mn_major(b1, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
}

// ---- d_src consumers: the block owns source rows row0 .. row0 + 63
__device__ __forceinline__ void de_consumer(const Smem& sm, const float4* rows, const float* lse,
                                            float* d_src, int ns, int nt, int e) {
  const int b = blockIdx.y, row0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, qd = lane & 3;
  const int r_g = row0 + (warp & 3) * 16 + g, r_g8 = r_g + 8;  // < Ns' (whole tiles)
  const size_t p_g = static_cast<size_t>(b) * whole_tiles(ns) + r_g, p_g8 = p_g + 8;
  const float4 gd_g = rows[p_g], gd_g8 = rows[p_g8];  // (g, delta)
  const float nl_g = -lse[p_g] * kLog2e, nl_g8 = -lse[p_g8] * kLog2e;
  const size_t i_g = static_cast<size_t>(b) * ns + r_g, i_g8 = i_g + 8;

  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

  mbar_wait(sm.own_full, 0);
  for (int t = 0; t < whole_tiles(nt) / kTile; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const bf16* tile = sm.tile(s);
    const float4* kv = sm.vals4(s) + 32 * wg;  // the own columns' keys: x, y, z, |f|^2
    float sc[16];
    own_scores(sc, sm, tile, wg);
    uint32_t dsa[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v_g[2], v_g8[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 f = kv[8 * k + 2 * qd + c];
        const float nb = -f.w * kLog2e;
        const float p = exp2f(fmaf(sc[4 * k + c], 2.f * kLog2e, nb + nl_g));
        const float p8 = exp2f(fmaf(sc[4 * k + 2 + c], 2.f * kLog2e, nb + nl_g8));
        const float dp = gd_g.x * f.x + gd_g.y * f.y + gd_g.z * f.z;
        const float dp8 = gd_g8.x * f.x + gd_g8.y * f.y + gd_g8.z * f.z;
        v_g[c] = p * (dp - gd_g.w);
        v_g8[c] = p8 * (dp8 - gd_g8.w);
      }
      dsa[2 * k] = pack_bf16(v_g[0], v_g[1]);
      dsa[2 * k + 1] = pack_bf16(v_g8[0], v_g8[1]);
    }
    accumulate(acc0, acc1, dsa, sm, tile, wg);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }
  float* d_g = r_g < ns ? d_src + i_g * e : nullptr;
  float* d_g8 = r_g8 < ns ? d_src + i_g8 * e : nullptr;
  store_rows_f32(d_g, d_g8, acc0, 2.f, 256 * wg, e, qd);
  store_rows_f32(d_g, d_g8, acc1, 2.f, 256 * wg + 128, e, qd);
}

// acc -= cs * f over a thread's part of a [64, 128] accumulator: f the
// bf16 embedding rows f_g, f_g8 at columns col0 + 0..127 (below ``cols``)
__device__ __forceinline__ void subtract_colsum(float (&acc)[64], const bf16* f_g,
                                                const bf16* f_g8, float cs_g, float cs_g8,
                                                int col0, int cols, int q) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + 8 * j + 2 * q;
    if (c >= cols) continue;
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_g + c));
    const float2 a8 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_g8 + c));
    acc[4 * j] -= cs_g * a.x;
    acc[4 * j + 1] -= cs_g * a.y;
    acc[4 * j + 2] -= cs_g8 * a8.x;
    acc[4 * j + 3] -= cs_g8 * a8.y;
  }
}

// ---- d_tgt_emb / d_tgt consumers: the block owns target rows key0 .. key0 + 63
__device__ __forceinline__ void df_consumer(const Smem& sm, const float4* keys,
                                            const bf16* tgt_emb, float* d_tgt_emb, float* d_tgt,
                                            int ns, int nt, int e) {
  const int b = blockIdx.y, key0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, qd = lane & 3;
  const int tid = threadIdx.x & 127;
  const int r_g = key0 + (warp & 3) * 16 + g, r_g8 = r_g + 8;  // < Nt' (whole tiles)
  const size_t p_g = static_cast<size_t>(b) * whole_tiles(nt) + r_g;
  const float4 kv_g = keys[p_g], kv_g8 = keys[p_g + 8];  // x, y, z, |f|^2 (+inf past Nt)
  // rows past Nt are not stored: they read the item's row 0 of tgt_emb
  const size_t j_g = static_cast<size_t>(b) * nt + (r_g < nt ? r_g : 0);
  const size_t j_g8 = static_cast<size_t>(b) * nt + (r_g8 < nt ? r_g8 : 0);
  const float nb_g = -kv_g.w * kLog2e, nb_g8 = -kv_g8.w * kLog2e;
  // this lane's part, over the own columns, of colsum(ds) and dtgt of its
  // two rows: cs, tx, ty, tz of row g, then of row g + 8
  float st[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

  mbar_wait(sm.own_full, 0);
  for (int t = 0; t < whole_tiles(ns) / kTile; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const bf16* tile = sm.tile(s);
    const float4* sv = sm.vals4(s) + 32 * wg;  // the own columns' source rows: g, delta
    const float* sl = sm.vals1(s) + 32 * wg;   // and their lse
    float sc[16];  // S^T: rows = owned keys, columns = the tile's sources
    own_scores(sc, sm, tile, wg);
    uint32_t dsa[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat16 d_g[2], d_g8[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 8 * k + 2 * qd + c;
        const float4 gd = sv[i];
        const float nl = -sl[i] * kLog2e;
        const float p = exp2f(fmaf(sc[4 * k + c], 2.f * kLog2e, nb_g + nl));
        const float p8 = exp2f(fmaf(sc[4 * k + 2 + c], 2.f * kLog2e, nb_g8 + nl));
        const float dp = gd.x * kv_g.x + gd.y * kv_g.y + gd.z * kv_g.z;
        const float dp8 = gd.x * kv_g8.x + gd.y * kv_g8.y + gd.z * kv_g8.z;
        d_g[c] = __float2bfloat16_rn(p * (dp - gd.w));
        d_g8[c] = __float2bfloat16_rn(p8 * (dp8 - gd.w));
        const float pb = __bfloat162float(__float2bfloat16_rn(p));
        const float pb8 = __bfloat162float(__float2bfloat16_rn(p8));
        st[0] += __bfloat162float(d_g[c]);
        st[1] = fmaf(pb, gd.x, st[1]);
        st[2] = fmaf(pb, gd.y, st[2]);
        st[3] = fmaf(pb, gd.z, st[3]);
        st[4] += __bfloat162float(d_g8[c]);
        st[5] = fmaf(pb8, gd.x, st[5]);
        st[6] = fmaf(pb8, gd.y, st[6]);
        st[7] = fmaf(pb8, gd.z, st[7]);
      }
      const __nv_bfloat162 r = __halves2bfloat162(d_g[0], d_g[1]);
      const __nv_bfloat162 r8 = __halves2bfloat162(d_g8[0], d_g8[1]);
      dsa[2 * k] = *reinterpret_cast<const uint32_t*>(&r);
      dsa[2 * k + 1] = *reinterpret_cast<const uint32_t*>(&r8);
    }
    accumulate(acc0, acc1, dsa, sm, tile, wg);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  // the two warpgroups' parts of colsum and dtgt, added in warpgroup order
  // (the same bits in both); the score swap is free once both have passed
  // the last ds swap
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = quad_sum(st[i]);
  float4* swap = sm.score_swap;
  swap[(2 * wg) * 128 + tid] = make_float4(st[0], st[1], st[2], st[3]);
  swap[(2 * wg + 1) * 128 + tid] = make_float4(st[4], st[5], st[6], st[7]);
  named_bar_sync(kScoresSwapped, kConsumerThreads);
  const float4 a0 = swap[tid], a1 = swap[128 + tid], c0 = swap[256 + tid], c1 = swap[384 + tid];
  const float cs_g = a0.x + c0.x, cs_g8 = a1.x + c1.x;
  const bf16* f_g = tgt_emb + j_g * e;
  const bf16* f_g8 = tgt_emb + j_g8 * e;
  subtract_colsum(acc0, f_g, f_g8, cs_g, cs_g8, 256 * wg, e, qd);
  subtract_colsum(acc1, f_g, f_g8, cs_g, cs_g8, 256 * wg + 128, e, qd);
  float* d_g = r_g < nt ? d_tgt_emb + j_g * e : nullptr;
  float* d_g8 = r_g8 < nt ? d_tgt_emb + j_g8 * e : nullptr;
  store_rows_f32(d_g, d_g8, acc0, 2.f, 256 * wg, e, qd);
  store_rows_f32(d_g, d_g8, acc1, 2.f, 256 * wg + 128, e, qd);
  if (wg == 0 && qd == 0) {
    if (r_g < nt) {
      d_tgt[3 * j_g] = a0.y + c0.y;
      d_tgt[3 * j_g + 1] = a0.z + c0.z;
      d_tgt[3 * j_g + 2] = a0.w + c0.w;
    }
    if (r_g8 < nt) {
      d_tgt[3 * j_g8] = a1.y + c1.y;
      d_tgt[3 * j_g8 + 1] = a1.z + c1.z;
      d_tgt[3 * j_g8 + 2] = a1.w + c1.w;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
vcp_bwd_de_kernel(const __grid_constant__ CUtensorMap src_map,  // [B * Ns, E] bf16
                  const __grid_constant__ CUtensorMap tgt_map,  // [B * Nt, E] bf16
                  const float4* __restrict__ keys,              // [B, Nt']: x, y, z, |f|^2
                  const float4* __restrict__ rows,              // [B, Ns']: g, delta
                  const float* __restrict__ lse,                // [B, Ns']
                  float* __restrict__ d_src,                    // [B, Ns, E]
                  int ns, int nt, int e) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);  // own = the source rows; tiles = target tiles
  const int n_boxes = (e + kBox - 1) / kBox;
  setup(sm, n_boxes);
  if (threadIdx.x >= kConsumerThreads) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      const int b = blockIdx.y;
      produce(sm, &src_map, b * ns + blockIdx.x * kTile, &tgt_map, b * nt, whole_tiles(nt) / kTile,
              n_boxes, keys + static_cast<size_t>(b) * whole_tiles(nt), nullptr);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    de_consumer(sm, rows, lse, d_src, ns, nt, e);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
vcp_bwd_df_kernel(const __grid_constant__ CUtensorMap src_map,  // [B * Ns, E] bf16
                  const __grid_constant__ CUtensorMap tgt_map,  // [B * Nt, E] bf16
                  const bf16* __restrict__ tgt_emb,             // [B, Nt, E]
                  const float4* __restrict__ keys,              // [B, Nt']: x, y, z, |f|^2
                  const float4* __restrict__ rows,              // [B, Ns']: g, delta
                  const float* __restrict__ lse,                // [B, Ns']
                  float* __restrict__ d_tgt_emb,                // [B, Nt, E]
                  float* __restrict__ d_tgt,                    // [B, Nt, 3]
                  int ns, int nt, int e) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);  // own = the target rows; tiles = source tiles
  const int n_boxes = (e + kBox - 1) / kBox;
  setup(sm, n_boxes);
  if (threadIdx.x >= kConsumerThreads) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      const int b = blockIdx.y;
      const size_t r0 = static_cast<size_t>(b) * whole_tiles(ns);
      produce(sm, &tgt_map, b * nt + blockIdx.x * kTile, &src_map, b * ns, whole_tiles(ns) / kTile,
              n_boxes, rows + r0, lse + r0);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    df_consumer(sm, keys, tgt_emb, d_tgt_emb, d_tgt, ns, nt, e);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

}  // namespace

// src_emb/tgt_emb bf16 [B,N,E], tgt f32 [B,Nt,3], corr/dcorr f32 [B,Ns,3],
// lse f32 [B,Ns'] (+inf past Ns), scratch keys f32 [B,Nt',4] and rows f32
// [B,Ns',4] (Ns', Nt': Ns, Nt rounded up to 64) -> d_src f32 [B,Ns,E],
// d_tgt_emb f32 [B,Nt,E], d_tgt f32 [B,Nt,3]. Any Ns, Nt > 0; requires
// E % 16 == 0, E <= 512, 16-byte aligned pointers. Returns the launch
// status.
cudaError_t vcr_vcp_bwd(const void* src_emb, const void* tgt_emb, const float* tgt,
                        const float* corr, const float* dcorr, const float* lse, float* keys,
                        float* rows, float* d_src, float* d_tgt_emb, float* d_tgt, int batch,
                        int ns, int nt, int e, cudaStream_t stream) {
  if (ns < 1 || nt < 1 || e % 16 || e > vcr::vcp::kMaxE) return cudaErrorInvalidValue;
  CUtensorMap src_map, tgt_map;
  cudaError_t err = make_box_map(&src_map, src_emb, static_cast<uint64_t>(batch) * ns, e);
  if (err == cudaSuccess) err = make_box_map(&tgt_map, tgt_emb, static_cast<uint64_t>(batch) * nt, e);
  if (err == cudaSuccess) err = allow_smem(vcp_bwd_de_kernel);
  if (err == cudaSuccess) err = allow_smem(vcp_bwd_df_kernel);
  if (err == cudaSuccess)
    err = vcr::vcp::launch_keys(tgt_emb, tgt, keys, batch, nt, whole_tiles(nt), e, stream);
  if (err != cudaSuccess) return err;
  const int entries = batch * whole_tiles(ns);
  vcp_rows_kernel<<<(entries + 255) / 256, 256, 0, stream>>>(
      corr, dcorr, reinterpret_cast<float4*>(rows), ns, whole_tiles(ns), entries);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float4* k4 = reinterpret_cast<const float4*>(keys);
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  vcp_bwd_de_kernel<<<dim3(whole_tiles(ns) / kTile, batch), kThreads, kSmemBytes, stream>>>(
      src_map, tgt_map, k4, r4, lse, d_src, ns, nt, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vcp_bwd_df_kernel<<<dim3(whole_tiles(nt) / kTile, batch), kThreads, kSmemBytes, stream>>>(
      src_map, tgt_map, static_cast<const bf16*>(tgt_emb), k4, r4, lse, d_tgt_emb, d_tgt, ns, nt,
      e);
  return cudaGetLastError();
}

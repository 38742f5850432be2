// Backward of the LPDNet DG block (edge conv), routed by saved winners.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:_fused_edge_conv_bwd
// (-> _edge_conv_bwd_kernel). Per query point i with neighbours idx[i, :]:
//
//   z[j]   = act(a[idx[i, j]] + h[i])                 (recomputed, f32)
//   dp[c]  = ct2[i, c] * act'(x2[i, c])               (nonzero only at the
//                                                      winner row win2[i, c])
//   dz[j]  = [win1 == j] ct1[i] + bf16(dp)[j] @ W2^T  (f32)
//   dq[j]  = dz[j] * act'(z[j])
//   da[idx[i, j]] += bf16(dq[j]);  dh[i] = sum_j dq[j]
//   dW2   += z^T dp;  db2 += sum dp                   (over all 2B*N queries)
//
// act' is taken from the post-activation sign (1 where it is > 0, else the
// slope), as the Pallas kernel does. Bound on the H100: bytes, just: at
// k = 20, F = 128 a query moves about 2.6 KB once each, against about 43
// KFLOP in f32 (dW2's sum and the elementwise work) and 33 KFLOP of the dz
// product on the bf16 tensor cores. The TPU kernel built a
// [k*TQ, N] one-hot and ran the gathers, the two products and the scatter
// as matmuls, with da, dW2 and db2 carried across a sequential grid.
//
// Here a persistent grid of blocks (one an SM: 256 threads, two
// warpgroups) walks rounds of four queries; each warpgroup runs one m64
// tile of two queries (32 rows each, padded past k) through the whole
// chain, as the forward's edge phase does, with no barrier per query:
//   * loads run one round ahead, by cp.async into the warpgroup's staging:
//     the next round's k gathered rows of ``a`` a query (swizzled 256-byte
//     rows, as edge_tile.cuh's gather; padding rows are not loaded), its
//     rows of h, ct1, ct2, x2, win1, win2, and the neighbour lists of the
//     round after. Each thread takes its two rows' A fragments of ``a`` by
//     ldmatrix, recomputes z in f32, keeps act'(z) as 64 bits and stores z
//     to shared memory for dW2;
//   * dz on the tensor cores: bf16(dp) @ W2^T is dense wgmma m64n128k16 (8
//     k steps) with A the routed matrix packed in registers (row j, column
//     o holds bf16(dp_o) where win2_o == j, else 0) and B W2 staged once
//     per block as two [128, 64] swizzled regions read K-major (the
//     contraction runs over W2's output dimension, along its rows). Each
//     product of two bf16 values is exact in f32 and a zero adds nothing,
//     so this is the routed sum in another order. ct1 is added at x1's
//     winner row and act'(z) applied in the accumulator's registers;
//   * da: bf16(dq) scattered by vector reductions of four f32
//     (red.global.add.v4.f32): lanes q and q ^ 1 swap one row's pair so
//     that each holds four consecutive columns of one row (640 reductions
//     a query at k = 20, against 2560 scalar atomics). The additions into
//     one element land in an order that changes from run to run;
//   * dh: each thread adds its two rows and stores the sum; after the
//     round's barrier the 16 row pairs of a query's two warps are added in
//     order;
//   * dW2 and db2 stay on the CUDA cores in f32 (bf16 operands would miss
//     the 1e-4 tolerance, and a dense product of the routed matrix would do
//     32 times the work): thread (o, half) keeps dW2[64 half .. + 63][o] in
//     64 registers and adds z[win2[o]][c] * dp[o] from the round's z tiles
//     (stored by column, so a warp's reads of 32 rows of one column fall in
//     32 banks). At the end each block writes its
//     partial; a second kernel adds the partials in block order
//     (deterministic).
// What bounds it (timed on the H100 by leaving parts out, PERF.md): the
// tile chain, the vector reductions and dW2's shared-memory reads, in that
// order; not the tensor cores.
// Shared memory per block: W2 32768, the two z tiles 2 * 128 * 68 f32 =
// 69632, dh's partial rows 2 * 4 * 8 * 136 f32 = 34816, the round's dp and
// win2 2560, two warpgroups' staging 2 * (16384 + 2 * 2 * 1280 + 2 * 256) =
// 44032, plus 1024 bytes of alignment slack = 184832 bytes. Registers: dW2's
// 64, the accumulator's 64 and the A fragments' 32 within the 255 a thread
// of a one-block-an-SM launch may take (`-Xptxas -v`, which chip_smoke.py
// prints: 248, no spills).
#include <cstdint>

#include "common.cuh"
#include "edge_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace vcr::hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups
using vcr::edge::kF;     // edge-conv width (LPDNet convDG1/convDG2)
using vcr::edge::kRows;  // edge rows a query, padded (k <= 32)
using vcr::edge::kW2Bytes;
constexpr int kRound = 4;      // queries of a round: two tiles of two
// z is stored by column, [warpgroup][kF columns][kZStride], row r of a tile at
// offset r: dW2's lanes read one column of 32 different rows (one bank each),
// and the tile's stores (8 rows x 4 column pairs a warp) fall in 32 banks
constexpr int kZStride = 68;
constexpr int kPartial = kF * kF + kF;  // one block's dW2 then db2

constexpr uint32_t kZOff = kW2Bytes;
constexpr uint32_t kZBytes = 2 * kF * kZStride * sizeof(float);
constexpr uint32_t kDhOff = kZOff + kZBytes;
constexpr int kDhStride = 136;  // f32 a row of dh's partial sums (fewer bank conflicts)
constexpr uint32_t kDhBytes = 2 * 4 * 8 * kDhStride * sizeof(float);  // [wg][warp][g][kF]
constexpr uint32_t kDpOff = kDhOff + kDhBytes;  // the round's dp [4][kF] f32, then win2 [4][kF]
constexpr uint32_t kDpBytes = kRound * kF * (sizeof(float) + 1);
// each warpgroup's staging, filled by cp.async one round ahead: the gathered
// rows of a [64 slots][256 bytes] (as edge_tile.cuh's gather), two buffers
// of the two queries' rows of h, ct1, ct2, x2 (256 bytes each) and win1,
// win2 (128), and two buffers of their neighbour lists (kRows ints a query)
constexpr uint32_t kABytes = vcr::edge::kABufBytes;
constexpr uint32_t kQRowBytes = 4 * kF * sizeof(bf16) + 2 * kF;  // h, ct1, ct2, x2, win1, win2
constexpr uint32_t kIdxBytes = 2 * kRows * sizeof(int);           // the tile's two lists
constexpr uint32_t kStageBytes = kABytes + 2 * 2 * kQRowBytes + 2 * kIdxBytes;  // rows: two rounds
constexpr uint32_t kStageOff = (kDpOff + kDpBytes + 127) / 128 * 128;
constexpr size_t kSmemBytes = 1024 + kStageOff + 2 * kStageBytes;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// W2 [kF (in = c), kF (out = o)] into w2t as two [128, 64] swizzled regions,
// region kh = W2[:, 64 kh ..]: the K-major B operand of dp @ W2^T, whose
// contraction runs over o (cp.async; the caller commits and waits).
__device__ __forceinline__ void stage_w2_k(const bf16* __restrict__ w2, uint8_t* w2t) {
  for (int t = threadIdx.x; t < kF * kF / 8; t += kThreads) {
    const int c = t >> 4, cc = t & 15;
    cp_async16(w2t + (cc >> 3) * (kF * 64 * sizeof(bf16)) + sw128_offset(c, cc & 7),
               w2 + c * kF + cc * 8);
  }
}

// The warpgroup's staging (thread t of its 128): the rows of a, the queries'
// rows, the neighbour lists of two rounds.
struct Stage {
  uint8_t* base;
  __device__ uint8_t* a() const { return base; }
  __device__ uint8_t* rows(int m) const { return base + kABytes + (m & 1) * 2 * kQRowBytes; }
  __device__ int* idx(int m) const {
    return reinterpret_cast<int*>(base + kABytes + 4 * kQRowBytes) + (m & 1) * 2 * kRows;
  }
};

// cp.async of the neighbour lists of queries i0, i0 + 1 into ids.
__device__ __forceinline__ void stage_idx(int* ids, const int* __restrict__ idx, int i0, int k,
                                          int t) {
  for (int c = t; c < 2 * k; c += 128) {
    const int p = c >= k, r = c - p * k;
    cp_async4(ids + p * kRows + r, idx + static_cast<size_t>(i0 + p) * k + r);
  }
}

// cp.async of queries i0, i0 + 1's k gathered rows of a (from their lists
// ids, by edge_tile.cuh's gather) into abuf and of their rows of h, ct1,
// ct2, x2, win1, win2 into qrows.
__device__ __forceinline__ void stage_rows(uint8_t* abuf, uint8_t* qrows, const int* ids,
                                           const bf16* __restrict__ a, const bf16* __restrict__ h,
                                           const bf16* __restrict__ ct1, const bf16* __restrict__ ct2,
                                           const bf16* __restrict__ x2,
                                           const uint8_t* __restrict__ win1,
                                           const uint8_t* __restrict__ win2, int i0, int n, int k,
                                           int t) {
  vcr::edge::gather_tile(abuf, ids, 0, i0, n, k, a, t);
  for (int c = t; c < 2 * 80; c += 128) {  // 80 chunks of 16 bytes a query
    const int p = c >= 80, r = c - p * 80;
    const size_t e = static_cast<size_t>(i0 + p) * kF;
    uint8_t* dst = qrows + p * kQRowBytes;
    if (r < 64) {
      const bf16* src = r < 16 ? h : r < 32 ? ct1 : r < 48 ? ct2 : x2;
      cp_async16(dst + (r >> 4) * 256 + (r & 15) * 16, src + e + (r & 15) * 8);
    } else {
      const int r2 = r - 64;
      cp_async16(dst + 1024 + (r2 >> 3) * 128 + (r2 & 7) * 16,
                 (r2 < 8 ? win1 : win2) + e + (r2 & 7) * 16);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
edge_conv_bwd_kernel(const int* __restrict__ idx,        // [B, N, k]
                     const uint8_t* __restrict__ win1,   // [B, N, F]
                     const uint8_t* __restrict__ win2,   // [B, N, F]
                     const bf16* __restrict__ a,         // [B, N, F]
                     const bf16* __restrict__ h,         // [B, N, F]
                     const bf16* __restrict__ w2,        // [F, F] (in, out)
                     const bf16* __restrict__ x2,        // [B, N, F]
                     const bf16* __restrict__ ct1g,      // [B, N, F]
                     const bf16* __restrict__ ct2g,      // [B, N, F]
                     float* __restrict__ da,             // [B, N, F], zeroed
                     float* __restrict__ dh,             // [B, N, F]
                     float* __restrict__ partial,        // [grid, kPartial]
                     int rows, int n, int k, float slope) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  const bf16* w2t = reinterpret_cast<const bf16*>(base);
  float* zt = reinterpret_cast<float*>(base + kZOff);
  float* dhx = reinterpret_cast<float*>(base + kDhOff);
  float* dps = reinterpret_cast<float*>(base + kDpOff);
  uint8_t* win2s = base + kDpOff + kRound * kF * sizeof(float);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int half = warp >> 1;             // which query of the warpgroup's tile
  const int row_g = 16 * (warp & 1) + g;  // the thread's rows of it: row_g, row_g + 8
  const int row_g8 = row_g + 8;

  stage_w2_k(w2, base);
  cp_async_commit();

  // dW2[64 ch + c][o] for c < 64 and db2[o] (ch == 0)
  const int o = tid & (kF - 1), ch = tid >> 7;
  float accw[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) accw[c] = 0.f;
  float db = 0.f;
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int t128 = tid & 127;
  const Stage stage{base + kStageOff + wg * kStageBytes};
  const int rounds = rows / kRound;
  // the loads run one round ahead: round m's lists arrive with round m-1's
  // rows, and round m's rows while round m-1 is computed
  if (blockIdx.x < rounds) {
    stage_idx(stage.idx(0), idx, kRound * blockIdx.x + 2 * wg, k, t128);
    cp_async_commit();
    cp_async_wait<0>();
    named_bar_sync(1 + wg, 128);
    stage_rows(stage.a(), stage.rows(0), stage.idx(0), a, h, ct1g, ct2g, x2, win1, win2,
               kRound * blockIdx.x + 2 * wg, n, k, t128);
    if (blockIdx.x + gridDim.x < rounds)
      stage_idx(stage.idx(1), idx, kRound * (blockIdx.x + gridDim.x) + 2 * wg, k, t128);
    cp_async_commit();
  }
  int m = 0;
  for (int rnd = blockIdx.x; rnd < rounds; rnd += gridDim.x, ++m) {
    // ---- the warpgroup's tile: query i, rows row_g and row_g8 of it
    const int i = kRound * rnd + 2 * wg + half;
    const int cloud = i / n * n;
    cp_async_wait<0>();
    named_bar_sync(1 + wg, 128);  // round m's rows and round m + 1's lists are in
    const int* ids = stage.idx(m) + half * kRows;
    const int nb_g = ids[row_g < k ? row_g : 0];
    const int nb_g8 = ids[row_g8 < k ? row_g8 : 0];
    uint32_t araw[32];  // bf16 pairs of a in the A fragment layout
    vcr::edge::a_fragments(araw, stage.a(), k);
    named_bar_sync(1 + wg, 128);  // the rows of a and the lists of round m are read
    if (rnd + gridDim.x < rounds) {
      stage_rows(stage.a(), stage.rows(m + 1), stage.idx(m + 1), a, h, ct1g, ct2g, x2, win1,
                 win2, kRound * (rnd + gridDim.x) + 2 * wg, n, k, t128);
      if (rnd + 2 * gridDim.x < rounds)
        stage_idx(stage.idx(m), idx, kRound * (rnd + 2 * gridDim.x) + 2 * wg, k, t128);
    }
    cp_async_commit();

    const uint8_t* qr = stage.rows(m) + half * kQRowBytes;  // h, ct1, ct2, x2, win1, win2
    const uint32_t* hw = reinterpret_cast<const uint32_t*>(qr);
    const uint32_t* ct1w = reinterpret_cast<const uint32_t*>(qr + 256);
    const uint32_t* ct2w = reinterpret_cast<const uint32_t*>(qr + 512);
    const uint32_t* x2w = reinterpret_cast<const uint32_t*>(qr + 768);
    const unsigned short* win1w = reinterpret_cast<const unsigned short*>(qr + 1024);
    const unsigned short* win2w = reinterpret_cast<const unsigned short*>(qr + 1152);
    float* z_g = zt + wg * kF * kZStride + 16 * warp + g;  // column c at c * kZStride
    float* z_g8 = z_g + 8;
    uint64_t pos = 0;  // bit 4j + e: z > 0 at row g, column 8j + 2q + e; 4j + 2 + e: row g + 8
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 hv = unpack_bf16(hw[4 * j + q]);
      const float2 av = unpack_bf16(araw[4 * (j >> 1) + 2 * (j & 1)]);
      const float2 av8 = unpack_bf16(araw[4 * (j >> 1) + 2 * (j & 1) + 1]);
      const float2 z = make_float2(vcr::leaky(av.x + hv.x, slope), vcr::leaky(av.y + hv.y, slope));
      const float2 z8 =
          make_float2(vcr::leaky(av8.x + hv.x, slope), vcr::leaky(av8.y + hv.y, slope));
      z_g[(8 * j + 2 * q) * kZStride] = z.x;
      z_g[(8 * j + 2 * q + 1) * kZStride] = z.y;
      z_g8[(8 * j + 2 * q) * kZStride] = z8.x;
      z_g8[(8 * j + 2 * q + 1) * kZStride] = z8.y;
      pos |= static_cast<uint64_t>(z.x > 0.f) << (4 * j) |
             static_cast<uint64_t>(z.y > 0.f) << (4 * j + 1) |
             static_cast<uint64_t>(z8.x > 0.f) << (4 * j + 2) |
             static_cast<uint64_t>(z8.y > 0.f) << (4 * j + 3);
    }

    // the routed matrix: bf16(dp_o) at row win2_o, packed as A fragments
    // (register 2j: row g, columns 8j + 2q, + 1; 2j + 1: row g + 8)
    uint32_t fa[16], fb[16];
    const bf16 zero = __float2bfloat16_rn(0.f);
    const int qw = 2 * wg + half;  // the query's place in the round
    const bool warp_keeps_dp = (warp & 1) == 0 && g == 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int w = 4 * j + q;
      const float2 c2 = unpack_bf16(ct2w[w]);
      const float2 y2 = unpack_bf16(x2w[w]);
      const uint32_t wb = win2w[w];
      const float d0 = c2.x * (y2.x > 0.f ? 1.f : slope), d1 = c2.y * (y2.y > 0.f ? 1.f : slope);
      const bf16 p0 = __float2bfloat16_rn(d0);
      const bf16 p1 = __float2bfloat16_rn(d1);
      if (warp_keeps_dp) {  // for dW2 after the barrier
        *reinterpret_cast<float2*>(dps + qw * kF + 8 * j + 2 * q) = make_float2(d0, d1);
        *reinterpret_cast<unsigned short*>(win2s + qw * kF + 8 * j + 2 * q) =
            static_cast<unsigned short>(wb);
      }
      const int r0 = wb & 0xff, r1 = wb >> 8;
      const uint32_t lo = pack_raw(r0 == row_g ? p0 : zero, r1 == row_g ? p1 : zero);
      const uint32_t hi = pack_raw(r0 == row_g8 ? p0 : zero, r1 == row_g8 ? p1 : zero);
      if (j < 8) {
        fa[2 * j] = lo;
        fa[2 * j + 1] = hi;
      } else {
        fb[2 * j - 16] = lo;
        fb[2 * j - 15] = hi;
      }
    }
    float acc[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.f;
    fence_regs(fa);
    fence_regs(fb);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128_rs<0>(acc, fa[4 * kk], fa[4 * kk + 1], fa[4 * kk + 2], fa[4 * kk + 3],
                          desc_k_major_rows(w2t, kk, kF));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128_rs<0>(acc, fb[4 * kk], fb[4 * kk + 1], fb[4 * kk + 2], fb[4 * kk + 3],
                          desc_k_major_rows(w2t, kk + 4, kF));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // dz += ct1 at x1's winner row; dq = dz act'(z); da and dh from registers
    float* dhw = dhx + ((wg * 4 + warp) * 8 + g) * kDhStride;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int w = 4 * j + q;
      const float2 c1 = unpack_bf16(ct1w[w]);
      const uint32_t wb = win1w[w];
      const int r0 = wb & 0xff, r1 = wb >> 8;
      if (r0 == row_g) acc[4 * j] += c1.x;
      if (r1 == row_g) acc[4 * j + 1] += c1.y;
      if (r0 == row_g8) acc[4 * j + 2] += c1.x;
      if (r1 == row_g8) acc[4 * j + 3] += c1.y;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!((pos >> (4 * j + e)) & 1)) acc[4 * j + e] *= slope;

      const float d0 = round_bf16(acc[4 * j]), d1 = round_bf16(acc[4 * j + 1]);
      const float d2 = round_bf16(acc[4 * j + 2]), d3 = round_bf16(acc[4 * j + 3]);
      const bool even = (q & 1) == 0;
      const float sx = __shfl_xor_sync(vcr::kFullMask, even ? d2 : d0, 1);
      const float sy = __shfl_xor_sync(vcr::kFullMask, even ? d3 : d1, 1);
      const int row = even ? row_g : row_g8;
      if (row < k) {
        float* dst = da + static_cast<size_t>(cloud + (even ? nb_g : nb_g8)) * kF + 8 * j +
                     (even ? 2 * q : 2 * q - 2);
        if (even)
          red_add_v4(dst, d0, d1, sx, sy);
        else
          red_add_v4(dst, sx, sy, d2, d3);
      }
      *reinterpret_cast<float2*>(dhw + 8 * j + 2 * q) =
          make_float2(acc[4 * j] + acc[4 * j + 2], acc[4 * j + 1] + acc[4 * j + 3]);
    }
    __syncthreads();  // the round's z tiles and dh partials are in shared memory

    // ---- dW2, db2 over the round's four queries; dh of each
#pragma unroll 1
    for (int qi = 0; qi < kRound; ++qi) {
      const float dp = dps[qi * kF + o];
      const float* zc = zt + ((qi >> 1) * kF + 64 * ch) * kZStride + 32 * (qi & 1) +
                        win2s[qi * kF + o];  // row win2[o] of the query, column 64 ch
#pragma unroll
      for (int c = 0; c < 64; ++c) accw[c] = fmaf(zc[c * kZStride], dp, accw[c]);
      if (ch == 0) db += dp;
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int t = tid + kThreads * e2;
      const int qi = t >> 7, c = t & (kF - 1);
      const float* part = dhx + ((qi >> 1) * 4 + 2 * (qi & 1)) * 8 * kDhStride + c;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) sum += part[r * kDhStride];  // two warps' eight row pairs
      dh[static_cast<size_t>(kRound * rnd + qi) * kF + c] = sum;
    }
    __syncthreads();  // before the next round rewrites them
  }

  float* pb = partial + static_cast<size_t>(blockIdx.x) * kPartial;
#pragma unroll
  for (int c = 0; c < 64; ++c) pb[(64 * ch + c) * kF + o] = accw[c];
  if (ch == 0) pb[kF * kF + o] = db;
}

// dW2 and db2: the blocks' partial sums added in block order
__global__ void edge_conv_bwd_reduce_kernel(const float* __restrict__ partial, int blocks,
                                            float* __restrict__ dw2, float* __restrict__ db2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kPartial) return;
  float s = 0.f;
  for (int blk = 0; blk < blocks; ++blk) s += partial[static_cast<size_t>(blk) * kPartial + e];
  if (e < kF * kF)
    dw2[e] = s;
  else
    db2[e - kF * kF] = s;
}

}  // namespace

// The grid for `rows` = B*N queries on the current device: one block an SM
// (kSmemBytes of shared memory and 256 threads of up to 255 registers
// each), at most one per round of four queries -> blocks, and the f32
// scratch that vcr_edge_conv_bwd takes, blocks * (128*128+128) floats.
// Returns the query status.
cudaError_t vcr_edge_conv_bwd_grid(int rows, int* blocks, int64_t* scratch_floats) {
  cudaError_t err = cudaFuncSetAttribute(edge_conv_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_conv_bwd_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return err;
  const int rounds = rows / kRound;
  *blocks = per_sm * sms < rounds ? per_sm * sms : rounds;
  *scratch_floats = static_cast<int64_t>(*blocks) * kPartial;
  return *blocks < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// idx int32 [B,N,k], win1/win2 uint8 [B,N,128], a/h/x2/ct1/ct2 bf16 [B,N,128],
// w2 bf16 [128,128] (in, out) -> da f32 [B,N,128] (zeroed by the caller,
// added into), dh f32 [B,N,128], dw2 f32 [128,128], db2 f32 [128], on the
// grid and with the scratch `partial` that vcr_edge_conv_bwd_grid gave.
// Requires N % 16 == 0, 0 < k <= 32, every idx < N, win < k, 16-byte
// aligned pointers. Returns the launch status.
cudaError_t vcr_edge_conv_bwd(const int* idx, const void* win1, const void* win2,
                              const void* a, const void* h, const void* w2, const void* x2,
                              const void* ct1, const void* ct2, float* da, float* dh,
                              float* dw2, float* db2, float* partial, int blocks, int batch,
                              int n, int k, float slope, cudaStream_t stream) {
  if (k < 1 || k > kRows || n % 16 || blocks < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  edge_conv_bwd_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      idx, static_cast<const uint8_t*>(win1), static_cast<const uint8_t*>(win2),
      static_cast<const bf16*>(a), static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(x2), static_cast<const bf16*>(ct1), static_cast<const bf16*>(ct2),
      da, dh, partial, batch * n, n, k, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge_conv_bwd_reduce_kernel<<<(kPartial + 255) / 256, 256, 0, stream>>>(partial, blocks,
                                                                          dw2, db2);
  return cudaGetLastError();
}

// The pointer's dynamically quantized int8 projections by hand: one
// activation x [rows, K] through P = 1 to 3 (weight, bias) pairs,
//
//   out_p[rows, F_p] = bf16(((acc * xs[row]) * ws_p[col]) + bias_p[col]),
//   acc = sum_k xq[row, k] * wq_p[col, k]   (s8 x s8 -> s32)
//
// with xq, xs the per-row int8 codes and scales of x and wq_p, ws_p those
// of the weight [F_p, K] (nn.Linear's layout: one row an output channel),
// s = max|row| / 127 (at least 1e-30 / 127) and q = clip(round(v / s),
// -127, 127), round half to even.
//
// Replaces no Pallas kernel: the JAX package computes this in XLA, at
// vcrnet_tpu/ops/int8_linear.py:48 (int8_linear, an int8 dot_general into
// int32 between two quantization passes), behind Config.int8_eval; its
// self-attention gives q, k and v one input so that XLA quantizes it once
// (vcrnet_tpu/models/transformer.py:158-160). It is written here because
// PyTorch has no integer product on a CUDA tensor but torch._int_mm
// (cuBLASLt), and the card's tensor cores run s8 at twice the bf16 rate
// through wgmma ... .s32.s8.s8.
//
// Two kernels run for one call (one counted launch of the wrapper):
//   1. quantize_weights_kernel: one warp a weight row, over the rows of every
//      pair, the codes and scales written to int8 and f32 scratch [sum F_p,
//      K] and [sum F_p] (1.5 MB of bf16 read for q, k and v at 512);
//   2. projection_kernel, persistent: a block per SM walks over 128-row tiles
//      of x, and x's codes never leave shared memory. Three roles:
//      * the producer lane stages each tile's rows of x as bf16 in two slots
//        of 32 rows by bulk copies (TMA: no registers, a whole slot in
//        flight), and streams the weight codes of every 256-column tile of
//        every pair through a two-stage TMA ring;
//      * three quantizing warps (the producer warpgroup's others) take each
//        row's max |x|, its scale and its codes from the staging into the
//        tile of codes, in the K-major 128-byte swizzle that wgmma's
//        descriptor reads (chunk c of a 128-byte row at c ^ (row & 7)),
//        zeros past K and past ``rows``, and the scales beside it;
//      * two consumer warpgroups (64 rows each) run wgmma m64n256k32 s8
//        products of the resident codes against each weight slice into an
//        s32 accumulator, then the epilogue: the accumulator converted,
//        scaled by the row's and the column's scales, the bias added,
//        rounded to bf16 and stored through shared memory with TMA.
//      Once the consumers have multiplied a tile's last column tile they
//      release its codes, and the next tile's quantization (its first 32
//      rows staged while this tile's products ran) runs beside the last
//      epilogue. One buffer of codes (64 KB at K = 512) leaves room for the
//      staging; a second, to quantize during the products, would not.
//
// Numerics: the kernel equals the plain version (ops/int8_linear.py:
// int8_linear_ref, a pair at a time) bit for bit. The max is taken over the
// bf16 values; the scale fl(a / 127), the reciprocal fl(1 / s) and each
// quotient fl(v / s) are correctly rounded (row_quant and code below, held
// for every bf16 v under every bf16 row maximum by train/int8_parts.py),
// the code rounds half to even; the integer sums are exact in any order
// (|acc| <= 127^2 K < 2^24, so its conversion is exact too); the epilogue's
// products and sum are __fmul_rn / __fadd_rn, which nvcc does not contract
// into an fma (an fma moves the last f32 bit, and so one bf16 ulp). Build
// without --use_fast_math.
//
// Bound on the H100: bytes. At rows = 65536, K = F = 512 one projection must
// read 67.1 MB of bf16 activations and write 67.1 MB of bf16 output (0.040
// ms at 3.35 TB/s) against 34.4 G int8 operations (0.017 ms at 1,979 TOPS);
// q, k and v of one input read the same 67.1 MB and write 201 MB (0.080 ms;
// operations 0.052 ms). x is read once for all P projections and its codes
// stay on chip; what the design moves beyond the bound's bytes is the weight
// codes' rereads from L2 (a [256, K] tile for every 128 rows). What holds it
// from the bound (train/int8_parts.py, by builds with parts cut): the
// epilogue, which the tensor cores wait through, and the half of each
// tile's rows of x staged only once the quantization has begun.
//
// Shared memory (a block has 227 KB), K <= 512: codes 64 KB, staging 2 x 32
// KB, W ring 2 x 32 KB, the output staged in two passes of 128 columns
// (32 KB); K <= 1024 (a second instance): codes 128 KB, staging 2 x 8 KB
// (4 rows), W ring 64 KB, the output in four passes (16 KB).
// 384 threads, ~226 KB of shared memory, one block per SM.
#include "common.cuh"
#include "hopper.cuh"

namespace vcr {
namespace quant {
namespace {

using namespace vcr::hopper;
using bf16 = __nv_bfloat16;

constexpr int kMaxK = 1024;   // the widest row held on chip (two instances, see Tiling)
constexpr int kMaxPairs = 3;  // projections of one input
constexpr int kChunk = 8;     // bf16 values in a 16-byte load, int8 codes in an 8-byte store
constexpr int kRowChunks = kMaxK / kChunk / 32;  // a lane's chunks of one row

// v + kRound rounds v (|v| < 2^22) to an integer, half to even, and leaves
// it in the low bits of the sum's bit pattern (0x4B400000 + v).
constexpr float kRound = 12582912.f;  // 1.5 * 2^23

__device__ __forceinline__ uint32_t abs_max2(uint32_t a, uint32_t b) {  // of bf16 pairs
  a &= 0x7fff7fffu;
  b &= 0x7fff7fffu;
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// max |v| over a chunk's 8 bf16 values, as a bf16 pair.
__device__ __forceinline__ uint32_t amax8(const uint4 v) {
  return abs_max2(abs_max2(v.x, v.y), abs_max2(v.z, v.w));
}

// A lane's bf16 pair of maxima -> the row's max |x| over the warp.
__device__ __forceinline__ float warp_max(uint32_t pair) {
  const float2 p = unpack_bf16(pair);
  float m = fmaxf(p.x, p.y);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  return m;
}

// A row's scale s = fl(max(amax, 1e-30) / 127) and what its codes take.
// A code is round(fl(v / s)), the quotient correctly rounded by Markstein's
// step (IBM J. Res. Dev. 34(1), 1990): with inv = fl(1 / s) and q0 =
// fl(v inv), within an ulp of v / s, the remainder e = v - s q0 is exact in
// one fma and fl(q0 + e inv) is the correctly rounded quotient. The
// remainder is exact only while it is a normal number, so rows with a scale
// below 2^-64 take v and s times 2^64 (an exact scaling, which leaves the
// quotient as it is) and inv over 2^64. train/int8_parts.py holds the codes
// equal to __fdiv_rn's for every bf16 v under every bf16 row maximum.
struct RowQuant {
  float s;     // the scale
  float sc;    // 1, or 2^64 for a tiny scale
  float s_sc;  // s * sc
  float inv;   // fl(1 / s)
  float inv_sc;  // inv / sc
};

constexpr float kInv127 = 1.f / 127.f;  // fl(1 / 127)

__device__ __forceinline__ RowQuant row_quant(float amax) {
  RowQuant q;
  const float a = fmaxf(amax, 1e-30f);
  const float q0 = __fmul_rn(a, kInv127);
  q.s = fmaf(fmaf(-127.f, q0, a), kInv127, q0);  // fl(a / 127), Markstein's step again
  float y;  // 1 / s within an ulp, then one Newton step: fl(1 / s)
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(q.s));
  q.inv = fmaf(fmaf(-q.s, y, 1.f), y, y);
  const bool tiny = q.s < 0x1p-64f;
  q.sc = tiny ? 0x1p64f : 1.f;
  q.s_sc = __fmul_rn(q.s, q.sc);
  q.inv_sc = tiny ? __fmul_rn(q.inv, 0x1p-64f) : q.inv;
  return q;
}

// clip(round(v / s), -127, 127), half to even, in the low byte. The clip is
// never needed: |v| <= max|x| gives |fl(v / s)| <= 127 (1 + 2^-23).
__device__ __forceinline__ uint32_t code(float v, const RowQuant& q) {
  const float q0 = __fmul_rn(v, q.inv);
  const float e = fmaf(-q.s_sc, q0, __fmul_rn(v, q.sc));
  return __float_as_uint(__fadd_rn(fmaf(e, q.inv_sc, q0), kRound));
}

// Four words' low bytes, the first lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The 8 codes of a chunk of bf16 values, the first in the lowest byte.
__device__ __forceinline__ uint2 codes8(const uint4 v, const RowQuant& q) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t c[kChunk];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack_bf16(w[i]);
    c[2 * i] = code(p.x, q);
    c[2 * i + 1] = code(p.y, q);
  }
  return make_uint2(pack4(c[0], c[1], c[2], c[3]), pack4(c[4], c[5], c[6], c[7]));
}

// ---------------------------------------------------------------- pass 1

constexpr int kWeightWarps = 8;  // weight rows a block

struct WeightRows {
  const bf16* w[kMaxPairs];
  int row0[kMaxPairs + 1];  // the first code row of each pair; row0[pairs] = sum F_p
  int pairs;
};

__global__ void __launch_bounds__(32 * kWeightWarps)
quantize_weights_kernel(const __grid_constant__ WeightRows src, int8_t* __restrict__ wq,
                        float* __restrict__ ws, int k) {
  const int r = blockIdx.x * kWeightWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= src.row0[src.pairs]) return;
  int p = 0;
  while (p + 1 < src.pairs && r >= src.row0[p + 1]) ++p;
  const uint4* row =
      reinterpret_cast<const uint4*>(src.w[p] + static_cast<size_t>(r - src.row0[p]) * k);
  uint2* dst = reinterpret_cast<uint2*>(wq + static_cast<size_t>(r) * k);
  const int chunks = k / kChunk;
  uint4 v[kRowChunks];
  uint32_t amax = 0;
#pragma unroll
  for (int i = 0; i < kRowChunks; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < chunks ? row[c] : make_uint4(0, 0, 0, 0);
    amax = abs_max2(amax, amax8(v[i]));
  }
  const RowQuant q = row_quant(warp_max(amax));
  if (lane == 0) ws[r] = q.s;
#pragma unroll
  for (int i = 0; i < kRowChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) dst[c] = codes8(v[i], q);
  }
}

// ---------------------------------------------------------------- pass 2

constexpr int kConsumers = 2;  // warpgroups, 64 rows each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kQuantWarps = 3;  // the producer warpgroup's other warps quantize x
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 80;   // setmaxnreg: the producer warpgroup gives back,
constexpr int kConsumerRegs = 208;  // the consumers take
constexpr int kTileM = 64 * kConsumers;
constexpr int kTileN = 256;                            // output columns of one product
constexpr int kSlice = 128;                            // codes a slice: 128 bytes a row
constexpr uint32_t kCodeBoxBytes = 64 * kSlice;        // [64 rows, 128 codes]
constexpr uint32_t kSliceBytes = kConsumers * kCodeBoxBytes;      // [128 rows, 128] of x
constexpr uint32_t kStageBytes = (kTileN / 64) * kCodeBoxBytes;   // [256 rows, 128] of W
constexpr int kStages = 2;                             // of the W ring

template <bool kWide>
struct Tiling {
  static constexpr int kSlices = kWide ? kMaxK / kSlice : kMaxK / kSlice / 2;  // K <= 1024 or 512
  static constexpr int kLaneChunks = kSlices / 2;  // a lane's 16-byte chunks of a row of x
  static constexpr int kXRows = kWide ? 4 : 32;    // rows of x a staging slot holds
  static constexpr int kRounds = kTileM / kXRows;  // staging slots a tile
  static constexpr int kQRows = kWide ? 2 : 4;     // rows a quantizing warp takes at once
  static constexpr int kOutPasses = kWide ? 4 : 2;  // the output tile staged in passes
  static constexpr int kPassCols = kTileN / kOutPasses;
  static constexpr uint32_t kABytes = kSlices * kSliceBytes;
  static constexpr uint32_t kXSlotBytes = kXRows * kSlices * kSlice * sizeof(bf16);
  static constexpr uint32_t kOutBytes = kConsumers * 64 * kPassCols * sizeof(bf16);
  static constexpr size_t kSmemBytes = 1024 + kABytes + 2 * kXSlotBytes + kStages * kStageBytes +
                                       kOutBytes + kTileM * sizeof(float) + (2 * kStages + 6) * 8;
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

struct Params {
  CUtensorMap w;               // the weight codes [sum F_p, K] int8, boxes [64, 128]
  CUtensorMap out[kMaxPairs];  // [rows, F_p] bf16, boxes [64, 64]
  const bf16* x;               // [rows, K]
  const bf16* bias[kMaxPairs];  // [F_p]
  const float* ws;             // [sum F_p]
  float* xs;                   // [rows]: the row scales, or null
  int w_row0[kMaxPairs];       // the first code row of each pair
  int f[kMaxPairs];
  int pairs, rows, k;
};

struct Smem {
  uint8_t* a;        // [slice]{box wg 0, box wg 1}: the codes of x
  uint8_t* x;        // [2 slots]{kXRows rows of x, bf16}: the staging of the next codes
  uint8_t* ring;     // [stage]{4 boxes of W rows}
  uint8_t* out;      // [consumer]{a pass's boxes}
  float* xs;         // [128]: the row scales of the codes
  uint64_t* full;    // [stage] W
  uint64_t* empty;
  uint64_t* x_full;  // [slot]
  uint64_t* x_empty;
  uint64_t* a_full;  // the codes of a tile are written
  uint64_t* a_free;  // the products have read them
};

// bf16(((acc * xs) * ws) + bias): correctly rounded products and sum.
__device__ __forceinline__ float dequant(int acc, float row_scale, float col_scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), row_scale), col_scale), bias);
}

// The producer lane. The staging of x: round R of the block's tiles (tile R /
// kRounds, its rows kXRows (R % kRounds) on) into slot R % 2 by one bulk copy;
// rows past prm.rows are not copied.
template <bool kWide>
__device__ __forceinline__ void stage_x(const Params& prm, const Smem& sm, int round) {
  using T = Tiling<kWide>;
  const int slot = round & 1;
  if (round >= 2) mbar_wait(&sm.x_empty[slot], ((round >> 1) & 1) ^ 1);
  const int t = blockIdx.x + round / T::kRounds * gridDim.x;
  const int row0 = t * kTileM + (round % T::kRounds) * T::kXRows;
  const int n = max(0, min(T::kXRows, prm.rows - row0));
  const uint32_t bytes = n * prm.k * sizeof(bf16);
  mbar_expect_tx(&sm.x_full[slot], bytes);
  if (bytes)
    bulk_load(sm.x + slot * T::kXSlotBytes, prm.x + static_cast<size_t>(row0) * prm.k, bytes,
              &sm.x_full[slot]);
}

// The producer lane: every tile's rows of x into the staging, and the weight
// codes of every column tile of every pair, slice by slice, through the W
// ring. The next tile's first two rounds of x are staged once a tile's first
// slices are under way (their slots were freed by this tile's
// quantization), the others as the next quantization frees their slots.
template <bool kWide>
__device__ __forceinline__ void produce(const Params& prm, const Smem& sm, int row_tiles,
                                        int k_slices) {
  using T = Tiling<kWide>;
  int round = 0;
  for (; round < T::kRounds; ++round) stage_x<kWide>(prm, sm, round);
  int it = 0;  // slices issued, over all tiles: the ring's position
  for (int t = blockIdx.x; t < row_tiles; t += gridDim.x) {
    const bool next = t + gridDim.x < row_tiles;
    int early = next ? 2 : 0;  // of the next tile's rounds, still to stage
    int w = 0;                 // this tile's slices issued
    for (int p = 0; p < prm.pairs; ++p)
      for (int col0 = 0; col0 < prm.f[p]; col0 += kTileN)
        for (int kb = 0; kb < k_slices; ++kb, ++it, ++w) {
          if (w == kStages)
            for (; early > 0; --early, ++round) stage_x<kWide>(prm, sm, round);
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = sm.ring + s * kStageBytes;
          mbar_expect_tx(&sm.full[s], kStageBytes);
          // rows past F_p are the next pair's (or zeros past the last): they
          // meet output columns that are not stored
          for (int c = 0; c < kTileN / 64; ++c)
            tma_load_box(st + c * kCodeBoxBytes, &prm.w, &sm.full[s], kb * kSlice,
                         prm.w_row0[p] + col0 + c * 64);
        }
    for (; early > 0; --early, ++round) stage_x<kWide>(prm, sm, round);
    for (int j = 2; j < T::kRounds && next; ++j, ++round) stage_x<kWide>(prm, sm, round);
  }
}

// A quantizing warp: kQRows rows of a staging slot, its rows r0 .. (row
// ``row`` of x, ``tr`` of the tile on), into codes in every slice of the
// codes buffer and scales in sm.xs (and prm.xs where asked). Chunks past K
// and rows past prm.rows are zeros, whose codes are zeros.
template <bool kWide>
__device__ __forceinline__ void quantize_rows(const Params& prm, const Smem& sm,
                                              const uint8_t* slot, int r0, int row, int tr,
                                              int lane) {
  using T = Tiling<kWide>;
  constexpr int kLC = T::kLaneChunks;
  const int chunks = prm.k / kChunk;
  const int slice_chunks = (prm.k + kSlice - 1) / kSlice * (kSlice / kChunk);
  uint4 v[T::kQRows][kLC];
#pragma unroll
  for (int r = 0; r < T::kQRows; ++r) {
    const bool valid = row + r < prm.rows;
    const uint4* src = reinterpret_cast<const uint4*>(slot + (r0 + r) * prm.k * sizeof(bf16));
#pragma unroll
    for (int i = 0; i < kLC; ++i) {
      const int c = lane + 32 * i;
      v[r][i] = valid && c < chunks ? src[c] : make_uint4(0, 0, 0, 0);
    }
  }
  RowQuant q[T::kQRows];
#pragma unroll
  for (int r = 0; r < T::kQRows; ++r) {
    uint32_t pair = 0;
#pragma unroll
    for (int i = 0; i < kLC; ++i) pair = abs_max2(pair, amax8(v[r][i]));
    q[r] = row_quant(warp_max(pair));
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < T::kQRows; ++r) {
      const bool valid = row + r < prm.rows;
      sm.xs[tr + r] = valid ? q[r].s : 0.f;
      if (valid && prm.xs != nullptr) prm.xs[row + r] = q[r].s;
    }
  }
#pragma unroll
  for (int r = 0; r < T::kQRows; ++r) {
    // row tr + r: row (tr + r) % 64 of warpgroup (tr + r) / 64's box of each slice
    uint8_t* box = sm.a + (tr + r) / 64 * kCodeBoxBytes;
    const int br = (tr + r) % 64;
#pragma unroll
    for (int i = 0; i < kLC; ++i) {
      const int ci = lane + 32 * i;  // codes 8 ci .. 8 ci + 7: slice ci / 16, byte 8 (ci % 16)
      if (ci < slice_chunks)
        *reinterpret_cast<uint2*>(box + (ci >> 4) * kSliceBytes + sw128_offset(br, (ci & 15) >> 1) +
                                  8 * (ci & 1)) = codes8(v[r][i], q[r]);
    }
  }
}

// A quantizing warp: for each tile, once the products have read the last
// tile's codes, its share of each staging slot's rows into the codes.
template <bool kWide>
__device__ __forceinline__ void quantize(const Params& prm, const Smem& sm, int row_tiles) {
  using T = Tiling<kWide>;
  const int qw = (threadIdx.x >> 5) - kConsumerWarps - 1, lane = threadIdx.x & 31;
  int round = 0;
  for (int t = blockIdx.x, n = 0; t < row_tiles; t += gridDim.x, ++n) {
    mbar_wait(sm.a_free, (n & 1) ^ 1);  // the last tile's products are done
    for (int j = 0; j < T::kRounds; ++j, ++round) {
      const int slot = round & 1;
      mbar_wait(&sm.x_full[slot], (round >> 1) & 1);
      const int tr0 = j * T::kXRows;  // the slot's first row in the tile
      for (int r0 = qw * T::kQRows; r0 < T::kXRows; r0 += kQuantWarps * T::kQRows)
        quantize_rows<kWide>(prm, sm, sm.x + slot * T::kXSlotBytes, r0, t * kTileM + tr0 + r0,
                             tr0 + r0, lane);
      fence_proxy_async();  // the slot is refilled by a bulk copy
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.x_empty[slot]);
    }
    fence_proxy_async();  // the codes are read by wgmma
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.a_full);
  }
}

// A consumer warpgroup: its 64 rows of each row tile against the weight
// codes of every column tile of every pair, and the epilogue. Once the last
// column tile's products are done the codes are released for the next tile,
// whose quantization runs beside the last epilogue.
template <bool kWide>
__device__ __forceinline__ void consume(const Params& prm, const Smem& sm, int row_tiles,
                                        int k_slices) {
  using T = Tiling<kWide>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, qd = lane & 3;
  const bool storer = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  uint8_t* tile_s = sm.out + wg * (T::kOutBytes / kConsumers);
  const uint8_t* a_wg = sm.a + wg * kCodeBoxBytes;
  const int r_g = wq * 16 + g;  // this lane's rows r_g, r_g + 8 of the 64
  int it = 0;
  for (int t = blockIdx.x, n = 0; t < row_tiles; t += gridDim.x, ++n) {
    const int row0 = t * kTileM + wg * 64;  // the warpgroup's first row
    mbar_wait(sm.a_full, n & 1);
    const float rs_a = sm.xs[wg * 64 + r_g], rs_b = sm.xs[wg * 64 + r_g + 8];
    for (int p = 0; p < prm.pairs; ++p) {
      const int f = prm.f[p];
      for (int col0 = 0; col0 < f; col0 += kTileN) {
        int acc[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0;
        fence_regs(acc);
        for (int kb = 0; kb < k_slices; ++kb, ++it) {
          const int s = it % kStages;
          mbar_wait(&sm.full[s], (it / kStages) & 1);
          const uint8_t* a = a_wg + kb * kSliceBytes;
          const uint8_t* w = sm.ring + s * kStageBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n256k32_s8(acc, desc_sw128(a + 32 * kk, 0, 1024),
                                desc_sw128(w + 32 * kk, 0, 1024), 1);
          wgmma_commit();
          wgmma_wait<1>();  // the previous slice's products are done
          if (kb > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % kStages]);
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&sm.empty[(it - 1) % kStages]);
          if (p == prm.pairs - 1 && col0 + kTileN >= f) mbar_arrive(sm.a_free);  // the last
        }

        const bf16* bias = prm.bias[p];
        const float* ws = prm.ws + prm.w_row0[p];
#pragma unroll
        for (int pass = 0; pass < T::kOutPasses; ++pass) {
          if (storer) bulk_wait_read<0>();  // the last stores have read tile_s
          named_bar_sync(1 + wg, 128);
#pragma unroll
          for (int jj = 0; jj < T::kPassCols / 8; ++jj) {
            const int a = 4 * (pass * (T::kPassCols / 8) + jj);  // this pair's place in acc
            const int c = col0 + pass * T::kPassCols + 8 * jj + 2 * qd;
            float2 b = make_float2(0.f, 0.f), cs = make_float2(0.f, 0.f);
            if (c < f) {
              b = unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + c));
              cs = *reinterpret_cast<const float2*>(ws + c);
            }
            uint8_t* box = tile_s + (jj >> 3) * kBoxBytes + 4 * qd;
            *reinterpret_cast<uint32_t*>(box + sw128_offset(r_g, jj & 7)) =
                pack_bf16(dequant(acc[a], rs_a, cs.x, b.x), dequant(acc[a + 1], rs_a, cs.y, b.y));
            *reinterpret_cast<uint32_t*>(box + sw128_offset(r_g + 8, jj & 7)) =
                pack_bf16(dequant(acc[a + 2], rs_b, cs.x, b.x),
                          dequant(acc[a + 3], rs_b, cs.y, b.y));
          }
          fence_proxy_async();  // the boxes are read by TMA
          named_bar_sync(1 + wg, 128);
          if (storer && row0 < prm.rows) {
            const int c0 = col0 + pass * T::kPassCols;
            for (int bx = 0; bx < T::kPassCols / kBox && c0 + bx * kBox < f; ++bx)
              tma_store_box(&prm.out[p], tile_s + bx * kBoxBytes, c0 + bx * kBox, row0);
            bulk_commit();
          }
        }
      }
    }
  }
  if (storer) bulk_wait<0>();  // the shared memory stays until the stores are done
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
projection_kernel(const __grid_constant__ Params prm, int row_tiles) {
  using T = Tiling<kWide>;
  extern __shared__ uint8_t smem_raw[];
  Smem sm;
  sm.a = align_1024(smem_raw);
  sm.x = sm.a + T::kABytes;
  sm.ring = sm.x + 2 * T::kXSlotBytes;
  sm.out = sm.ring + kStages * kStageBytes;
  sm.xs = reinterpret_cast<float*>(sm.out + T::kOutBytes);
  sm.full = reinterpret_cast<uint64_t*>(sm.xs + kTileM);
  sm.empty = sm.full + kStages;
  sm.x_full = sm.empty + kStages;
  sm.x_empty = sm.x_full + 2;
  sm.a_full = sm.x_empty + 2;
  sm.a_free = sm.a_full + 1;
  const int k_slices = (prm.k + kSlice - 1) / kSlice;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.x_full[s], 1);
      mbar_init(&sm.x_empty[s], kQuantWarps);  // lane 0 of every quantizing warp
    }
    mbar_init(sm.a_full, kQuantWarps);
    mbar_init(sm.a_free, kConsumerWarps);
    mbar_init_fence();
  }
  __syncthreads();

  // the roles split once, in one if/else that never rejoins (setmaxnreg)
  if (threadIdx.x >= 32 * kConsumerWarps) {  // ---- the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 32 * kConsumerWarps)
      produce<kWide>(prm, sm, row_tiles, k_slices);
    else if (threadIdx.x >= 32 * (kConsumerWarps + 1))
      quantize<kWide>(prm, sm, row_tiles);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<kWide>(prm, sm, row_tiles, k_slices);
  }
}

int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return count;
}

template <bool kWide>
cudaError_t launch_projections(const Params& prm, cudaStream_t stream) {
  constexpr size_t smem = Tiling<kWide>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      projection_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int row_tiles = (prm.rows + kTileM - 1) / kTileM;
  const int grid = row_tiles < sm_count() ? row_tiles : sm_count();
  projection_kernel<kWide><<<grid, kThreads, smem, stream>>>(prm, row_tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace quant
}  // namespace vcr

// x bf16 [rows, K] through ``pairs`` (1..3) pairs of w[p] bf16 [f[p], K] and
// bias[p] bf16 [f[p]] into out[p] bf16 [rows, f[p]]; scratch wq int8
// [sum f, K] and ws f32 [sum f] (the weight codes and scales, left for the
// caller to read) and, unless null, xs f32 [rows] (the row scales). Requires
// K % 64 == 0 and K <= 1024, f[p] % 64 == 0 and f[p] <= 1024, rows >= 1,
// 16-byte aligned pointers. Returns the launch status.
cudaError_t vcr_int8_linear(const void* x, int rows, int k, int pairs, const void* const* w,
                            const void* const* bias, void* const* out, const int* f, void* wq,
                            float* ws, float* xs, cudaStream_t stream) {
  using namespace vcr::quant;
  if (k <= 0 || k > kMaxK || k % 64 || rows <= 0 || pairs < 1 || pairs > kMaxPairs)
    return cudaErrorInvalidValue;
  WeightRows src{};
  Params prm{};
  src.pairs = prm.pairs = pairs;
  for (int p = 0; p < pairs; ++p) {
    if (f[p] <= 0 || f[p] > kMaxK || f[p] % 64) return cudaErrorInvalidValue;
    src.w[p] = static_cast<const bf16*>(w[p]);
    src.row0[p + 1] = src.row0[p] + f[p];
    prm.w_row0[p] = src.row0[p];
    prm.f[p] = f[p];
    prm.bias[p] = static_cast<const bf16*>(bias[p]);
  }
  const int w_rows = src.row0[pairs];
  quantize_weights_kernel<<<(w_rows + kWeightWarps - 1) / kWeightWarps, 32 * kWeightWarps, 0,
                            stream>>>(src, static_cast<int8_t*>(wq), ws, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = vcr::hopper::make_box_map_s8(&prm.w, wq, w_rows, k);
  for (int p = 0; p < pairs && err == cudaSuccess; ++p)
    err = vcr::hopper::make_box_map(&prm.out[p], out[p], rows, f[p]);
  if (err != cudaSuccess) return err;
  prm.x = static_cast<const bf16*>(x);
  prm.ws = ws;
  prm.xs = xs;
  prm.rows = rows;
  prm.k = k;
  return k > kMaxK / 2 ? launch_projections<true>(prm, stream)
                       : launch_projections<false>(prm, stream);
}

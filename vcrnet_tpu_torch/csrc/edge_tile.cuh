// The DG block's edge phase on wgmma, shared by edge_conv.cu (which selects
// the neighbours itself) and edge_conv_from_idx.cu (which is given them):
// for each query i of a block and its kRows selected rows,
//
//   z_r   = act(a[sel[r]] + h[i])            (f32)
//   x1[i] = max_r z_r
//   x2[i] = max_r act(bf16(z_r) @ W2 + b2)   (f32 accumulation)
//
// with the first row winning ties (the winners, when asked for, are those
// rows: uint8 k-positions). A query's k <= 32 rows are padded to kRows = 32
// by repeating its first neighbour, which leaves both maxima and the
// winners unchanged (a padding row ties row 0 and comes after it).
//
// One warpgroup runs the phase on m64 tiles of two queries (warps 0-1 hold
// the first query's 32 rows, warps 2-3 the second's). Per tile:
//   * the tile's k real rows of ``a`` a query arrive by cp.async (16-byte
//     chunks) in a [64 slots, 256 bytes] buffer, chunk c of a slot stored
//     at c ^ (slot % 8) so that ldmatrix's eight rows fall in eight bank
//     groups; the next tile's rows are in flight while a tile is computed.
//     Padding rows are not loaded: their lanes hand ldmatrix the query's
//     first row. Eight ldmatrix .x4 give each thread its two rows' 32
//     columns in the wgmma A-fragment layout (rows g and g + 8 of its
//     warp, columns 8j + 2q, 8j + 2q + 1 for j < 16). An earlier version
//     gathered the same registers by 4-byte loads of global memory: the two
//     timed alike on the card (a throwaway harness); this one moves about
//     a third fewer bytes at k = 20 and overlaps the loads with the
//     products;
//   * each thread adds h and applies act in f32 and packs z to bf16x2: 32
//     registers, the A operand of the product;
//   * the product [64, 128] x [128, 128] is eight wgmma m64n128k16 steps
//     with W2 as the B operand, staged once per block in four swizzled
//     [64, 64] boxes and read MN-major (trans-b = 1), as O += P.V reads V
//     in flash_packed.cu; the f32 accumulator stays in registers;
//   * the epilogue (bias, act, max) works on the accumulator in registers:
//     each thread takes the larger of its rows g and g + 8, the eight lanes
//     of a column reduce by shuffles, and the two warps of a query meet in
//     a small shared-memory exchange, from which the block writes x1 and x2
//     row by row. Without winners the maxima are taken on bf16 pairs
//     (rounding keeps order, so the bf16 of the max is the max of the
//     bf16s); with winners, on the f32 values with their rows (the smaller
//     row on ties), x1's beside the product.
// Both kernels run this one device function on the same tiles, and a wgmma
// row depends only on its own A row, so they agree bit for bit on the same
// selection. Shared memory of the phase: W2 32768 bytes, the block's
// selections 8192, the exchange 18432 (two buffers), the gathered rows
// 16384.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vcr {
namespace edge {

using bf16 = __nv_bfloat16;

constexpr int kF = 128;       // edge-conv width (LPDNet convDG1/convDG2)
constexpr int kRows = 32;     // edge rows per query after padding (k <= 32)
constexpr int kTileQ = 64;    // queries of a block: 32 m64 tiles of two queries
constexpr int kThreads = 128; // one warpgroup
constexpr uint32_t kW2Bytes = kF * kF * sizeof(bf16);
constexpr uint32_t kSelBytes = kTileQ * kRows * sizeof(int);
// one exchange buffer: x1 and x2 maxima [4 warps][kF] f32, then their rows
// [4 warps][kF] uint8
constexpr uint32_t kRedBufBytes = 2 * 4 * kF * sizeof(float) + 2 * 4 * kF;
constexpr uint32_t kRedBytes = 2 * kRedBufBytes;
constexpr uint32_t kABufBytes = 2 * kRows * kF * sizeof(bf16);  // a tile's gathered rows

// The block copies W2 [kF (in), kF (out)] into w2s (1024-byte aligned) as
// four 128-byte-swizzled boxes, box (kh, nh) = W2[64 kh.., 64 nh..] at
// (2 kh + nh) * 8 KB: the MN-major B operand of z @ W2. cp.async; the
// caller commits, waits and fences.
__device__ __forceinline__ void stage_w2_mn(const bf16* __restrict__ w2, bf16* w2s) {
  uint8_t* dst = reinterpret_cast<uint8_t*>(w2s);
  for (int t = threadIdx.x; t < kF * kF / 8; t += blockDim.x) {
    const int row = t >> 4, cc = t & 15;  // W2 row, 16-byte chunk of it
    const int box = (row >> 6) * 2 + (cc >> 3);
    hopper::cp_async16(dst + box * hopper::kBoxBytes + hopper::sw128_offset(row & 63, cc & 7),
                       w2 + row * kF + cc * 8);
  }
}

// b2's two values at the thread's columns 8j + 2q, 8j + 2q + 1 (j < 16), as
// packed bf16x2 words.
__device__ __forceinline__ void load_b2(const bf16* __restrict__ b2, uint32_t (&b2p)[16]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) b2p[j] = __ldg(reinterpret_cast<const uint32_t*>(b2) + 4 * j + q);
}

// (m, r) becomes the larger of (m, r) and (om, orow), ties to the smaller row.
__device__ __forceinline__ void keep_max(float& m, int& r, float om, int orow) {
  if (om > m || (om == m && orow < r)) {
    m = om;
    r = orow;
  }
}

// Per column held by the thread (v[4j + e] row g, v[4j + 2 + e] row g + 8),
// the max over the warp's 16 rows and its row (of the query), written by
// the lanes of g == 0 to vals/rows [kF] of this warp.
__device__ __forceinline__ void warp_column_max(const float (&v)[64], int row_g, float* vals,
                                                uint8_t* rows) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m = v[4 * j + e];
      int r = row_g;
      keep_max(m, r, v[4 * j + 2 + e], row_g + 8);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        keep_max(m, r, __shfl_xor_sync(kFullMask, m, off), __shfl_xor_sync(kFullMask, r, off));
      if (lane < 4) {
        vals[8 * j + 2 * q + e] = m;
        rows[8 * j + 2 * q + e] = static_cast<uint8_t>(r);
      }
    }
}

__device__ __forceinline__ uint32_t hmax2_u32(uint32_t x, uint32_t y) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                   *reinterpret_cast<const __nv_bfloat162*>(&y));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// The same without winners, on bf16: rounding to bf16 keeps order, so the
// bf16 of the max is the max of the bf16s. v[2j] holds row g's columns
// 8j + 2q, + 1 as a bf16 pair, v[2j + 1] row g + 8's; the lanes of g == 0
// write the warp's pairs to vals [kF / 2] (word 4j + q).
__device__ __forceinline__ void warp_column_max_bf16(const uint32_t (&v)[32], uint32_t* vals) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint32_t m = hmax2_u32(v[2 * j], v[2 * j + 1]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) m = hmax2_u32(m, __shfl_xor_sync(kFullMask, m, off));
    if (lane < 4) vals[4 * j + q] = m;
  }
}

// The tile's gathered rows of ``a``: cp.async of each query's k real rows
// (16 chunks of 16 bytes each) into abuf [64 slots][256 bytes], slot
// 32 p + r for row r of the tile's query p (flat row row0 + q0 + p, its
// list at sel[(q0 + p) * kRows]), chunk c of a slot at c ^ (slot % 8) so
// that ldmatrix's eight rows fall in eight bank groups. Padding rows are
// not loaded: a_fragments reads slot 32 p for them. ``t`` is the thread's
// index in its warpgroup. The caller commits.
__device__ __forceinline__ void gather_tile(uint8_t* abuf, const int* sel, int q0, int row0,
                                            int n, int k, const bf16* __restrict__ a, int t) {
  const int per_query = k * 16;
  for (int c = t; c < 2 * per_query; c += kThreads) {
    const int p = c >= per_query, rem = c - p * per_query;
    const int r = rem >> 4, ch = rem & 15;
    const int i = row0 + q0 + p;
    const int slot = 32 * p + r;
    hopper::cp_async16(abuf + slot * 256 + ((ch ^ (slot & 7)) << 4),
                       a + static_cast<size_t>(i / n * n + sel[(q0 + p) * kRows + r]) * kF + ch * 8);
  }
}

// The thread's A fragments of the gathered tile (eight ldmatrix .x4): k
// step kk in araw[4kk .. 4kk + 3], rows g and g + 8 of its warp, which
// holds rows 16 (warp % 2) .. + 15 of the tile's query warp / 2.
__device__ __forceinline__ void a_fragments(uint32_t (&araw)[32], const uint8_t* abuf, int k) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r = 16 * (warp & 1) + (lane & 15);
  const int slot = 32 * (warp >> 1) + (r < k ? r : 0);  // padding rows read the first row
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int ch = 2 * kk + (lane >> 4);
    hopper::ldmatrix_x4(*reinterpret_cast<uint32_t(*)[4]>(&araw[4 * kk]),
                        abuf + slot * 256 + ((ch ^ (slot & 7)) << 4));
  }
}

// The warpgroup (threads 0..127 of the block) runs the edge phase on
// n_tiles tiles of two queries: tile t holds the block's queries 2t and
// 2t + 1, flat rows row0 + 2t (+1) of [B*N], with their kRows selected
// rows sel[query * kRows ..] (shared memory, indices into the query's
// cloud of n rows; the first k are read). w2s is W2 staged by stage_w2_mn,
// b2p from load_b2, red kRedBytes and abuf kABufBytes of shared memory.
// Writes x1/x2 and, with kWinners, the winners (first row on ties, from f32
// comparisons); without, the maxima are taken on bf16 pairs, which gives
// the same x1 and x2. The next tile's rows are gathered while a tile is
// computed.
template <bool kWinners>
__device__ __forceinline__ void edge_rows(const int* sel, int n_tiles, int row0, int n, int k,
                                          const bf16* __restrict__ a, const bf16* __restrict__ h,
                                          const bf16* w2s, const uint32_t (&b2p)[16],
                                          bf16* __restrict__ x1, bf16* __restrict__ x2,
                                          uint8_t* __restrict__ win1, uint8_t* __restrict__ win2,
                                          uint8_t* red, uint8_t* abuf, float slope) {
  using namespace hopper;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int half = warp >> 1;                 // which query of the tile
  const int row_g = 16 * (warp & 1) + g;      // the thread's rows of that query: row_g, row_g + 8

  gather_tile(abuf, sel, 0, row0, n, k, a, tid);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int i = row0 + 2 * t + half;
    const uint32_t* hw = reinterpret_cast<const uint32_t*>(h + static_cast<size_t>(i) * kF);
    uint32_t hp[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) hp[j] = __ldg(hw + 4 * j + q);
    cp_async_wait<0>();
    __syncthreads();  // the tile's rows are in abuf
    uint32_t araw[32];  // bf16 pairs of a in the A fragment layout
    a_fragments(araw, abuf, k);
    __syncthreads();  // every warp has its fragments: abuf takes the next tile
    if (t + 1 < n_tiles) gather_tile(abuf, sel, 2 * (t + 1), row0, n, k, a, tid);
    cp_async_commit();

    float z[64];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 hv = unpack_bf16(hp[j]);
      const float2 av = unpack_bf16(araw[4 * (j >> 1) + 2 * (j & 1)]);
      const float2 av8 = unpack_bf16(araw[4 * (j >> 1) + 2 * (j & 1) + 1]);
      z[4 * j] = leaky(av.x + hv.x, slope);
      z[4 * j + 1] = leaky(av.y + hv.y, slope);
      z[4 * j + 2] = leaky(av8.x + hv.x, slope);
      z[4 * j + 3] = leaky(av8.y + hv.y, slope);
    }
    uint32_t fa[16], fb[16];  // bf16(z) as the A fragments of k steps 0-3 and 4-7
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      fa[r] = pack_bf16(z[2 * r], z[2 * r + 1]);
      fb[r] = pack_bf16(z[32 + 2 * r], z[33 + 2 * r]);
    }
    uint8_t* buf = red + (t & 1) * kRedBufBytes;
    float* v1 = reinterpret_cast<float*>(buf);
    float* v2 = v1 + 4 * kF;
    uint8_t* r1 = buf + 2 * 4 * kF * sizeof(float);
    uint8_t* r2 = r1 + 4 * kF;
    uint32_t* p1 = reinterpret_cast<uint32_t*>(buf);  // without winners: bf16 pairs
    uint32_t* p2 = p1 + 4 * kF / 2;
    if (!kWinners) {  // x1 from the packed fragments, before the product reads them
      uint32_t zb[32];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        zb[r] = fa[r];
        zb[16 + r] = fb[r];
      }
      warp_column_max_bf16(zb, p1 + warp * kF / 2);
    }
    float acc[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.f;
    fence_regs(fa);
    fence_regs(fb);
    fence_regs(acc);
    wgmma_fence();
    accumulate_64x128(acc, fa, w2s);
    accumulate_64x128(acc, fb, w2s + 2 * kBox * kBox);
    wgmma_commit();
    // with winners, x1 from the f32 z registers, beside the product
    if (kWinners) warp_column_max(z, row_g, v1 + warp * kF, r1 + warp * kF);

    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bias = unpack_bf16(b2p[j]);
      acc[4 * j] = leaky(acc[4 * j] + bias.x, slope);
      acc[4 * j + 1] = leaky(acc[4 * j + 1] + bias.y, slope);
      acc[4 * j + 2] = leaky(acc[4 * j + 2] + bias.x, slope);
      acc[4 * j + 3] = leaky(acc[4 * j + 3] + bias.y, slope);
    }
    if (kWinners) {
      warp_column_max(acc, row_g, v2 + warp * kF, r2 + warp * kF);
    } else {
      uint32_t yb[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) yb[r] = pack_bf16(acc[2 * r], acc[2 * r + 1]);
      warp_column_max_bf16(yb, p2 + warp * kF / 2);
    }
    __syncthreads();

    if (kWinners) {
      // the two warps of a query: keep the larger, the smaller row on ties
      const int c = tid;
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        const size_t o = static_cast<size_t>(row0 + 2 * t + qq) * kF + c;
        float m = v1[2 * qq * kF + c];
        int r = r1[2 * qq * kF + c];
        keep_max(m, r, v1[(2 * qq + 1) * kF + c], r1[(2 * qq + 1) * kF + c]);
        x1[o] = __float2bfloat16_rn(m);
        win1[o] = static_cast<uint8_t>(r);
        m = v2[2 * qq * kF + c];
        r = r2[2 * qq * kF + c];
        keep_max(m, r, v2[(2 * qq + 1) * kF + c], r2[(2 * qq + 1) * kF + c]);
        x2[o] = __float2bfloat16_rn(m);
        win2[o] = static_cast<uint8_t>(r);
      }
    } else {
      // thread tid: query tid / 64 of the tile, bf16 pair tid % 64
      const int qq = tid >> 6, w = tid & 63;
      const size_t o = static_cast<size_t>(row0 + 2 * t + qq) * (kF / 2) + w;
      const uint32_t* a1 = p1 + 2 * qq * (kF / 2) + w;
      const uint32_t* a2 = p2 + 2 * qq * (kF / 2) + w;
      reinterpret_cast<uint32_t*>(x1)[o] = hmax2_u32(a1[0], a1[kF / 2]);
      reinterpret_cast<uint32_t*>(x2)[o] = hmax2_u32(a2[0], a2[kF / 2]);
    }
    // the next tile writes the other buffer; the one after reuses this one
    // only after the next tile's barrier, which every read here precedes
  }
}

}  // namespace edge
}  // namespace vcr

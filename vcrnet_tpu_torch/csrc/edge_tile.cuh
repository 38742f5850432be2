// The DG block's edge phase, shared by edge_conv.cu (which selects the
// neighbours itself) and edge_conv_from_idx.cu (which is given them): for
// one query and its kRows selected rows,
//
//   z_r   = act(a[sel[r]] + h[i])            (f32)
//   x1[i] = max_r z_r
//   x2[i] = max_r act(bf16(z_r) @ W2 + b2)   (f32 accumulation)
//
// with the product on the tensor cores through warp-level mma
// (nvcuda::wmma, bf16 in, f32 accumulate). A query's k <= 32 rows are
// padded to kRows = 32 by repeating its first neighbour, which leaves both
// maxima unchanged and gives the product whole 16-row tiles. Both kernels
// run this one device function, so they agree bit for bit on the same
// selection.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace vcr {
namespace edge {

constexpr int kWarps = 8;
constexpr int kTileQ = 16;  // queries per block
constexpr int kF = 128;     // edge-conv width (LPDNet convDG1/convDG2)
constexpr int kRows = 32;   // edge rows per query after padding (k <= 32)

// shared memory of the edge phase: per-warp [kRows, kF] bf16 edge tiles,
// W2, per-warp [16, 16] f32 staging tiles, the block's selections
constexpr size_t kEdgeBytes = sizeof(__nv_bfloat16) * kWarps * kRows * kF;
constexpr size_t kW2Bytes = sizeof(__nv_bfloat16) * kF * kF;
constexpr size_t kStageBytes = sizeof(float) * kWarps * 16 * 16;
constexpr size_t kSelBytes = sizeof(int) * kTileQ * kRows;

// The block copies W2 [kF, kF] into shared memory (16-byte copies).
__device__ __forceinline__ void stage_w2(const __nv_bfloat16* __restrict__ w2,
                                         __nv_bfloat16* w2s) {
  for (int t = threadIdx.x; t < kF * kF / 8; t += blockDim.x)
    reinterpret_cast<uint4*>(w2s)[t] = reinterpret_cast<const uint4*>(w2)[t];
}

// One warp evaluates query row ``row_i`` (an index into the flattened
// [B*N] rows) over qsel[0..kRows) (shared memory, rows of this cloud's
// ``ab``). zw is the warp's [kRows, kF] edge tile, stage its [16, 16] f32
// tile, w2s the staged W2. Writes x1/x2 and, when non-null, the winners
// (the first position on ties; padding rows repeat position 0 and never
// win).
__device__ __forceinline__ void warp_edge_rows(
    const int* qsel, const __nv_bfloat16* __restrict__ ab, const __nv_bfloat16* __restrict__ h,
    const __nv_bfloat16* w2s, const __nv_bfloat16* __restrict__ b2,
    __nv_bfloat16* __restrict__ x1, __nv_bfloat16* __restrict__ x2,
    uint8_t* __restrict__ win1, uint8_t* __restrict__ win2, size_t row_i, __nv_bfloat16* zw,
    float* stage, float slope) {
  using namespace nvcuda;
  const int lane = threadIdx.x & 31;
  const int c = lane * 4;  // this lane's 4 channels of the F = 128

  const uint2 hraw = *reinterpret_cast<const uint2*>(h + row_i * kF + c);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hraw);
  const float2 h01 = __bfloat1622float2(h2[0]), h23 = __bfloat1622float2(h2[1]);
  const float hv[4] = {h01.x, h01.y, h23.x, h23.y};
  float m1[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  uint8_t w1[4] = {0, 0, 0, 0};
  for (int r = 0; r < kRows; ++r) {
    const uint2 araw =
        *reinterpret_cast<const uint2*>(ab + static_cast<size_t>(qsel[r]) * kF + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&araw);
    const float2 a01 = __bfloat1622float2(a2[0]), a23 = __bfloat1622float2(a2[1]);
    const float av[4] = {a01.x, a01.y, a23.x, a23.y};
    float z[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      z[t] = vcr::leaky(av[t] + hv[t], slope);
      if (z[t] > m1[t]) {
        m1[t] = z[t];
        w1[t] = static_cast<uint8_t>(r);
      }
    }
    uint2 zraw;
    __nv_bfloat162* z2 = reinterpret_cast<__nv_bfloat162*>(&zraw);
    z2[0] = __floats2bfloat162_rn(z[0], z[1]);
    z2[1] = __floats2bfloat162_rn(z[2], z[3]);
    *reinterpret_cast<uint2*>(zw + r * kF + c) = zraw;
  }
  uint2 o1;
  __nv_bfloat162* o12 = reinterpret_cast<__nv_bfloat162*>(&o1);
  o12[0] = __floats2bfloat162_rn(m1[0], m1[1]);
  o12[1] = __floats2bfloat162_rn(m1[2], m1[3]);
  *reinterpret_cast<uint2*>(x1 + row_i * kF + c) = o1;
  if (win1 != nullptr) {
    uint32_t wp;
    uint8_t* wb = reinterpret_cast<uint8_t*>(&wp);
#pragma unroll
    for (int t = 0; t < 4; ++t) wb[t] = w1[t];
    *reinterpret_cast<uint32_t*>(win1 + row_i * kF + c) = wp;
  }
  __syncwarp();

  // [32, F] x [F, F] on the tensor cores, one 16-column block at a time;
  // lane (col, half) reduces 8 rows of each 16-row tile
  const int col = lane & 15, half = lane >> 4;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> za;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> wf;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int nb16 = 0; nb16 < kF / 16; ++nb16) {
    const float bias = __bfloat162float(b2[nb16 * 16 + col]);
    float m2 = -CUDART_INF_F;
    int win_r = 0;
    for (int mb = 0; mb < kRows / 16; ++mb) {
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kF / 16; ++kk) {
        wmma::load_matrix_sync(za, zw + mb * 16 * kF + kk * 16, kF);
        wmma::load_matrix_sync(wf, w2s + kk * 16 * kF + nb16 * 16, kF);
        wmma::mma_sync(acc, za, wf, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const float y = vcr::leaky(stage[(half * 8 + rr) * 16 + col] + bias, slope);
        if (y > m2) {  // rows ascend within a lane: the first row wins ties
          m2 = y;
          win_r = mb * 16 + half * 8 + rr;
        }
      }
      __syncwarp();
    }
    // the two halves interleave rows: keep the larger, the smaller row on ties
    const float om2 = __shfl_xor_sync(vcr::kFullMask, m2, 16);
    const int owin = __shfl_xor_sync(vcr::kFullMask, win_r, 16);
    if (om2 > m2 || (om2 == m2 && owin < win_r)) {
      m2 = om2;
      win_r = owin;
    }
    if (half == 0) {
      x2[row_i * kF + nb16 * 16 + col] = __float2bfloat16_rn(m2);
      if (win2 != nullptr) win2[row_i * kF + nb16 * 16 + col] = static_cast<uint8_t>(win_r);
    }
  }
  __syncwarp();
}

}  // namespace edge
}  // namespace vcr

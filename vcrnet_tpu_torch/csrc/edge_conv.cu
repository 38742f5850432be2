// LPDNet DG block: feature-space kNN fused with the decomposed edge conv.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:fused_edge_conv
// (_fused_edge_conv_fwd_impl -> _edge_conv_deferred_kernel / _edge_conv_kernel).
//
//   scores[i, j] = 2 x_i . x_j - |x_j|^2     (bf16 x, f32 accumulation,
//                                            j == i masked to -inf)
//   idx[i]       = top-k of scores[i], ties to the smaller column
//   z_ij         = act(a[j] + h[i])          (f32)
//   x1[i]        = max_j z_ij
//   x2[i]        = max_j act(bf16(z_ij) @ W2 + b2)   (f32 accumulation)
//
// Bound on the H100: operations. Per query the kernel does an N x C score
// row and a [k, F] x [F, F] product (2*N*C + 2*k*F*F flops); the bytes it
// must move are the four [B, N, *] activations. Both products run on the
// tensor cores through warp-level mma (nvcuda::wmma, bf16 in, f32
// accumulate). A block owns 16 queries: its [16, N] score tile and then
// its per-warp [32, F] edge tiles live in one shared-memory region, W2
// (32 KB) is staged once per block, and no [B, N, N] or [B, N, k, F]
// tensor reaches device memory. Each query's k = 20 edge rows are padded
// to 32 by repeating its first neighbour, which leaves both maxima
// unchanged and gives the product whole 16-row tiles.
//
// Training: with non-null ``win1``/``win2`` the kernel also writes, per
// output channel of x1 and x2, the k-position that won the max (uint8,
// the first position on ties, as the Pallas kernel's emit_winners; the
// padding rows repeat position 0 and so never win). edge_conv_bwd.cu
// routes the gradient by them.
#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kTileQ = 16;  // queries per block
constexpr int kF = 128;     // edge-conv width (LPDNet convDG1/convDG2)
constexpr int kRows = 32;   // edge rows per query after padding (k <= 32)

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) / 128 * 128; }

struct Layout {
  size_t scores, w2, q, stage, sel, total;
  __host__ __device__ Layout(int n, int c) {
    const size_t score_bytes = sizeof(float) * kTileQ * n;
    const size_t edge_bytes = sizeof(__nv_bfloat16) * kWarps * kRows * kF;
    const size_t region = align128(score_bytes > edge_bytes ? score_bytes : edge_bytes);
    scores = 0;
    w2 = region;
    q = w2 + align128(sizeof(__nv_bfloat16) * kF * kF);
    stage = q + align128(sizeof(__nv_bfloat16) * kTileQ * c);
    sel = stage + align128(sizeof(float) * kWarps * 16 * 16);
    total = sel + align128(sizeof(int) * kTileQ * kRows);
  }
};

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
edge_conv_kernel(const __nv_bfloat16* __restrict__ x,   // [B, N, C]
                 const float* __restrict__ norms,       // [B, N]
                 const __nv_bfloat16* __restrict__ a,   // [B, N, F]
                 const __nv_bfloat16* __restrict__ h,   // [B, N, F]
                 const __nv_bfloat16* __restrict__ w2,  // [F, F] (in, out)
                 const __nv_bfloat16* __restrict__ b2,  // [F]
                 __nv_bfloat16* __restrict__ x1,        // [B, N, F]
                 __nv_bfloat16* __restrict__ x2,        // [B, N, F]
                 int* __restrict__ idx,                 // [B, N, k]
                 uint8_t* __restrict__ win1,            // [B, N, F] or null
                 uint8_t* __restrict__ win2,            // [B, N, F] or null
                 int n, int k, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(n, C);
  float* scores = reinterpret_cast<float*>(smem + L.scores);
  __nv_bfloat16* zbuf = reinterpret_cast<__nv_bfloat16*>(smem + L.scores);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L.w2);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  float* stage_all = reinterpret_cast<float*>(smem + L.stage);
  int* sel = reinterpret_cast<int*>(smem + L.sel);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * n * C;

  // stage W2 and this block's query rows (16-byte copies)
  for (int t = threadIdx.x; t < kF * kF / 8; t += blockDim.x)
    reinterpret_cast<uint4*>(w2s)[t] = reinterpret_cast<const uint4*>(w2)[t];
  for (int t = threadIdx.x; t < kTileQ * C / 8; t += blockDim.x)
    reinterpret_cast<uint4*>(qs)[t] =
        reinterpret_cast<const uint4*>(xb + static_cast<size_t>(q0) * C)[t];
  __syncthreads();

  // [16, N] raw inner products, 16 keys per mma tile, tiles split by warp
  {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[C / 16];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) wmma::load_matrix_sync(qa[kk], qs + kk * 16, C);
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    for (int tile = warp; tile < n / 16; tile += kWarps) {
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        wmma::load_matrix_sync(kb, xb + static_cast<size_t>(tile) * 16 * C + kk * 16, C);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(scores + tile * 16, acc, n, wmma::mem_row_major);
    }
  }
  __syncthreads();
  const float* nb = norms + static_cast<size_t>(b) * n;
  for (int t = threadIdx.x; t < kTileQ * n; t += blockDim.x) {
    const int q = t / n, j = t - q * n;
    const float s = 2.f * scores[t] - nb[j];
    scores[t] = q0 + q == j ? -CUDART_INF_F : vcr::finite_or_neg_inf(s);
  }
  __syncthreads();

  for (int q = warp; q < kTileQ; q += kWarps) {
    int* qsel = sel + q * kRows;
    vcr::warp_select_topk(scores + q * n, n, k, qsel);
    if (lane < k) idx[(static_cast<size_t>(b) * n + q0 + q) * k + lane] = qsel[lane];
    if (lane >= k) qsel[lane] = qsel[0];  // pad: repeats neighbour 0
  }
  __syncthreads();  // the score tile's memory becomes the edge tiles

  __nv_bfloat16* zw = zbuf + warp * kRows * kF;
  float* stage = stage_all + warp * 16 * 16;
  const __nv_bfloat16* ab = a + static_cast<size_t>(b) * n * kF;
  const int c = lane * 4;  // this lane's 4 channels of the F = 128
  for (int q = warp; q < kTileQ; q += kWarps) {
    const size_t row_i = static_cast<size_t>(b) * n + q0 + q;
    const int* qsel = sel + q * kRows;

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
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> wb;
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
          wmma::load_matrix_sync(wb, w2s + kk * 16 * kF + nb16 * 16, kF);
          wmma::mma_sync(acc, za, wb, acc);
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
}

template <int C>
cudaError_t launch(const void* x, const float* norms, const void* a, const void* h,
                   const void* w2, const void* b2, void* x1, void* x2, int* idx,
                   void* win1, void* win2, int batch, int n, int k, float slope,
                   cudaStream_t stream) {
  const Layout L(n, C);
  cudaError_t err = cudaFuncSetAttribute(
      edge_conv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kTileQ, batch);
  edge_conv_kernel<C><<<grid, kWarps * 32, L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x), norms,
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(b2),
      static_cast<__nv_bfloat16*>(x1), static_cast<__nv_bfloat16*>(x2), idx,
      static_cast<uint8_t*>(win1), static_cast<uint8_t*>(win2), n, k, slope);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [B,N,C] (C in {32, 64, 128}), norms f32 [B,N], a/h bf16 [B,N,128],
// w2 bf16 [128,128] (in, out), b2 bf16 [128] -> x1/x2 bf16 [B,N,128],
// idx int32 [B,N,k], and with non-null win1/win2 the winners uint8 [B,N,128].
// Requires N % 16 == 0, k <= 32, k < N, 32-byte aligned pointers. Returns
// the launch status (cudaErrorInvalidValue for another C).
cudaError_t vcr_edge_conv(const void* x, const float* norms, const void* a,
                          const void* h, const void* w2, const void* b2, void* x1,
                          void* x2, int* idx, void* win1, void* win2, int batch, int n,
                          int c, int k, float slope, cudaStream_t stream) {
  switch (c) {
    case 32: return launch<32>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k, slope, stream);
    case 64: return launch<64>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k, slope, stream);
    case 128: return launch<128>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k, slope, stream);
    default: return cudaErrorInvalidValue;
  }
}

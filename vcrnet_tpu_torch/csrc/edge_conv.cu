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
// its per-warp [32, F] edge tiles and W2 (32 KB, staged once per block)
// live in one shared-memory region, and no [B, N, N] or [B, N, k, F]
// tensor reaches device memory. The edge phase (gather, act, the padded
// 20 -> 32 row product with W2, the two maxima) is edge_tile.cuh, shared
// with edge_conv_from_idx.cu.
//
// Training: with non-null ``win1``/``win2`` the kernel also writes, per
// output channel of x1 and x2, the k-position that won the max (uint8,
// the first position on ties, as the Pallas kernel's emit_winners; the
// padding rows repeat position 0 and so never win). edge_conv_bwd.cu
// routes the gradient by them.
#include "edge_tile.cuh"

namespace {

using namespace nvcuda;
using namespace vcr::edge;

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) / 128 * 128; }

// One region serves the [16, N] f32 score tile first and, once the
// selection is made, the edge tiles and W2 (staged only then), so the
// kernel fits N up to 3408 in the 227 KB a block can use.
struct Layout {
  size_t scores, w2, q, stage, sel, total;
  __host__ __device__ Layout(int n, int c) {
    const size_t score_bytes = sizeof(float) * kTileQ * n;
    const size_t edge_bytes = kEdgeBytes + kW2Bytes;
    const size_t region = align128(score_bytes > edge_bytes ? score_bytes : edge_bytes);
    scores = 0;
    w2 = kEdgeBytes;
    q = region;
    stage = q + align128(sizeof(__nv_bfloat16) * kTileQ * c);
    sel = stage + align128(kStageBytes);
    total = sel + align128(kSelBytes);
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

  // stage this block's query rows (16-byte copies)
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
  __syncthreads();  // the score tile's memory becomes the edge tiles and W2
  stage_w2(w2, w2s);
  __syncthreads();

  const __nv_bfloat16* ab = a + static_cast<size_t>(b) * n * kF;
  for (int q = warp; q < kTileQ; q += kWarps)
    warp_edge_rows(sel + q * kRows, ab, h, w2s, b2, x1, x2, win1, win2,
                   static_cast<size_t>(b) * n + q0 + q, zbuf + warp * kRows * kF,
                   stage_all + warp * 16 * 16, slope);
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
// Requires N % 16 == 0 and N <= 3408 (shared memory), k <= 32, k < N,
// 32-byte aligned pointers. Returns the launch status
// (cudaErrorInvalidValue for another C).
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

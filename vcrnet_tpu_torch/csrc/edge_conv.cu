// LPDNet DG block: feature-space kNN fused with the decomposed edge conv.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:fused_edge_conv
// (_fused_edge_conv_fwd_impl -> _edge_conv_deferred_kernel, with the exact
// selection of _select_knn_idx that packed_select=False runs).
//
//   scores[i, j] = 2 x_i . x_j - |x_j|^2     (bf16 x, f32 accumulation,
//                                            j == i at -inf, NaN -> -inf)
//   idx[i]       = top-k of scores[i], ties to the smaller column
//   z_ij         = act(a[j] + h[i])          (f32)
//   x1[i]        = max_j z_ij
//   x2[i]        = max_j act(bf16(z_ij) @ W2 + b2)   (f32 accumulation)
//
// Bound on the H100: operations. Per query the kernel does an N x C score
// row and a [k, F] x [F, F] product (2*N*C + 2*k*F*F flops); the bytes it
// must move are the four [B, N, *] activations. Neither a [B, N, N] nor a
// [B, N, k, F] tensor reaches device memory.
//
// A block is one warpgroup (128 threads) and owns 64 queries of one cloud.
//   * Scores: the block's query rows are one K-major operand ([64, C] in
//     128-byte-swizzled [64, 64] boxes, C = 32 uses the first half of one),
//     and the cloud's rows stream through a ring of two such key tiles, both
//     filled by cp.async. Each [64 queries, 64 keys] tile is one
//     wgmma_m64n64_ss chain of C / 16 k steps. Each warp fixes up its own
//     16 rows of the tile (the -|x_j|^2, the diagonal, NaN) into a private
//     staging area.
//   * Selection, in two passes over the key tiles (the scores of the
//     second are computed again: at C = 64 a tile's product is four
//     wgmma steps) with the state in registers, by topk.cuh (shared with
//     knn_gather_max.cu and knn.cu): 64-bit keys of score and column, each
//     lane's two best keys in pass 1, the k-th of the warp's 64 as the
//     threshold, and insertion of the keys at or above it into a list
//     ranked across the lanes in pass 2. Lane l of a warp sees columns l
//     and l + 32 of every tile of its 16 queries.
//   * The edge phase (edge_tile.cuh, shared with edge_conv_from_idx.cu):
//     wgmma m64n128 on tiles of two queries, z in registers.
// Shared memory per block (1024-aligned): the query rows 16384, the key
// ring 2 * 16384 (once the selection is made W2, 32768, takes the place of
// the query rows and the first slot, the edge phase's gathered rows, 16384,
// that of the second), the score staging 4 warps * 16 rows * 72 f32 = 18432 (the edge
// phase's exchange, 18432, reuses it), the selections 8192, plus 1024
// bytes of alignment slack = 76800 bytes. It does not depend on N. Three
// blocks an SM without winners (at most 170 registers a thread), two with,
// so one block's selection runs beside another's products. Registers
// (`-Xptxas -v`, which chip_smoke.py prints): 168 without winners, 254
// with, no spills. What holds it is not the tensor cores: the selection's
// insertion chains take about half its time (edge_conv against
// edge_conv_from_idx on the same shapes), the edge phase's CUDA-core work
// (z, act, the maxima) most of the rest.
//
// Training: with non-null ``win1``/``win2`` the kernel also writes, per
// output channel of x1 and x2, the k-position that won the max (uint8,
// the first position on ties, as the Pallas kernel's emit_winners).
// edge_conv_bwd.cu routes the gradient by them.
#include "edge_tile.cuh"
#include "topk.cuh"

namespace {

using namespace vcr::hopper;
using namespace vcr::edge;
using namespace vcr::topk;

constexpr int kKeyTile = 64;
constexpr int kStgStride = 72;  // floats a staged score row: 64 and 8 of padding
constexpr uint32_t kRowsBytes = 2 * kBoxBytes;  // [64, C <= 128] bf16
// W2 is staged once the selection is made, over the query rows and the ring
constexpr uint32_t kQOff = 0;
constexpr uint32_t kRingOff = kQOff + kRowsBytes;
static_assert(kW2Bytes <= 3 * kRowsBytes, "W2 takes the place of the query rows and the ring");
constexpr uint32_t kStgOff = kRingOff + 2 * kRowsBytes;
// the edge phase's gathered rows take the ring's second slot, after W2
constexpr uint32_t kABufOff = kW2Bytes;
static_assert(kABufOff + kABufBytes <= kStgOff, "the gathered rows fit beside W2");
constexpr uint32_t kStgBytes = 4 * 16 * kStgStride * sizeof(float);
static_assert(kRedBytes <= kStgBytes, "the edge phase's exchange reuses the score staging");
constexpr uint32_t kSelOff = kStgOff + kStgBytes;
constexpr size_t kSmemBytes = 1024 + kSelOff + kSelBytes;

// 64 rows of a [*, C] bf16 matrix from ``src`` into dst as swizzled boxes
// of 64 columns (cp.async; the caller commits).
template <int C>
__device__ __forceinline__ void load_rows(uint8_t* dst, const bf16* __restrict__ src) {
  constexpr int kChunks = C / 8;  // 16-byte chunks of a row
  for (int t = threadIdx.x; t < 64 * kChunks; t += kThreads) {
    const int r = t / kChunks, c = t % kChunks;
    cp_async16(dst + (c >> 3) * kBoxBytes + sw128_offset(r, c & 7), src + r * C + c * 8);
  }
}

template <int C, bool kWinners>
__global__ void __launch_bounds__(kThreads, kWinners ? 2 : 3)
edge_conv_kernel(const bf16* __restrict__ x,    // [B, N, C]
                 const float* __restrict__ norms,  // [B, N]
                 const bf16* __restrict__ a,    // [B, N, F]
                 const bf16* __restrict__ h,    // [B, N, F]
                 const bf16* __restrict__ w2,   // [F, F] (in, out)
                 const bf16* __restrict__ b2,   // [F]
                 bf16* __restrict__ x1,         // [B, N, F]
                 bf16* __restrict__ x2,         // [B, N, F]
                 int* __restrict__ idx,         // [B, N, k]
                 uint8_t* __restrict__ win1,    // [B, N, F] or null
                 uint8_t* __restrict__ win2,    // [B, N, F] or null
                 int n, int k, float slope) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  const bf16* w2s = reinterpret_cast<const bf16*>(base);
  const bf16* qs = reinterpret_cast<const bf16*>(base + kQOff);
  int* sel = reinterpret_cast<int*>(base + kSelOff);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const bf16* xb = x + static_cast<size_t>(b) * n * C;
  const float* nb = norms + static_cast<size_t>(b) * n;

  load_rows<C>(base + kQOff, xb + static_cast<size_t>(q0) * C);
  load_rows<C>(base + kRingOff, xb);
  cp_async_commit();
  uint32_t b2p[16];
  load_b2(b2, b2p);

  // per query of the warp: pass 1 keeps the lane's two best keys (m1, m2),
  // pass 2 the sorted list (rank = lane) of the keys at or above thr
  uint64_t m1[16], m2[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m1[r] = m2[r] = 0;  // below every key
  float* stg = reinterpret_cast<float*>(base + kStgOff) + warp * 16 * kStgStride;
  const int i_g = q0 + warp * 16 + g, i_g8 = i_g + 8;
  const int n_tiles = n / kKeyTile;
  for (int u = 0; u < 2 * n_tiles; ++u) {  // the key tiles twice: one pass each
    const int t = u < n_tiles ? u : u - n_tiles;
    if (u + 1 < 2 * n_tiles) {
      load_rows<C>(base + kRingOff + ((u + 1) & 1) * kRowsBytes,
                   xb + static_cast<size_t>((u + 1) % n_tiles) * kKeyTile * C);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    const bf16* ks = reinterpret_cast<const bf16*>(base + kRingOff + (u & 1) * kRowsBytes);
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_m64n64_ss(sc, desc_k_major(qs, kk), desc_k_major(ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * q, key = t * kKeyTile + col;
      const float2 nv = __ldg(reinterpret_cast<const float2*>(nb + key));
      float2 s, s8;
      s.x = key == i_g ? -CUDART_INF_F : vcr::finite_or_neg_inf(2.f * sc[4 * j] - nv.x);
      s.y = key + 1 == i_g ? -CUDART_INF_F : vcr::finite_or_neg_inf(2.f * sc[4 * j + 1] - nv.y);
      s8.x = key == i_g8 ? -CUDART_INF_F : vcr::finite_or_neg_inf(2.f * sc[4 * j + 2] - nv.x);
      s8.y = key + 1 == i_g8 ? -CUDART_INF_F : vcr::finite_or_neg_inf(2.f * sc[4 * j + 3] - nv.y);
      *reinterpret_cast<float2*>(stg + g * kStgStride + col) = s;
      *reinterpret_cast<float2*>(stg + (g + 8) * kStgStride + col) = s8;
    }
    __syncwarp();
    const int j0 = t * kKeyTile + lane;
    if (u < n_tiles) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        keep_top2(m1[r], m2[r], rank_key(stg[r * kStgStride + lane], j0));
        keep_top2(m1[r], m2[r], rank_key(stg[r * kStgStride + lane + 32], j0 + 32));
      }
      if (u == n_tiles - 1) {
        // at least k keys (distinct) are at or above the k-th best of the
        // lanes' 64: so are the k best of the row. m2 becomes that
        // threshold, m1 the list.
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          m2[r] = warp_kth_of_64(m1[r], m2[r], k);
          m1[r] = 0;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        insert_from(m1[r], rank_key(stg[r * kStgStride + lane], j0), m2[r]);
        insert_from(m1[r], rank_key(stg[r * kStgStride + lane + 32], j0 + 32), m2[r]);
      }
    }
    __syncthreads();  // the next iteration refills the ring slot read here
  }
  stage_w2_mn(w2, reinterpret_cast<bf16*>(base));  // lands while the selections are written
  cp_async_commit();
  const uint64_t(&list)[16] = m1;

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int col = static_cast<int>(~static_cast<uint32_t>(list[r]));
    const int first = __shfl_sync(vcr::kFullMask, col, 0);
    const int ql = warp * 16 + r;
    if (lane < k) idx[(static_cast<size_t>(b) * n + q0 + ql) * k + lane] = col;
    sel[ql * kRows + lane] = lane < k ? col : first;  // pad: repeats neighbour 0
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // W2 is in; the staging becomes the edge phase's exchange
  edge_rows<kWinners>(sel, kTileQ / 2, b * n + q0, n, k, a, h, w2s, b2p, x1, x2, win1, win2,
                      base + kStgOff, base + kABufOff, slope);
}

template <int C, bool kWinners>
cudaError_t launch(const void* x, const float* norms, const void* a, const void* h,
                   const void* w2, const void* b2, void* x1, void* x2, int* idx,
                   void* win1, void* win2, int batch, int n, int k, float slope,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_conv_kernel<C, kWinners>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kTileQ, batch);
  edge_conv_kernel<C, kWinners><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), norms, static_cast<const bf16*>(a),
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<bf16*>(x1), static_cast<bf16*>(x2), idx, static_cast<uint8_t*>(win1),
      static_cast<uint8_t*>(win2), n, k, slope);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const void* x, const float* norms, const void* a, const void* h,
                   const void* w2, const void* b2, void* x1, void* x2, int* idx,
                   void* win1, void* win2, int batch, int n, int k, float slope,
                   cudaStream_t stream) {
  if ((win1 == nullptr) != (win2 == nullptr)) return cudaErrorInvalidValue;
  return win1 != nullptr
             ? launch<C, true>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k,
                               slope, stream)
             : launch<C, false>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k,
                                slope, stream);
}

}  // namespace

// x bf16 [B,N,C] (C in {32, 64, 128}), norms f32 [B,N], a/h bf16 [B,N,128],
// w2 bf16 [128,128] (in, out), b2 bf16 [128] -> x1/x2 bf16 [B,N,128],
// idx int32 [B,N,k], and with non-null win1/win2 the winners uint8 [B,N,128].
// Requires N % 64 == 0, 0 < k <= 32, k < N, 16-byte aligned pointers.
// Returns the launch status (cudaErrorInvalidValue for another C or N, k).
cudaError_t vcr_edge_conv(const void* x, const float* norms, const void* a,
                          const void* h, const void* w2, const void* b2, void* x1,
                          void* x2, int* idx, void* win1, void* win2, int batch, int n,
                          int c, int k, float slope, cudaStream_t stream) {
  if (n % kTileQ || k < 1 || k > kRows || k >= n) return cudaErrorInvalidValue;
  switch (c) {
    case 32: return launch<32>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k, slope, stream);
    case 64: return launch<64>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k, slope, stream);
    case 128: return launch<128>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k, slope, stream);
    default: return cudaErrorInvalidValue;
  }
}

// LPDNet DG block: feature-space kNN fused with the decomposed edge conv.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:fused_edge_conv
// (_fused_edge_conv_fwd_impl -> _edge_conv_deferred_kernel, with the exact
// selection of _select_knn_idx that packed_select=False runs).
//
//   scores[i, j] = 2 x_i . x_j - |x_j|^2     (f32 accumulation; j == i at
//                                            -inf, NaN -> -inf)
//   idx[i]       = top-k of scores[i], ties to the smaller column
//   z_ij         = act(a[j] + h[i])          (f32)
//   x1[i]        = max_j z_ij
//   x2[i]        = max_j act(bf16(z_ij) @ W2 + b2)   (f32 accumulation)
//
// Two instances of the kNN space x, one kernel body (edge_conv_block):
//   * bf16 x at C = 32, 64, 128 (edge_conv_kernel<C, winners>;
//     vcr_edge_conv): the space of LPDNet without a feature T-Net, whose x
//     is conv2_lpd's bf16 output. Scores on wgmma (below).
//   * f32 x at C = 64 (edge_conv_float_kernel<winners>;
//     vcr_edge_conv_f32knn): the space after t_net_fea, which is f32 in
//     both packages and on which the JAX package's exact path selects
//     (rounded to bf16, it gives other neighbours to about 4% of the rows
//     at N = 1024: ROADMAP C5). Scores on the CUDA cores as knn_scores.cuh's
//     xyz_score computes them: a chain of fused multiply-adds in channel
//     order, then 2 d - |x_j|^2 rounded once. Chosen over a 3xTF32 split on
//     wgmma because its order is the plain f32 product's and a CPU test can
//     write it bit for bit (tests/test_torch_edge_tiles.py); the cost is
//     2 * N * C fmas a query row for the two passes, 8.6 G fmas at B = 64,
//     N = 1024, about 0.26 ms at the 67 TFLOP/s f32 rate.
// The selection, the edge phase and the bf16 a, h, W2, b2 are the same in
// both.
//
// Bound on the H100: operations. Per query the kernel does an N x C score
// row and a [k, F] x [F, F] product (2*N*C + 2*k*F*F flops); the bytes it
// must move are the four [B, N, *] activations. Neither a [B, N, N] nor a
// [B, N, k, F] tensor reaches device memory.
//
// A block is one warpgroup (128 threads) and owns 64 queries of one cloud.
//   * Scores, bf16: the block's query rows are one K-major operand ([64, C]
//     in 128-byte-swizzled [64, 64] boxes, C = 32 uses the first half of
//     one), and the cloud's rows stream through a ring of two such key
//     tiles, both filled by cp.async. Each [64 queries, 64 keys] tile is one
//     wgmma_m64n64_ss chain of C / 16 k steps. Each warp fixes up its own
//     16 rows of the tile (the -|x_j|^2, the diagonal, NaN) into a private
//     staging area.
//   * Scores, f32: the query rows and the ring's key tiles hold f32 rows of
//     256 bytes (64 of them fill the same 16 KB slot), unswizzled but for
//     their 16-byte chunks: chunk c of row r sits at c ^ (r & 7), so the
//     eight lanes of a quarter warp that read chunk c of eight keys fall in
//     eight bank groups, and the 16 queries' chunks are broadcasts. Lane l
//     of a warp computes columns l and l + 32 of its warp's 16 queries in
//     registers, the layout in which the selection reads the bf16 staging.
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
// phase's exchange, 18432, reuses it; the f32 instance stages no scores),
// the selections 8192, plus 1024 bytes of alignment slack = 76800 bytes,
// both instances. It does not depend on N. Three
// blocks an SM without winners (at most 170 registers a thread), two with,
// so one block's selection runs beside another's products. Registers
// (`-Xptxas -v`, which chip_smoke.py prints): 168 without winners, 247
// with (the f32 instance 168 and 249: it loads b2 after the selection,
// or its score tile spills), no spills. What holds it is not the tensor cores: the selection's
// insertion chains take about half its time (edge_conv against
// edge_conv_from_idx on the same shapes), the edge phase's CUDA-core work
// (z, act, the maxima) most of the rest.
//
// Any N: the grid has ceil(N / 64) blocks a cloud. The last key tile reads
// the cloud's last row in place of the rows past N, and their norms are
// +inf (the wrapper pads the norms to whole tiles), so their scores are
// -inf: they rank after every real key, -inf ones included (ties go to the
// smaller column), and k < N real keys exist. The last block's queries past
// N select on repeats of the last row and write nothing (edge_tile.cuh).
//
// Training: with non-null ``win1``/``win2`` the kernel also writes, per
// output channel of x1 and x2, the k-position that won the max (uint8,
// the first position on ties, as the Pallas kernel's emit_winners).
// edge_conv_bwd.cu routes the gradient by them.
#include <type_traits>

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
// of 64 columns (cp.async; the caller commits). Only the first ``rows``
// are read: the rest repeat the last of them (the end of a cloud).
template <int C>
__device__ __forceinline__ void load_rows(uint8_t* dst, const bf16* __restrict__ src, int rows) {
  constexpr int kChunks = C / 8;  // 16-byte chunks of a row
  for (int t = threadIdx.x; t < 64 * kChunks; t += kThreads) {
    const int r = t / kChunks, c = t % kChunks;
    cp_async16(dst + (c >> 3) * kBoxBytes + sw128_offset(r, c & 7),
               src + min(r, rows - 1) * C + c * 8);
  }
}

// The f32 instance's rows: 64 rows of a [*, 64] f32 matrix from ``src``
// into dst, 256 bytes a row, 16-byte chunk c of row r at chunk c ^ (r & 7)
// (cp.async; the caller commits). Only the first ``rows`` are read, as
// above.
template <int C>
__device__ __forceinline__ void load_rows(uint8_t* dst, const float* __restrict__ src, int rows) {
  static_assert(C == 64, "the f32 kNN space is 64 wide (LPDNet's t_net_fea)");
  for (int t = threadIdx.x; t < 64 * 16; t += kThreads) {
    const int r = t >> 4, c = t & 15;
    cp_async16(dst + r * 256 + ((c ^ (r & 7)) << 4), src + min(r, rows - 1) * 64 + c * 4);
  }
}

// The f32 instance's score tile: sc[2 r + h] = the score of column
// 32 h + lane of key tile t for the warp's query r (query i_r = i0 + r),
// each dot product a chain of fmas in channel order and 2 d - |x_j|^2
// rounded once, as knn_scores.cuh:xyz_score. qs, ks: the rows as
// load_rows<64> of a float matrix lays them out.
__device__ __forceinline__ void f32_score_tile(const float4* qs, const float4* ks,
                                               const float* __restrict__ nb, int t, int i0,
                                               float (&sc)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* q = qs + warp * 16 * 16;  // the warp's 16 query rows of 16 chunks
  const float4* k0 = ks + lane * 16;      // key rows lane and lane + 32: both swizzle by lane & 7
  const float4* k1 = ks + (lane + 32) * 16;
  const int sw = lane & 7;
  {
    const float4 a = k0[sw], b = k1[sw];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 v = q[r * 16 + (r & 7)];
      sc[2 * r] = __fmaf_rn(v.w, a.w, __fmaf_rn(v.z, a.z, __fmaf_rn(v.y, a.y, __fmul_rn(v.x, a.x))));
      sc[2 * r + 1] =
          __fmaf_rn(v.w, b.w, __fmaf_rn(v.z, b.z, __fmaf_rn(v.y, b.y, __fmul_rn(v.x, b.x))));
    }
  }
#pragma unroll 3
  for (int c = 1; c < 16; ++c) {
    const float4 a = k0[c ^ sw], b = k1[c ^ sw];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 v = q[r * 16 + (c ^ (r & 7))];
      sc[2 * r] = __fmaf_rn(v.w, a.w, __fmaf_rn(v.z, a.z, __fmaf_rn(v.y, a.y,
                            __fmaf_rn(v.x, a.x, sc[2 * r]))));
      sc[2 * r + 1] = __fmaf_rn(v.w, b.w, __fmaf_rn(v.z, b.z, __fmaf_rn(v.y, b.y,
                                __fmaf_rn(v.x, b.x, sc[2 * r + 1]))));
    }
  }
  const int j = t * kKeyTile + lane;
  const float n0 = -__ldg(nb + j), n1 = -__ldg(nb + j + 32);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    sc[2 * r] = j == i0 + r ? -CUDART_INF_F : vcr::finite_or_neg_inf(__fmaf_rn(2.f, sc[2 * r], n0));
    sc[2 * r + 1] =
        j + 32 == i0 + r ? -CUDART_INF_F : vcr::finite_or_neg_inf(__fmaf_rn(2.f, sc[2 * r + 1], n1));
  }
}

// One block of either instance: XT is the kNN space's type (bf16, or f32
// at C = 64).
template <int C, bool kWinners, typename XT>
__device__ __forceinline__ void edge_conv_block(
    const XT* __restrict__ x,         // [B, N, C]
    const float* __restrict__ norms,  // [B, n_tiles * 64], +inf past N
    const bf16* __restrict__ a,       // [B, N, F]
    const bf16* __restrict__ h,       // [B, N, F]
    const bf16* __restrict__ w2,      // [F, F] (in, out)
    const bf16* __restrict__ b2,      // [F]
    bf16* __restrict__ x1,            // [B, N, F]
    bf16* __restrict__ x2,            // [B, N, F]
    int* __restrict__ idx,            // [B, N, k]
    uint8_t* __restrict__ win1,       // [B, N, F] or null
    uint8_t* __restrict__ win2,       // [B, N, F] or null
    int n, int k, float slope) {
  constexpr bool kF32 = std::is_same<XT, float>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  const bf16* w2s = reinterpret_cast<const bf16*>(base);
  const bf16* qs = reinterpret_cast<const bf16*>(base + kQOff);
  int* sel = reinterpret_cast<int*>(base + kSelOff);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const int n_tiles = (n + kKeyTile - 1) / kKeyTile;
  const int n_valid = min(kTileQ, n - q0);  // the block's queries within the cloud
  const XT* xb = x + static_cast<size_t>(b) * n * C;
  const float* nb = norms + static_cast<size_t>(b) * n_tiles * kKeyTile;

  load_rows<C>(base + kQOff, xb + static_cast<size_t>(q0) * C, n_valid);
  load_rows<C>(base + kRingOff, xb, min(kKeyTile, n));
  cp_async_commit();
  uint32_t b2p[16];
  if constexpr (!kF32) load_b2(b2, b2p);  // f32: after the selection (16 registers)

  // per query of the warp: pass 1 keeps the lane's two best keys (m1, m2),
  // pass 2 the sorted list (rank = lane) of the keys at or above thr
  uint64_t m1[16], m2[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m1[r] = m2[r] = 0;  // below every key
  float* stg = reinterpret_cast<float*>(base + kStgOff) + warp * 16 * kStgStride;
  const int i_g = q0 + warp * 16 + g, i_g8 = i_g + 8;
  for (int u = 0; u < 2 * n_tiles; ++u) {  // the key tiles twice: one pass each
    const int t = u < n_tiles ? u : u - n_tiles;
    if (u + 1 < 2 * n_tiles) {
      const int next = (u + 1) % n_tiles;
      load_rows<C>(base + kRingOff + ((u + 1) & 1) * kRowsBytes,
                   xb + static_cast<size_t>(next) * kKeyTile * C,
                   min(kKeyTile, n - next * kKeyTile));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    float sc[32];
    if constexpr (kF32) {  // lane's columns in registers
      f32_score_tile(reinterpret_cast<const float4*>(base + kQOff),
                     reinterpret_cast<const float4*>(base + kRingOff + (u & 1) * kRowsBytes),
                     nb, t, q0 + warp * 16, sc);
    } else {  // the warp's 16 rows of the tile into its staging
      const bf16* ks = reinterpret_cast<const bf16*>(base + kRingOff + (u & 1) * kRowsBytes);
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
    }
    // the score of the warp's query r at column lane + 32 h of the tile
    const auto score = [&](int r, int half) -> float {
      if constexpr (kF32) return sc[2 * r + half];
      else return stg[r * kStgStride + lane + 32 * half];
    };
    const int j0 = t * kKeyTile + lane;
    if (u < n_tiles) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        keep_top2(m1[r], m2[r], rank_key(score(r, 0), j0));
        keep_top2(m1[r], m2[r], rank_key(score(r, 1), j0 + 32));
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
        insert_from(m1[r], rank_key(score(r, 0), j0), m2[r]);
        insert_from(m1[r], rank_key(score(r, 1), j0 + 32), m2[r]);
      }
    }
    __syncthreads();  // the next iteration refills the ring slot read here
  }
  stage_w2_mn(w2, reinterpret_cast<bf16*>(base));  // lands while the selections are written
  cp_async_commit();
  if constexpr (kF32) load_b2(b2, b2p);
  const uint64_t(&list)[16] = m1;

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int col = static_cast<int>(~static_cast<uint32_t>(list[r]));
    const int first = __shfl_sync(vcr::kFullMask, col, 0);
    const int ql = warp * 16 + r;
    if (lane < k && ql < n_valid) idx[(static_cast<size_t>(b) * n + q0 + ql) * k + lane] = col;
    sel[ql * kRows + lane] = lane < k ? col : first;  // pad: repeats neighbour 0
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // W2 is in; the staging becomes the edge phase's exchange
  edge_rows<kWinners>(sel, n_valid, b * n + q0, n, k, a, h, w2s, b2p, x1, x2, win1, win2,
                      base + kStgOff, base + kABufOff, slope);
}

#define EDGE_CONV_PARAMS(XT)                                                                 \
  const XT* __restrict__ x, const float* __restrict__ norms, const bf16* __restrict__ a,    \
      const bf16* __restrict__ h, const bf16* __restrict__ w2, const bf16* __restrict__ b2, \
      bf16* __restrict__ x1, bf16* __restrict__ x2, int* __restrict__ idx,                  \
      uint8_t* __restrict__ win1, uint8_t* __restrict__ win2, int n, int k, float slope

template <int C, bool kWinners>
__global__ void __launch_bounds__(kThreads, kWinners ? 2 : 3)
edge_conv_kernel(EDGE_CONV_PARAMS(bf16)) {
  edge_conv_block<C, kWinners>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, n, k, slope);
}

template <bool kWinners>
__global__ void __launch_bounds__(kThreads, kWinners ? 2 : 3)
edge_conv_float_kernel(EDGE_CONV_PARAMS(float)) {
  edge_conv_block<64, kWinners>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, n, k, slope);
}

// The kernel of an instance: the kNN space's type XT, its width C.
template <int C, bool kWinners, typename XT>
auto kernel_of() {
  if constexpr (std::is_same<XT, float>::value) return edge_conv_float_kernel<kWinners>;
  else return edge_conv_kernel<C, kWinners>;
}

template <int C, bool kWinners, typename XT>
cudaError_t launch(const void* x, const float* norms, const void* a, const void* h,
                   const void* w2, const void* b2, void* x1, void* x2, int* idx,
                   void* win1, void* win2, int batch, int n, int k, float slope,
                   cudaStream_t stream) {
  const auto kernel = kernel_of<C, kWinners, XT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const XT*>(x), norms, static_cast<const bf16*>(a),
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<bf16*>(x1), static_cast<bf16*>(x2), idx, static_cast<uint8_t*>(win1),
      static_cast<uint8_t*>(win2), n, k, slope);
  return cudaGetLastError();
}

template <int C, typename XT = bf16>
cudaError_t launch(const void* x, const float* norms, const void* a, const void* h,
                   const void* w2, const void* b2, void* x1, void* x2, int* idx,
                   void* win1, void* win2, int batch, int n, int k, float slope,
                   cudaStream_t stream) {
  if (k < 1 || k > kRows || k >= n) return cudaErrorInvalidValue;
  if ((win1 == nullptr) != (win2 == nullptr)) return cudaErrorInvalidValue;
  return win1 != nullptr
             ? launch<C, true, XT>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k,
                                   slope, stream)
             : launch<C, false, XT>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n,
                                    k, slope, stream);
}

}  // namespace

// x bf16 [B,N,C] (C in {32, 64, 128}), norms f32 [B,N'] (N' = N rounded up
// to 64, +inf past N), a/h bf16 [B,N,128], w2 bf16 [128,128] (in, out), b2
// bf16 [128] -> x1/x2 bf16 [B,N,128], idx int32 [B,N,k], and with non-null
// win1/win2 the winners uint8 [B,N,128]. Requires 0 < k <= 32, k < N,
// 16-byte aligned pointers. Returns the launch status
// (cudaErrorInvalidValue for another C or k).
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

// The same with the kNN space x in f32 [B,N,64] (the f32 instance; c must
// be 64): the same outputs, selected on the f32 values. The signature is
// vcr_edge_conv's.
cudaError_t vcr_edge_conv_f32knn(const void* x, const float* norms, const void* a,
                                 const void* h, const void* w2, const void* b2, void* x1,
                                 void* x2, int* idx, void* win1, void* win2, int batch, int n,
                                 int c, int k, float slope, cudaStream_t stream) {
  if (c != 64) return cudaErrorInvalidValue;
  return launch<64, float>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k, slope,
                           stream);
}

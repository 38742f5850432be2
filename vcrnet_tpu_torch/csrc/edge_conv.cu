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
// Two instances of the kNN space x, one kernel body (edge_conv_block), both
// with their scores on wgmma:
//   * bf16 x at C = 32, 64, 128 (edge_conv_kernel<C, winners>;
//     vcr_edge_conv): the space of LPDNet without a feature T-Net, whose x
//     is conv2_lpd's bf16 output. One plane: a [64 queries, 64 keys] tile
//     is one wgmma_m64n64_ss chain of C / 16 k steps.
//   * f32 x at C = 64 (edge_conv_split_kernel<winners>; vcr_edge_split, then
//     vcr_edge_conv_f32knn): the space after t_net_fea, which is f32 in
//     both packages and on which the JAX package's exact path selects
//     (rounded to bf16, it gives other neighbours to about 4% of the rows
//     at N = 1024: ROADMAP C5). A split pass (edge_split_kernel, one launch,
//     bound by its bytes) writes every value as three bf16 planes,
//       x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1),
//     whose sum is x exactly for |x| >= 2^-108 (3 x 8 significand bits
//     cover f32's 24; below, x2 is a bf16 subnormal and the sum is within
//     2^-133). A tile's dot products are the six exact bf16 products
//     xa . yb with a + b <= 2: six chains of four k steps into one f32
//     accumulator, smallest first (x2.y0, x1.y1, x0.y2, x1.y0, x0.y1,
//     x0.y0) so that the large term is added last. The dropped x1.y2,
//     x2.y1 and x2.y2 are below about 2^-26 of |x||y| a channel, under the
//     f32 sum's own rounding. A value that is NaN, +-inf or beyond bf16's
//     largest finite value (x0 = inf) leaves NaN in x2, so every score of
//     its row and of its column is NaN, then -inf. Three bf16 planes rather
//     than a 3xTF32 split: 6 bytes an element against 8, bf16's rate
//     (twice TF32's) for the same products, and the bf16 instance's own
//     loads and descriptors.
// The selection, the edge phase and the bf16 a, h, W2, b2 are the same in
// both.
//
// Bound on the H100: operations. Per query the kernel does an N x C score
// row (the f32 instance the six products of its planes, at the bf16 rate)
// and a [k, F] x [F, F] product; the bytes it must move are the four
// [B, N, *] activations (the f32 instance's planes besides). Neither a
// [B, N, N] nor a [B, N, k, F] tensor reaches device memory. What holds it
// is not the tensor cores: the selection's insertion chains take about
// half its time (edge_conv against edge_conv_from_idx on the same shapes),
// the edge phase's CUDA-core work (z, act, the maxima) most of the rest.
// The f32 instance's 24 k steps a key tile, against 4 at C = 64 in bf16,
// add about a fifth to its scores and selection (train/edge_conv_parts.py).
//
// A block is one warpgroup (128 threads) and owns 64 queries of one cloud.
//   * Scores: the block's query rows are one K-major operand ([64, C] in
//     128-byte-swizzled [64, 64] boxes, C = 32 uses the first half of one;
//     the f32 instance's three planes a box each). The cloud's rows stream
//     through a ring of key tiles filled by cp.async: in bf16 two slots,
//     the next tile landing in one while the other is read; in f32 one slot
//     of three planes, which the next tile refills once every warp has its
//     products and which lands while the tile is ranked. A tile's products
//     are one wgmma_m64n64_ss chain of C / 16 k steps (bf16) or six of four
//     (f32). Each warp fixes up its own 16 rows of the tile (the -|x_j|^2,
//     the diagonal, NaN) into a private staging area.
//   * The f32 instance keeps the bf16 instance's shared memory and so its
//     blocks an SM: the other blocks of an SM rank while a block waits for
//     its products. A second slot and a second accumulator (the next tile's
//     products issued before a tile is ranked) take 101376 bytes, two
//     blocks an SM: so built, the instance took 1.008 ms against this one's
//     0.818 at B = 64, N = 1024, and 1.493 against 1.257 with winners
//     (edge_conv_parts.py in turns, H100 80GB HBM3 at 700 W).
//   * Selection, in two passes over the key tiles (the scores of the
//     second are computed again) with the state in registers, by topk.cuh
//     (shared with knn_gather_max.cu and knn.cu): 64-bit keys of score and
//     column, each lane's two best keys in pass 1, the k-th of the warp's 64
//     as the threshold, and insertion of the keys at or above it into a
//     list ranked across the lanes in pass 2. Lane l of a warp sees columns
//     l and l + 32 of every tile of its 16 queries.
//   * The edge phase (edge_tile.cuh, shared with edge_conv_from_idx.cu):
//     wgmma m64n128 on tiles of two queries, z in registers.
// Shared memory per block (1024-aligned): the query rows R and the key
// ring, 2 R in bf16 (R = 16384) and R in f32 (three 8192-byte planes,
// R = 24576); once the selection is made W2, 32768, takes the place of the
// query rows and the ring, and the edge phase's gathered rows, 16384,
// follow it. Then the score staging 4 warps * 16 rows * 72 f32 = 18432 (the
// edge phase's exchange reuses it), the selections 8192, plus 1024 bytes of
// alignment slack: 76800 bytes in both instances. It does not depend on N.
// Three blocks an SM without winners (at most 170 registers a thread), two
// with. Registers (`-Xptxas -v`, which chip_smoke.py prints): 168 without
// winners, 247 with (the f32 instance 168 and 254: it loads b2 after the
// selection), no spills.
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
#include "edge_tile.cuh"
#include "topk.cuh"

namespace {

using namespace vcr::hopper;
using namespace vcr::edge;
using namespace vcr::topk;

constexpr int kKeyTile = 64;
constexpr int kStgStride = 72;  // floats a staged score row: 64 and 8 of padding
constexpr int kSplitPlanes = 3;  // the f32 instance's bf16 planes x0, x1, x2
// the bytes of the block's query rows and of a ring slot: [64, C <= 128]
// bf16 in two boxes, or the f32 instance's three [64, 64] planes
template <int kPlanes>
constexpr uint32_t kRowsBytes = kPlanes == 1 ? 2 * kBoxBytes : kPlanes * kBoxBytes;
// W2 is staged once the selection is made, over the query rows and the ring
constexpr uint32_t kQOff = 0;
template <int kPlanes>
constexpr uint32_t kRingOff = kQOff + kRowsBytes<kPlanes>;
// the key ring: two slots of bf16 rows, one of the f32 instance's planes
template <int kPlanes>
constexpr int kRingSlots = kPlanes == 1 ? 2 : 1;
template <int kPlanes>
constexpr uint32_t kStgOff = kRingOff<kPlanes> + kRingSlots<kPlanes> * kRowsBytes<kPlanes>;
static_assert(kW2Bytes <= 3 * kRowsBytes<1>, "W2 takes the place of the query rows and the ring");
// the edge phase's gathered rows follow W2
constexpr uint32_t kABufOff = kW2Bytes;
static_assert(kABufOff + kABufBytes <= kStgOff<1> && kABufOff + kABufBytes <= kStgOff<3>,
              "the gathered rows fit beside W2");
constexpr uint32_t kStgBytes = 4 * 16 * kStgStride * sizeof(float);
static_assert(kRedBytes <= kStgBytes, "the edge phase's exchange reuses the score staging");
template <int kPlanes>
constexpr uint32_t kSelOff = kStgOff<kPlanes> + kStgBytes;
template <int kPlanes>
constexpr size_t kSmemBytes = 1024 + kSelOff<kPlanes> + kSelBytes;
static_assert(kSmemBytes<1> == 76800 && kSmemBytes<3> == 76800, "three blocks an SM");

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

// The f32 instance's rows: the same 64 rows of each bf16 plane of the split
// (plane p at src + p * plane), one box a plane.
__device__ __forceinline__ void load_planes(uint8_t* dst, const bf16* __restrict__ src,
                                            size_t plane, int rows) {
#pragma unroll
  for (int p = 0; p < kSplitPlanes; ++p) load_rows<64>(dst + p * kBoxBytes, src + p * plane, rows);
}

// The f32 instance's products of a key tile: the six plane pairs (a, b),
// a + b <= 2, of the query planes qs and the key planes ks into one
// accumulator, smallest first; one committed group, which the caller waits
// for.
__device__ __forceinline__ void split_products(float (&acc)[32], const bf16* qs, const bf16* ks) {
  constexpr int kPairs[6][2] = {{2, 0}, {1, 1}, {0, 2}, {1, 0}, {0, 1}, {0, 0}};
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64_ss(acc, desc_k_major(qs + kPairs[p][0] * kBox * kBox, kk),
                      desc_k_major(ks + kPairs[p][1] * kBox * kBox, kk), p > 0 || kk > 0);
  wgmma_commit();
}

// The warp's 16 rows of key tile t from the accumulator (rows g and g + 8
// of the warp, query i_g = its row g, columns 8 j + 2 q and + 1) into its
// staging: 2 d - |x_j|^2, the diagonal and NaN at -inf.
__device__ __forceinline__ void stage_scores(const float (&sc)[32], const float* __restrict__ nb,
                                             int t, int i_g, float* stg) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int i_g8 = i_g + 8;
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

// Step u of the walk over the key tiles (tile t; pass 1 for u < n_tiles,
// pass 2 after) on the warp's staged scores: lane l takes columns l and
// l + 32 of its 16 queries.
__device__ __forceinline__ void rank_tile(const float* stg, int u, int n_tiles, int t, int k,
                                          uint64_t (&m1)[16], uint64_t (&m2)[16]) {
  const int lane = threadIdx.x & 31;
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
}

// One block of either instance: kPlanes 1 (x a bf16 [B, N, C]) or 3 (x the
// f32 instance's planes [3, B, N, 64] of the split pass).
template <int C, bool kWinners, int kPlanes>
__device__ __forceinline__ void edge_conv_block(
    const bf16* __restrict__ x,       // [B, N, C] or [3, B, N, 64]
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
  constexpr bool kSplit = kPlanes == kSplitPlanes;
  static_assert(kPlanes == 1 || (kSplit && C == 64), "the split space is 64 wide");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  const bf16* w2s = reinterpret_cast<const bf16*>(base);
  const bf16* qs = reinterpret_cast<const bf16*>(base + kQOff);
  int* sel = reinterpret_cast<int*>(base + kSelOff<kPlanes>);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const int n_tiles = (n + kKeyTile - 1) / kKeyTile;
  const int n_valid = min(kTileQ, n - q0);  // the block's queries within the cloud
  const bf16* xb = x + static_cast<size_t>(b) * n * C;
  const float* nb = norms + static_cast<size_t>(b) * n_tiles * kKeyTile;
  const size_t plane = kSplit ? static_cast<size_t>(gridDim.y) * n * C : 0;  // of a split plane

  if constexpr (kSplit) {
    load_planes(base + kQOff, xb + static_cast<size_t>(q0) * C, plane, n_valid);
    load_planes(base + kRingOff<kPlanes>, xb, plane, min(kKeyTile, n));
  } else {
    load_rows<C>(base + kQOff, xb + static_cast<size_t>(q0) * C, n_valid);
    load_rows<C>(base + kRingOff<kPlanes>, xb, min(kKeyTile, n));
  }
  cp_async_commit();
  uint32_t b2p[16];
  if constexpr (!kSplit) load_b2(b2, b2p);  // split: after the selection (16 registers)

  // per query of the warp: pass 1 keeps the lane's two best keys (m1, m2),
  // pass 2 the sorted list (rank = lane) of the keys at or above thr
  uint64_t m1[16], m2[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m1[r] = m2[r] = 0;  // below every key
  float* stg = reinterpret_cast<float*>(base + kStgOff<kPlanes>) + warp * 16 * kStgStride;
  const int i_g = q0 + warp * 16 + g, i_g8 = i_g + 8;
  if constexpr (kSplit) {
    // one ring slot: a tile's products are waited for, then the next
    // tile's planes land in the slot while the tile is ranked
    const bf16* ks = reinterpret_cast<const bf16*>(base + kRingOff<kPlanes>);
    for (int u = 0; u < 2 * n_tiles; ++u) {  // the key tiles twice: one pass each
      const int t = u < n_tiles ? u : u - n_tiles;
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // tile t's planes are in
      float sc[32];
      split_products(sc, qs, ks);
      wgmma_wait<0>();
      fence_regs(sc);
      __syncthreads();  // every warp's products have read the slot
      if (u + 1 < 2 * n_tiles) {
        const int next = (u + 1) % n_tiles;
        load_planes(base + kRingOff<kPlanes>, xb + static_cast<size_t>(next) * kKeyTile * C,
                    plane, min(kKeyTile, n - next * kKeyTile));
        cp_async_commit();
      }
      stage_scores(sc, nb, t, i_g, stg);
      rank_tile(stg, u, n_tiles, t, k, m1, m2);
    }
  } else {
    for (int u = 0; u < 2 * n_tiles; ++u) {  // the key tiles twice: one pass each
      const int t = u < n_tiles ? u : u - n_tiles;
      if (u + 1 < 2 * n_tiles) {
        const int next = (u + 1) % n_tiles;
        load_rows<C>(base + kRingOff<kPlanes> + ((u + 1) & 1) * kRowsBytes<kPlanes>,
                     xb + static_cast<size_t>(next) * kKeyTile * C,
                     min(kKeyTile, n - next * kKeyTile));
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      fence_proxy_async();
      __syncthreads();

      // the warp's 16 rows of the tile into its staging (as stage_scores)
      float sc[32];
      const bf16* ks =
          reinterpret_cast<const bf16*>(base + kRingOff<kPlanes> + (u & 1) * kRowsBytes<kPlanes>);
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
      // the score of the warp's query r at column lane + 32 h of the tile
      // (as rank_tile)
      const auto score = [&](int r, int half) -> float {
        return stg[r * kStgStride + lane + 32 * half];
      };
      const int j0 = t * kKeyTile + lane;
      if (u < n_tiles) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          keep_top2(m1[r], m2[r], rank_key(score(r, 0), j0));
          keep_top2(m1[r], m2[r], rank_key(score(r, 1), j0 + 32));
        }
        if (u == n_tiles - 1) {
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
  }
  stage_w2_mn(w2, reinterpret_cast<bf16*>(base));  // lands while the selections are written
  cp_async_commit();
  if constexpr (kSplit) load_b2(b2, b2p);
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
                      base + kStgOff<kPlanes>, base + kABufOff, slope);
}

#define EDGE_CONV_PARAMS                                                                     \
  const bf16* __restrict__ x, const float* __restrict__ norms, const bf16* __restrict__ a,  \
      const bf16* __restrict__ h, const bf16* __restrict__ w2, const bf16* __restrict__ b2, \
      bf16* __restrict__ x1, bf16* __restrict__ x2, int* __restrict__ idx,                  \
      uint8_t* __restrict__ win1, uint8_t* __restrict__ win2, int n, int k, float slope

template <int C, bool kWinners>
__global__ void __launch_bounds__(kThreads, kWinners ? 2 : 3)
edge_conv_kernel(EDGE_CONV_PARAMS) {
  edge_conv_block<C, kWinners, 1>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, n, k, slope);
}

// x: the planes [3, B, N, 64] (B = gridDim.y)
template <bool kWinners>
__global__ void __launch_bounds__(kThreads, kWinners ? 2 : 3)
edge_conv_split_kernel(EDGE_CONV_PARAMS) {
  edge_conv_block<64, kWinners, kSplitPlanes>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2,
                                              n, k, slope);
}

// The split pass: each f32 of x as three bf16 planes (x0, x1, x2 as defined
// above; the subtractions are exact where x0 is finite), eight values a
// thread: two 16-byte loads, one 16-byte store a plane.
__global__ void __launch_bounds__(256) edge_split_kernel(const float4* __restrict__ x,
                                                         uint4* __restrict__ planes,
                                                         size_t octs) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= octs) return;
  const float4 lo = __ldg(x + 2 * i), hi = __ldg(x + 2 * i + 1);
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t p0[4], p1[4], p2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p0[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
    const float2 f0 = unpack_bf16(p0[j]);
    const float r0 = v[2 * j] - f0.x, r1 = v[2 * j + 1] - f0.y;
    p1[j] = pack_bf16(r0, r1);
    const float2 f1 = unpack_bf16(p1[j]);
    p2[j] = pack_bf16(r0 - f1.x, r1 - f1.y);
  }
  planes[i] = make_uint4(p0[0], p0[1], p0[2], p0[3]);
  planes[octs + i] = make_uint4(p1[0], p1[1], p1[2], p1[3]);
  planes[2 * octs + i] = make_uint4(p2[0], p2[1], p2[2], p2[3]);
}

template <int C, bool kWinners, int kPlanes>
cudaError_t launch(const void* x, const float* norms, const void* a, const void* h,
                   const void* w2, const void* b2, void* x1, void* x2, int* idx,
                   void* win1, void* win2, int batch, int n, int k, float slope,
                   cudaStream_t stream) {
  const auto kernel = kPlanes == 1 ? edge_conv_kernel<C, kWinners> : edge_conv_split_kernel<kWinners>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes<kPlanes>));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch);
  kernel<<<grid, kThreads, kSmemBytes<kPlanes>, stream>>>(
      static_cast<const bf16*>(x), norms, static_cast<const bf16*>(a),
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<bf16*>(x1), static_cast<bf16*>(x2), idx, static_cast<uint8_t*>(win1),
      static_cast<uint8_t*>(win2), n, k, slope);
  return cudaGetLastError();
}

template <int C, int kPlanes = 1>
cudaError_t launch(const void* x, const float* norms, const void* a, const void* h,
                   const void* w2, const void* b2, void* x1, void* x2, int* idx,
                   void* win1, void* win2, int batch, int n, int k, float slope,
                   cudaStream_t stream) {
  if (k < 1 || k > kRows || k >= n) return cudaErrorInvalidValue;
  if ((win1 == nullptr) != (win2 == nullptr)) return cudaErrorInvalidValue;
  return win1 != nullptr
             ? launch<C, true, kPlanes>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n,
                                        k, slope, stream)
             : launch<C, false, kPlanes>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch,
                                         n, k, slope, stream);
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

// The split pass: x f32 [count] (count % 8 == 0, 16-byte aligned) ->
// planes bf16 [3, count] (16-byte aligned): x0, x1, x2 of every value.
cudaError_t vcr_edge_split(const float* x, void* planes, int64_t count, cudaStream_t stream) {
  if (count % 8) return cudaErrorInvalidValue;
  const size_t octs = static_cast<size_t>(count / 8);
  if (octs == 0) return cudaSuccess;
  edge_split_kernel<<<static_cast<unsigned>((octs + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), static_cast<uint4*>(planes), octs);
  return cudaGetLastError();
}

// The f32 instance: x the split pass's planes bf16 [3, B, N, 64] of an f32
// kNN space [B, N, 64] (c must be 64), norms that space's f32 norms; the
// same outputs, selected on the f32 values. The signature is
// vcr_edge_conv's.
cudaError_t vcr_edge_conv_f32knn(const void* x, const float* norms, const void* a,
                                 const void* h, const void* w2, const void* b2, void* x1,
                                 void* x2, int* idx, void* win1, void* win2, int batch, int n,
                                 int c, int k, float slope, cudaStream_t stream) {
  if (c != 64) return cudaErrorInvalidValue;
  return launch<64, kSplitPlanes>(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch, n, k,
                                  slope, stream);
}

// The xyz scores and selection of the kNN kernels, shared by
// knn_gather_max.cu, which fuses the selection with a gather-max, and
// knn.cu's xyz path, which returns the selection alone: the same cloud gives
// the same score bits (xyz_score is the only expression of an xyz score in
// the port) and, through the same exact selection, the same neighbours.
// (edge_conv.cu computes its bf16 scores with wgmma on its own tiles and
// selects with the same topk.cuh.)
//
//   scores[i, j] = 2 x_i . x_j - |x_j|^2   (f32; j == i at -inf, NaN -> -inf)
//
// A block owns kQueriesPerBlock queries of one cloud, kQueriesPerWarp to a
// warp. The cloud's points are staged once in shared memory as one float4
// each (x, y, z, -|x|^2): 16 KB at N = 1024, 48 KB at N = 3072; a larger
// cloud goes through in tiles of kMaxStaged points, staged again for the
// second pass. Lane l takes columns l, l + 32, ... of its warp's rows and
// selects in the two passes of topk.cuh, computing the scores again in the
// second (eight operations a score, against a 16-byte shared-memory load
// that serves both of the warp's queries).
#pragma once

#include "topk.cuh"

namespace vcr {
namespace knn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueriesPerWarp = 2;
constexpr int kQueriesPerBlock = kWarps * kQueriesPerWarp;
constexpr int kMaxStaged = 3072;  // points staged at once: 48 KB

// The score of key point p for query point q, both staged as (x, y, z,
// -|x|^2), with self for the diagonal. The dot product is a chain of fused
// multiply-adds in coordinate order, as a matrix product over C = 3
// accumulates (ops/_common.py:knn_scores); 2 d - |p|^2 is rounded once (2 d
// is exact, so one fma rounds it as a product and a subtraction would).
__device__ __forceinline__ float xyz_score(float4 q, float4 p, bool self) {
  const float d = __fmaf_rn(q.z, p.z, __fmaf_rn(q.y, p.y, __fmul_rn(q.x, p.x)));
  const float s = __fmaf_rn(2.f, d, p.w);
  return self ? -CUDART_INF_F : vcr::finite_or_neg_inf(s);
}

// Shared memory of a block, launch grid of the blocks.
inline size_t staged_bytes(int n) {
  return sizeof(float4) * static_cast<size_t>(n < kMaxStaged ? n : kMaxStaged);
}
inline dim3 grid(int n, int batch) {
  return dim3((n + kQueriesPerBlock - 1) / kQueriesPerBlock, batch);
}

// Points [t0, t0 + m) of the cloud into pts.
__device__ __forceinline__ void stage(float4* pts, const float* __restrict__ xb,
                                      const float* __restrict__ nb, int t0, int m) {
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const int j = t0 + t;
    pts[t] = make_float4(xb[3 * j], xb[3 * j + 1], xb[3 * j + 2], -nb[j]);
  }
}

// Every warp of the block selects the k (<= 32, < n) best columns of its
// queries i0 + q, q < kQueriesPerWarp, of the cloud (xb [n, 3], nb [n]):
// lane r of list[q] ends with the key of rank r (topk::key_column gives
// its column). A query past the end takes the last point's row and is not
// to be stored. Every thread of the block calls it (block barriers).
__device__ __forceinline__ void block_xyz_topk(const float* __restrict__ xb,
                                               const float* __restrict__ nb, int n, int k,
                                               int i0, float4* pts,
                                               uint64_t (&list)[kQueriesPerWarp]) {
  using namespace vcr::topk;
  const int lane = threadIdx.x & 31;
  const int tile = n < kMaxStaged ? n : kMaxStaged;
  float4 q[kQueriesPerWarp];
  int qi[kQueriesPerWarp];
  // pass 1 state: each lane's two best (order, column), INT_MIN for none
  int o1[kQueriesPerWarp], o2[kQueriesPerWarp], j1[kQueriesPerWarp], j2[kQueriesPerWarp];
#pragma unroll
  for (int u = 0; u < kQueriesPerWarp; ++u) {
    qi[u] = i0 + u < n ? i0 + u : n - 1;
    q[u] = make_float4(xb[3 * qi[u]], xb[3 * qi[u] + 1], xb[3 * qi[u] + 2], 0.f);
    o1[u] = o2[u] = INT_MIN;
    j1[u] = j2[u] = -1;
    list[u] = 0;
  }

  // pass 1: each lane's two best keys, compared as orders (the lane's
  // columns ascend, so a strict > keeps the smaller column on ties, as the
  // keys order them)
  for (int t0 = 0; t0 < n; t0 += tile) {
    const int m = n - t0 < tile ? n - t0 : tile;
    if (t0 > 0) __syncthreads();  // the tile before is read
    stage(pts, xb, nb, t0, m);
    __syncthreads();
    for (int jj = lane; jj < m; jj += 32) {
      const float4 p = pts[jj];
      const int j = t0 + jj;
#pragma unroll
      for (int u = 0; u < kQueriesPerWarp; ++u) {
        const int o = score_order(xyz_score(q[u], p, j == qi[u]));
        const bool first = o > o1[u], second = o > o2[u];
        o2[u] = first ? o1[u] : (second ? o : o2[u]);
        j2[u] = first ? j1[u] : (second ? j : j2[u]);
        o1[u] = first ? o : o1[u];
        j1[u] = first ? j : j1[u];
      }
    }
  }
  // at least k keys (distinct) are at or above the k-th best of the lanes'
  // 64: so are the k best of the row (no score: INT_MIN and -1 make key 0)
  uint64_t thr[kQueriesPerWarp];
#pragma unroll
  for (int u = 0; u < kQueriesPerWarp; ++u)
    thr[u] = warp_kth_of_64(order_key(o1[u], j1[u]), order_key(o2[u], j2[u]), k);

  // pass 2: the keys at or above the threshold into the ranked list; a
  // cloud staged whole stays in place
  for (int t0 = 0; t0 < n; t0 += tile) {
    const int m = n - t0 < tile ? n - t0 : tile;
    if (n > tile) {
      __syncthreads();
      stage(pts, xb, nb, t0, m);
      __syncthreads();
    }
    for (int jb = 0; jb < m; jb += 32) {  // whole warps: insert_from ballots
      const int jj = jb + lane;
      const float4 p = pts[jj < m ? jj : m - 1];
      const int j = t0 + jj;
#pragma unroll
      for (int u = 0; u < kQueriesPerWarp; ++u)
        insert_from(list[u], jj < m ? order_key(score_order(xyz_score(q[u], p, j == qi[u])), j) : 0,
                    thr[u]);
    }
  }
}

}  // namespace knn
}  // namespace vcr

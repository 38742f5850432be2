// The two-pass top-k selection of the kNN kernels, one warp per score row.
//
// Shared by edge_conv.cu (scores from wgmma tiles) and knn_scores.cuh
// (xyz scores on the CUDA cores: knn_gather_max.cu and knn.cu's xyz path).
// A key is the order-preserving uint32 of the f32 score (zero made +0; NaN
// is already -inf) above the complement of the column, so one 64-bit
// comparison orders by score and then by the smaller column, as
// common.cuh:warp_select_topk compares, and the -inf diagonal stays
// selectable in its own order. Every key is above 0, which therefore
// stands for "no key" (a lane past the end of a row).
//
// Pass 1 keeps each lane's two best keys (keep_top2, or on 32-bit orders as
// knn_scores.cuh does); the k-th best of the
// warp's 64 (warp_kth_of_64) is a threshold with at least k keys at or
// above it, so the row's k best are among them. Pass 2 inserts every key
// at or above the threshold into a list sorted across the lanes (lane r
// holds rank r; insert_from): rank by a ballot, shift by one shuffle. On
// random rows about k + 1 keys are inserted, and no pass reads a row k
// times as warp_select_topk does.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace vcr {
namespace topk {

// The selection key of score s at column j: larger key = ranks first.
__device__ __forceinline__ uint64_t rank_key(float s, int j) {
  if (s == 0.f) s = 0.f;  // -0 and +0 compare equal as floats
  uint32_t u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return static_cast<uint64_t>(u) << 32 | static_cast<uint32_t>(~j);
}

// The order-preserving int32 of score s (NaN excluded): s > t as floats iff
// score_order(s) > score_order(t) as ints, -0 and +0 one value, and every
// score's order above INT_MIN, which stands for "no score". order_key of it
// is rank_key's key: order_key(score_order(s), j) == rank_key(s, j).
__device__ __forceinline__ int score_order(float s) {
  const int i = __float_as_int(__fadd_rn(s, 0.f));  // -0 + 0 = +0
  return i ^ ((i >> 31) & 0x7fffffff);
}
__device__ __forceinline__ uint64_t order_key(int order, int j) {
  return static_cast<uint64_t>(static_cast<uint32_t>(order) ^ 0x80000000u) << 32 |
         static_cast<uint32_t>(~j);
}

// The column of a key.
__device__ __forceinline__ int key_column(uint64_t key) {
  return static_cast<int>(~static_cast<uint32_t>(key));
}

// Sort one key a lane across the warp (bitonic), descending (lane r gets
// rank r) or ascending.
__device__ __forceinline__ uint64_t warp_sort(uint64_t key, bool descending) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t other = __shfl_xor_sync(kFullMask, key, stride);
      const bool block_desc = size == 32 ? descending : (lane & size) == 0;
      const bool keep_max = ((lane & stride) == 0) == block_desc;
      key = keep_max ? (other > key ? other : key) : (other < key ? other : key);
    }
  return key;
}

// The k-th largest (k <= 32) of the warp's 64 keys m1, m2 (one pair a lane):
// the top 32 of a descending and an ascending sorted run are their
// lane-wise maxima, a bitonic sequence, which five steps sort.
__device__ __forceinline__ uint64_t warp_kth_of_64(uint64_t m1, uint64_t m2, int k) {
  const int lane = threadIdx.x & 31;
  uint64_t key = warp_sort(m1, true);
  const uint64_t asc = warp_sort(m2, false);
  key = key > asc ? key : asc;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const uint64_t other = __shfl_xor_sync(kFullMask, key, stride);
    key = ((lane & stride) == 0) == (other > key) ? other : key;
  }
  return __shfl_sync(kFullMask, key, k - 1);
}

// The lane's two best keys so far.
__device__ __forceinline__ void keep_top2(uint64_t& m1, uint64_t& m2, uint64_t key) {
  const bool first = key > m1;
  m2 = first ? m1 : (key > m2 ? key : m2);
  m1 = first ? key : m1;
}

// Insert each lane's key that is at least ``thr`` into the warp's sorted
// list (lane r holds rank r), one at a time: rank by a ballot, shift by one
// shuffle.
__device__ __forceinline__ void insert_from(uint64_t& list, uint64_t key, uint64_t thr) {
  const int lane = threadIdx.x & 31;
  unsigned cand = __ballot_sync(kFullMask, key >= thr);
  while (cand) {
    const int src = __ffs(cand) - 1;
    cand &= cand - 1;
    const uint64_t x = __shfl_sync(kFullMask, key, src);
    const int pos = __popc(__ballot_sync(kFullMask, list > x));
    const uint64_t up = __shfl_up_sync(kFullMask, list, 1);
    list = lane > pos ? up : (lane == pos ? x : list);
  }
}

}  // namespace topk
}  // namespace vcr

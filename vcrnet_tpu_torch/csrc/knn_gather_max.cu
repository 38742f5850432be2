// LPDNet SN block: xyz kNN fused with a channel-wise gather-max.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:fused_knn_gather_max
// (_fused_gather_max_impl -> _gather_max_kernel, with the exact selection
// and exact gathers: packed_select=False, int8_gather=False).
//
//   scores[i, j] = 2 x_i . x_j - |x_j|^2   (f32, j == i masked to -inf)
//   idx[i]       = top-k columns of scores[i], ties to the smaller column
//   out[i, c]    = max_{j in idx[i]} values[j, c]
//
// Bound on the H100: bytes. The kernel reads x (12 B/point) and the value
// table (2F B/point, gathered k times but from L2) and writes out + idx;
// the C = 3 score product is about 8 N operations a query on the CUDA
// cores. The [N, N] scores never leave the SM:
//   * scores and selection (knn_scores.cuh, shared with knn.cu's xyz
//     path): the cloud staged once a block as float4 (x, y, z, -|x|^2), two
//     queries a warp, lane l on columns l, l + 32, ...; the two-pass
//     selection of topk.cuh (each lane's two best 64-bit keys, the k-th of
//     the warp's 64 as a threshold, then about k + 1 insertions into a list
//     ranked across the lanes) in place of k full passes over a score row;
//   * the gather (common.cuh:warp_gather_max, shared with
//     gather_max_from_idx.cu): the selection in shared memory, 16-byte
//     indexed loads of the k rows. The TPU's one-hot matmul gather and its
//     int8 table are not carried over: an indexed load is exact and cheap
//     here.
//
// Training: with a non-null ``win`` the kernel also writes, per output
// channel, the k-position of the neighbour that won the max (uint8, the
// first position on ties: strict > in selection order, as the Pallas
// kernel's emit_winners). gather_max_bwd.cu routes the gradient by it.
#include "knn_scores.cuh"

namespace {

using namespace vcr::knn;

__global__ void __launch_bounds__(kThreads)
knn_gather_max_kernel(const float* __restrict__ x,       // [B, N, 3]
                      const float* __restrict__ norms,   // [B, N]
                      const __nv_bfloat16* __restrict__ values,  // [B, N, F]
                      __nv_bfloat16* __restrict__ out,   // [B, N, F]
                      int* __restrict__ idx,             // [B, N, k]
                      uint8_t* __restrict__ win,         // [B, N, F] or null
                      int n, int f, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sel_all[kWarps * 32];  // a warp's selection, for its gathers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kQueriesPerBlock + warp * kQueriesPerWarp;
  uint64_t list[kQueriesPerWarp];
  block_xyz_topk(x + static_cast<size_t>(b) * n * 3, norms + static_cast<size_t>(b) * n, n, k,
                 i0, reinterpret_cast<float4*>(smem), list);

  const __nv_bfloat16* table = values + static_cast<size_t>(b) * n * f;
  int* sel = sel_all + warp * 32;
#pragma unroll
  for (int u = 0; u < kQueriesPerWarp; ++u) {
    if (i0 + u >= n) break;
    const size_t row = static_cast<size_t>(b) * n + i0 + u;
    const int col = vcr::topk::key_column(list[u]);
    if (lane < k) idx[row * k + lane] = sel[lane] = col;
    __syncwarp();
    vcr::warp_gather_max(table, sel, k, f, out + row * f,
                         win != nullptr ? win + row * f : nullptr);
    __syncwarp();  // the next query's selection takes sel's place
  }
}

}  // namespace

// x f32 [B,N,3], norms f32 [B,N], values bf16 [B,N,F] -> out bf16 [B,N,F],
// idx int32 [B,N,k], and with a non-null win the winners uint8 [B,N,F].
// Requires F % 8 == 0, 16-byte aligned values/out, 8-byte aligned win,
// 0 < k <= 32, k < N. Returns the launch status.
cudaError_t vcr_knn_gather_max(const float* x, const float* norms,
                               const void* values, void* out, int* idx, void* win,
                               int batch, int n, int f, int k,
                               cudaStream_t stream) {
  if (k < 1 || k > 32 || k >= n || f % 8) return cudaErrorInvalidValue;
  const size_t smem = staged_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      knn_gather_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  knn_gather_max_kernel<<<grid(n, batch), kThreads, smem, stream>>>(
      x, norms, static_cast<const __nv_bfloat16*>(values),
      static_cast<__nv_bfloat16*>(out), idx, static_cast<uint8_t*>(win), n, f, k);
  return cudaGetLastError();
}

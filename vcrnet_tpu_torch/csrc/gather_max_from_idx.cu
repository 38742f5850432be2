// LPDNet SN block over a GIVEN neighbour selection: channel-wise gather-max.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:gather_max_from_idx
// (_gather_max_from_idx_impl -> _gather_max_from_idx_kernel).
//
//   out[i, c] = max_{r < k} values[idx[i, r], c]
//
// It is knn_gather_max.cu without the score row and the selection: the
// refinement loop computes the source's xyz kNN once (rigid transforms keep
// distances) and later iterations only gather. The TPU kernel gathered with
// one [k*TQ, N] one-hot matmul because the TPU has no indexed load; here one
// warp owns one query, reads its k indices and reduces the k value rows with
// 16-byte indexed loads (common.cuh:warp_gather_max, the same device code as
// knn_gather_max.cu, so the two agree bit for bit on the same idx).
//
// Bound on the H100: bytes (idx, the value table once, out; no arithmetic
// but k comparisons per channel). The k-fold re-reads of the table hit L2.
//
// Training: with a non-null ``win`` the kernel also writes each channel's
// winning k-position (uint8, the first on ties, as the Pallas kernel's
// emit_winners); gather_max_bwd.cu routes the gradient by it.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // queries per block, one per warp

__global__ void __launch_bounds__(kWarps * 32)
gather_max_from_idx_kernel(const int* __restrict__ idx,               // [B, N, k]
                           const __nv_bfloat16* __restrict__ values,  // [B, N, F]
                           __nv_bfloat16* __restrict__ out,           // [B, N, F]
                           uint8_t* __restrict__ win,                 // [B, N, F] or null
                           int n, int f, int k) {
  __shared__ int sel_all[kWarps * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // no block-wide barrier below

  int* sel = sel_all + warp * 32;
  const size_t row = static_cast<size_t>(b) * n + i;
  if (lane < k) sel[lane] = idx[row * k + lane];
  __syncwarp();
  vcr::warp_gather_max(values + static_cast<size_t>(b) * n * f, sel, k, f, out + row * f,
                       win != nullptr ? win + row * f : nullptr);
}

}  // namespace

// idx int32 [B,N,k] with entries in [0, N), values bf16 [B,N,F] -> out bf16
// [B,N,F], and with a non-null win the winners uint8 [B,N,F]. Requires
// F % 8 == 0, 16-byte aligned values/out, 8-byte aligned win, k <= 32.
// Returns the launch status.
cudaError_t vcr_gather_max_from_idx(const int* idx, const void* values, void* out, void* win,
                                    int batch, int n, int f, int k, cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, batch);
  gather_max_from_idx_kernel<<<grid, kWarps * 32, 0, stream>>>(
      idx, static_cast<const __nv_bfloat16*>(values), static_cast<__nv_bfloat16*>(out),
      static_cast<uint8_t*>(win), n, f, k);
  return cudaGetLastError();
}

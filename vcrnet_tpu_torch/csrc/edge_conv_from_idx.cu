// LPDNet DG block over a GIVEN neighbour selection.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:edge_conv_from_idx
// (-> _edge_conv_from_idx_kernel). Eval only, no backward.
//
//   z_ij  = act(a[idx[i, j]] + h[i])          (f32)
//   x1[i] = max_j z_ij
//   x2[i] = max_j act(bf16(z_ij) @ W2 + b2)   (f32 accumulation)
//
// It is edge_conv.cu without the distance product and the selection: the
// refinement loop reuses an earlier iteration's feature graph
// (Config.reuse_feature_knn). The TPU kernel gathered with a [k*TQ, N]
// one-hot matmul; here a block owns 16 queries, loads their indices, and
// each warp runs the edge phase of edge_tile.cuh (indexed loads of the k
// rows, the 20 -> 32 padded product with W2 on the tensor cores, the two
// maxima): the same device code as edge_conv.cu, so the two agree bit for
// bit on the same idx.
//
// Bound on the H100: operations (2*k*F*F flops per query against the three
// [B, N, F] activations and idx). W2 (32 KB) is staged once per block and
// no [B, N, k, F] tensor reaches device memory.
#include "edge_tile.cuh"

namespace {

using namespace vcr::edge;

constexpr size_t kSmemBytes = kEdgeBytes + kW2Bytes + kStageBytes + kSelBytes;

__global__ void __launch_bounds__(kWarps * 32)
edge_conv_from_idx_kernel(const int* __restrict__ idx,           // [B, N, k]
                          const __nv_bfloat16* __restrict__ a,   // [B, N, F]
                          const __nv_bfloat16* __restrict__ h,   // [B, N, F]
                          const __nv_bfloat16* __restrict__ w2,  // [F, F] (in, out)
                          const __nv_bfloat16* __restrict__ b2,  // [F]
                          __nv_bfloat16* __restrict__ x1,        // [B, N, F]
                          __nv_bfloat16* __restrict__ x2,        // [B, N, F]
                          int n, int k, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* zbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + kEdgeBytes);
  float* stage_all = reinterpret_cast<float*>(smem + kEdgeBytes + kW2Bytes);
  int* sel = reinterpret_cast<int*>(smem + kEdgeBytes + kW2Bytes + kStageBytes);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;

  stage_w2(w2, w2s);
  for (int q = warp; q < kTileQ; q += kWarps) {
    const int* qidx = idx + (static_cast<size_t>(b) * n + q0 + q) * k;
    sel[q * kRows + lane] = qidx[lane < k ? lane : 0];  // pad: repeats neighbour 0
  }
  __syncthreads();

  const __nv_bfloat16* ab = a + static_cast<size_t>(b) * n * kF;
  for (int q = warp; q < kTileQ; q += kWarps)
    warp_edge_rows(sel + q * kRows, ab, h, w2s, b2, x1, x2, nullptr, nullptr,
                   static_cast<size_t>(b) * n + q0 + q, zbuf + warp * kRows * kF,
                   stage_all + warp * 16 * 16, slope);
}

}  // namespace

// idx int32 [B,N,k] with entries in [0, N), a/h bf16 [B,N,128], w2 bf16
// [128,128] (in, out), b2 bf16 [128] -> x1/x2 bf16 [B,N,128]. Requires
// N % 16 == 0, k <= 32, 32-byte aligned pointers. Returns the launch status.
cudaError_t vcr_edge_conv_from_idx(const int* idx, const void* a, const void* h,
                                   const void* w2, const void* b2, void* x1, void* x2,
                                   int batch, int n, int k, float slope,
                                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_conv_from_idx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kTileQ, batch);
  edge_conv_from_idx_kernel<<<grid, kWarps * 32, kSmemBytes, stream>>>(
      idx, static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(b2),
      static_cast<__nv_bfloat16*>(x1), static_cast<__nv_bfloat16*>(x2), n, k, slope);
  return cudaGetLastError();
}

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
// one-hot matmul; here a block (one warpgroup) owns 64 consecutive query
// rows of the flattened [B*N] (the last block fewer: it gates on rows, not
// on N), loads their indices, and runs the edge phase
// of edge_tile.cuh (the rows gathered by cp.async and read as wgmma A
// fragments by ldmatrix, the [64, 128] x [128, 128] product per tile of two
// queries with W2 staged in swizzled boxes, the two maxima from registers):
// the same device code as edge_conv.cu, so the two agree bit for bit on the
// same idx.
//
// Bound on the H100: operations (2*k*F*F flops per query against the three
// [B, N, F] activations and idx). Shared memory per block: W2 32768, the
// selections 8192, the exchange 18432, the gathered rows 16384, plus 1024
// bytes of alignment slack = 76800 bytes: three blocks an SM (at most 170
// registers a thread). Registers (`-Xptxas -v`, which chip_smoke.py
// prints): 168, no spills. What holds it is the CUDA-core work around the
// product (z, act, the maxima and their exchange), not the tensor cores.
#include "edge_tile.cuh"

namespace {

using namespace vcr::hopper;
using namespace vcr::edge;

constexpr uint32_t kSelOff = kW2Bytes;
constexpr uint32_t kRedOff = kSelOff + kSelBytes;
constexpr uint32_t kABufOff = kRedOff + kRedBytes;
constexpr size_t kSmemBytes = 1024 + kABufOff + kABufBytes;

__global__ void __launch_bounds__(kThreads, 3)
edge_conv_from_idx_kernel(const int* __restrict__ idx,   // [B, N, k]
                          const bf16* __restrict__ a,    // [B, N, F]
                          const bf16* __restrict__ h,    // [B, N, F]
                          const bf16* __restrict__ w2,   // [F, F] (in, out)
                          const bf16* __restrict__ b2,   // [F]
                          bf16* __restrict__ x1,         // [B, N, F]
                          bf16* __restrict__ x2,         // [B, N, F]
                          int rows, int n, int k, float slope) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  int* sel = reinterpret_cast<int*>(base + kSelOff);
  const int row0 = blockIdx.x * kTileQ;

  stage_w2_mn(w2, reinterpret_cast<bf16*>(base));
  cp_async_commit();
  uint32_t b2p[16];
  load_b2(b2, b2p);
  for (int t = threadIdx.x; t < kTileQ * kRows; t += kThreads) {
    const int i = row0 + t / kRows, r = t % kRows;
    if (i < rows) sel[t] = idx[static_cast<size_t>(i) * k + (r < k ? r : 0)];  // pad: neighbour 0
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  edge_rows<false>(sel, min(kTileQ, rows - row0), row0, n, k, a, h,
                   reinterpret_cast<const bf16*>(base), b2p, x1,
                   x2, nullptr, nullptr, base + kRedOff, base + kABufOff, slope);
}

}  // namespace

// idx int32 [B,N,k] with entries in [0, N), a/h bf16 [B,N,128], w2 bf16
// [128,128] (in, out), b2 bf16 [128] -> x1/x2 bf16 [B,N,128]. Any N: the
// last block's queries past B*N (and, where B*N is odd, the last tile's
// second query) repeat a real query and are not written. Requires
// 0 < k <= 32, 16-byte aligned pointers. Returns the launch status.
cudaError_t vcr_edge_conv_from_idx(const int* idx, const void* a, const void* h,
                                   const void* w2, const void* b2, void* x1, void* x2,
                                   int batch, int n, int k, float slope,
                                   cudaStream_t stream) {
  if (n < 1 || k < 1 || k > kRows) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      edge_conv_from_idx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const int rows = batch * n;
  edge_conv_from_idx_kernel<<<(rows + kTileQ - 1) / kTileQ, kThreads, kSmemBytes, stream>>>(
      idx, static_cast<const bf16*>(a), static_cast<const bf16*>(h),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(x1),
      static_cast<bf16*>(x2), rows, n, k, slope);
  return cudaGetLastError();
}

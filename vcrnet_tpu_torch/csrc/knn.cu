// Exact kNN indices of a cloud in its own feature space, self excluded.
//
// Replaces vcrnet_tpu/ops/pallas_knn.py:fused_knn (_fused_knn_impl ->
// _knn_kernel), the selection behind graph.knn(method="auto"): DGCNN's xyz
// graph, in eval and in training.
//
//   scores[i, j] = 2 x_i . x_j - |x_j|^2   (f32, j == i masked to -inf)
//   idx[i]       = top-k columns of scores[i], ties to the smaller column
//
// Bound on the H100: operations (2 N (C + 1) f32 flops per query on the CUDA
// cores against 4 C + 4k bytes per point). The design keeps the [N, N]
// scores out of device memory: one warp per query builds the query's score
// row in shared memory and selects from it by exact f32 comparison
// (common.cuh:warp_select_topk). On f32 xyz (DGCNN's graph, the only input
// the models send) the score stage is knn_scores.cuh:warp_xyz_score_row,
// the device code knn_gather_max.cu runs, so this kernel returns that
// kernel's selection bit for bit. Any other input (f32 or bf16, C <= 512)
// takes a general path: the query row in shared memory, an f32
// fused-multiply-add chain over C per key. The TPU kernel's packed-int32
// selection is not copied.
#include "knn_scores.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr size_t kSmemLimit = 232448;  // shared memory a block can use on sm_90
constexpr size_t kSelBytes = sizeof(int) * 32;  // one warp's selection

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One warp per query: blockDim.x / 32 score rows, then the selections.
__device__ __forceinline__ void select_and_store(const float* row, int n, int k, int* sel,
                                                 int* __restrict__ qidx) {
  vcr::warp_select_topk(row, n, k, sel);
  const int lane = threadIdx.x & 31;
  if (lane < k) qidx[lane] = sel[lane];
}

__global__ void knn_xyz_kernel(const float* __restrict__ x,      // [B, N, 3]
                               const float* __restrict__ norms,  // [B, N]
                               int* __restrict__ idx,            // [B, N, k]
                               int n, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int i = blockIdx.x * warps + warp;
  if (i >= n) return;  // no block-wide barrier below
  float* row = reinterpret_cast<float*>(smem) + static_cast<size_t>(warp) * n;
  int* sel = reinterpret_cast<int*>(smem + sizeof(float) * warps * n) + warp * 32;
  vcr::knn::warp_xyz_score_row(x + static_cast<size_t>(b) * n * 3,
                               norms + static_cast<size_t>(b) * n, i, n, row);
  select_and_store(row, n, k, sel, idx + (static_cast<size_t>(b) * n + i) * k);
}

template <typename T>
__global__ void knn_general_kernel(const T* __restrict__ x,          // [B, N, C]
                                   const float* __restrict__ norms,  // [B, N]
                                   int* __restrict__ idx,            // [B, N, k]
                                   int n, int c, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int i = blockIdx.x * warps + warp;
  if (i >= n) return;  // no block-wide barrier below
  float* row = reinterpret_cast<float*>(smem) + static_cast<size_t>(warp) * n;
  float* qrow = reinterpret_cast<float*>(smem) + static_cast<size_t>(warps) * n + warp * c;
  int* sel = reinterpret_cast<int*>(smem + sizeof(float) * warps * (n + c)) + warp * 32;
  const T* xb = x + static_cast<size_t>(b) * n * c;
  const float* nb = norms + static_cast<size_t>(b) * n;
  for (int t = lane; t < c; t += 32) qrow[t] = to_float(xb[static_cast<size_t>(i) * c + t]);
  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    const T* kj = xb + static_cast<size_t>(j) * c;
    float d = 0.f;
    for (int t = 0; t < c; ++t) d = fmaf(qrow[t], to_float(kj[t]), d);
    const float s = 2.f * d - nb[j];
    row[j] = j == i ? -CUDART_INF_F : vcr::finite_or_neg_inf(s);
  }
  __syncwarp();
  select_and_store(row, n, k, sel, idx + (static_cast<size_t>(b) * n + i) * k);
}

// Queries (warps) per block of the warp-per-query kernels: as many of
// kMaxWarps as have room for their rows, 0 when not even one has.
int warps_that_fit(int n, int c_staged) {
  const size_t per_warp = sizeof(float) * (static_cast<size_t>(n) + c_staged) + kSelBytes;
  const size_t fit = kSmemLimit / per_warp;
  return static_cast<int>(fit < static_cast<size_t>(kMaxWarps) ? fit : kMaxWarps);
}

template <typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel kernel, int warps, size_t smem, int batch, int n,
                        cudaStream_t stream, Args... args) {
  if (warps < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + warps - 1) / warps, batch), warps * 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// x [B,N,C] f32 (is_bf16 == 0) or bf16, norms f32 [B,N] -> idx int32 [B,N,k].
// Requires k <= 32, k < N, C <= 512. Returns the launch status (cudaErrorInvalidValue when a score row does not
// fit a block's shared memory).
cudaError_t vcr_knn(const void* x, const float* norms, int* idx, int batch, int n, int c, int k,
                    int is_bf16, cudaStream_t stream) {
  if (!is_bf16 && c == 3) {
    const int warps = warps_that_fit(n, 0);
    const size_t smem = (sizeof(float) * n + kSelBytes) * (warps > 0 ? warps : 1);
    return launch_rows(knn_xyz_kernel, warps, smem, batch, n, stream,
                       static_cast<const float*>(x), norms, idx, n, k);
  }
  const int warps = warps_that_fit(n, c);
  const size_t smem = (sizeof(float) * (n + c) + kSelBytes) * (warps > 0 ? warps : 1);
  if (is_bf16)
    return launch_rows(knn_general_kernel<__nv_bfloat16>, warps, smem, batch, n, stream,
                       static_cast<const __nv_bfloat16*>(x), norms, idx, n, c, k);
  return launch_rows(knn_general_kernel<float>, warps, smem, batch, n, stream,
                     static_cast<const float*>(x), norms, idx, n, c, k);
}

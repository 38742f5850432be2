// The transformer pointer's position-wise feed-forward sublayer in one kernel.
//
// Replaces vcrnet_tpu/ops/pallas_pointer.py:fused_ff (_ff_kernel).
//
//   h   = bf16(relu(y @ W1 + b1))       (bf16 in, f32 accumulation and bias)
//   out = bf16(h @ W2 + b2)
//
// Bound on the H100: operations (4 D F flops per row against 4 D bytes in and
// out; the weights, 2 D F bf16 values, are shared by every row). Both
// products run on the tensor cores through warp-level mma (gemm_tile.cuh). A
// block owns 64 rows: its y tile and its [64, F] hidden tile stay in shared
// memory as bf16 (JAX's rounding point), W1 and W2 stream through shared
// memory in [64, 128] tiles, and only y and out touch device memory. The TPU
// kernel held both weight matrices in VMEM; a block's shared memory cannot.
#include "gemm_tile.cuh"

namespace {

using namespace vcr::gemm;

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) / 128 * 128; }

__global__ void __launch_bounds__(kThreads)
pointer_ff_kernel(const __nv_bfloat16* __restrict__ y,   // [rows, D]
                  const __nv_bfloat16* __restrict__ w1,  // [D, F] (in, out)
                  const __nv_bfloat16* __restrict__ b1,  // [F]
                  const __nv_bfloat16* __restrict__ w2,  // [F, D]
                  const __nv_bfloat16* __restrict__ b2,  // [D]
                  __nv_bfloat16* __restrict__ out,       // [rows, D]
                  long long rows, int d, int f) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + align128(tile_bytes(d)));
  unsigned char* scratch = smem + align128(tile_bytes(d)) + align128(tile_bytes(f));
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTM;
  const int ldy = padded(d), ldh = padded(f);

  load_rows(y, row0, static_cast<size_t>(rows), d, ys);
  block_gemm(ys, ldy, w1, d, f, scratch, [&](int r, int c, float v) {
    hs[r * ldh + c] = __float2bfloat16_rn(fmaxf(v + __bfloat162float(b1[c]), 0.f));
  });
  block_gemm(hs, ldh, w2, f, d, scratch, [&](int r, int c, float v) {
    if (row0 + r < static_cast<size_t>(rows))
      out[(row0 + r) * d + c] = __float2bfloat16_rn(v + __bfloat162float(b2[c]));
  });
}

}  // namespace

// Shared memory the kernel needs for widths (d, f).
size_t vcr_pointer_ff_smem(int d, int f) {
  return align128(tile_bytes(d)) + align128(tile_bytes(f)) + kScratchBytes;
}

// y bf16 [rows, D], w1 bf16 [D, F], b1 bf16 [F], w2 bf16 [F, D], b2 bf16 [D]
// -> out bf16 [rows, D]. Requires D % 128 == 0, F % 128 == 0, 32-byte aligned
// pointers, and vcr_pointer_ff_smem(D, F) within a block's shared memory
// (D = 512, F = 1024 takes 224,256 bytes). Returns the launch status.
cudaError_t vcr_pointer_ff(const void* y, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, long long rows, int d, int f,
                           cudaStream_t stream) {
  const size_t smem = vcr_pointer_ff_smem(d, f);
  cudaError_t err = cudaFuncSetAttribute(
      pointer_ff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((rows + kTM - 1) / kTM);
  pointer_ff_kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out), rows, d, f);
  return cudaGetLastError();
}

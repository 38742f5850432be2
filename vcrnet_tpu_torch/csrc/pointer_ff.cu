// The transformer pointer's position-wise feed-forward sublayer by hand.
//
// Replaces vcrnet_tpu/ops/pallas_pointer.py:fused_ff (_ff_kernel).
//
//   h   = bf16(relu(y @ W1 + b1))       (bf16 in, f32 accumulation and bias)
//   out = bf16(h @ W2 + b2)
//
// Bound on the H100: operations (4 D F flops per row against 4 D bytes in and
// out; the weights, 2 D F bf16 values, are shared by every row). Two launches
// of gemm_wgmma.cuh's persistent TMA + wgmma product over all rows at once
// (one counted launch of the wrapper): the first writes h, with its ReLU, to
// a [rows, F] bf16 scratch in device memory, the second reads it back. The
// product takes one n for all its jobs, and the two products' n differ
// (F, then D), so they are two launches. The Pallas kernel held both weight
// matrices and a row tile's hidden values in VMEM; here h crosses device
// memory (or L2) once each way, 2 F bytes a row against the 4 D F flops of
// the row's products, and each product reads its weights' slices from L2 by
// TMA for every tile of 128 rows.
#include "gemm_wgmma.cuh"

// Shared memory of the sublayer's kernels (both launches of the product),
// at any widths.
size_t vcr_pointer_ff_smem(int /*d*/, int /*f*/) { return vcr::gemm90::kSmemBytes; }

// y bf16 [rows, D], w1 bf16 [D, F], b1 bf16 [F], w2 bf16 [F, D], b2 bf16 [D],
// hidden bf16 [rows, F] scratch -> out bf16 [rows, D]. Requires D % 64 == 0,
// F % 64 == 0, 16-byte aligned pointers; any number of rows. Returns the
// launch status.
cudaError_t vcr_pointer_ff(const void* y, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* hidden, void* out, long long rows, int d, int f,
                           cudaStream_t stream) {
  using namespace vcr::gemm90;
  using Up = Epilogue<true, false, false>;  // bf16(relu(y W1 + b1))
  Jobs up{};
  up.depth = d;
  up.n = f;
  cudaError_t err = add_job<Up>(up, y, w1, b1, hidden, static_cast<int>(rows));
  if (err == cudaSuccess) err = launch_gemm<Up>(up, stream);
  if (err != cudaSuccess) return err;  // h is written

  Jobs down{};
  down.depth = f;
  down.n = d;
  err = add_job(down, hidden, w2, b2, out, static_cast<int>(rows));
  if (err != cudaSuccess) return err;
  return launch_gemm(down, stream);
}

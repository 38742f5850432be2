// The transformer pointer's multi-head attention sublayer by hand: the q, k
// and v projections, per-head softmax(q k^T / sqrt(dk)) v, the out
// projection.
//
// Replaces vcrnet_tpu/ops/pallas_pointer.py:fused_mha (_mha_kernel).
//
//   Q = bf16(yq @ Wq + bq),  K = bf16(ykv @ Wk + bk),  V = bf16(ykv @ Wv + bv)
//   per head:  s = (Q_h K_h^T) * sm_scale,  online softmax over 64-key tiles,
//              O_h = bf16((bf16(exp(s - m)) @ V_h) / l)
//   out = bf16(O @ Wo + bo)
//
// with f32 accumulation, scores and softmax, and the biases in bf16.
//
// Three kernels run for one call (one counted launch of the wrapper):
//   1. gemm_wgmma.cuh's product with three jobs: Q, K and V over all B * N
//      rows at once (A = yq for Q, ykv for K and V; for self-attention both
//      are one tensor), into a scratch in device memory;
//   2. flash_fwd.cuh's fwd_kernel over the projected Q, K and V,
//      writing O over Q in place (a block reads its Q tile once, before it
//      writes the same rows and columns of O);
//   3. the product again, one job: out = O @ Wo + bo.
// The Pallas kernel ran the sublayer per batch item with K and V kept in
// VMEM, and its own docstring (pallas_pointer.py:5-16) records why that
// loses on the TPU: per-item products of [1024, 512] x [512, 128] cannot
// keep the matrix unit busy. Here each projection is one product of B * N
// rows on the tensor cores (TMA + wgmma, bf16 in, f32 accumulate), and the
// attention is the warp-specialised online softmax of the model's own
// attention, one pass over the keys.
//
// Bound on the H100: operations (8 D^2 flops of projections and 4 Nk D of
// attention per query row against about 8 D bytes of activations and
// scratch a row); Q, K, V and O cross device memory (or L2) once each way.
//
// Numerics: the Pallas kernel rounded exp(s - m) to bf16 against each row's
// final max; the online softmax rounds it against the running max of 64-key
// tiles and rescales O when the max moves (ROADMAP C, "Online softmax in
// pointer_mha.cu"): the same divergence as flash_packed.cu's.
#include "flash_fwd.cuh"
#include "gemm_wgmma.cuh"

namespace {

constexpr int kDk = 128;

}  // namespace

// Shared memory of the sublayer's largest kernel (the products), at any
// model width.
size_t vcr_pointer_mha_smem(int /*d*/) {
  const size_t flash = vcr::flash::kSmemBytes;
  return vcr::gemm90::kSmemBytes > flash ? vcr::gemm90::kSmemBytes : flash;
}

// yq bf16 [B,Nq,D], ykv bf16 [B,Nk,D], wq/wk/wv/wo bf16 [D,D] (in, out),
// bq/bk/bv/bo bf16 [D], qscr bf16 [B,Nq,D] and kscr/vscr bf16 [B,Nk,D]
// scratch -> out bf16 [B,Nq,D]. Requires D = n_heads * 128, 16-byte aligned
// pointers (any Nq, Nk >= 1: the attention writes O over Q only in the rows
// of its own item below Nq). Returns the launch status.
cudaError_t vcr_pointer_mha(const void* yq, const void* ykv, const void* wq, const void* bq,
                            const void* wk, const void* bk, const void* wv, const void* bv,
                            const void* wo, const void* bo, void* qscr, void* kscr, void* vscr,
                            void* out, int batch, int nq, int nk, int d, int n_heads,
                            cudaStream_t stream) {
  using namespace vcr::gemm90;
  const int q_rows = batch * nq, kv_rows = batch * nk;

  Jobs qkv{};
  qkv.depth = d;
  qkv.n = d;
  cudaError_t err = add_job(qkv, yq, wq, bq, qscr, q_rows);
  if (err == cudaSuccess) err = add_job(qkv, ykv, wk, bk, kscr, kv_rows);
  if (err == cudaSuccess) err = add_job(qkv, ykv, wv, bv, vscr, kv_rows);
  if (err == cudaSuccess) err = launch_gemm(qkv, stream);
  if (err != cudaSuccess) return err;

  CUtensorMap q_map, k_map, v_map;
  err = make_box_map(&q_map, qscr, q_rows, d);
  if (err == cudaSuccess) err = make_box_map(&k_map, kscr, kv_rows, d);
  if (err == cudaSuccess) err = make_box_map(&v_map, vscr, kv_rows, d);
  if (err == cudaSuccess)
    err = vcr::flash::launch_fwd(q_map, k_map, v_map, static_cast<bf16*>(qscr), nullptr, batch,
                                 nq, nk, nk, n_heads, 1.0f / sqrtf(static_cast<float>(kDk)),
                                 stream);
  if (err != cudaSuccess) return err;

  Jobs proj{};
  proj.depth = d;
  proj.n = d;
  err = add_job(proj, qscr, wo, bo, out, q_rows);
  if (err != cudaSuccess) return err;
  return launch_gemm(proj, stream);
}

// Attention over packed heads: q/k/v [B, N, H*128], head h = columns
// [h*128, (h+1)*128), output in the same packed layout.
//
// Replaces vcrnet_tpu/ops/pallas_attention.py:flash_mha_packed
// (_flash_packed_impl -> _fwd_packed_kernel, :239) and, with the row
// logsumexp written out, the training forward _fwd_library (:66).
//
// The kernel is flash_fwd.cuh's fwd_kernel, which pointer_mha.cu (the
// sublayer's attention) launches too, and whose producer and online softmax
// colmass.cu's lse_kernel shares: the design, its bound and its numerics are
// described there.
//
// Training: with a non-null ``lse`` the kernel also writes each row's
// logsumexp m + log(l) of the scaled scores ([B, H, Nq] f32), from which
// flash_bwd.cu recomputes the probabilities.
#include "flash_fwd.cuh"

// q bf16 [B,Nq,H*128], k/v bf16 [B,Nk,H*128] -> out bf16 [B,Nq,H*128], and
// with a non-null lse the row logsumexp f32 [B,H,Nq], over the first
// nk_valid keys (1 <= nk_valid <= Nk; finite K and V rows beyond it). Any
// Nq, Nk (rows past them in a last tile: flash_fwd.cuh); 16-byte aligned
// pointers.
cudaError_t vcr_flash_packed(const void* q, const void* k, const void* v, void* out,
                             float* lse, int batch, int nq, int nk, int nk_valid,
                             int n_heads, float sm_scale, cudaStream_t stream) {
  using namespace vcr::hopper;
  const uint64_t d_model = static_cast<uint64_t>(n_heads) * vcr::flash::kDk;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_box_map(&q_map, q, static_cast<uint64_t>(batch) * nq, d_model);
  if (err == cudaSuccess) err = make_box_map(&k_map, k, static_cast<uint64_t>(batch) * nk, d_model);
  if (err == cudaSuccess) err = make_box_map(&v_map, v, static_cast<uint64_t>(batch) * nk, d_model);
  if (err != cudaSuccess) return err;
  return vcr::flash::launch_fwd(q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse,
                                batch, nq, nk, nk_valid, n_heads, sm_scale, stream);
}

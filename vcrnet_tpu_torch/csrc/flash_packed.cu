// Attention over packed heads: q/k/v [B, N, H*dk], head h = columns
// [h*dk, (h+1)*dk), output in the same packed layout, at dk = 128, 64 or 256
// (the instance of fwd_kernel is chosen by d_model / n_heads).
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

// q bf16 [B,Nq,D], k/v bf16 [B,Nk,D] (D = n_heads * dk, dk = 64, 128 or 256) ->
// out bf16 [B,Nq,D], and with a non-null lse the row logsumexp f32
// [B,H,Nq], over the first nk_valid keys (1 <= nk_valid <= Nk; finite K and
// V rows beyond it). Any Nq, Nk (rows past them in a last tile:
// flash_fwd.cuh); 16-byte aligned pointers. Another dk is refused
// (cudaErrorInvalidValue) before anything is launched.
cudaError_t vcr_flash_packed(const void* q, const void* k, const void* v, void* out,
                             float* lse, int batch, int nq, int nk, int nk_valid, int d_model,
                             int n_heads, float sm_scale, cudaStream_t stream) {
  using namespace vcr::hopper;
  return dispatch_head_dim<256>(d_model, n_heads, [&](auto dk) {
    CUtensorMap q_map, k_map, v_map;
    cudaError_t err = make_box_map(&q_map, q, static_cast<uint64_t>(batch) * nq, d_model);
    if (err == cudaSuccess)
      err = make_box_map(&k_map, k, static_cast<uint64_t>(batch) * nk, d_model);
    if (err == cudaSuccess)
      err = make_box_map(&v_map, v, static_cast<uint64_t>(batch) * nk, d_model);
    if (err != cudaSuccess) return err;
    return vcr::flash::launch_fwd<decltype(dk)::value>(
        q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, batch, nq, nk, nk_valid,
        n_heads, sm_scale, stream);
  });
}

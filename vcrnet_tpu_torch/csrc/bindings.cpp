// Python bindings of the kernels. The only source that includes PyTorch's
// headers: the .cu files keep a plain C++ interface, so nvcc compiles them
// without PyTorch and the extension builds quickly.
//
// The Python wrappers (vcrnet_tpu_torch/ops/*.py) check device, dtype,
// shape, contiguity and alignment and allocate every output buffer (a
// kernel's scratch is sized and allocated here, from what its .cu file
// reports); these functions launch on the tensors' device, on its current
// stream, and raise on a launch error. An optional output (the training
// forward's winners and logsumexp) is passed as an undefined tensor, None
// on the Python side, when it is not wanted.
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

cudaError_t vcr_knn_gather_max(const float* x, const float* norms, const void* values,
                               void* out, int* idx, void* win, int batch, int n, int f, int k,
                               cudaStream_t stream);
cudaError_t vcr_edge_conv(const void* x, const float* norms, const void* a, const void* h,
                          const void* w2, const void* b2, void* x1, void* x2, int* idx,
                          void* win1, void* win2, int batch, int n, int c, int k, float slope,
                          cudaStream_t stream);
cudaError_t vcr_edge_conv_f32knn(const void* x, const float* norms, const void* a, const void* h,
                                 const void* w2, const void* b2, void* x1, void* x2, int* idx,
                                 void* win1, void* win2, int batch, int n, int c, int k,
                                 float slope, cudaStream_t stream);
cudaError_t vcr_edge_split(const float* x, void* planes, int64_t count, cudaStream_t stream);
cudaError_t vcr_flash_packed(const void* q, const void* k, const void* v, void* out,
                             float* lse, int batch, int nq, int nk, int nk_valid, int d_model,
                             int n_heads, float sm_scale, cudaStream_t stream);
cudaError_t vcr_vcp_stream(const void* src_emb, const void* tgt_emb, const float* tgt,
                           float* keys, float* out, float* lse, int batch, int ns, int nt, int e,
                           cudaStream_t stream);
cudaError_t vcr_gather_max_bwd(const int* idx, const void* win, const void* ct, float* dv,
                               int batch, int n, int f, int k, cudaStream_t stream);
cudaError_t vcr_edge_conv_bwd_grid(int rows, int* blocks, int64_t* scratch_floats);
cudaError_t vcr_edge_conv_bwd(const int* idx, const void* win1, const void* win2,
                              const void* a, const void* h, const void* w2, const void* x2,
                              const void* ct1, const void* ct2, float* da, float* dh,
                              float* dw2, float* db2, float* partial, int blocks, int batch,
                              int n, int k, float slope, cudaStream_t stream);
cudaError_t vcr_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, void* dq, void* dk,
                          void* dv, int batch, int nq, int nk, int d_model, int n_heads,
                          float sm_scale, cudaStream_t stream);
cudaError_t vcr_vcp_bwd(const void* src_emb, const void* tgt_emb, const float* tgt,
                        const float* corr, const float* dcorr, const float* lse, float* keys,
                        float* rows, float* d_src, float* d_tgt_emb, float* d_tgt, int batch,
                        int ns, int nt, int e, cudaStream_t stream);

cudaError_t vcr_gather_max_from_idx(const int* idx, const void* values, void* out, void* win,
                                    int batch, int n, int f, int k, cudaStream_t stream);
cudaError_t vcr_edge_conv_from_idx(const int* idx, const void* a, const void* h,
                                   const void* w2, const void* b2, void* x1, void* x2,
                                   int batch, int n, int k, float slope,
                                   cudaStream_t stream);
cudaError_t vcr_softmax_colmass(const void* q, const void* k, float* lse, float* out,
                                int batch, int nq, int nk, int d_model, int n_heads,
                                float sm_scale, cudaStream_t stream);

cudaError_t vcr_knn(const void* x, const float* norms, int* idx, int batch, int n, int c, int k,
                    int is_bf16, cudaStream_t stream);
size_t vcr_dgcnn_eval_smem();
cudaError_t vcr_dgcnn_eval(const float* x, const int* idx, const void* w1, const float* b1,
                           const void* w2, const float* b2, const void* w3, const float* b3,
                           const void* w4, const float* b4, const void* w5, const float* b5,
                           void* cat, float* out, int batch, int n, int k, int emb,
                           cudaStream_t stream);
size_t vcr_pointer_mha_smem(int d);
cudaError_t vcr_pointer_mha(const void* yq, const void* ykv, const void* wq, const void* bq,
                            const void* wk, const void* bk, const void* wv, const void* bv,
                            const void* wo, const void* bo, void* qscr, void* kscr,
                            void* vscr, void* out, int batch, int nq, int nk, int d,
                            int n_heads, cudaStream_t stream);
size_t vcr_pointer_ff_smem(int d, int f);
cudaError_t vcr_pointer_ff(const void* y, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* hidden, void* out, long long rows, int d, int f,
                           cudaStream_t stream);
cudaError_t vcr_int8_linear(const void* x, int rows, int k, int pairs, const void* const* w,
                            const void* const* bias, void* const* out, const int* f, void* wq,
                            float* ws, float* xs, cudaStream_t stream);

namespace {

cudaStream_t stream_of(const torch::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

// A length rounded up to whole 64-row tiles: the row count of the scratch
// that the kernels of a ragged cloud read in whole tiles.
int64_t whole_tiles(int64_t n) { return (n + 63) / 64 * 64; }

void* optional_ptr(const c10::optional<torch::Tensor>& t) {
  return t.has_value() ? t->data_ptr() : nullptr;
}

void knn_gather_max(torch::Tensor x, torch::Tensor norms, torch::Tensor values,
                    torch::Tensor out, torch::Tensor idx, c10::optional<torch::Tensor> win,
                    int64_t k) {
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(vcr_knn_gather_max(
      x.data_ptr<float>(), norms.data_ptr<float>(), values.data_ptr(), out.data_ptr(),
      idx.data_ptr<int>(), optional_ptr(win), x.size(0), x.size(1), values.size(2), k,
      stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void edge_conv(torch::Tensor x, torch::Tensor norms, torch::Tensor a, torch::Tensor h,
               torch::Tensor w2, torch::Tensor b2, torch::Tensor x1, torch::Tensor x2,
               torch::Tensor idx, c10::optional<torch::Tensor> win1,
               c10::optional<torch::Tensor> win2, int64_t k, double slope) {
  const c10::cuda::CUDAGuard guard(x.device());
  TORCH_CHECK(norms.size(1) == whole_tiles(x.size(-2)), "edge_conv: norms must fill whole tiles");
  // bf16 [B, N, C], or the split planes [3, B, N, 64] of an f32 kNN space
  // (LPDNet's after t_net_fea): the f32 instance
  const auto launch = x.dim() == 4 ? &vcr_edge_conv_f32knn : &vcr_edge_conv;
  C10_CUDA_CHECK(launch(
      x.data_ptr(), norms.data_ptr<float>(), a.data_ptr(), h.data_ptr(), w2.data_ptr(),
      b2.data_ptr(), x1.data_ptr(), x2.data_ptr(), idx.data_ptr<int>(), optional_ptr(win1),
      optional_ptr(win2), x.size(-3), x.size(-2), x.size(-1), k, static_cast<float>(slope),
      stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void edge_split(torch::Tensor x, torch::Tensor planes) {
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(vcr_edge_split(x.data_ptr<float>(), planes.data_ptr(), x.numel(), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_packed(torch::Tensor q, torch::Tensor k, torch::Tensor v, torch::Tensor out,
                  c10::optional<torch::Tensor> lse, int64_t nk_valid, int64_t n_heads,
                  double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(vcr_flash_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  static_cast<float*>(optional_ptr(lse)), q.size(0), q.size(1),
                                  k.size(1), nk_valid, q.size(2), n_heads,
                                  static_cast<float>(sm_scale), stream_of(q)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void vcp_stream(torch::Tensor src_emb, torch::Tensor tgt_emb, torch::Tensor tgt,
                torch::Tensor keys, torch::Tensor out, c10::optional<torch::Tensor> lse) {
  const c10::cuda::CUDAGuard guard(src_emb.device());
  TORCH_CHECK(keys.size(1) == whole_tiles(tgt_emb.size(1)), "vcp_stream: keys must fill whole tiles");
  C10_CUDA_CHECK(vcr_vcp_stream(src_emb.data_ptr(), tgt_emb.data_ptr(), tgt.data_ptr<float>(),
                                keys.data_ptr<float>(), out.data_ptr<float>(),
                                static_cast<float*>(optional_ptr(lse)), src_emb.size(0),
                                src_emb.size(1), tgt_emb.size(1), src_emb.size(2),
                                stream_of(src_emb)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void gather_max_bwd(torch::Tensor idx, torch::Tensor win, torch::Tensor ct, torch::Tensor dv) {
  const c10::cuda::CUDAGuard guard(idx.device());
  C10_CUDA_CHECK(vcr_gather_max_bwd(idx.data_ptr<int>(), win.data_ptr(), ct.data_ptr(),
                                    dv.data_ptr<float>(), ct.size(0), ct.size(1), ct.size(2),
                                    idx.size(2), stream_of(idx)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void edge_conv_bwd(torch::Tensor idx, torch::Tensor win1, torch::Tensor win2, torch::Tensor a,
                   torch::Tensor h, torch::Tensor w2, torch::Tensor x2, torch::Tensor ct1,
                   torch::Tensor ct2, torch::Tensor da, torch::Tensor dh, torch::Tensor dw2,
                   torch::Tensor db2, double slope) {
  const c10::cuda::CUDAGuard guard(idx.device());
  int blocks = 0;
  int64_t scratch_floats = 0;
  C10_CUDA_CHECK(vcr_edge_conv_bwd_grid(a.size(0) * a.size(1), &blocks, &scratch_floats));
  const auto partial = torch::empty({scratch_floats}, da.options());
  C10_CUDA_CHECK(vcr_edge_conv_bwd(
      idx.data_ptr<int>(), win1.data_ptr(), win2.data_ptr(), a.data_ptr(), h.data_ptr(),
      w2.data_ptr(), x2.data_ptr(), ct1.data_ptr(), ct2.data_ptr(), da.data_ptr<float>(),
      dh.data_ptr<float>(), dw2.data_ptr<float>(), db2.data_ptr<float>(),
      partial.data_ptr<float>(), blocks, a.size(0), a.size(1), idx.size(2),
      static_cast<float>(slope), stream_of(idx)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_bwd(torch::Tensor q, torch::Tensor k, torch::Tensor v, torch::Tensor o,
               torch::Tensor dout, torch::Tensor lse, torch::Tensor delta, torch::Tensor dq,
               torch::Tensor dk, torch::Tensor dv, int64_t n_heads, double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  TORCH_CHECK(lse.size(2) == whole_tiles(q.size(1)) && delta.sizes() == lse.sizes(),
              "flash_bwd: lse and delta must fill whole tiles");
  C10_CUDA_CHECK(vcr_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               dout.data_ptr(), lse.data_ptr<float>(), delta.data_ptr<float>(),
                               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), q.size(0),
                               q.size(1), k.size(1), q.size(2), n_heads,
                               static_cast<float>(sm_scale), stream_of(q)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void vcp_bwd(torch::Tensor src_emb, torch::Tensor tgt_emb, torch::Tensor tgt,
             torch::Tensor corr, torch::Tensor dcorr, torch::Tensor lse, torch::Tensor keys,
             torch::Tensor rows, torch::Tensor d_src, torch::Tensor d_tgt_emb,
             torch::Tensor d_tgt) {
  const c10::cuda::CUDAGuard guard(src_emb.device());
  TORCH_CHECK(keys.size(1) == whole_tiles(tgt_emb.size(1)), "vcp_bwd: keys must fill whole tiles");
  TORCH_CHECK(rows.size(1) == whole_tiles(src_emb.size(1)) && lse.size(1) == rows.size(1),
              "vcp_bwd: rows and lse must fill whole tiles");
  C10_CUDA_CHECK(vcr_vcp_bwd(src_emb.data_ptr(), tgt_emb.data_ptr(), tgt.data_ptr<float>(),
                             corr.data_ptr<float>(), dcorr.data_ptr<float>(),
                             lse.data_ptr<float>(), keys.data_ptr<float>(),
                             rows.data_ptr<float>(), d_src.data_ptr<float>(),
                             d_tgt_emb.data_ptr<float>(), d_tgt.data_ptr<float>(),
                             src_emb.size(0), src_emb.size(1), tgt_emb.size(1),
                             src_emb.size(2), stream_of(src_emb)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void gather_max_from_idx(torch::Tensor idx, torch::Tensor values, torch::Tensor out,
                         c10::optional<torch::Tensor> win) {
  const c10::cuda::CUDAGuard guard(idx.device());
  C10_CUDA_CHECK(vcr_gather_max_from_idx(idx.data_ptr<int>(), values.data_ptr(),
                                         out.data_ptr(), optional_ptr(win), values.size(0),
                                         values.size(1), values.size(2), idx.size(2),
                                         stream_of(idx)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void edge_conv_from_idx(torch::Tensor idx, torch::Tensor a, torch::Tensor h, torch::Tensor w2,
                        torch::Tensor b2, torch::Tensor x1, torch::Tensor x2, double slope) {
  const c10::cuda::CUDAGuard guard(idx.device());
  C10_CUDA_CHECK(vcr_edge_conv_from_idx(idx.data_ptr<int>(), a.data_ptr(), h.data_ptr(),
                                        w2.data_ptr(), b2.data_ptr(), x1.data_ptr(),
                                        x2.data_ptr(), a.size(0), a.size(1), idx.size(2),
                                        static_cast<float>(slope), stream_of(idx)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void softmax_colmass(torch::Tensor q, torch::Tensor k, torch::Tensor lse, torch::Tensor out,
                     int64_t n_heads, double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  TORCH_CHECK(lse.size(2) == whole_tiles(q.size(1)), "softmax_colmass: lse must fill whole tiles");
  C10_CUDA_CHECK(vcr_softmax_colmass(q.data_ptr(), k.data_ptr(), lse.data_ptr<float>(),
                                     out.data_ptr<float>(), q.size(0), q.size(1), k.size(1),
                                     q.size(2), n_heads, static_cast<float>(sm_scale),
                                     stream_of(q)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void knn(torch::Tensor x, torch::Tensor norms, torch::Tensor idx) {
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(vcr_knn(x.data_ptr(), norms.data_ptr<float>(), idx.data_ptr<int>(), x.size(0),
                         x.size(1), x.size(2), idx.size(2),
                         x.scalar_type() == torch::kBFloat16 ? 1 : 0, stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// folded: w1, b1, ..., w5, b5 (weights bf16 [in, out], biases f32)
void dgcnn_eval(torch::Tensor x, torch::Tensor idx, std::vector<torch::Tensor> folded,
                torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(x.device());
  TORCH_CHECK(folded.size() == 10, "dgcnn_eval: expected five (weight, bias) pairs");
  const auto cat = torch::empty({x.size(0), x.size(1), 512},
                                x.options().dtype(torch::kBFloat16));
  C10_CUDA_CHECK(vcr_dgcnn_eval(
      x.data_ptr<float>(), idx.data_ptr<int>(), folded[0].data_ptr(),
      folded[1].data_ptr<float>(), folded[2].data_ptr(), folded[3].data_ptr<float>(),
      folded[4].data_ptr(), folded[5].data_ptr<float>(), folded[6].data_ptr(),
      folded[7].data_ptr<float>(), folded[8].data_ptr(), folded[9].data_ptr<float>(),
      cat.data_ptr(), out.data_ptr<float>(), x.size(0), x.size(1), idx.size(2), out.size(2),
      stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The projections go to a scratch in device memory: Q ([B, Nq, D] bf16, which
// the attention overwrites with O) and K and V (2 x [B, Nk, D] bf16).
void pointer_mha(torch::Tensor yq, torch::Tensor ykv, torch::Tensor wq, torch::Tensor bq,
                 torch::Tensor wk, torch::Tensor bk, torch::Tensor wv, torch::Tensor bv,
                 torch::Tensor wo, torch::Tensor bo, torch::Tensor out, int64_t n_heads) {
  const c10::cuda::CUDAGuard guard(yq.device());
  const auto qscr = torch::empty_like(yq);
  const auto kscr = torch::empty_like(ykv);
  const auto vscr = torch::empty_like(ykv);
  C10_CUDA_CHECK(vcr_pointer_mha(
      yq.data_ptr(), ykv.data_ptr(), wq.data_ptr(), bq.data_ptr(), wk.data_ptr(), bk.data_ptr(),
      wv.data_ptr(), bv.data_ptr(), wo.data_ptr(), bo.data_ptr(), qscr.data_ptr(),
      kscr.data_ptr(), vscr.data_ptr(), out.data_ptr(), yq.size(0), yq.size(1), ykv.size(1),
      yq.size(2), n_heads, stream_of(yq)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The hidden activations go to a scratch in device memory: [B, N, F] bf16.
void pointer_ff(torch::Tensor y, torch::Tensor w1, torch::Tensor b1, torch::Tensor w2,
                torch::Tensor b2, torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(y.device());
  const auto hidden = torch::empty({y.size(0), y.size(1), w1.size(1)}, y.options());
  C10_CUDA_CHECK(vcr_pointer_ff(y.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                b2.data_ptr(), hidden.data_ptr(), out.data_ptr(),
                                y.size(0) * y.size(1), y.size(2), w1.size(1), stream_of(y)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// One activation x [rows, K] through 1..3 (weight, bias) pairs into the
// outputs the wrapper allocates; the weights' codes and scales go to wq int8
// [sum F, K] and ws f32 [sum F], and the row scales to xs f32 [rows] when it
// is given, so that a caller can hold them against the plain version's.
void int8_linear(torch::Tensor x, std::vector<torch::Tensor> weights,
                 std::vector<torch::Tensor> biases, std::vector<torch::Tensor> outs,
                 torch::Tensor wq, torch::Tensor ws, c10::optional<torch::Tensor> xs) {
  const c10::cuda::CUDAGuard guard(x.device());
  TORCH_CHECK(!weights.empty() && weights.size() <= 3 && biases.size() == weights.size() &&
                  outs.size() == weights.size(),
              "int8_linear: 1 to 3 (weight, bias, output) triples");
  const void* w[3] = {};
  const void* b[3] = {};
  void* o[3] = {};
  int f[3] = {};
  for (size_t p = 0; p < weights.size(); ++p) {
    w[p] = weights[p].data_ptr();
    b[p] = biases[p].data_ptr();
    o[p] = outs[p].data_ptr();
    f[p] = static_cast<int>(weights[p].size(0));
  }
  const int64_t k = x.size(-1);
  C10_CUDA_CHECK(vcr_int8_linear(x.data_ptr(), static_cast<int>(x.numel() / k),
                                 static_cast<int>(k), static_cast<int>(weights.size()), w, b, o,
                                 f, wq.data_ptr(), ws.data_ptr<float>(),
                                 xs.has_value() ? xs->data_ptr<float>() : nullptr,
                                 stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

int64_t dgcnn_eval_smem() { return vcr_dgcnn_eval_smem(); }
int64_t pointer_mha_smem(int64_t d) { return vcr_pointer_mha_smem(d); }
int64_t pointer_ff_smem(int64_t d, int64_t f) { return vcr_pointer_ff_smem(d, f); }

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("knn_gather_max", &knn_gather_max);
  m.def("edge_conv", &edge_conv);
  m.def("edge_split", &edge_split);
  m.def("flash_packed", &flash_packed);
  m.def("vcp_stream", &vcp_stream);
  m.def("gather_max_bwd", &gather_max_bwd);
  m.def("edge_conv_bwd", &edge_conv_bwd);
  m.def("flash_bwd", &flash_bwd);
  m.def("vcp_bwd", &vcp_bwd);
  m.def("gather_max_from_idx", &gather_max_from_idx);
  m.def("edge_conv_from_idx", &edge_conv_from_idx);
  m.def("softmax_colmass", &softmax_colmass);
  m.def("knn", &knn);
  m.def("dgcnn_eval", &dgcnn_eval);
  m.def("pointer_mha", &pointer_mha);
  m.def("pointer_ff", &pointer_ff);
  m.def("int8_linear", &int8_linear);
  m.def("dgcnn_eval_smem", &dgcnn_eval_smem);
  m.def("pointer_mha_smem", &pointer_mha_smem);
  m.def("pointer_ff_smem", &pointer_ff_smem);
}

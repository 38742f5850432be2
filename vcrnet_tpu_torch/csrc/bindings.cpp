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
cudaError_t vcr_flash_packed(const void* q, const void* k, const void* v, void* out,
                             float* lse, int batch, int nq, int nk, int nk_valid,
                             int n_heads, float sm_scale, cudaStream_t stream);
cudaError_t vcr_vcp_stream(const void* src_emb, const void* tgt_emb, const float* norms,
                           const float* tgt, float* out, float* lse, int batch, int ns, int nt,
                           int e, cudaStream_t stream);
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
                          void* dv, int batch, int nq, int nk, int n_heads, float sm_scale,
                          cudaStream_t stream);
cudaError_t vcr_vcp_bwd(const void* src_emb, const void* tgt_emb, const float* norms,
                        const float* tgt, const float* corr, const float* dcorr,
                        const float* lse, float* d_src, float* d_tgt_emb, float* d_tgt,
                        int batch, int ns, int nt, int e, cudaStream_t stream);

cudaError_t vcr_gather_max_from_idx(const int* idx, const void* values, void* out, void* win,
                                    int batch, int n, int f, int k, cudaStream_t stream);
cudaError_t vcr_edge_conv_from_idx(const int* idx, const void* a, const void* h,
                                   const void* w2, const void* b2, void* x1, void* x2,
                                   int batch, int n, int k, float slope,
                                   cudaStream_t stream);
cudaError_t vcr_softmax_colmass(const void* q, const void* k, float* lse, float* out,
                                int batch, int nq, int nk, int n_heads, float sm_scale,
                                cudaStream_t stream);

namespace {

cudaStream_t stream_of(const torch::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

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
  C10_CUDA_CHECK(vcr_edge_conv(
      x.data_ptr(), norms.data_ptr<float>(), a.data_ptr(), h.data_ptr(), w2.data_ptr(),
      b2.data_ptr(), x1.data_ptr(), x2.data_ptr(), idx.data_ptr<int>(), optional_ptr(win1),
      optional_ptr(win2), x.size(0), x.size(1), x.size(2), k, static_cast<float>(slope),
      stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_packed(torch::Tensor q, torch::Tensor k, torch::Tensor v, torch::Tensor out,
                  c10::optional<torch::Tensor> lse, int64_t nk_valid, int64_t n_heads,
                  double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(vcr_flash_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  static_cast<float*>(optional_ptr(lse)), q.size(0), q.size(1),
                                  k.size(1), nk_valid, n_heads, static_cast<float>(sm_scale),
                                  stream_of(q)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void vcp_stream(torch::Tensor src_emb, torch::Tensor tgt_emb, torch::Tensor norms,
                torch::Tensor tgt, torch::Tensor out, c10::optional<torch::Tensor> lse) {
  const c10::cuda::CUDAGuard guard(src_emb.device());
  C10_CUDA_CHECK(vcr_vcp_stream(src_emb.data_ptr(), tgt_emb.data_ptr(),
                                norms.data_ptr<float>(), tgt.data_ptr<float>(),
                                out.data_ptr<float>(), static_cast<float*>(optional_ptr(lse)),
                                src_emb.size(0), src_emb.size(1), tgt_emb.size(1),
                                src_emb.size(2), stream_of(src_emb)));
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
  C10_CUDA_CHECK(vcr_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               dout.data_ptr(), lse.data_ptr<float>(), delta.data_ptr<float>(),
                               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), q.size(0),
                               q.size(1), k.size(1), n_heads, static_cast<float>(sm_scale),
                               stream_of(q)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void vcp_bwd(torch::Tensor src_emb, torch::Tensor tgt_emb, torch::Tensor norms,
             torch::Tensor tgt, torch::Tensor corr, torch::Tensor dcorr, torch::Tensor lse,
             torch::Tensor d_src, torch::Tensor d_tgt_emb, torch::Tensor d_tgt) {
  const c10::cuda::CUDAGuard guard(src_emb.device());
  C10_CUDA_CHECK(vcr_vcp_bwd(src_emb.data_ptr(), tgt_emb.data_ptr(), norms.data_ptr<float>(),
                             tgt.data_ptr<float>(), corr.data_ptr<float>(),
                             dcorr.data_ptr<float>(), lse.data_ptr<float>(),
                             d_src.data_ptr<float>(), d_tgt_emb.data_ptr<float>(),
                             d_tgt.data_ptr<float>(), src_emb.size(0), src_emb.size(1),
                             tgt_emb.size(1), src_emb.size(2), stream_of(src_emb)));
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
  C10_CUDA_CHECK(vcr_softmax_colmass(q.data_ptr(), k.data_ptr(), lse.data_ptr<float>(),
                                     out.data_ptr<float>(), q.size(0), q.size(1), k.size(1),
                                     n_heads, static_cast<float>(sm_scale), stream_of(q)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("knn_gather_max", &knn_gather_max);
  m.def("edge_conv", &edge_conv);
  m.def("flash_packed", &flash_packed);
  m.def("vcp_stream", &vcp_stream);
  m.def("gather_max_bwd", &gather_max_bwd);
  m.def("edge_conv_bwd", &edge_conv_bwd);
  m.def("flash_bwd", &flash_bwd);
  m.def("vcp_bwd", &vcp_bwd);
  m.def("gather_max_from_idx", &gather_max_from_idx);
  m.def("edge_conv_from_idx", &edge_conv_from_idx);
  m.def("softmax_colmass", &softmax_colmass);
}

// Python bindings of the four kernels. The only source that includes
// PyTorch's headers: the .cu files keep a plain C++ interface, so nvcc
// compiles them without PyTorch and the extension builds quickly.
//
// The Python wrappers (vcrnet_tpu_torch/ops/*.py) check device, dtype,
// shape, contiguity and alignment and allocate every output; these
// functions launch on the tensors' device, on its current stream, and raise
// on a launch error.
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

cudaError_t vcr_knn_gather_max(const float* x, const float* norms, const void* values,
                               void* out, int* idx, int batch, int n, int f, int k,
                               cudaStream_t stream);
cudaError_t vcr_edge_conv(const void* x, const float* norms, const void* a, const void* h,
                          const void* w2, const void* b2, void* x1, void* x2, int* idx,
                          int batch, int n, int c, int k, float slope, cudaStream_t stream);
cudaError_t vcr_flash_packed(const void* q, const void* k, const void* v, void* out,
                             int batch, int nq, int nk, int n_heads, float sm_scale,
                             cudaStream_t stream);
cudaError_t vcr_vcp_stream(const void* src_emb, const void* tgt_emb, const float* norms,
                           const float* tgt, float* out, int batch, int ns, int nt, int e,
                           cudaStream_t stream);

namespace {

cudaStream_t stream_of(const torch::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void knn_gather_max(torch::Tensor x, torch::Tensor norms, torch::Tensor values,
                    torch::Tensor out, torch::Tensor idx, int64_t k) {
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(vcr_knn_gather_max(
      x.data_ptr<float>(), norms.data_ptr<float>(), values.data_ptr(), out.data_ptr(),
      idx.data_ptr<int>(), x.size(0), x.size(1), values.size(2), k, stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void edge_conv(torch::Tensor x, torch::Tensor norms, torch::Tensor a, torch::Tensor h,
               torch::Tensor w2, torch::Tensor b2, torch::Tensor x1, torch::Tensor x2,
               torch::Tensor idx, int64_t k, double slope) {
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(vcr_edge_conv(
      x.data_ptr(), norms.data_ptr<float>(), a.data_ptr(), h.data_ptr(), w2.data_ptr(),
      b2.data_ptr(), x1.data_ptr(), x2.data_ptr(), idx.data_ptr<int>(), x.size(0),
      x.size(1), x.size(2), k, static_cast<float>(slope), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_packed(torch::Tensor q, torch::Tensor k, torch::Tensor v, torch::Tensor out,
                  int64_t n_heads, double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(vcr_flash_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  q.size(0), q.size(1), k.size(1), n_heads,
                                  static_cast<float>(sm_scale), stream_of(q)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void vcp_stream(torch::Tensor src_emb, torch::Tensor tgt_emb, torch::Tensor norms,
                torch::Tensor tgt, torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(src_emb.device());
  C10_CUDA_CHECK(vcr_vcp_stream(src_emb.data_ptr(), tgt_emb.data_ptr(),
                                norms.data_ptr<float>(), tgt.data_ptr<float>(),
                                out.data_ptr<float>(), src_emb.size(0), src_emb.size(1),
                                tgt_emb.size(1), src_emb.size(2), stream_of(src_emb)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("knn_gather_max", &knn_gather_max);
  m.def("edge_conv", &edge_conv);
  m.def("flash_packed", &flash_packed);
  m.def("vcp_stream", &vcp_stream);
}

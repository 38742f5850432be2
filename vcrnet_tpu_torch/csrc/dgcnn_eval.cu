// DGCNN at eval: the four edge-conv stages with BatchNorm folded into their
// weights, the max over the k neighbours after each, and the final
// projection of the 512-wide concat.
//
// Replaces vcrnet_tpu/ops/pallas_dgcnn.py:fused_dgcnn_eval (_dgcnn_kernel).
//
//   e_ij = [x_j ; x_i]  for j in idx[i]                (xyz rounded to bf16)
//   h1 = relu(e W1 + b1), h2 = relu(bf16(h1) W2 + b2), h3 = relu(bf16(h2) W3 + b3),
//   h4 = relu(bf16(h3) W4 + b4)                        (f32 accumulation, bias, relu)
//   x_s[i] = max_j h_s[i, j],   out = relu(bf16([x1 x2 x3 x4]) W5 + b5)   (f32)
//
// Bound on the H100: operations (per edge 2 (6*64 + 64*64 + 64*128 + 128*256)
// flops, per point 2 * 512 * emb more, against 12 + 4k bytes in and 4 emb bytes
// out per point). The design keeps every per-edge activation out of device
// memory. A first kernel gives a block 16 query points: their 16 k edge rows
// (k-major: row j * 16 + q is neighbour j of query q, so one 16-row mma tile is
// one neighbour slot of all 16 queries) go through the stages in shared memory
// as bf16, the rounding the next product applies anyway; stage 1 (depth 6)
// runs on the CUDA cores, stages 2-4 on the tensor cores (warp-level mma),
// their weights read from device memory (L2) straight into fragments, each
// once per warp. Stage 4's [16 k, 256] output is never stored: bias and relu
// are monotone, so the max over the neighbour slots is taken on the raw
// accumulators and only [16, 256] is activated. The kernel writes the concat
// [B N, 512] as bf16 (its rounding point) to a scratch. W5 (512 KB at emb =
// 512) does not fit a block's shared memory, so a second kernel in this
// source projects 64-row tiles of the scratch through it (gemm_tile.cuh).
// The TPU kernel's one-hot matmul gather and 128-lane padding of xyz are not
// carried over: the gather is an indexed load.
#include "gemm_tile.cuh"

namespace {

using namespace nvcuda;
using vcr::gemm::kPad;
using vcr::gemm::kThreads;
using vcr::gemm::kWarps;

constexpr int kTileQ = 16;   // query points per block
constexpr int kCat = 512;    // 64 + 64 + 128 + 256
constexpr int kLdWide = 128 + kPad;  // h1 (64 wide) and h3 (128 wide)
constexpr int kLdNarrow = 64 + kPad;  // h2
constexpr int kLdCat = kCat + kPad;

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) / 128 * 128; }

struct Layout {
  size_t wide, narrow, cat, stage, sel, xyz, w1, total;
  __host__ __device__ explicit Layout(int k) {
    const size_t rows = static_cast<size_t>(kTileQ) * k;
    wide = 0;
    narrow = wide + align128(sizeof(__nv_bfloat16) * rows * kLdWide);
    cat = narrow + align128(sizeof(__nv_bfloat16) * rows * kLdNarrow);
    stage = cat + align128(sizeof(__nv_bfloat16) * kTileQ * kLdCat);
    sel = stage + align128(sizeof(float) * kWarps * 16 * 16);
    xyz = sel + align128(sizeof(int) * rows);
    w1 = xyz + align128(sizeof(float) * kTileQ * 3);
    total = w1 + align128(sizeof(float) * (6 * 64 + 64));
  }
};

// One stage on the tensor cores: out = relu(in @ W + bias) over the block's
// 16 k rows, tile by tile. A warp keeps the weight fragments of its 16-column
// block and walks the neighbour slots j. With STORE the activated tile goes
// to ``out`` as bf16; without, the warp keeps the running max of the raw
// accumulators over j and writes relu(max + bias) to ``xcat`` (16 rows).
template <int DEPTH, int COUT, bool STORE>
__device__ __forceinline__ void edge_stage(const __nv_bfloat16* in, int ld_in,
                                           const __nv_bfloat16* __restrict__ w,
                                           const float* __restrict__ bias,
                                           __nv_bfloat16* out, int ld_out,
                                           __nv_bfloat16* xcat, float* stage, int k) {
  constexpr int kCols = COUT / 16;
  constexpr int kShare = kCols >= kWarps ? 1 : kWarps / kCols;  // warps per column block
  static_assert(STORE || kShare == 1, "the running max is one warp's");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> wf[DEPTH / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc, best;
  for (int nb = warp % kCols; nb < kCols; nb += kWarps) {
#pragma unroll
    for (int kk = 0; kk < DEPTH / 16; ++kk)
      wmma::load_matrix_sync(wf[kk], w + kk * 16 * COUT + nb * 16, COUT);
    wmma::fill_fragment(best, -CUDART_INF_F);
    for (int j = warp / kCols; j < k; j += kShare) {
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DEPTH / 16; ++kk) {
        wmma::load_matrix_sync(af, in + j * 16 * ld_in + kk * 16, ld_in);
        wmma::mma_sync(acc, af, wf[kk], acc);
      }
      if (STORE) {
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 16 * 16; e += 32) {
          const int c = nb * 16 + (e & 15);
          out[(j * 16 + (e >> 4)) * ld_out + c] =
              __float2bfloat16_rn(fmaxf(stage[e] + bias[c], 0.f));
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int t = 0; t < acc.num_elements; ++t) best.x[t] = fmaxf(best.x[t], acc.x[t]);
      }
    }
    if (!STORE) {
      wmma::store_matrix_sync(stage, best, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = lane; e < 16 * 16; e += 32) {
        const int c = nb * 16 + (e & 15);
        xcat[(e >> 4) * kLdCat + c] = __float2bfloat16_rn(fmaxf(stage[e] + bias[c], 0.f));
      }
      __syncwarp();
    }
  }
}

// xcat[q, c] = max over the k neighbour slots of h[j * 16 + q, c], c < width.
__device__ __forceinline__ void max_over_neighbours(const __nv_bfloat16* h, int ld, int width,
                                                    int k, __nv_bfloat16* xcat) {
  for (int t = threadIdx.x; t < kTileQ * width; t += blockDim.x) {
    const int q = t / width, c = t - q * width;
    float m = -CUDART_INF_F;
    for (int j = 0; j < k; ++j) m = fmaxf(m, __bfloat162float(h[(j * 16 + q) * ld + c]));
    xcat[q * kLdCat + c] = __float2bfloat16_rn(m);  // exact: m is a bf16 value
  }
}

__global__ void __launch_bounds__(kThreads)
dgcnn_edges_kernel(const float* __restrict__ x,            // [B, N, 3]
                   const int* __restrict__ idx,            // [B, N, k]
                   const __nv_bfloat16* __restrict__ w1,   // [6, 64]: neighbour rows, centre rows
                   const float* __restrict__ b1,
                   const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,  // [64, 64]
                   const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,  // [64, 128]
                   const __nv_bfloat16* __restrict__ w4, const float* __restrict__ b4,  // [128, 256]
                   __nv_bfloat16* __restrict__ cat,        // [B, N, 512]
                   int n, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(k);
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(smem + L.wide);
  __nv_bfloat16* narrow = reinterpret_cast<__nv_bfloat16*>(smem + L.narrow);
  __nv_bfloat16* xcat = reinterpret_cast<__nv_bfloat16*>(smem + L.cat);
  float* stage = reinterpret_cast<float*>(smem + L.stage) + (threadIdx.x >> 5) * 16 * 16;
  int* sel = reinterpret_cast<int*>(smem + L.sel);   // [k, 16], k-major
  float* ctr = reinterpret_cast<float*>(smem + L.xyz);  // [16, 3], rounded to bf16
  float* w1s = reinterpret_cast<float*>(smem + L.w1);   // [6, 64] then b1 [64]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int rows = kTileQ * k;
  const float* xb = x + static_cast<size_t>(b) * n * 3;
  const int* ib = idx + (static_cast<size_t>(b) * n + q0) * k;

  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int q = t / k, j = t - q * k;
    sel[j * kTileQ + q] = ib[t];
  }
  for (int t = threadIdx.x; t < kTileQ * 3; t += blockDim.x)
    ctr[t] = __bfloat162float(__float2bfloat16_rn(xb[q0 * 3 + t]));
  for (int t = threadIdx.x; t < 6 * 64; t += blockDim.x) w1s[t] = __bfloat162float(w1[t]);
  for (int t = threadIdx.x; t < 64; t += blockDim.x) w1s[6 * 64 + t] = b1[t];
  __syncthreads();

  // stage 1 on the CUDA cores: relu((nbr . W1n + ctr . W1c) + b1) -> wide[:, 0:64]
  for (int t = threadIdx.x; t < rows * 64; t += blockDim.x) {
    const int row = t >> 6, c = t & 63;
    const int q = row & (kTileQ - 1);
    const float* nx = xb + static_cast<size_t>(sel[row]) * 3;
    const float n0 = __bfloat162float(__float2bfloat16_rn(nx[0]));
    const float n1 = __bfloat162float(__float2bfloat16_rn(nx[1]));
    const float n2 = __bfloat162float(__float2bfloat16_rn(nx[2]));
    const float hn = fmaf(n2, w1s[2 * 64 + c], fmaf(n1, w1s[64 + c], n0 * w1s[c]));
    const float hc = fmaf(ctr[q * 3 + 2], w1s[5 * 64 + c],
                          fmaf(ctr[q * 3 + 1], w1s[4 * 64 + c], ctr[q * 3] * w1s[3 * 64 + c]));
    wide[row * kLdWide + c] = __float2bfloat16_rn(fmaxf((hn + hc) + w1s[6 * 64 + c], 0.f));
  }
  __syncthreads();
  max_over_neighbours(wide, kLdWide, 64, k, xcat);

  edge_stage<64, 64, true>(wide, kLdWide, w2, b2, narrow, kLdNarrow, nullptr, stage, k);
  __syncthreads();  // h2 complete; h1 is dead
  max_over_neighbours(narrow, kLdNarrow, 64, k, xcat + 64);

  edge_stage<64, 128, true>(narrow, kLdNarrow, w3, b3, wide, kLdWide, nullptr, stage, k);
  __syncthreads();
  max_over_neighbours(wide, kLdWide, 128, k, xcat + 128);

  edge_stage<128, 256, false>(wide, kLdWide, w4, b4, nullptr, 0, xcat + 256, stage, k);
  __syncthreads();

  __nv_bfloat16* cb = cat + (static_cast<size_t>(b) * n + q0) * kCat;
  for (int t = threadIdx.x; t < kTileQ * kCat / 8; t += blockDim.x) {
    const int q = t / (kCat / 8), c8 = (t % (kCat / 8)) * 8;
    *reinterpret_cast<uint4*>(cb + q * kCat + c8) =
        *reinterpret_cast<const uint4*>(xcat + q * kLdCat + c8);
  }
}

__global__ void __launch_bounds__(kThreads)
dgcnn_project_kernel(const __nv_bfloat16* __restrict__ cat,  // [rows, 512]
                     const __nv_bfloat16* __restrict__ w5,   // [512, emb]
                     const float* __restrict__ b5,
                     float* __restrict__ out,                // [rows, emb]
                     long long rows, int emb) {
  using namespace vcr::gemm;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* scratch = smem + align128(tile_bytes(kCat));
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTM;
  const size_t n_rows = static_cast<size_t>(rows);
  load_rows(cat, row0, n_rows, kCat, as);
  block_gemm(as, padded(kCat), w5, kCat, emb, scratch, [&](int r, int c, float v) {
    if (row0 + r < n_rows) out[(row0 + r) * emb + c] = fmaxf(v + b5[c], 0.f);
  });
}

}  // namespace

// Shared memory of the edge kernel for k neighbours (the wrapper's gate).
size_t vcr_dgcnn_eval_smem(int k) { return Layout(k).total; }

// x f32 [B,N,3], idx int32 [B,N,k] (entries in [0, N)), w1 bf16 [6,64], w2
// bf16 [64,64], w3 bf16 [64,128], w4 bf16 [128,256], w5 bf16 [512,emb] (all
// [in, out], BatchNorm folded in), b1..b5 f32, cat bf16 [B,N,512] scratch ->
// out f32 [B,N,emb]. Requires N % 16 == 0, emb % 128 == 0, 32-byte aligned
// pointers, and vcr_dgcnn_eval_smem(k) within a block's shared memory
// (k <= 30). Returns the launch status.
cudaError_t vcr_dgcnn_eval(const float* x, const int* idx, const void* w1, const float* b1,
                           const void* w2, const float* b2, const void* w3, const float* b3,
                           const void* w4, const float* b4, const void* w5, const float* b5,
                           void* cat, float* out, int batch, int n, int k, int emb,
                           cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const Layout L(k);
  cudaError_t err = cudaFuncSetAttribute(
      dgcnn_edges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  dgcnn_edges_kernel<<<dim3(n / kTileQ, batch), kThreads, L.total, stream>>>(
      x, idx, static_cast<const bf*>(w1), b1, static_cast<const bf*>(w2), b2,
      static_cast<const bf*>(w3), b3, static_cast<const bf*>(w4), b4, static_cast<bf*>(cat), n,
      k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = align128(vcr::gemm::tile_bytes(kCat)) + vcr::gemm::kScratchBytes;
  err = cudaFuncSetAttribute(dgcnn_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(batch) * n;
  dgcnn_project_kernel<<<static_cast<unsigned>((rows + vcr::gemm::kTM - 1) / vcr::gemm::kTM),
                         kThreads, smem, stream>>>(static_cast<const bf*>(cat),
                                                   static_cast<const bf*>(w5), b5, out, rows,
                                                   emb);
  return cudaGetLastError();
}

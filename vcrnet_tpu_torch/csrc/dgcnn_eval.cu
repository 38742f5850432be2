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
// out per point). Two kernels, one counted launch of the wrapper:
//
// 1. the edge kernel. Each edge's four stages depend on that edge alone, so
//    nothing of size k is held: a warpgroup owns 64 query points and streams
//    their neighbour slots, one slot (64 edges, row r = neighbour j of query
//    r) at a time through the four stages, all on the tensor cores:
//      * stage 1 (depth 6) is one zero-padded wgmma m64n64k16: the A
//        fragment is built in registers from the neighbour's and the
//        centre's xyz ([x_j ; x_i ; 0 0], rounded to bf16), B is W1 loaded
//        by TMA into a [64, 64] box whose rows past 6 TMA fills with zeros;
//      * stages 2-4 are wgmma with A from registers: the accumulator of a
//        stage, with bias and ReLU, packed to bf16 pairs IS the A fragment
//        of the next (hopper.cuh, "the accumulator layout"); B is the
//        weight read MN-major from boxes that TMA loads once per block
//        (W2 8 KB, W3 16 KB, W4 64 KB). Stage 4 (256 wide) runs as two
//        halves of 128 columns so that its accumulator is 64 registers;
//      * after each stage the activated values, as bf16 pairs, are folded
//        into a running max per (query, channel) by max.bf16x2. The max of
//        the rounded values is the rounded max (rounding is monotone), and
//        a running max that starts at zero applies stage 4's ReLU. Stages
//        1-3 keep theirs in registers (64 a thread); stage 4's 128 values a
//        thread go to shared memory, laid out by thread so that no other
//        thread touches them (16-byte accesses, no bank conflicts).
//    The cloud of the block's batch item is staged in shared memory (up to
//    4096 points; a larger cloud is read from device memory through the
//    same generic pointer), the neighbour indices are read from device
//    memory (L1), and the concat [B N, 512] is written once, as bf16 (its
//    rounding point), to a scratch. Two warpgroups a block share the
//    weights; each one's epilogues overlap the other's products.
// 2. the projection relu(cat W5 + b5) on gemm_wgmma.cuh's persistent TMA +
//    wgmma product, with an f32 bias, a ReLU and an f32 output: W5 (512 KB
//    at emb = 512) is read in slices by TMA for every 128 rows.
// The TPU kernel's one-hot matmul gather, 128-lane padding of xyz and
// [k TQ, 256] stage activations are not carried over: the gather is an
// indexed load, and a slot's activations live in registers.
#include "gemm_wgmma.cuh"

namespace {

using namespace vcr::hopper;
using bf16 = __nv_bfloat16;

constexpr int kCat = 512;  // 64 + 64 + 128 + 256
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileQ = 64 * kWarpgroups;  // query points a block
constexpr int kCloudMax = 4096;           // points of a cloud staged in shared memory

// Shared memory from a 1024-byte boundary: the weights as MN-major boxes of
// [64 (in), 64 (out)] bf16 (W1 with its rows past 6 zero; W2; W3's two
// column halves; W4's [2 row blocks][4 column blocks]), each warpgroup's
// stage-4 running maxima ([16 uint4][128 threads]), the biases b1..b4 (f32),
// the cloud (f32), the weights' barrier.
constexpr uint32_t kW1 = 0;
constexpr uint32_t kW2 = kW1 + kBoxBytes;
constexpr uint32_t kW3 = kW2 + kBoxBytes;
constexpr uint32_t kW4 = kW3 + 2 * kBoxBytes;
constexpr uint32_t kWeightBytes = kW4 + 8 * kBoxBytes;
constexpr uint32_t kMax4Bytes = 16 * 128 * 16;
constexpr uint32_t kMax4 = kWeightBytes;
constexpr uint32_t kBias = kMax4 + kWarpgroups * kMax4Bytes;
constexpr uint32_t kBias2 = 64, kBias3 = 128, kBias4 = 256, kBiasFloats = 512;
constexpr uint32_t kCloud = kBias + kBiasFloats * 4;
constexpr uint32_t kBar = kCloud + kCloudMax * 3 * 4;
constexpr size_t kSmemBytes = 1024 + kBar + 8;

struct WeightMaps {
  CUtensorMap w1;  // [6, 64]
  CUtensorMap w2;  // [64, 64]
  CUtensorMap w3;  // [64, 128]
  CUtensorMap w4;  // [128, 256]
};

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// relu(acc + bias) of an m64nN accumulator (N / 2 values a thread) as bf16
// pairs ``p`` (the next product's A fragment), folded into the running
// maxima ``m``.
template <int kN>
__device__ __forceinline__ void activate(const float (&acc)[kN / 2], const float* bias, int qd,
                                         uint32_t (&p)[kN / 4], uint32_t (&m)[kN / 4]) {
#pragma unroll
  for (int jj = 0; jj < kN / 8; ++jj) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * jj + 2 * qd);
    p[2 * jj] = pack_bf16(fmaxf(acc[4 * jj] + b.x, 0.f), fmaxf(acc[4 * jj + 1] + b.y, 0.f));
    p[2 * jj + 1] = pack_bf16(fmaxf(acc[4 * jj + 2] + b.x, 0.f), fmaxf(acc[4 * jj + 3] + b.y, 0.f));
    m[2 * jj] = max_bf16x2(m[2 * jj], p[2 * jj]);
    m[2 * jj + 1] = max_bf16x2(m[2 * jj + 1], p[2 * jj + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dgcnn_edges_kernel(const __grid_constant__ WeightMaps maps,
                   const float* __restrict__ x,    // [B, N, 3]
                   const int* __restrict__ idx,    // [B, N, k]
                   const float* __restrict__ b1, const float* __restrict__ b2,
                   const float* __restrict__ b3, const float* __restrict__ b4,
                   bf16* __restrict__ cat,         // [B, N, 512]
                   int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  float* bias = reinterpret_cast<float*>(sm + kBias);
  float* cloud_s = reinterpret_cast<float*>(sm + kCloud);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + kBar);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const float* xb = x + static_cast<size_t>(b) * n * 3;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 12 * kBoxBytes);
    tma_load_box(sm + kW1, &maps.w1, bar, 0, 0);
    tma_load_box(sm + kW2, &maps.w2, bar, 0, 0);
    for (int c = 0; c < 2; ++c) tma_load_box(sm + kW3 + c * kBoxBytes, &maps.w3, bar, 64 * c, 0);
    for (int r = 0; r < 2; ++r)
      for (int c = 0; c < 4; ++c)
        tma_load_box(sm + kW4 + (4 * r + c) * kBoxBytes, &maps.w4, bar, 64 * c, 64 * r);
  }
  const bool staged = n <= kCloudMax;
  if (staged)
    for (int t = tid; t < 3 * n; t += kThreads) cloud_s[t] = xb[t];
  for (int t = tid; t < 64; t += kThreads) {
    bias[t] = b1[t];
    bias[kBias2 + t] = b2[t];
  }
  for (int t = tid; t < 128; t += kThreads) bias[kBias3 + t] = b3[t];
  for (int t = tid; t < 256; t += kThreads) bias[kBias4 + t] = b4[t];
  const int wg = tid >> 7, t = tid & 127;
  uint4* max4 = reinterpret_cast<uint4*>(sm + kMax4 + wg * kMax4Bytes) + t;  // [i * 128]
#pragma unroll
  for (int i = 0; i < 16; ++i) max4[i * 128] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  mbar_wait(bar, 0);

  const int q0 = blockIdx.x * kTileQ + wg * 64;
  if (q0 >= n) return;  // the block's second warpgroup past a ragged end
  const float* cloud = staged ? cloud_s : xb;
  const int lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int ra = q0 + 16 * (t >> 5) + g, rb = ra + 8;  // this thread's rows
  const int* ia = idx + (static_cast<size_t>(b) * n + min(ra, n - 1)) * k;
  const int* ib = idx + (static_cast<size_t>(b) * n + min(rb, n - 1)) * k;

  // Stage 1's row is [x_j y_j z_j x_i y_i z_i 0 0 | 0 ...]; lane qd holds its
  // entries 2 qd and 2 qd + 1. The centre's part is fixed for the loop:
  // lo is x_j (qd 0), z_j (qd 1), y_i (qd 2), 0 (qd 3); hi is y_j, x_i, z_i, 0.
  float fix_lo[2], fix_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* c = cloud + 3 * min(r ? rb : ra, n - 1);
    fix_lo[r] = qd == 2 ? round_bf16(c[1]) : 0.f;
    fix_hi[r] = qd == 1 ? round_bf16(c[0]) : qd == 2 ? round_bf16(c[2]) : 0.f;
  }
  const uint8_t* w1s = sm + kW1;
  const uint8_t* w2s = sm + kW2;
  const bf16* w3s = reinterpret_cast<const bf16*>(sm + kW3);
  const uint8_t* w4s = sm + kW4;

  uint32_t m1[16], m2[16], m3[32];
#pragma unroll
  for (int i = 0; i < 16; ++i) m1[i] = m2[i] = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) m3[i] = 0u;

  for (int j = 0; j < k; ++j) {
    uint32_t a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* p = cloud + 3 * __ldg((r ? ib : ia) + j);
      const float v0 = p[qd == 0 ? 0 : 2], v1 = p[1];
      a[r] = pack_bf16(qd < 2 ? round_bf16(v0) : fix_lo[r], qd == 0 ? round_bf16(v1) : fix_hi[r]);
    }
    fence_regs(a);

    // stage 1: [64, 16] x [16, 64], k entries past 6 zero on both sides
    float acc1[32];
    wgmma_fence();
    wgmma_m64n64_rs<1>(acc1, a[0], a[1], 0u, 0u, desc_sw128(w1s, kBoxBytes, 1024), 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc1);
    uint32_t p1[16];
    activate<64>(acc1, bias, qd, p1, m1);
    fence_regs(p1);

    // stage 2: [64, 64] x W2 [64, 64]
    float acc2[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64_rs<1>(acc2, p1[4 * kk], p1[4 * kk + 1], p1[4 * kk + 2], p1[4 * kk + 3],
                         desc_sw128(w2s + kk * 16 * 128, kBoxBytes, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc2);
    uint32_t p2[16];
    activate<64>(acc2, bias + kBias2, qd, p2, m2);
    fence_regs(p2);

    // stage 3: [64, 64] x W3 [64, 128]
    float acc3[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128_rs<1>(acc3, p2[4 * kk], p2[4 * kk + 1], p2[4 * kk + 2], p2[4 * kk + 3],
                          desc_mn_major(w3s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc3);
    uint32_t p3[32];
    activate<128>(acc3, bias + kBias3, qd, p3, m3);
    fence_regs(p3);

    // stage 4: [64, 128] x W4 [128, 256] in two halves of 128 columns, each
    // folded into the running maxima in shared memory
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc4[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128_rs<1>(acc4, p3[4 * kk], p3[4 * kk + 1], p3[4 * kk + 2], p3[4 * kk + 3],
                            desc_sw128(w4s + ((kk >> 2) * 4 + 2 * h) * kBoxBytes + (kk & 3) * 16 * 128,
                                       kBoxBytes, 1024),
                            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc4);
      const float* b4s = bias + kBias4 + 128 * h;
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // uint4 i: column groups jj = 2 i, 2 i + 1
        uint4 v = max4[(8 * h + i) * 128];
        const float* a4 = acc4 + 8 * i;
        const float2 c0 = *reinterpret_cast<const float2*>(b4s + 16 * i + 2 * qd);
        const float2 c1 = *reinterpret_cast<const float2*>(b4s + 16 * i + 8 + 2 * qd);
        v.x = max_bf16x2(v.x, pack_bf16(a4[0] + c0.x, a4[1] + c0.y));
        v.y = max_bf16x2(v.y, pack_bf16(a4[2] + c0.x, a4[3] + c0.y));
        v.z = max_bf16x2(v.z, pack_bf16(a4[4] + c1.x, a4[5] + c1.y));
        v.w = max_bf16x2(v.w, pack_bf16(a4[6] + c1.x, a4[7] + c1.y));
        max4[(8 * h + i) * 128] = v;
      }
    }
  }

  // the concat of the four maxima, rows ra and rb, as bf16 pairs
  bf16* ca = cat + (static_cast<size_t>(b) * n + ra) * kCat + 2 * qd;
  bf16* cb = ca + 8 * kCat;
  const bool va = ra < n, vb = rb < n;
  auto put = [&](int col, uint32_t lo, uint32_t hi) {
    if (va) *reinterpret_cast<uint32_t*>(ca + col) = lo;
    if (vb) *reinterpret_cast<uint32_t*>(cb + col) = hi;
  };
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    put(8 * jj, m1[2 * jj], m1[2 * jj + 1]);
    put(64 + 8 * jj, m2[2 * jj], m2[2 * jj + 1]);
  }
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) put(128 + 8 * jj, m3[2 * jj], m3[2 * jj + 1]);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint4 v = max4[i * 128];
    put(256 + 16 * i, v.x, v.y);
    put(256 + 16 * i + 8, v.z, v.w);
  }
}

}  // namespace

// Shared memory of the edge kernel, at any N and k (the projection takes
// gemm_wgmma.cuh's 214,064 bytes).
size_t vcr_dgcnn_eval_smem() { return kSmemBytes; }

// x f32 [B,N,3], idx int32 [B,N,k] (entries in [0, N)), w1 bf16 [6,64], w2
// bf16 [64,64], w3 bf16 [64,128], w4 bf16 [128,256], w5 bf16 [512,emb] (all
// [in, out], BatchNorm folded in), b1..b5 f32, cat bf16 [B,N,512] scratch ->
// out f32 [B,N,emb]. Requires emb % 8 == 0, k >= 1, 16-byte aligned
// pointers; any N. Returns the launch status.
cudaError_t vcr_dgcnn_eval(const float* x, const int* idx, const void* w1, const float* b1,
                           const void* w2, const float* b2, const void* w3, const float* b3,
                           const void* w4, const float* b4, const void* w5, const float* b5,
                           void* cat, float* out, int batch, int n, int k, int emb,
                           cudaStream_t stream) {
  namespace gemm = vcr::gemm90;
  WeightMaps maps;
  cudaError_t err = make_box_map(&maps.w1, w1, 6, 64);
  if (err == cudaSuccess) err = make_box_map(&maps.w2, w2, 64, 64);
  if (err == cudaSuccess) err = make_box_map(&maps.w3, w3, 64, 128);
  if (err == cudaSuccess) err = make_box_map(&maps.w4, w4, 128, 256);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dgcnn_edges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  dgcnn_edges_kernel<<<dim3((n + kTileQ - 1) / kTileQ, batch), kThreads, kSmemBytes, stream>>>(
      maps, x, idx, b1, b2, b3, b4, static_cast<bf16*>(cat), n, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;  // cat is written

  using CatProjection = gemm::Epilogue<true, true, true>;  // relu(cat W5 + b5), f32
  gemm::Jobs proj{};
  proj.depth = kCat;
  proj.n = emb;
  err = gemm::add_job<CatProjection>(proj, cat, w5, b5, out, batch * n);
  if (err != cudaSuccess) return err;
  return gemm::launch_gemm<CatProjection>(proj, stream);
}

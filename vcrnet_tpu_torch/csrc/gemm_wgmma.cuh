// A matrix product on the tensor cores through TMA and wgmma, for the
// projections of the pointer's attention sublayer (pointer_mha.cu), its
// feed-forward sublayer (pointer_ff.cu) and DGCNN's projection of the
// concat (dgcnn_eval.cu):
//
//   out[rows, n] = act(A[rows, depth] @ W[depth, n] + bias[n])
//
// bf16 in, f32 accumulate, the bias added in f32, act a ReLU or nothing and
// the result rounded once to the output's type. The epilogue's options are
// compile-time (Epilogue below): the projections of the attention take a
// bf16 bias, no ReLU and a bf16 output, the rounding points of the Pallas
// kernel's projections (pallas_pointer.py:_mha_kernel); the feed-forward's
// first product takes a ReLU (pallas_pointer.py:_ff_kernel), DGCNN's
// projection an f32 bias, a ReLU and an f32 output
// (pallas_dgcnn.py:_dgcnn_kernel). One launch runs up to three such
// products ("jobs", each with its own A, W, bias and output), so that the
// q, k and v projections of a sublayer are one launch whether q and k/v
// come from one activation (self-attention) or from two (cross-attention).
//
// Bound on the H100: at depth = n = 512 about 256 flops a byte moved
// (2 * depth * n flops a row against (depth + n) * 2 bytes), a little
// under the card's 295, so operations and bytes nearly balance; a tile of
// the activations is read from L2 once for every 256 output columns.
//
// Design:
//   * a tile of the output is 128 rows by 256 columns; two consumer
//     warpgroups own 64 rows each, one producer warp feeds them;
//   * the producer streams 64-deep slices of A (two [64, 64] boxes, one a
//     warpgroup) and of W (four [64, 64] boxes, 256 columns) through a
//     ring of three stages in shared memory with TMA (128-byte swizzle),
//     one full/empty mbarrier pair per stage;
//   * a warpgroup's product is wgmma m64n256k16 with both operands in
//     shared memory: A read K-major, W (row-major [depth, n], so the
//     contraction runs down its rows) read MN-major; the [64, 256] f32
//     accumulator (128 registers a thread) stays in registers across the
//     depth, and each stage is released once the products that read it
//     have completed (one group of products stays in flight);
//   * the kernel is persistent: a block per SM walks over the tiles, and
//     the producer runs ahead into the next tile's slices while the
//     consumers round and store the last one. Tiles go row-tile major,
//     every job's column tiles within a row tile, so a tile of A is read
//     from device memory once and from L2 by the others;
//   * the epilogue adds the bias, rounds to bf16 and writes a warpgroup's
//     [64, 256] tile into shared memory as four boxes in the 128-byte
//     swizzle (the XOR spreads a warp's eight rows over all banks), and one
//     thread stores the boxes with TMA; the next tile's epilogue waits
//     until those stores have read the boxes. Storing bf16 pairs straight
//     from the accumulator's layout (4-byte stores, eight rows a warp
//     instruction) took half the time of the products at B * N = 65536
//     rows (train/attention_parts.py). An f32 output goes the same way in
//     two passes of 128 columns (eight boxes of [64, 32] f32), the second
//     waiting until the first pass's stores have read the boxes. Rows at
//     or beyond ``rows`` and columns at or beyond ``n`` are neither read
//     (TMA reads zeros) nor written.
// 288 threads, ~209 KB of shared memory, one block per SM.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vcr {
namespace gemm90 {
namespace {

using namespace vcr::hopper;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;  // warpgroups, 64 rows each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kTileM = 64 * kConsumers;
constexpr int kTileN = 256;
constexpr int kTileK = 64;
constexpr int kStages = 3;
constexpr uint32_t kABytes = kConsumers * kBoxBytes;      // [128, 64]
constexpr uint32_t kWBytes = (kTileN / kBox) * kBoxBytes;  // [64, 256]
constexpr uint32_t kStageBytes = kABytes + kWBytes;
constexpr uint32_t kOutBytes = kConsumers * kWBytes;       // [128, 256] bf16
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + kOutBytes + 2 * kStages * 8;
constexpr int kMaxJobs = 3;

// What the epilogue applies: a ReLU or nothing, a bias of bf16 or f32, an
// output of bf16 or f32 (a bf16 output takes a bf16 bias).
template <bool kReluArg, bool kBiasF32Arg, bool kOutF32Arg>
struct Epilogue {
  static constexpr bool kRelu = kReluArg;
  static constexpr bool kBiasF32 = kBiasF32Arg;
  static constexpr bool kOutF32 = kOutF32Arg;
};
using Projection = Epilogue<false, false, false>;  // bf16(A W + b), b bf16

struct Job {
  CUtensorMap a;    // [rows, depth] bf16
  CUtensorMap w;    // [depth, n] bf16
  CUtensorMap out;  // [rows, n] bf16 or f32
  const void* bias;  // [n] bf16 or f32
  int rows;
};

struct Jobs {
  Job job[kMaxJobs];
  int count;
  int depth;  // % 64 == 0
  int n;      // % 8 == 0, the same for every job
};

// Tile ``t`` -> (job, first row, first column); false where that job has
// no such row tile (its rows are fewer than another job's).
__device__ __forceinline__ bool tile_of(const Jobs& jobs, int t, int col_tiles, int& j, int& row0,
                                        int& col0) {
  const int per_row = jobs.count * col_tiles;
  const int c = t % per_row;
  j = c / col_tiles;
  row0 = (t / per_row) * kTileM;
  col0 = (c % col_tiles) * kTileN;
  return row0 < jobs.job[j].rows;
}

template <class Ep>
__device__ __forceinline__ float act(float v) {
  return Ep::kRelu ? fmaxf(v, 0.f) : v;
}

// The bias of columns c and c + 1 (zeros past n), for an f32 output.
template <class Ep>
__device__ __forceinline__ float2 bias_pair(const void* bias, int c, int n) {
  if constexpr (Ep::kBiasF32)
    return c < n ? *reinterpret_cast<const float2*>(static_cast<const float*>(bias) + c)
                 : make_float2(0.f, 0.f);
  else
    return c < n ? unpack_bf16(*reinterpret_cast<const uint32_t*>(static_cast<const bf16*>(bias) + c))
                 : make_float2(0.f, 0.f);
}

template <bool kRelu, bool kBiasF32, bool kOutF32>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ Jobs jobs, int n_tiles) {
  using Ep = Epilogue<kRelu, kBiasF32, kOutF32>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);  // [stage]{A 2 boxes, W 4 boxes}
  uint8_t* out_s = ring + kStages * kStageBytes;  // [consumer]{4 boxes}
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + kOutBytes);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col_tiles = (jobs.n + kTileN - 1) / kTileN;
  const int k_steps = jobs.depth / kTileK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // ---- producer: one lane issues every copy
    if (lane == 0) {
      int it = 0;  // slices issued, over all tiles: the ring's position
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int j, row0, col0;
        if (!tile_of(jobs, t, col_tiles, j, row0, col0)) continue;
        const CUtensorMap* a_map = &jobs.job[j].a;
        const CUtensorMap* w_map = &jobs.job[j].w;
        for (int kb = 0; kb < k_steps; ++kb, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = ring + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          for (int c = 0; c < kConsumers; ++c)
            tma_load_box(st + c * kBoxBytes, a_map, &full[s], kb * kTileK, row0 + c * kBox);
          for (int c = 0; c < kTileN / kBox; ++c)
            tma_load_box(st + kABytes + c * kBoxBytes, w_map, &full[s], col0 + c * kBox,
                         kb * kTileK);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows row0 + 64 wg .. + 63 of a tile
  const int wg = warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const bool storer = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  uint8_t* tile_s = out_s + wg * kWBytes;
  const int r_g = (warp & 3) * 16 + g;  // this lane's rows r_g, r_g + 8 of the 64
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int j, row0, col0;
    if (!tile_of(jobs, t, col_tiles, j, row0, col0)) continue;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int kb = 0; kb < k_steps; ++kb, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* st = ring + s * kStageBytes;
      const bf16* a_box = reinterpret_cast<const bf16*>(st + wg * kBoxBytes);
      const bf16* w_tile = reinterpret_cast<const bf16*>(st + kABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256_ss_mn(acc, desc_k_major(a_box, kk),
                            desc_sw128(w_tile + kk * 16 * kBox, kBoxBytes, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done
      if (kb > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    const Job& job = jobs.job[j];
    const int n = jobs.n;
    if constexpr (!Ep::kOutF32) {
      // the bias is read here as PR 9's kernel read it: through bias_pair the
      // attention's projections compiled to other instructions
      static_assert(!Ep::kBiasF32, "a bf16 output takes a bf16 bias");
      if (storer) bulk_wait_read<0>();  // the last tile's stores have read tile_s
      named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < kTileN / 8; ++jj) {
        const int c = col0 + 8 * jj + 2 * qd;
        const float2 bias = c < n ? unpack_bf16(*reinterpret_cast<const uint32_t*>(
                                        static_cast<const bf16*>(job.bias) + c))
                                  : make_float2(0.f, 0.f);
        uint8_t* box = tile_s + (jj >> 3) * kBoxBytes + 4 * qd;
        *reinterpret_cast<uint32_t*>(box + sw128_offset(r_g, jj & 7)) =
            pack_bf16(act<Ep>(acc[4 * jj] + bias.x), act<Ep>(acc[4 * jj + 1] + bias.y));
        *reinterpret_cast<uint32_t*>(box + sw128_offset(r_g + 8, jj & 7)) =
            pack_bf16(act<Ep>(acc[4 * jj + 2] + bias.x), act<Ep>(acc[4 * jj + 3] + bias.y));
      }
      fence_proxy_async();  // the boxes are read by TMA
      named_bar_sync(1 + wg, 128);
      if (storer && row0 + wg * 64 < job.rows) {
        for (int b = 0; b < kTileN / kBox && col0 + b * kBox < n; ++b)
          tma_store_box(&job.out, tile_s + b * kBoxBytes, col0 + b * kBox, row0 + wg * 64);
        bulk_commit();
      }
    } else {
      // f32: two passes of 128 columns, each four [64, 32] boxes; column
      // 8 jj + 2 qd of a pass lies in box jj / 4, 16-byte chunk
      // 2 (jj % 4) + qd / 2, at byte 8 (qd % 2) of it
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        if (storer) bulk_wait_read<0>();  // the last stores have read tile_s
        named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < kTileN / 16; ++jj) {
          const int a = 4 * (16 * pass + jj);  // this pair's place in acc
          const int c = col0 + 128 * pass + 8 * jj + 2 * qd;
          const float2 bias = bias_pair<Ep>(job.bias, c, n);
          uint8_t* box = tile_s + (jj >> 2) * kBoxBytes + 8 * (qd & 1);
          const int chunk = 2 * (jj & 3) + (qd >> 1);
          *reinterpret_cast<float2*>(box + sw128_offset(r_g, chunk)) =
              make_float2(act<Ep>(acc[a] + bias.x), act<Ep>(acc[a + 1] + bias.y));
          *reinterpret_cast<float2*>(box + sw128_offset(r_g + 8, chunk)) =
              make_float2(act<Ep>(acc[a + 2] + bias.x), act<Ep>(acc[a + 3] + bias.y));
        }
        fence_proxy_async();  // the boxes are read by TMA
        named_bar_sync(1 + wg, 128);
        if (storer && row0 + wg * 64 < job.rows) {
          const int c0 = col0 + 128 * pass;
          for (int b = 0; b < 4 && c0 + b * (kBox / 2) < n; ++b)
            tma_store_box(&job.out, tile_s + b * kBoxBytes, c0 + b * (kBox / 2), row0 + wg * 64);
          bulk_commit();
        }
      }
    }
  }
  if (storer) bulk_wait<0>();  // the shared memory stays until the stores are done
}

int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return count;
}

// One job of a launch: out [rows, n] = act(a [rows, depth] @ w [depth, n] + bias),
// out and bias of the types Ep names.
template <class Ep = Projection>
inline cudaError_t add_job(Jobs& jobs, const void* a, const void* w, const void* bias, void* out,
                           int rows) {
  Job& job = jobs.job[jobs.count++];
  cudaError_t err = make_box_map(&job.a, a, rows, jobs.depth);
  if (err == cudaSuccess) err = make_box_map(&job.w, w, jobs.depth, jobs.n);
  if (err == cudaSuccess)
    err = Ep::kOutF32 ? make_box_map_f32(&job.out, out, rows, jobs.n)
                      : make_box_map(&job.out, out, rows, jobs.n);
  job.bias = bias;
  job.rows = rows;
  return err;
}

// Launches the jobs' products, a persistent block per SM. depth % 64 == 0,
// n % 8 == 0, 16-byte aligned pointers; every job added with the same Ep.
template <class Ep = Projection>
inline cudaError_t launch_gemm(const Jobs& jobs, cudaStream_t stream) {
  int max_rows = 0;
  for (int j = 0; j < jobs.count; ++j)
    if (jobs.job[j].rows > max_rows) max_rows = jobs.job[j].rows;
  const int n_tiles =
      (max_rows + kTileM - 1) / kTileM * jobs.count * ((jobs.n + kTileN - 1) / kTileN);
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<Ep::kRelu, Ep::kBiasF32, Ep::kOutF32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  gemm_kernel<Ep::kRelu, Ep::kBiasF32, Ep::kOutF32>
      <<<grid, kThreads, kSmemBytes, stream>>>(jobs, n_tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemm90
}  // namespace vcr

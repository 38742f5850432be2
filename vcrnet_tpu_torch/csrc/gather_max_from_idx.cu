// LPDNet SN block over a GIVEN neighbour selection: channel-wise gather-max.
//
// Replaces vcrnet_tpu/ops/pallas_edgeconv.py:gather_max_from_idx
// (_gather_max_from_idx_impl -> _gather_max_from_idx_kernel, :585, call
// :1142).
//
//   out[i, c] = max_{r < k} values[idx[i, r], c]
//
// It is knn_gather_max.cu without the score row and the selection: the
// refinement loop computes the source's xyz kNN once (rigid transforms keep
// distances) and later iterations only gather. The TPU kernel gathered with
// one [k*TQ, N] one-hot matmul because the TPU has no indexed load.
//
// Bound on the H100: bytes (idx, the value table once, out; no arithmetic
// but k comparisons per channel). A gather of whole rows from device memory
// (one warp a query, common.cuh:warp_gather_max, as knn_gather_max.cu
// does) reads each row k times: at B = 64, N = 1024, F = 256 that is 671 MB
// from L2, whose rate held that kernel at 0.12 ms against a bound of 0.022.
// So the gather reads from shared memory instead, by channel slices:
//   * a block owns one cloud and a slice of S = 2W channels (W 32-bit words
//     of bf16 pairs a point: W = 32, 16, 8 or 4, the widest whose [N, S]
//     slice fits in shared memory beside a ring of indices: up to about
//     1650, 3300, 6600 and 13200 points at k = 20). It stages the cloud's
//     slice once by cp.async (16-byte chunks), so device memory sees the
//     table once, out once, and idx once a slice;
//   * the block's queries' indices are staged beside it, all at once where
//     they fit (one round trip), else through a ring of two buffers, each
//     query's padded to whole int4s by repeating index k - 1 (a repeated
//     row comes after itself and never wins);
//   * W lanes own a query (32 / W queries a warp), lane w the channel pair
//     w of the slice: at W = 32 a warp's load of one row is 128 contiguous
//     bytes, one wavefront of shared memory with no bank conflict. A lane
//     reads a query's indices four at a time (one int4 broadcast) and the
//     rows four at a time, the next four loaded before this four's
//     comparisons, and keeps the running max of its pair as a bf16x2 word:
//     `set.gt` on bf16x2 gives a mask per half (the row's value strictly
//     above the max so far, NaN never), a select takes the value and, with
//     winners, the position r. Rows are taken in the order of idx, so the
//     max keeps the first row that reaches it, as warp_gather_max does: out
//     and winners equal knn_gather_max's bit for bit on the same idx;
//   * the grid is (slices, splits, B): a cloud's slices run side by side
//     (they read the same idx), and where B x slices blocks would leave SMs
//     idle (a few clouds, or one block an SM at N = 3072) the queries of a
//     cloud are split between blocks that each stage the slice (from L2).
// At B = 64, N = 1024 a block (1024 threads) holds 128 KB of slice and 80 KB
// of indices, one block an SM: its staging, its reads and its stores do not
// overlap one another, and that, not a rate, is what holds it (with the
// reads cut, the rest takes about half of the time).
//
// Beyond the slices of 8 channels the second path reads the rows from
// device memory, one warp a query (common.cuh:warp_gather_max), with the
// same results. Any N, any F % 8 == 0, 0 < k <= 32.
//
// Training: with a non-null ``win`` the kernel also writes each channel's
// winning k-position (uint8, the first on ties, as the Pallas kernel's
// emit_winners); gather_max_bwd.cu routes the gradient by it.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using vcr::hopper::cp_async16;
using vcr::hopper::cp_async_commit;
using vcr::hopper::cp_async_wait;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMinChunk = 128;            // queries of a ring buffer of indices, at least
constexpr size_t kSliceBudget = 232448;  // bytes of shared memory a block can use
constexpr size_t kBlockBudget = kSliceBudget;  // ... and that one is given
constexpr uint32_t kNegInf2 = 0xff80ff80u;  // a bf16 pair of -inf

// 0xffff in each half where a > b (bf16, ordered: NaN compares false).
__device__ __forceinline__ uint32_t gt_mask(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// log2 of a staged point's bytes (W words)
template <int W>
constexpr int kLog2Row = W == 32 ? 7 : W == 16 ? 6 : W == 8 ? 5 : 4;

// The lane's word of point ``p`` of the slice: one shift-add from its word
// of point 0 (``tw``, a shared-memory address), rows of W words.
template <int W>
__device__ __forceinline__ uint32_t row_word(uint32_t tw, int p) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(tw + (static_cast<uint32_t>(p) << kLog2Row<W>)));
  return v;
}

template <int W, bool kWinners>
__global__ void __launch_bounds__(kThreads)
slice_kernel(const int* __restrict__ idx,               // [B, N, k]
             const __nv_bfloat16* __restrict__ values,  // [B, N, F]
             __nv_bfloat16* __restrict__ out,           // [B, N, F]
             uint8_t* __restrict__ win,                 // [B, N, F] or null
             int n, int f, int k, int split, int chunk) {
  extern __shared__ uint4 smem_raw[];
  constexpr int kQueriesPerWarp = 32 / W;
  const int kk = (k + 3) & ~3;  // a query's indices in the ring: whole int4s
  uint32_t* table = reinterpret_cast<uint32_t*>(smem_raw);  // [N][W] words of the slice
  int* ring = reinterpret_cast<int*>(table + n * W);         // [1 or 2][chunk][kk]
  const int b = blockIdx.z, c0 = blockIdx.x * 2 * W;
  const int words = min(W, (f - c0) / 2);  // the last slice may be narrower
  const int chunks = words / 4;             // 16-byte chunks of a point's slice
  const int q_lo = blockIdx.y * split, q_hi = min(n, q_lo + split);
  const int n_chunks = (q_hi - q_lo + chunk - 1) / chunk;
  const int* ib = idx + static_cast<size_t>(b) * n * k;

  // the chunk's queries' indices by cp.async: where k % 4 == 0 they are one
  // contiguous run, copied 16 bytes at a time; else 4 bytes at a time, the
  // slots past k repeating index k - 1, whose row then comes again after
  // itself and never wins (the comparison is strict)
  auto stage_indices = [&](int c) {
    int* dst = ring + (c & 1) * chunk * kk;
    const int q0 = q_lo + c * chunk, count = min(chunk, q_hi - q0) * kk;
    const int* src = ib + static_cast<size_t>(q0) * k;
    if (kk == k) {
      for (int t = 4 * threadIdx.x; t < count; t += 4 * kThreads) cp_async16(dst + t, src + t);
      return;
    }
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int qq = t / kk, r = t - qq * kk;
      vcr::hopper::cp_async4(dst + t, src + qq * k + min(r, k - 1));
    }
  };

  const __nv_bfloat16* vb = values + static_cast<size_t>(b) * n * f + c0;
  for (int t = threadIdx.x; t < n * chunks; t += kThreads) {
    const int r = t / chunks, c = t - r * chunks;
    cp_async16(table + r * W + 4 * c, vb + static_cast<size_t>(r) * f + 8 * c);
  }
  if (n_chunks > 0) stage_indices(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / W, w = lane % W;
  const uint32_t tw = vcr::hopper::smem_addr(table + w);  // the lane's word of point 0
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {  // the next chunk's indices land while this one is read
      stage_indices(c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int* sel_c = ring + (c & 1) * chunk * kk;
    const int q0 = q_lo + c * chunk, q_n = min(chunk, q_hi - q0);
    for (int qq = warp * kQueriesPerWarp + sub; qq < q_n; qq += kWarps * kQueriesPerWarp) {
      // four rows a step, the next step's four loaded before this step's
      // comparisons: eight loads in flight a lane
      const int4* sp = reinterpret_cast<const int4*>(sel_c + qq * kk);
      uint32_t m = kNegInf2, pos = 0;  // pos: the winning r in each 16-bit half
      int4 s4 = sp[0];
      uint32_t v0 = row_word<W>(tw, s4.x), v1 = row_word<W>(tw, s4.y);
      uint32_t v2 = row_word<W>(tw, s4.z), v3 = row_word<W>(tw, s4.w);
#pragma unroll 1
      for (int r = 0; r < kk; r += 4) {
        uint32_t n0 = 0, n1 = 0, n2 = 0, n3 = 0;
        if (r + 4 < kk) {
          s4 = sp[r / 4 + 1];
          n0 = row_word<W>(tw, s4.x);
          n1 = row_word<W>(tw, s4.y);
          n2 = row_word<W>(tw, s4.z);
          n3 = row_word<W>(tw, s4.w);
        }
        const uint32_t v[4] = {v0, v1, v2, v3};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t gt = gt_mask(v[i], m);
          m = (v[i] & gt) | (m & ~gt);
          if (kWinners) pos = (((r + i) * 0x00010001u) & gt) | (pos & ~gt);
        }
        v0 = n0;
        v1 = n1;
        v2 = n2;
        v3 = n3;
      }
      if (w < words) {
        const size_t o = (static_cast<size_t>(b) * n + q0 + qq) * f + c0 + 2 * w;
        *reinterpret_cast<uint32_t*>(out + o) = m;
        if (kWinners)
          *reinterpret_cast<uint16_t*>(win + o) =
              static_cast<uint16_t>((pos & 0xffu) | (pos >> 8));
      }
    }
    __syncthreads();  // the ring's buffer c & 1 takes chunk c + 2
  }
}

// The second path: one warp a query, its rows read from device memory.
constexpr int kRowWarps = 8;

__global__ void __launch_bounds__(kRowWarps * 32)
rows_kernel(const int* __restrict__ idx, const __nv_bfloat16* __restrict__ values,
            __nv_bfloat16* __restrict__ out, uint8_t* __restrict__ win, int n, int f, int k) {
  __shared__ int sel_all[kRowWarps * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i = blockIdx.x * kRowWarps + warp;
  if (i >= n) return;  // no block-wide barrier below

  int* sel = sel_all + warp * 32;
  const size_t row = static_cast<size_t>(b) * n + i;
  if (lane < k) sel[lane] = idx[row * k + lane];
  __syncwarp();
  vcr::warp_gather_max(values + static_cast<size_t>(b) * n * f, sel, k, f, out + row * f,
                       win != nullptr ? win + row * f : nullptr);
}

// Bytes of a query's indices in shared memory (whole int4s).
size_t query_bytes(int k) { return ((k + 3) & ~3) * sizeof(int); }

// Shared memory of a block at its least: the slice and a ring of two
// buffers of kMinChunk queries' indices.
size_t slice_smem(int n, int w, int k) {
  return static_cast<size_t>(n) * w * 4 + 2 * kMinChunk * query_bytes(k);
}

// The SMs of the current device, asked once a device (a launch that waited
// on host calls would show their time in a timing of the device).
cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (cached[device] == 0)
    err = cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
  *sms = cached[device];
  return err;
}

template <int W, bool kWinners>
cudaError_t launch_slices(const int* idx, const void* values, void* out, void* win, int batch,
                          int n, int f, int k, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // the kernel may use up to a block's budget: allowed once a device
  static bool allowed[64] = {};
  int device = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess && !allowed[device]) {
    err = cudaFuncSetAttribute(slice_kernel<W, kWinners>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSliceBudget));
    allowed[device] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return err;
  const int slices = (f + 2 * W - 1) / (2 * W);
  // blocks an SM holds: by the 228 KB of an SM's shared memory (1 KB of it
  // reserved a block) and by its 2048 threads
  const size_t least = slice_smem(n, W, k);
  const int per_sm = max(1, min(2048 / kThreads, static_cast<int>(233472 / (least + 1024))));
  const int splits = max(1, min(sms * per_sm / (batch * slices), (n + 63) / 64));
  const int split = (n + splits - 1) / splits;
  // all of the block's indices at once where they fit beside the slice (no
  // round trip a chunk), else a ring of two buffers as large as fits
  const size_t table = static_cast<size_t>(n) * W * 4, qb = query_bytes(k);
  const size_t room = max(kBlockBudget, least) - table;
  const int chunk = split * qb <= room ? split : static_cast<int>(room / (2 * qb)) / 32 * 32;
  const size_t smem = table + (chunk == split ? 1 : 2) * chunk * qb;
  slice_kernel<W, kWinners><<<dim3(slices, splits, batch), kThreads, smem, stream>>>(
      idx, static_cast<const __nv_bfloat16*>(values), static_cast<__nv_bfloat16*>(out),
      static_cast<uint8_t*>(win), n, f, k, split, chunk);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_slices(const int* idx, const void* values, void* out, void* win, int batch,
                          int n, int f, int k, cudaStream_t stream) {
  return win != nullptr
             ? launch_slices<W, true>(idx, values, out, win, batch, n, f, k, stream)
             : launch_slices<W, false>(idx, values, out, win, batch, n, f, k, stream);
}

}  // namespace

// idx int32 [B,N,k] with entries in [0, N), values bf16 [B,N,F] -> out bf16
// [B,N,F], and with a non-null win the winners uint8 [B,N,F]. Requires
// F % 8 == 0, 0 < k <= 32, 16-byte aligned idx/values/out, 8-byte aligned
// win. Any N. Returns the launch status.
cudaError_t vcr_gather_max_from_idx(const int* idx, const void* values, void* out, void* win,
                                    int batch, int n, int f, int k, cudaStream_t stream) {
  if (f % 8 || k < 1 || k > 32) return cudaErrorInvalidValue;
  if (slice_smem(n, 32, k) <= kSliceBudget)
    return launch_slices<32>(idx, values, out, win, batch, n, f, k, stream);
  if (slice_smem(n, 16, k) <= kSliceBudget)
    return launch_slices<16>(idx, values, out, win, batch, n, f, k, stream);
  if (slice_smem(n, 8, k) <= kSliceBudget)
    return launch_slices<8>(idx, values, out, win, batch, n, f, k, stream);
  if (slice_smem(n, 4, k) <= kSliceBudget)
    return launch_slices<4>(idx, values, out, win, batch, n, f, k, stream);
  const dim3 grid((n + kRowWarps - 1) / kRowWarps, batch);
  rows_kernel<<<grid, kRowWarps * 32, 0, stream>>>(
      idx, static_cast<const __nv_bfloat16*>(values), static_cast<__nv_bfloat16*>(out),
      static_cast<uint8_t*>(win), n, f, k);
  return cudaGetLastError();
}

// Whole-cloud soft correspondence, streamed with an online softmax.
//
// Replaces vcrnet_tpu/ops/pallas_vcp.py:streaming_soft_correspondence
// (_run_streaming -> _vcp_kernel, :29, call :129).
//
//   s_ij    = 2 e_i . f_j - |f_j|^2           (bf16 embeddings, f32 accumulation)
//   corr_i  = sum_j softmax_j(s_ij) * tgt_j   (f32)
//
// Bound on the H100: operations (2 * Ns * Nt * E flops for the scores
// against (Ns + Nt) * E * 2 bytes of embeddings read once). The 3-wide
// weighted sum of tgt costs about 8 flops a score on the CUDA cores
// against 2 E = 1024 on the tensor cores, so it stays there in f32 (the
// TPU kernel's hi/lo bf16 split of xyz, an MXU trick, is not needed).
// The design keeps the tensor cores fed and every score in registers:
//   * a block owns 128 source rows of one batch item: two consumer
//     warpgroups of 64 rows and a producer warpgroup, one lane of which
//     issues the copies;
//   * S = E_rows . F^T is wgmma m64n64k16 over E / 16 = 32 k steps, the
//     key tile read K-major from shared memory. The first 16 steps take
//     the rows as A fragments held in registers (four bf16x2 registers a
//     step, loaded once: 64 registers), the other 16 from shared memory
//     (the rows' second half, loaded once by TMA). With all of A in shared
//     memory, the two warpgroups' reads (A and B, 4 KB a step each) outran
//     shared memory's 128 bytes a clock and bounded the products; with all
//     of it in registers (128) the consumers needed more than the 240
//     registers setmaxnreg can give them and spilled. Half and half reads
//     192 KB of shared memory a tile against 2048 clocks of products;
//   * the producer lane streams each 64-key tile of the target embedding
//     through a ring of eight stages of [64 keys, 128 columns] (two
//     128-byte-swizzled boxes, 16 KB: two tiles in flight) with TMA, one
//     full/empty mbarrier pair per stage; both consumers read each stage.
//     The tile's keys' (x, y, z, |f|^2), packed beforehand by
//     vcp_keys_kernel (vcp.cuh), arrive by one bulk copy into a ring of
//     their own;
//   * the consumers wait for a tile's four stages, run its 32 products as
//     one chain (a wait between them would split it, and ptxas then fences
//     each product on its own), and release the four stages together;
//   * the online softmax runs in registers on the accumulator layout (a
//     row's 64 scores sit in the four lanes of a quad: max and sum reduce
//     over __shfl_xor 1 and 2), in base 2; each thread keeps its part of
//     the row's running sum l and of the xyz sums, rescaled by
//     alpha = exp2(m_old - m_new) when the max moves, and the quad adds
//     them up once at the end.
// Nothing of S or P leaves registers. Shared memory per block: the rows'
// second half 65536 + ring 8 * 16384 + key values 4 * 1024 + barriers 200,
// plus 1024 bytes of alignment slack = 201928 bytes (<= 227 KB): one block
// per SM, whose two consumer warpgroups overlap one's softmax with the
// other's products. Registers: the fragments 64, S 32, the row statistics
// 10 and the addresses need more than the 168 a thread a block of 384
// threads starts with, so the producer warpgroup drops to 24 and the
// consumers rise to 240 (setmaxnreg); `-Xptxas -v` (chip_smoke.py prints
// it) reports no spills.
//
// Any Ns: the last block of an item owns rows past Ns (all of its second
// warpgroup's where Ns % 128 <= 64). In their place it reads the last row
// (its register fragments) and whatever the TMA boxes hold (the next batch
// item's rows, or zeros past the end of the tensor), runs the loop, arrives
// on every barrier, and stores nothing.
//
// Any Nt: the packing pass writes the keys of whole 64-key tiles, those
// past Nt with a norm of +inf (vcp.cuh). In the last tile the key rows past
// Nt are the next item's (or zeros past the end of the tensor); their
// scores 2 e . f - inf are -inf whatever those rows hold (finite), so
// they add exp2(-inf) = 0 to the sums, with xyz 0. Every visited tile has
// a real key, so the running max stays finite.
//
// E < 512: the last loaded box of a row is partly past E and TMA fills it
// with zeros, as the fragments past E are; boxes wholly past E are zeroed
// once in the rows' half and in every stage and never loaded, so every tile
// runs the same 32 k steps.
//
// Training: with a non-null ``lse`` the kernel also writes each source
// row's logsumexp m + log(l) of the scores ([B, Ns] f32, the Pallas
// kernel's save_lse), from which vcp_bwd.cu recomputes the probabilities.
//
// E > 512 runs another kernel, wide_kernel (below), so that this one keeps
// its instructions.
#include "common.cuh"
#include "hopper.cuh"
#include "vcp.cuh"

namespace {

using namespace vcr::hopper;
using vcr::vcp::kLn2;
using vcr::vcp::kLog2e;
using vcr::vcp::kMaxBoxes;
using vcr::vcp::kTile;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;  // warpgroups, 64 source rows each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRows = 64 * kConsumers;
constexpr int kChunkBoxes = 2;  // a stage: [64 keys, 128 columns]
constexpr int kMaxChunks = kMaxBoxes / kChunkBoxes;
constexpr uint32_t kChunkBytes = kChunkBoxes * kBoxBytes;
constexpr int kStages = 8;
static_assert(kStages % kMaxChunks == 0, "stage s always holds chunk s % kMaxChunks of a tile");
constexpr int kRegSteps = 2 * kMaxBoxes;   // k16 steps whose A fragments stay in registers
constexpr int kQBoxes = kMaxBoxes / 2;     // the rest: boxes 4..7 of the rows, in shared memory
constexpr uint32_t kQBytes = kConsumers * kQBoxes * kBoxBytes;
constexpr int kValSlots = 4;
constexpr uint32_t kValBytes = kTile * sizeof(float4);
constexpr int kBarriers = 1 + 2 * kStages + 2 * kValSlots;
constexpr size_t kSmemBytes =
    1024 + kQBytes + kStages * kChunkBytes + kValSlots * kValBytes + kBarriers * 8;

// Shared memory: the rows' second half [consumer][4 boxes], the ring
// [stage][2 boxes], the key values [slot][64] (x, y, z, |f|^2 of a tile's
// keys), then the barriers. Only the aligned base is held; every part is a
// constant offset from it (a pointer a part would cost the consumers
// registers they do not have).
struct Smem {
  static constexpr uint32_t kRing = kQBytes;
  static constexpr uint32_t kVals = kRing + kStages * kChunkBytes;
  static constexpr uint32_t kBars = kVals + kValSlots * kValBytes;
  uint8_t* base;

  __device__ explicit Smem(uint8_t* raw) : base(align_1024(raw)) {}
  __device__ bf16* q(int c) const { return reinterpret_cast<bf16*>(base) + c * kQBoxes * kBox * kBox; }
  __device__ bf16* stage(int s) const {
    return reinterpret_cast<bf16*>(base + kRing + s * kChunkBytes);
  }
  __device__ float4* vals(int v) const {
    return reinterpret_cast<float4*>(base + kVals) + v * kTile;
  }
  __device__ uint64_t* full(int s) const { return reinterpret_cast<uint64_t*>(base + kBars) + s; }
  __device__ uint64_t* empty(int s) const { return full(kStages + s); }
  __device__ uint64_t* val_full(int v) const { return full(2 * kStages + v); }
  __device__ uint64_t* val_empty(int v) const { return full(2 * kStages + kValSlots + v); }
  __device__ uint64_t* q_full() const { return full(2 * kStages + 2 * kValSlots); }
};

// The producer lane: the second half of the block's rows once, then every
// tile's key values and its four chunks of columns, through the two rings;
// boxes wholly past E are not loaded (a barrier completes on the bytes of
// the others, or at once).
__device__ __forceinline__ void produce(const Smem& sm, const CUtensorMap* src_map,
                                        const CUtensorMap* tgt_map, const float4* keys_b,
                                        int q_row, int k_row, int n_tiles, int n_boxes) {
  const int q_boxes = max(0, min(kQBoxes, n_boxes - kQBoxes));
  mbar_expect_tx(sm.q_full(), kConsumers * q_boxes * kBoxBytes);
  for (int c = 0; c < kConsumers; ++c)
    for (int x = 0; x < q_boxes; ++x)
      tma_load_box(sm.q(c) + x * kBox * kBox, src_map, sm.q_full(), (kQBoxes + x) * kBox,
                   q_row + 64 * c);
  int chunk = 0;  // chunks through the ring so far, over all tiles
  for (int t = 0; t < n_tiles; ++t) {
    const int v = t % kValSlots;
    if (t >= kValSlots) mbar_wait(sm.val_empty(v), ((t / kValSlots) & 1) ^ 1);
    mbar_expect_tx(sm.val_full(v), kValBytes);
    bulk_load(sm.vals(v), keys_b + t * kTile, kValBytes, sm.val_full(v));
    for (int c = 0; c < kMaxChunks; ++c, ++chunk) {
      const int s = chunk % kStages;
      if (chunk >= kStages) mbar_wait(sm.empty(s), ((chunk / kStages) & 1) ^ 1);
      const int boxes = max(0, min(kChunkBoxes, n_boxes - kChunkBoxes * c));
      mbar_expect_tx(sm.full(s), boxes * kBoxBytes);
      for (int h = 0; h < boxes; ++h)
        tma_load_box(sm.stage(s) + h * kBox * kBox, tgt_map, sm.full(s),
                     (kChunkBoxes * c + h) * kBox, k_row + t * kTile);
    }
  }
}

// ---- consumers: warpgroup wg owns source rows q0 + 64 wg .. + 63
__device__ __forceinline__ void consume(const Smem& sm, const bf16* src_emb, float* out,
                                        float* lse, int q0, int ns, int e, int n_tiles) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const int r_g = q0 + wg * 64 + (warp & 3) * 16 + g, r_g8 = r_g + 8;

  // the A fragments of the thread's rows g and g + 8 over the first half of
  // E: k step kk holds columns 16 kk + 2 qd (+1) and 16 kk + 8 + 2 qd (+1)
  uint32_t qa[4 * kRegSteps];
  {
    const size_t row0 = static_cast<size_t>(b) * ns;
    const uint32_t* a_g = reinterpret_cast<const uint32_t*>(src_emb + (row0 + min(r_g, ns - 1)) * e);
    const uint32_t* a_g8 =
        reinterpret_cast<const uint32_t*>(src_emb + (row0 + min(r_g8, ns - 1)) * e);
#pragma unroll
    for (int kk = 0; kk < kRegSteps; ++kk) {
      const bool in = 16 * kk < e;
      const int w = 8 * kk + qd;  // bf16x2 word of column 16 kk + 2 qd
      qa[4 * kk] = in ? __ldg(a_g + w) : 0u;
      qa[4 * kk + 1] = in ? __ldg(a_g8 + w) : 0u;
      qa[4 * kk + 2] = in ? __ldg(a_g + w + 4) : 0u;
      qa[4 * kk + 3] = in ? __ldg(a_g8 + w + 4) : 0u;
    }
  }

  float m_g = -CUDART_INF_F, m_g8 = -CUDART_INF_F;  // running max of s * log2(e)
  float l_g = 0.f, l_g8 = 0.f;                     // this lane's part of the row sums
  float x_g = 0.f, y_g = 0.f, z_g = 0.f, x_g8 = 0.f, y_g8 = 0.f, z_g8 = 0.f;

  const bf16* q_w = sm.q(wg);
  mbar_wait(sm.q_full(), 0);
  for (int t = 0; t < n_tiles; ++t) {
    // the tile's four chunks sit in consecutive stages of one phase; wait
    // for all four, so the chain of 32 products has no branch in it
    const int s0 = t * kMaxChunks % kStages;
    const uint32_t parity = (t * kMaxChunks / kStages) & 1;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) mbar_wait(sm.full(s0 + c), parity);
    float sc[32];  // 2 e . f of the tile; the first k step overwrites it
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
      for (int kk = 0; kk < 4 * kChunkBoxes; ++kk) {
        const int k = 4 * kChunkBoxes * c + kk;
        if (k < kRegSteps)
          wgmma_m64n64_rs(sc, qa[4 * k], qa[4 * k + 1], qa[4 * k + 2], qa[4 * k + 3],
                          desc_k_major(sm.stage(s0 + c), kk), k != 0);
        else
          wgmma_m64n64_ss(sc, desc_k_major(q_w, k - kRegSteps), desc_k_major(sm.stage(s0 + c), kk),
                          1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0)
      for (int c = 0; c < kMaxChunks; ++c) mbar_arrive(sm.empty(s0 + c));

    const int v = t % kValSlots;
    mbar_wait(sm.val_full(v), (t / kValSlots) & 1);
    const float4* kv = sm.vals(v);
    // scores in base 2: (2 S - |f|^2) log2(e)
    float mx_g = -CUDART_INF_F, mx_g8 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float nb = -kv[8 * j + 2 * qd + c].w * kLog2e;
        sc[4 * j + c] = fmaf(sc[4 * j + c], 2.f * kLog2e, nb);
        sc[4 * j + 2 + c] = fmaf(sc[4 * j + 2 + c], 2.f * kLog2e, nb);
        mx_g = fmaxf(mx_g, sc[4 * j + c]);
        mx_g8 = fmaxf(mx_g8, sc[4 * j + 2 + c]);
      }
    const float mn_g = fmaxf(m_g, quad_max(mx_g)), mn_g8 = fmaxf(m_g8, quad_max(mx_g8));
    const float alpha_g = exp2f(m_g - mn_g), alpha_g8 = exp2f(m_g8 - mn_g8);
    m_g = mn_g;
    m_g8 = mn_g8;
    l_g *= alpha_g;
    x_g *= alpha_g;
    y_g *= alpha_g;
    z_g *= alpha_g;
    l_g8 *= alpha_g8;
    x_g8 *= alpha_g8;
    y_g8 *= alpha_g8;
    z_g8 *= alpha_g8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 f = kv[8 * j + 2 * qd + c];
        const float p = exp2f(sc[4 * j + c] - mn_g), p8 = exp2f(sc[4 * j + 2 + c] - mn_g8);
        l_g += p;
        x_g = fmaf(p, f.x, x_g);
        y_g = fmaf(p, f.y, y_g);
        z_g = fmaf(p, f.z, z_g);
        l_g8 += p8;
        x_g8 = fmaf(p8, f.x, x_g8);
        y_g8 = fmaf(p8, f.y, y_g8);
        z_g8 = fmaf(p8, f.z, z_g8);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.val_empty(v));
  }

  l_g = quad_sum(l_g);
  x_g = quad_sum(x_g);
  y_g = quad_sum(y_g);
  z_g = quad_sum(z_g);
  l_g8 = quad_sum(l_g8);
  x_g8 = quad_sum(x_g8);
  y_g8 = quad_sum(y_g8);
  z_g8 = quad_sum(z_g8);
  if (qd == 0) {
    const size_t i_g = static_cast<size_t>(b) * ns + r_g, i_g8 = i_g + 8;
    if (r_g < ns) {
      out[3 * i_g] = x_g / l_g;
      out[3 * i_g + 1] = y_g / l_g;
      out[3 * i_g + 2] = z_g / l_g;
      if (lse != nullptr) lse[i_g] = m_g * kLn2 + logf(l_g);
    }
    if (r_g8 < ns) {
      out[3 * i_g8] = x_g8 / l_g8;
      out[3 * i_g8 + 1] = y_g8 / l_g8;
      out[3 * i_g8 + 2] = z_g8 / l_g8;
      if (lse != nullptr) lse[i_g8] = m_g8 * kLn2 + logf(l_g8);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
vcp_stream_kernel(const bf16* __restrict__ src_emb,               // [B, Ns, E]
                  const __grid_constant__ CUtensorMap src_map,  // [B * Ns, E] bf16
                  const __grid_constant__ CUtensorMap tgt_map,  // [B * Nt, E] bf16
                  const float4* __restrict__ keys,              // [B, n_tiles * 64]: x, y, z, |f|^2
                  float* __restrict__ out,                      // [B, Ns, 3]
                  float* __restrict__ lse,                      // [B, Ns] or null
                  int ns, int nt, int e) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const int b = blockIdx.y, q0 = blockIdx.x * kRows;
  const int n_boxes = (e + kBox - 1) / kBox;
  const int n_tiles = (nt + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kConsumerWarps);  // lane 0 of every consumer warp
    }
    for (int v = 0; v < kValSlots; ++v) {
      mbar_init(sm.val_full(v), 1);
      mbar_init(sm.val_empty(v), kConsumerWarps);
    }
    mbar_init(sm.q_full(), 1);
    mbar_init_fence();
  }
  // boxes wholly past E are never loaded: zero them once in the rows' half
  // and in every stage (stage s always holds chunk s % 4), so the products
  // always run over eight boxes and the wgmma chain has no branch in it
  for (int c = 0; c < kConsumers; ++c)
    for (int x = 0; x < kQBoxes; ++x)
      if (kQBoxes + x >= n_boxes)
        for (int i = threadIdx.x; i < static_cast<int>(kBoxBytes / sizeof(uint4)); i += kThreads)
          reinterpret_cast<uint4*>(sm.q(c) + x * kBox * kBox)[i] = make_uint4(0, 0, 0, 0);
  for (int s = 0; s < kStages; ++s)
    for (int h = 0; h < kChunkBoxes; ++h)
      if (kChunkBoxes * (s % kMaxChunks) + h >= n_boxes)
        for (int i = threadIdx.x; i < static_cast<int>(kBoxBytes / sizeof(uint4)); i += kThreads)
          reinterpret_cast<uint4*>(sm.stage(s) + h * kBox * kBox)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  // the roles split once, in one if/else that never rejoins (setmaxnreg)
  if (threadIdx.x >= 32 * kConsumerWarps) {  // ---- producer: one lane issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 32 * kConsumerWarps)
      produce(sm, &src_map, &tgt_map, keys + static_cast<size_t>(b) * n_tiles * kTile,
              b * ns + q0, b * nt, n_tiles, n_boxes);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume(sm, src_emb, out, lse, q0, ns, e, n_tiles);
  }
}


// ---- the kernel for 512 < E <= 1024 (wide_kernel). At E = 1024 neither half
// of the design above fits: the rows' A fragments over half of E would take
// 128 registers a thread (the consumers spilled at 240 with that many), and
// 128 rows of [E] bf16 take 256 KB of shared memory. So a block owns 64
// source rows of one batch item, held in shared memory (16 boxes, 128 KB,
// loaded once by TMA), and its two consumer warpgroups take alternate 64-key
// tiles (warpgroup w the tiles t with t % 2 == w), each with its own running
// max, sum and xyz sums over its tiles, in ascending order. Each warpgroup
// has a ring of four one-box stages ([64 keys, 64 columns], 8 KB) of its
// own; the producer warp's one lane issues the two warpgroups' tiles box by
// box in turn (tile 2u box x, tile 2u + 1 box x, then box x + 1), so both
// progress together. A warpgroup's score tile is the sum over the row
// boxes of four m64n64k16 products (A and B from shared memory), one box at
// a time: it waits for the box's stage, runs its four products, waits for
// them and releases the stage. At the end warpgroup 1 hands its rows' (m,
// l, x, y, z) to warpgroup 0 through shared memory, which merges the two
// as flash decoding merges its splits: m = max(m0, m1), l = l0 a0 + l1 a1
// with a = exp2(m_w - m), the xyz sums likewise, and stores corr and lse.
// Shared memory: rows 131072 + rings 2 * 4 * 8192 + key values 4 * 1024 +
// the merge 64 * 5 * 4 + barriers 200, plus 1024 bytes of alignment slack =
// 203208 bytes, one block an SM; 288 threads (two consumer warpgroups and
// the producer warp), no register rebalancing. A simple design: each
// product waits for its box (its speed is later work, PERF.md).
//
// Ragged lengths as above: rows past Ns are whatever the TMA boxes hold and
// are not stored; keys past Nt score -inf by their infinite norm. E that is
// no multiple of 64: the last box of a row and of a key tile is partly past
// E and TMA fills it with zeros. Tile 0 belongs to warpgroup 0, so its
// running max is finite; warpgroup 1 holds m = -inf and l = 0 where Nt
// has one tile, and its share of the merge is exp2(-inf) = 0.
namespace wide {

constexpr int kRows = 64;
constexpr int kStages = 4;  // a warpgroup's ring, one box a stage
constexpr int kValSlots = 4;
constexpr uint32_t kValBytes = kTile * sizeof(float4);
constexpr uint32_t kRowBytes = vcr::vcp::kMaxWideBoxes * kBoxBytes;
constexpr int kMergeFloats = 5 * kRows;  // m, l, x, y, z of warpgroup 1's rows
constexpr int kBarriers = 1 + 2 * kConsumers * kStages + 2 * kValSlots;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr size_t kSmemBytes = 1024 + kRowBytes + kConsumers * kStages * kBoxBytes +
                              kValSlots * kValBytes + kMergeFloats * 4 + kBarriers * 8;

struct Smem {
  static constexpr uint32_t kRing = kRowBytes;
  static constexpr uint32_t kVals = kRing + kConsumers * kStages * kBoxBytes;
  static constexpr uint32_t kMerge = kVals + kValSlots * kValBytes;
  static constexpr uint32_t kBars = kMerge + kMergeFloats * 4;
  uint8_t* base;

  __device__ explicit Smem(uint8_t* raw) : base(align_1024(raw)) {}
  __device__ bf16* rows() const { return reinterpret_cast<bf16*>(base); }
  __device__ bf16* stage(int w, int s) const {
    return reinterpret_cast<bf16*>(base + kRing + (w * kStages + s) * kBoxBytes);
  }
  __device__ float4* vals(int v) const {
    return reinterpret_cast<float4*>(base + kVals) + v * kTile;
  }
  __device__ float* merge() const { return reinterpret_cast<float*>(base + kMerge); }
  __device__ uint64_t* full(int w, int s) const {
    return reinterpret_cast<uint64_t*>(base + kBars) + w * kStages + s;
  }
  __device__ uint64_t* empty(int w, int s) const { return full(kConsumers + w, s); }
  __device__ uint64_t* val_full(int v) const { return full(2 * kConsumers, v); }
  __device__ uint64_t* val_empty(int v) const { return full(2 * kConsumers, kValSlots + v); }
  __device__ uint64_t* rows_full() const { return full(2 * kConsumers, 2 * kValSlots); }
};

__device__ __forceinline__ void produce(const Smem& sm, const CUtensorMap* src_map,
                                        const CUtensorMap* tgt_map, const float4* keys_b,
                                        int q_row, int k_row, int n_tiles, int n_boxes) {
  mbar_expect_tx(sm.rows_full(), n_boxes * kBoxBytes);
  for (int x = 0; x < n_boxes; ++x)
    tma_load_box(sm.rows() + x * kBox * kBox, src_map, sm.rows_full(), x * kBox, q_row);
  int issued[kConsumers] = {0, 0};  // boxes through each warpgroup's ring so far
  for (int t0 = 0; t0 < n_tiles; t0 += kConsumers) {
    for (int t = t0; t < min(t0 + kConsumers, n_tiles); ++t) {
      const int v = t % kValSlots;
      if (t >= kValSlots) mbar_wait(sm.val_empty(v), ((t / kValSlots) & 1) ^ 1);
      mbar_expect_tx(sm.val_full(v), kValBytes);
      bulk_load(sm.vals(v), keys_b + t * kTile, kValBytes, sm.val_full(v));
    }
    for (int x = 0; x < n_boxes; ++x)
      for (int w = 0; w < kConsumers && t0 + w < n_tiles; ++w) {
        const int c = issued[w]++, s = c % kStages;
        if (c >= kStages) mbar_wait(sm.empty(w, s), ((c / kStages) & 1) ^ 1);
        mbar_expect_tx(sm.full(w, s), kBoxBytes);
        tma_load_box(sm.stage(w, s), tgt_map, sm.full(w, s), x * kBox,
                     k_row + (t0 + w) * kTile);
      }
  }
}

__device__ __forceinline__ void consume(const Smem& sm, float* out, float* lse, int q0, int ns,
                                        int n_tiles, int n_boxes) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const int r = (warp & 3) * 16 + g;  // the block's rows r and r + 8

  float m_g = -CUDART_INF_F, m_g8 = -CUDART_INF_F;  // running max of s * log2(e)
  float l_g = 0.f, l_g8 = 0.f;                     // this lane's part of the row sums
  float x_g = 0.f, y_g = 0.f, z_g = 0.f, x_g8 = 0.f, y_g8 = 0.f, z_g8 = 0.f;

  mbar_wait(sm.rows_full(), 0);
  int c = 0;  // boxes of this warpgroup's ring consumed so far
  for (int t = wg; t < n_tiles; t += kConsumers) {
    float sc[32];  // 2 e . f of the tile; the first k step overwrites it
    for (int x = 0; x < n_boxes; ++x, ++c) {
      const int s = c % kStages;
      mbar_wait(sm.full(wg, s), (c / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_ss(sc, desc_k_major(sm.rows(), 4 * x + kk), desc_k_major(sm.stage(wg, s), kk),
                        x > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(wg, s));
    }

    const int v = t % kValSlots;
    mbar_wait(sm.val_full(v), (t / kValSlots) & 1);
    const float4* kv = sm.vals(v);
    // scores in base 2: (2 S - |f|^2) log2(e)
    float mx_g = -CUDART_INF_F, mx_g8 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float nb = -kv[8 * j + 2 * qd + cc].w * kLog2e;
        sc[4 * j + cc] = fmaf(sc[4 * j + cc], 2.f * kLog2e, nb);
        sc[4 * j + 2 + cc] = fmaf(sc[4 * j + 2 + cc], 2.f * kLog2e, nb);
        mx_g = fmaxf(mx_g, sc[4 * j + cc]);
        mx_g8 = fmaxf(mx_g8, sc[4 * j + 2 + cc]);
      }
    const float mn_g = fmaxf(m_g, quad_max(mx_g)), mn_g8 = fmaxf(m_g8, quad_max(mx_g8));
    const float alpha_g = exp2f(m_g - mn_g), alpha_g8 = exp2f(m_g8 - mn_g8);
    m_g = mn_g;
    m_g8 = mn_g8;
    l_g *= alpha_g;
    x_g *= alpha_g;
    y_g *= alpha_g;
    z_g *= alpha_g;
    l_g8 *= alpha_g8;
    x_g8 *= alpha_g8;
    y_g8 *= alpha_g8;
    z_g8 *= alpha_g8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float4 f = kv[8 * j + 2 * qd + cc];
        const float p = exp2f(sc[4 * j + cc] - mn_g), p8 = exp2f(sc[4 * j + 2 + cc] - mn_g8);
        l_g += p;
        x_g = fmaf(p, f.x, x_g);
        y_g = fmaf(p, f.y, y_g);
        z_g = fmaf(p, f.z, z_g);
        l_g8 += p8;
        x_g8 = fmaf(p8, f.x, x_g8);
        y_g8 = fmaf(p8, f.y, y_g8);
        z_g8 = fmaf(p8, f.z, z_g8);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.val_empty(v));
  }

  l_g = quad_sum(l_g);
  x_g = quad_sum(x_g);
  y_g = quad_sum(y_g);
  z_g = quad_sum(z_g);
  l_g8 = quad_sum(l_g8);
  x_g8 = quad_sum(x_g8);
  y_g8 = quad_sum(y_g8);
  z_g8 = quad_sum(z_g8);
  float* mg = sm.merge();  // [5][64]: m, l, x, y, z of warpgroup 1's rows
  if (wg == 1 && qd == 0) {
    const float mine[2][5] = {{m_g, l_g, x_g, y_g, z_g}, {m_g8, l_g8, x_g8, y_g8, z_g8}};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 5; ++i) mg[i * kRows + r + 8 * h] = mine[h][i];
  }
  named_bar_sync(1, 32 * kConsumerWarps);
  if (wg == 1 || qd != 0) return;
  const int r_g = q0 + r, r_g8 = r_g + 8;
  const size_t i_g = static_cast<size_t>(b) * ns + r_g, i_g8 = i_g + 8;
  if (r_g < ns) {
    const float m1 = mg[r], m = fmaxf(m_g, m1);
    const float a0 = exp2f(m_g - m), a1 = exp2f(m1 - m);
    const float l = l_g * a0 + mg[kRows + r] * a1;
    out[3 * i_g] = (x_g * a0 + mg[2 * kRows + r] * a1) / l;
    out[3 * i_g + 1] = (y_g * a0 + mg[3 * kRows + r] * a1) / l;
    out[3 * i_g + 2] = (z_g * a0 + mg[4 * kRows + r] * a1) / l;
    if (lse != nullptr) lse[i_g] = m * kLn2 + logf(l);
  }
  if (r_g8 < ns) {
    const float m1 = mg[r + 8], m = fmaxf(m_g8, m1);
    const float a0 = exp2f(m_g8 - m), a1 = exp2f(m1 - m);
    const float l = l_g8 * a0 + mg[kRows + r + 8] * a1;
    out[3 * i_g8] = (x_g8 * a0 + mg[2 * kRows + r + 8] * a1) / l;
    out[3 * i_g8 + 1] = (y_g8 * a0 + mg[3 * kRows + r + 8] * a1) / l;
    out[3 * i_g8 + 2] = (z_g8 * a0 + mg[4 * kRows + r + 8] * a1) / l;
    if (lse != nullptr) lse[i_g8] = m * kLn2 + logf(l);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
wide_kernel(const __grid_constant__ CUtensorMap src_map,  // [B * Ns, E] bf16
            const __grid_constant__ CUtensorMap tgt_map,  // [B * Nt, E] bf16
            const float4* __restrict__ keys,              // [B, n_tiles * 64]: x, y, z, |f|^2
            float* __restrict__ out,                      // [B, Ns, 3]
            float* __restrict__ lse,                      // [B, Ns] or null
            int ns, int nt, int e) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const int b = blockIdx.y, q0 = blockIdx.x * kRows;
  const int n_boxes = (e + kBox - 1) / kBox;
  const int n_tiles = (nt + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(sm.full(w, s), 1);
        mbar_init(sm.empty(w, s), 4);  // lane 0 of each of the warpgroup's warps
      }
    for (int v = 0; v < kValSlots; ++v) {
      mbar_init(sm.val_full(v), 1);
      mbar_init(sm.val_empty(v), 4);  // the warps of the tile's warpgroup
    }
    mbar_init(sm.rows_full(), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 32 * kConsumerWarps) {  // ---- producer: one lane issues every copy
    if (threadIdx.x == 32 * kConsumerWarps)
      produce(sm, &src_map, &tgt_map, keys + static_cast<size_t>(b) * n_tiles * kTile,
              b * ns + q0, b * nt, n_tiles, n_boxes);
    return;
  }
  consume(sm, out, lse, q0, ns, n_tiles, n_boxes);
}

}  // namespace wide

}  // namespace

// src_emb bf16 [B,Ns,E], tgt_emb bf16 [B,Nt,E], tgt f32 [B,Nt,3], keys f32
// [B,Nt',4] scratch (Nt' = Nt rounded up to 64) -> out f32 [B,Ns,3], and
// with a non-null lse the row logsumexp f32 [B,Ns]. Any Ns, Nt; requires
// E % 16 == 0, E <= 1024 (vcp_stream_kernel up to 512, wide_kernel above),
// 16-byte aligned pointers. Returns the launch status.
cudaError_t vcr_vcp_stream(const void* src_emb, const void* tgt_emb, const float* tgt,
                           float* keys, float* out, float* lse, int batch, int ns, int nt,
                           int e, cudaStream_t stream) {
  if (ns < 1 || nt < 1 || e % 16 || e > vcr::vcp::kMaxWideE) return cudaErrorInvalidValue;
  const bool is_wide = e > vcr::vcp::kMaxE;
  CUtensorMap src_map, tgt_map;
  cudaError_t err = make_box_map(&src_map, src_emb, static_cast<uint64_t>(batch) * ns, e);
  if (err == cudaSuccess) err = make_box_map(&tgt_map, tgt_emb, static_cast<uint64_t>(batch) * nt, e);
  if (err == cudaSuccess)
    err = is_wide ? cudaFuncSetAttribute(wide::wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(wide::kSmemBytes))
                  : cudaFuncSetAttribute(vcp_stream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = vcr::vcp::launch_keys(tgt_emb, tgt, keys, batch, nt, (nt + kTile - 1) / kTile * kTile,
                                e, stream);
  if (err != cudaSuccess) return err;
  if (is_wide) {
    wide::wide_kernel<<<dim3((ns + wide::kRows - 1) / wide::kRows, batch), wide::kThreads,
                        wide::kSmemBytes, stream>>>(
        src_map, tgt_map, reinterpret_cast<const float4*>(keys), out, lse, ns, nt, e);
    return cudaGetLastError();
  }
  const dim3 grid((ns + kRows - 1) / kRows, batch);
  vcp_stream_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(src_emb), src_map, tgt_map, reinterpret_cast<const float4*>(keys), out, lse, ns, nt, e);
  return cudaGetLastError();
}

// Hopper building blocks shared by the attention kernels (flash_fwd.cuh for
// flash_packed.cu, colmass.cu and pointer_mha.cu; flash_bwd.cu), the
// products of pointer_mha.cu, pointer_ff.cu and dgcnn_eval.cu
// (gemm_wgmma.cuh) and of int8_linear.cu, DGCNN's edge kernel (dgcnn_eval.cu), the
// soft-correspondence kernels (vcp_stream.cu, vcp_bwd.cu) and the edge-conv
// kernels (edge_conv.cu, edge_conv_from_idx.cu through edge_tile.cuh,
// edge_conv_bwd.cu): TMA tensor maps and loads,
// cp.async copies into swizzled boxes, mbarriers, named barriers, register
// rebalancing, wgmma descriptors, the wgmma shapes they use and the fences
// around them, the two tile products built from those shapes, the stores of
// an accumulator's rows and a vector reduction into device memory.
//
// Tiles. Every operand tile is a TMA box of [64 rows, 64 bf16 columns]
// (128 bytes a row) loaded with the 128-byte swizzle, so one head's 128
// columns of the packed [B*N, H*128] view are two boxes, 8 KB apart. A box
// starts on a 1024-byte boundary: the swizzle XORs the 16-byte chunk index
// of a row with the row's index modulo 8, taken from address bits [7, 10),
// and the wgmma descriptor (layout type 1, base offset 0) reads it back by
// the same rule. Match the two or the products read scrambled rows.
//
// Operands. A box serves wgmma either way round:
//   * K-major (the contraction runs along the 128-byte rows; trans = 0):
//     8-row groups 1024 bytes apart (SBO), a k16 step is +32 bytes inside
//     the row, and the second box holds k steps 4..7;
//   * MN-major (the contraction runs down the rows; trans = 1, for B only):
//     a k16 step is 16 rows (+2048 bytes), 8-row groups 1024 bytes apart
//     (SBO), and the two 64-column halves of N = 128 are the two boxes,
//     8192 bytes apart (LBO).
// The trans bit is easy to get wrong silently: S = Q.K^T reads K K-major,
// O += P.V reads V MN-major, though both are [keys, 128] boxes.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace vcr {
namespace hopper {

constexpr int kBox = 64;                                        // rows and columns of a box
constexpr uint32_t kBoxBytes = kBox * kBox * sizeof(__nv_bfloat16);  // 8 KB
constexpr uint32_t kHeadTileBytes = 2 * kBoxBytes;              // [64, 128]: one head's columns

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled is a driver-API function, and the extension is not
// linked against libcuda (torch.utils.cpp_extension.load does not add it).
// The CUDA runtime has already loaded the driver, so look the symbol up there.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A map over the row-major bf16 matrix [rows, cols] at ``base`` (16-byte
// aligned, cols % 8 == 0) whose box is [64, 64] with the 128-byte swizzle.
// The map holds the global address, so it is built for every call and
// passed to the kernel by value (``const __grid_constant__ CUtensorMap``).
// Rows past the end of the matrix arrive as zeros.
inline cudaError_t make_box_map(CUtensorMap* map, const void* base, uint64_t rows,
                                uint64_t cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {kBox, kBox};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same over a row-major f32 matrix [rows, cols] (cols % 4 == 0): a box of
// [64 rows, 32 columns], 128 bytes a row as above, for storing f32 tiles.
inline cudaError_t make_box_map_f32(CUtensorMap* map, const void* base, uint64_t rows,
                                    uint64_t cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(float)};
  const cuuint32_t box[2] = {kBox / 2, kBox};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same over a row-major int8 matrix [rows, cols] (cols % 16 == 0): a box
// of [64 rows, 128 columns], 128 bytes a row as above, for the codes of an s8
// product; rows and columns past the matrix arrive as zeros.
inline cudaError_t make_box_map_s8(CUtensorMap* map, const void* base, uint64_t rows,
                                   uint64_t cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {2 * kBox, kBox};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory rounded up to the 1024-byte boundary the swizzle
// needs (the launch asks for 1 KB more than it uses).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// After the inits, before any thread uses a barrier (then __syncthreads).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The producer's arrival on a ``full`` barrier, announcing the bytes the
// copies it is about to issue will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``
// (the phase before the first, of parity 1, counts as complete).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One [64, 64] box of ``map`` at (column ``col``, row ``row``) into shared
// memory at ``dst`` (1024-byte aligned); completion is counted on ``bar``.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// The other way: one [64, 64] box from shared memory at ``src`` (1024-byte
// aligned, in the layout a load with the 128-byte swizzle leaves) to ``map``
// at (column ``col``, row ``row``); rows and columns past the matrix are not
// written. The copies a thread issues complete as bulk groups: bulk_commit,
// then bulk_wait_read (the shared memory may be written again) or
// bulk_wait (the writes are done).
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map, const void* src, int col,
                                              int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(col), "r"(row)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending) : "memory");
}
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(kPending) : "memory");
}

// Byte offset of 16-byte chunk ``chunk`` (0..7) of row ``row`` inside a
// 128-byte-swizzled region whose rows are 128 bytes: the layout a TMA box
// with the 128-byte swizzle has, for kernels that fill boxes themselves.
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes from device memory to shared memory without passing through
// registers (cp.async, L2 only); a group of them completes by
// cp_async_wait<n> (all but the newest n committed groups). Its writes are
// ordinary ones: fence_proxy_async before wgmma reads them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// The same for 4 bytes (cp.async.ca: through L1).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory (ldmatrix .x4): lanes 8m ..
// 8m + 7 give the 16-byte rows of matrix m, and register m of lane (g, q)
// receives row g, columns 2q and 2q + 1 of it. With matrices (rows 0-7,
// k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) of
// a warp's 16 rows this is the A fragment of an m64 k16 step.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// p[0..3] += v, as one vector reduction (sm_90; p 16-byte aligned). The
// additions of concurrent reductions to one address land in no set order.
__device__ __forceinline__ void red_add_v4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}

// Orders this thread's ordinary shared-memory writes before later reads by
// the asynchronous proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A contiguous copy of ``bytes`` (a multiple of 16; both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at ``p``:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// k16 step ``kk`` of a K-major operand of 64 rows held as consecutive
// boxes, four steps a box: 0..7 for one head's [64, 128] (two boxes),
// 0..31 for a [64, 512] embedding tile (eight boxes).
__device__ __forceinline__ uint64_t desc_k_major(const __nv_bfloat16* tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * kBox * kBox + (kk & 3) * 16, 0, 1024);
}

// k16 step ``kk`` of a K-major operand of ``rows`` rows (a multiple of 8)
// held as [rows, 64] regions one after the other, four steps a region: the
// B operand of an n = rows product (desc_k_major is rows = 64).
__device__ __forceinline__ uint64_t desc_k_major_rows(const __nv_bfloat16* tile, int kk, int rows) {
  return desc_sw128(tile + (kk >> 2) * rows * kBox + (kk & 3) * 16, 0, 1024);
}

// k16 step ``kk`` (0..3) of an MN-major [64 (k), 128 (n)] B operand held as
// two boxes: 16 rows a step, the halves of n one box apart.
__device__ __forceinline__ uint64_t desc_mn_major(const __nv_bfloat16* tile, int kk) {
  return desc_sw128(tile + kk * 16 * kBox, kBoxBytes, 1024);
}

// Barrier ``id`` (1..15; 0 is __syncthreads) over the first ``threads``
// threads of the block to reach it (a multiple of 32). bar.sync also
// orders the shared-memory reads and writes of the threads it joins.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Register rebalancing between warpgroups (all 128 threads execute it): the
// producer warpgroup gives registers back, the consumers take them. The
// roles must split once, in one if/else that never rejoins, or ptxas
// ignores the instruction.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// wgmma.fence goes before the first wgmma of a batch: it orders the
// registers the batch reads (an A fragment, an accumulator just rescaled)
// after the instructions that wrote them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma: after wgmma_wait, before the math that reads
// them, and before a batch that writes them.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for packed A fragments: their conversions must be done before
// the wgmma.fence that opens the batch reading them.
template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// The same for an s32 accumulator.
template <int kN>
__device__ __forceinline__ void fence_regs(int (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both from shared memory, both
// K-major, f32 accumulate; ``accumulate`` = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A from registers (a bf16x2
// fragment, as below), B from shared memory read K-major (kTransB = 0) or
// MN-major (kTransB = 1: a [k, 64] box whose rows run along n); f32
// accumulate; ``accumulate`` = 0 overwrites d.
template <int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128]: A from registers (a bf16x2
// fragment, a[0..3]: rows g and g + 8, k columns 2q.. and 2q + 8..), B from
// shared memory read MN-major (kTransB = 1) or K-major (kTransB = 0: B's 128
// columns are the rows of the operand tile, the contraction runs along
// them); f32 accumulate; ``accumulate`` = 0 overwrites d.
template <int kTransB = 1>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, "
      "1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// d[64 x 256] (+)= A[64 x 16] . B[16 x 256], both from shared memory: A
// K-major (a box as desc_k_major), B MN-major (trans-b = 1: B's 256 columns
// run along the 128-byte rows of four boxes 8 KB apart, as desc_mn_major
// reads them); f32 accumulate; ``accumulate`` = 0 overwrites d. The
// accumulator layout is the m64nN one below, with j = 0..31.
__device__ __forceinline__ void wgmma_m64n256_ss_mn(float (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, "
      "0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 256] (+)= A[64 x 32] . B[32 x 256] in s8 -> s32, both from shared
// memory and both K-major (the only layout wgmma takes for 8-bit types): A a
// [64, 128] int8 box, B 256 rows of 128 bytes one after the other (four such
// boxes); ``accumulate`` = 0 overwrites d. The accumulator layout is the
// m64nN one below (as f32), with j = 0..31.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
        "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
        "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
        "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),
        "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]),
        "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]),
        "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
        "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Two f32 values as one bf16x2 register, the first in the low half (the
// lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The inverse: a bf16x2 register as two f32 values (low half first).
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---- the accumulator layout of wgmma m64nN (f32), per thread of the
// warpgroup: warp w covers rows 16w .. 16w + 15; with g = lane / 4 and
// q = lane % 4, d[4j + 0..1] hold row 16w + g, columns 8j + 2q + {0, 1},
// and d[4j + 2..3] row 16w + g + 8, the same columns. A row's values thus
// sit in the four lanes of one quad. The same layout, packed in pairs
// (pack_bf16(d[2i], d[2i + 1])), is the A fragment of the next product:
// k16 step kk reads packed registers 4kk .. 4kk + 3.

// d[64 x 64] = A . B^T over 128 columns, A and B [64, 128] K-major tiles
// (two boxes each) in shared memory: the score tile of 64 rows by 64 rows.
__device__ __forceinline__ void scores_64x64(float (&d)[32], const __nv_bfloat16* a,
                                             const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64_ss(d, desc_k_major(a, kk), desc_k_major(b, kk), kk > 0);
}

// acc[64 x 128] += A . B over 64: A a [64, 64] bf16 fragment in registers
// (packed as above), B a [64, 128] tile in shared memory read MN-major.
__device__ __forceinline__ void accumulate_64x128(float (&acc)[64], const uint32_t (&a)[16],
                                                  const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                        desc_mn_major(b, kk));
}

// Row max and sum over the quad that holds a row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A thread's part of a [64, 128] f32 accumulator as bf16: row g, scaled by
// scale_g, to the 128 columns at ``row_g``, and row g + 8 likewise; a null
// row pointer skips the row (it lies past the end of the output).
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* row_g, __nv_bfloat16* row_g8,
                                                const float (&d)[64], float scale_g,
                                                float scale_g8, int q) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * q;
    if (row_g != nullptr)
      *reinterpret_cast<uint32_t*>(row_g + c) = pack_bf16(d[4 * j] * scale_g, d[4 * j + 1] * scale_g);
    if (row_g8 != nullptr)
      *reinterpret_cast<uint32_t*>(row_g8 + c) =
          pack_bf16(d[4 * j + 2] * scale_g8, d[4 * j + 3] * scale_g8);
  }
}

// A thread's part of a [64, 128] f32 accumulator, scaled by ``scale``, to
// the f32 rows ``row_g`` and ``row_g8`` (nullptr: not stored) at their
// columns ``col0`` + 0..127; columns at or beyond ``cols`` are skipped.
__device__ __forceinline__ void store_rows_f32(float* row_g, float* row_g8, const float (&d)[64],
                                               float scale, int col0, int cols, int q) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + 8 * j + 2 * q;
    if (c >= cols) continue;
    if (row_g != nullptr)
      *reinterpret_cast<float2*>(row_g + c) = make_float2(d[4 * j] * scale, d[4 * j + 1] * scale);
    if (row_g8 != nullptr)
      *reinterpret_cast<float2*>(row_g8 + c) =
          make_float2(d[4 * j + 2] * scale, d[4 * j + 3] * scale);
  }
}

}  // namespace hopper
}  // namespace vcr

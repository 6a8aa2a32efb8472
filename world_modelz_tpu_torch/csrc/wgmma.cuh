// Hopper warpgroup products (wgmma.mma_async, sm_90a) on 128-byte
// swizzled shared-memory tiles, for the bf16 local-3D backward
// (local3d_bwd.cu), the grouped expert GEMM (expert_gemm.cu) and, in
// TF32, the VQ search (vq_search.cuh) and the f32 dense layers
// (dense_tf32.cu).
//
// A tile of R rows of D bf16 (D a multiple of 64, R of 8) is stored as
// D / 64 column blocks, each R rows of 128 bytes; the 16-byte chunk c of a
// row r sits at chunk c ^ (r % 8) of its 128-byte row (the B128 swizzle),
// so 8 rows' chunks of one column fall in 8 different bank groups. Tiles
// start on 1,024-byte boundaries (the swizzle repeats every 8 rows).
//
// A warpgroup (4 warps) issues each product for 64 rows; warp w holds rows
// 16 w .. 16 w + 15 of the f32 result in mma.sync's C layout (flash_mma.cuh):
// d[j][0..1] row g, columns 8 j + 2 t, +1; d[j][2..3] row g + 8 (lane = 4 g
// + t). Rounded pairwise, two neighbouring 8-column tiles are the A
// fragment of the next product's 16-deep slice (mma::to_a_frags), which
// wgmma takes from registers.
//
// Descriptors (PTX ISA, matrix descriptor): start address >> 4 in bits
// 0-13, leading byte offset >> 4 in 16-29, stride byte offset >> 4 in
// 32-45, layout 1 (B128) in 62-63. K-major (a row holds the depth): the
// stride is 1,024 bytes between 8-row groups; a 16-deep step starts 32
// bytes further into the swizzled row, or in the next column block.
// MN-major (a row is one step of the depth, TransB = 1): the leading
// offset is the column blocks' stride, the stride 1,024 bytes between
// 8-row groups; a 16-deep step starts 16 rows further down.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <stdint.h>

#include "flash_mma.cuh"

namespace wmz {
namespace wg {

using bf16 = __nv_bfloat16;

// element offset of the 16-byte chunk c8 (columns 8 c8 .. 8 c8 + 7) of row
// r in a swizzled tile of R rows
template <int R>
__device__ __forceinline__ int chunk_at(int r, int c8) {
  return (c8 >> 3) * R * 64 + r * 64 + (((c8 & 7) ^ (r & 7)) << 3);
}

// rows [row0, row0 + rows) of a row-major bf16 operand (`base` at row 0,
// ld elements between rows) -> rows dst0 .. dst0 + rows - 1 of the
// swizzled tile dst of R rows; rows at or past N are zero. Every thread of
// the block takes part.
template <int D, int R>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* __restrict__ base,
                                                long long ld, int row0, int N, int dst0 = 0,
                                                int rows = R) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c8 = i % kChunks;
    const bool valid = row0 + r < N;
    mma::cp_async16(dst + chunk_at<R>(dst0 + r, c8),
                    base + (valid ? (row0 + r) * ld : 0) + c8 * 8, valid);
  }
}

__device__ __forceinline__ uint64_t make_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = mma::smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// 16-deep step kk of a K-major swizzled tile of R rows
template <int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return make_desc(tile + (kk >> 2) * R * 64 + (kk & 3) * 16, 16, 1024);
}
// 16-deep step kk (rows 16 kk .. 16 kk + 15) of an MN-major swizzled tile
// of R rows
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return make_desc(tile + kk * 16 * 64, R * 128, 1024);
}

// --- tensor-memory-accelerator copies (TMA) of 64 x 64 boxes into
// swizzled tiles, counted on an mbarrier a stage

// a 2-D map of a row-major bf16 operand of `rows` rows of `inner`
// elements (`ld` elements between rows), read in 64 x 64 boxes with the
// B128 swizzle; rows past the end read as zeros. Host side: the encoder
// comes from the driver through the runtime, so nothing links libcuda.
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, long long inner,
                                   long long rows, long long ld) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64}, step[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mma::smem_addr(bar)),
               "r"(count)
               : "memory");
}
// after the barriers are initialised, before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` to land this phase
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   mma::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(mma::smem_addr(bar)),
      "r"(phase)
      : "memory");
}
// the 64 x 64 box at (column c0, row c1) of `map` -> dst (8 KB, 1,024-byte
// aligned), counted on bar
__device__ __forceinline__ void tma_box(bf16* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(mma::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mma::smem_addr(bar))
      : "memory");
}
// rows [row, row + 64) of the operand of `map` (D columns from column c0)
// -> the swizzled tile dst of 64 rows; issued by one thread, which first
// announces the bytes on bar
template <int D>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map, int c0, int row,
                                         uint64_t* bar) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h) tma_box(dst + h * 64 * 64, map, c0 + 64 * h, row, bar);
}

// before the first product that reads registers written since the last
// one (accumulators, A fragments), and after shared-memory writes
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The compiler sees a product's registers as read and written when the
// instruction issues, but the tensor cores read A fragments and write the
// accumulators until wait(): pin them on both sides of the products, so
// that no register is moved or reused in between.
template <int C>
__device__ __forceinline__ void fence_regs(float d[C][4]) {
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int C>
__device__ __forceinline__ void fence_frags(uint32_t a[C][4]) {
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// d (64 x 64, f32, mma.sync C layout per warp) += A B, K = 16: A from
// shared memory (desc_a, K-major), B from shared memory (desc_b; TransB 1:
// MN-major); scale_d 0 overwrites d
template <int TransB>
__device__ __forceinline__ void mma_ss_n64(float d[8][4], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// d (64 x 64, f32, mma.sync C layout per warp) += A B, K = 16: A from
// registers (this warp's 16 rows as mma.sync A fragments), B from shared
// memory (desc_b; TransB 1: MN-major); scale_d 0 overwrites d. Pass A
// fragments written in the step of their product: ptxas 12.9 gave the
// registers of fragments held across a loop's steps to other values
// (local3d_bwd.cu, pass 1).
template <int TransB>
__device__ __forceinline__ void mma_rs_n64(float d[8][4], const uint32_t a[4], uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// d (64 x 128, f32, mma.sync C layout per warp) += A B, K = 16: A from
// registers (this warp's 16 rows as mma.sync A fragments), B from shared
// memory (desc_b; TransB 1: MN-major); scale_d 0 overwrites d
template <int TransB>
__device__ __forceinline__ void mma_rs_n128(float d[16][4], const uint32_t a[4], uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// d (64 x 128, f32, mma.sync C layout per warp) += A B, K = 16: A and B
// from shared memory (desc_a, desc_b; TransA / TransB 1: MN-major, which
// bf16 allows on both sides); scale_d 0 overwrites d
template <int TransA, int TransB>
__device__ __forceinline__ void mma_ss_n128(float d[16][4], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// d (64 x 64, f32, mma.sync C layout per warp) += A B, K = 8 in TF32: A
// and B K-major tiles of f32 (TF32 reads the top 19 bits) in shared memory
// (desc_a, desc_b: the 8-deep step is 32 bytes, as a 16-deep bf16 step, so
// desc_k serves on the tile's bytes); scale_d 0 overwrites d. TF32 takes
// no transpose.
__device__ __forceinline__ void mma_tf32_n64(float d[8][4], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32, mma.sync C layout per warp) += A B, K = 8 in TF32: A
// from registers (this warp's 16 rows as mma.sync m16n8k8 .tf32 A
// fragments: rows g, g + 8 at k-slots t, t + 4), B a K-major tile of f32
// in shared memory (desc_b, as mma_tf32_n64's); scale_d 0 overwrites d.
// The A registers are read until the product's group is waited for.
__device__ __forceinline__ void mma_tf32_rs_n64(float d[8][4], const uint32_t a[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

}  // namespace wg
}  // namespace wmz

// Tensor-core tiling for the dense flash-attention kernels on Hopper
// (sm_90a): bf16 tiles in shared memory, `cp.async` staging, `ldmatrix`
// fragments and `mma.sync.aligned.m16n8k16` products with f32 sums.
// flash_bwd.cu builds its bf16 backward pair on it; the forwards
// (flash_fwd.cu, local3d_fwd.cu) hold Q as A fragments in registers
// (`load_a_frags`, `warp_dots_frags` for Q K^T), round P into `to_a_frags`
// and take P V with `warp_product`; the local-3D backward (local3d_bwd.cu,
// on wgmma.cuh) takes its copies, fragments and stores from here.
//
// A block of W warps owns 16 W rows of one side (queries or keys) of one
// (b, h); warp w owns rows 16 w .. 16 w + 15 and keeps its sums in
// registers. Tiles sit in shared memory as bf16 rows of D values padded
// to D + 8, so the eight 16-byte rows of one 8 x 8 `ldmatrix` matrix lie in
// eight different bank groups: no bank conflicts without a swizzle.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t. An m16n8
// f32 tile c[4] holds (row g, columns 2t, 2t+1) in c[0..1] and (row g + 8,
// the same columns) in c[2..3]. Two neighbouring m16n8 tiles, rounded to
// bf16 pairwise, are exactly the A fragment of the m16n16 slice they span
// (`to_a_frags`), so a product's output feeds the next product from
// registers, without shared memory or a barrier.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace wmz {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 of padding after each row of a tile
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory bytes of a bf16 tile of `rows` rows of D values
template <int D>
constexpr size_t tile_bytes(int rows) {
  return (size_t)rows * (D + kPad) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled where !valid (src is
// then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `Pending` committed groups are still in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// rows [row0, row0 + Rows) of a row-major bf16 operand (`base` at row 0,
// row stride `ld_n` elements, 16-byte aligned rows) -> the padded tile
// `dst`; rows at or past N are zero. Every thread of the block takes part.
template <int D, int Rows>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* __restrict__ base,
                                                long long ld_n, int row0, int N) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < Rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int n = row0 + r;
    const bool valid = n < N;
    cp_async16(dst + r * (D + kPad) + c, base + (valid ? n * ld_n : 0) + c, valid);
  }
}

// Rows values of a row-major f32 vector (lse, delta) from row0 on -> dst;
// zero at or past N
template <int Rows>
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ src,
                                               int row0, int N) {
  for (int i = threadIdx.x; i < Rows; i += blockDim.x) {
    const bool valid = row0 + i < N;
    cp_async4(dst + i, src + (valid ? row0 + i : 0), valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: bf16 operands, f32 sums
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float acc[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc[j] = the m16n8 tile of columns 8 j .. 8 j + 7 of A B^T, for the 16
// rows of the padded tile A (this warp's rows) against the Cols rows of the
// padded tile B: both hold D values per row (the product's depth).
template <int D, int Cols>
__device__ __forceinline__ void warp_dots(const bf16* A, const bf16* B, float acc[Cols / 8][4]) {
  constexpr int L = D + kPad;
  const int lane = threadIdx.x & 31;
  zero<Cols / 8>(acc);
  // ldmatrix rows: A's matrices are (rows 0-7 | 8-15) x (depth 0-7 | 8-15);
  // B's are two n8 tiles x the two depth halves
  const bf16* a_row = A + (lane & 15) * L + (lane >> 4) * 8;
  const bf16* b_row = B + ((lane & 7) + (lane >> 4) * 8) * L + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ldmatrix_x4(a, a_row + kc * 16);
#pragma unroll
    for (int j = 0; j < Cols / 16; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, b_row + j * 16 * L + kc * 16);
      mma_16816(acc[2 * j], a, b[0], b[1]);
      mma_16816(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// the A fragments of this warp's 16 rows of the padded tile A (D values a
// row): one 16 x 16 slice of the depth per entry
template <int D>
__device__ __forceinline__ void load_a_frags(const bf16* A, uint32_t a[D / 16][4]) {
  const int lane = threadIdx.x & 31;
  const bf16* a_row = A + (lane & 15) * (D + kPad) + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) ldmatrix_x4(a[kc], a_row + kc * 16);
}

// warp_dots with A held as fragments (`load_a_frags`): acc[j] = the m16n8
// tile of columns 8 j .. 8 j + 7 of A B^T for the Cols rows of the padded
// tile B, which may start at any row of a tile
template <int D, int Cols>
__device__ __forceinline__ void warp_dots_frags(const uint32_t a[D / 16][4], const bf16* B,
                                                float acc[Cols / 8][4]) {
  constexpr int L = D + kPad;
  const int lane = threadIdx.x & 31;
  zero<Cols / 8>(acc);
  const bf16* b_row = B + ((lane & 7) + (lane >> 4) * 8) * L + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
    for (int j = 0; j < Cols / 16; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, b_row + j * 16 * L + kc * 16);
      mma_16816(acc[2 * j], a[kc], b[0], b[1]);
      mma_16816(acc[2 * j + 1], a[kc], b[2], b[3]);
    }
}

// max and sum over the four lanes (t = 0..3) that hold one row of an m16n8
// tile; every lane gets the result
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the m16n8 f32 tiles s[2 k], s[2 k + 1], rounded to bf16: the A fragment
// of the 16 x 16 slice k of the next product's depth
template <int Cols>
__device__ __forceinline__ void to_a_frags(const float s[Cols / 8][4], uint32_t a[Cols / 16][4]) {
#pragma unroll
  for (int k = 0; k < Cols / 16; ++k) {
    a[k][0] = pack_bf16(s[2 * k][0], s[2 * k][1]);
    a[k][1] = pack_bf16(s[2 * k][2], s[2 * k][3]);
    a[k][2] = pack_bf16(s[2 * k + 1][0], s[2 * k + 1][1]);
    a[k][3] = pack_bf16(s[2 * k + 1][2], s[2 * k + 1][3]);
  }
}

// acc[j] += the m16n8 tile of columns 8 j .. 8 j + 7 of P M: P is 16 x
// Depth, held as A fragments `pa`; M is the padded tile of Depth rows of D
// values (read transposed by ldmatrix.trans).
template <int D, int Depth>
__device__ __forceinline__ void warp_product(const uint32_t pa[Depth / 16][4], const bf16* M,
                                             float acc[D / 8][4]) {
  constexpr int L = D + kPad;
  const int lane = threadIdx.x & 31;
  // ldmatrix rows: (depth 0-7 | 8-15) x two n8 tiles of D
  const bf16* m_row = M + ((lane & 7) + ((lane >> 3) & 1) * 8) * L + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < Depth / 16; ++kc)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, m_row + kc * 16 * L + j * 16);
      mma_16816(acc[2 * j], pa[kc], b[0], b[1]);
      mma_16816(acc[2 * j + 1], pa[kc], b[2], b[3]);
    }
}

// this warp's 16 x D sums, rounded to bf16, into rows row0 + (0 .. 15) of
// `out` (row stride ld_n elements); rows at or past N are not written
template <int D>
__device__ __forceinline__ void store_rows(const float acc[D / 8][4], bf16* __restrict__ out,
                                           long long ld_n, int row0, int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = row0 + g + 8 * i;
    if (n >= N) continue;
    bf16* row = out + n * ld_n + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

}  // namespace mma
}  // namespace wmz

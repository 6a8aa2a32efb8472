// The tiling shared by the dense flash-attention kernels: the forward
// (flash_fwd.cu) and the split backward pair (flash_bwd.cu); the fused
// local-3D block (local3d_block.cu) runs its projections on it too.
//
// Operands are (B, H, N, D) tensors read through their strides (the last
// dimension contiguous), so q, k and v may be head views of a fused QKV
// projection. A block of kThreads = 256 threads, a 16 x 16 grid (ty, tx),
// owns one 64-row tile of queries (or keys) of one (b, h) and walks the 64-row
// tiles of the other side in order. Tiles sit in shared memory as f32, one
// row of D values per row padded to D + 1 so that 16 threads reading 16 rows
// hit 16 banks. The 64 x 64 score tile is split 4 x 4 per thread: thread
// (ty, tx) holds rows ty*4 .. ty*4+3 and columns tx, tx+16, tx+32, tx+48, so
// a row's values lie in the 16 lanes of one half-warp and a row reduction is
// four shuffles. A product of a 64 x 64 weight tile with a 64 x D tile gives
// the thread the same rows and columns tx + 16 c, c < D / 16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "vec.cuh"

namespace wmz {
namespace flash {

constexpr int kTile = 64;                // rows of a query or key tile
constexpr int kTx = 16;                  // threads along a row of scores
constexpr int kTy = 16;                  // threads along the tile's rows
constexpr int kThreads = kTx * kTy;      // 256
constexpr int kRows = kTile / kTy;       // score rows per thread
constexpr int kCols = kTile / kTx;       // score columns per thread
constexpr int kSLd = kTile + 1;          // padded row of a 64 x 64 f32 tile

// element strides of one (B, H, N, D) operand along b, h and n
struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// shared-memory bytes of `tiles` 64 x D tiles, `squares` 64 x 64 tiles and
// `vectors` 64-float vectors
template <int D>
constexpr size_t smem_bytes(int tiles, int squares, int vectors) {
  return sizeof(float) *
         ((size_t)tiles * kTile * (D + 1) + (size_t)squares * kTile * kSLd +
          (size_t)vectors * kTile);
}

// rows [row0, row0 + 64) of the (b, h) slice of `src` -> the f32 tile `dst`
// (64 x (D + 1)); rows at or past N are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Strides st, int b, int h, int row0,
                                          int N) {
  constexpr int kVec = D / 4;
  const T* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const int n = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N) x = load4(base + n * st.n + c);
    float* p = dst + r * (D + 1) + c;
    p[0] = x.x;
    p[1] = x.y;
    p[2] = x.z;
    p[3] = x.w;
  }
}

// s[i][j] += sum_d A[ty*kRows + i][d] * B[tx + kTx*j][d] for two 64 x D
// tiles (a product whose depth is staged through shared memory in chunks)
template <int D>
__device__ __forceinline__ void tile_dots_acc(const float* A, const float* B,
                                              float s[kRows][kCols]) {
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const float* a_row = A + ty * kRows * (D + 1);
  const float* b_row = B + tx * (D + 1);
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    float a[kRows], bb[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = a_row[i * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bb[j] = b_row[j * kTx * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// s[i][j] = sum_d A[ty*kRows + i][d] * B[tx + kTx*j][d] for two 64 x D tiles
template <int D>
__device__ __forceinline__ void tile_dots(const float* A, const float* B,
                                          float s[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
  tile_dots_acc<D>(A, B, s);
}

// acc[i][c] += sum_k P[ty*kRows + i][k] * M[k][tx + kTx*c]: a 64 x 64
// weight tile (row stride kSLd) times a 64 x D tile
template <int D>
__device__ __forceinline__ void tile_product(const float* P, const float* M,
                                             float acc[kRows][D / kTx]) {
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const float* p_row = P + ty * kRows * kSLd;
#pragma unroll 8
  for (int k = 0; k < kTile; ++k) {
    float p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) p[i] = p_row[i * kSLd + k];
    const float* m_row = M + k * (D + 1) + tx;
#pragma unroll
    for (int c = 0; c < D / kTx; ++c) {
      const float m = m_row[c * kTx];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], m, acc[i][c]);
    }
  }
}

// max and sum over the kTx lanes of a half-warp (one score row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the head sizes the kernels are instantiated for
inline bool bad_head_size(int D) { return D != 64 && D != 128; }

inline dim3 grid_for(int B, int H, int N) {
  return dim3((unsigned)((N + kTile - 1) / kTile), (unsigned)H, (unsigned)B);
}

}  // namespace flash
}  // namespace wmz

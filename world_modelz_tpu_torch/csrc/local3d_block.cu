// The whole local-3D attention block in one launch, for Hopper (sm_90a):
// the q, k and v projections, the windowed attention and the output
// projection.
//
// Replaces the TPU kernel world_modelz_tpu/kernels/local3d_block.py:
// _block_kernel (:122, pallas_call :262), which `Local3dAttention(backend=
// "fused")` reaches through `local3d_block` (:304).
//
// What it computes. x (the LayerNormed key/value stream) and q_in (the
// un-normed query stream) are (R, dim) and (R, dim_q), R = B*S*H*W rows in
// (b, s, h, w) order; the weights are in nn.Linear's (out, in) layout: wk,
// wv (inner, dim), wq (inner, dim_q), wo (out_dim, inner), with biases bv
// (inner) and bo (out_dim); inner = heads * dh. With T the operand type
// (f32 or bf16) and every product accumulated in f32:
//   k = T(x wk^T),  v = T(T(x wv^T) + bv),  q = T(q_in wq^T)
//   P = T(softmax(dh^-1/2 q k^T over the window)),  a = T(P v)
//   out = T(a wo^T + bo)
// which are the TPU kernel's rounding points (bv added after the cast, bo
// in f32). The window is local3d_window.cuh's: |ds| <= es inside the clip,
// |dh| <= eh and |dw| <= ew inside the frame.
//
// What bounds it on the H100. At serve/m3_g8 in bf16 (B=8, S=6, 8x8, dim
// 384, one head of 128, extents (3,1,1)) one launch must move x, q_in and
// out (3 x 3,072 x 384 x 2 B) and the weights (0.39 MB): ~7.5 MB, ~2.2 us
// at 3.35 TB/s; its products are ~1.27 GFLOP, ~1.3 us at the 989 TFLOP/s
// bf16 tensor-core peak. So it is bytes-bound, and at B=64 about 8 times
// both (the chip_smoke kernel line computes the bound from each run's
// shapes).
//
// Design. One cooperative launch (cudaLaunchCooperativeKernel) of as
// many blocks as can be resident at once, in three phases joined by
// grid-wide barriers (cooperative_groups::this_grid().sync()); blocks walk
// each phase's work with grid-stride loops. The attention is a phase of
// its own, not the prologue of the output tiles, so that every resident
// block takes part in it. Weights are read in place in their (out, in)
// layout, which is already the K-major operand of x w^T: no transposed
// copies. No atomics: every output element is written by one thread after
// a fixed sum, so two launches are bitwise equal. Phase 1 writes [q | k |
// v] to a scratch buffer (R, 3 * inner) and phase 2 the attention output
// to another (R, inner), which the wrapper allocates; at the serving and
// training shapes they are 3.1 and 25 MB, inside the 50 MB L2.
//
// bf16 at dh = 64 and 128, with dim, dim_q and out_dim multiples of 8 and
// dim, dim_q and inner at most 1,024 (local3d_block_mma_kernel): the
// tensor cores.
//  1. Projections: tiles of 64 rows (32 with two warps) by 64 columns of
//     [q | k | v], each section apart, on mma.sync m16n8k16 with
//     flash_mma.cuh's tools (cp.async, ldmatrix), summed in f32; a warp
//     owns 16 rows and 64 (or, with eight warps, 32) columns. A block
//     keeps its column's weight slice resident in shared memory (the grid
//     walks a row's column tiles side by side, so their rows of x share
//     the L2) and streams its rows of x through a ring of two 64-deep
//     chunks; chunks are zero past the depth, so a width such as 200
//     needs no other care. Each 16-deep step's products are summed apart
//     and added in f32, so that q, k and v round to bf16 as an f32 sum
//     does. Rounded to bf16 (v: + bv after the rounding) and written to
//     the scratch buffer through the ring's idle chunk, in 16-byte stores.
//  2. Attention: the bf16 forward's block on the tensor cores
//     (local3d_mma.cuh:fwd_block, which local3d_fwd.cu runs too), over
//     the scratch buffer's q, k and v at their row stride 3 * inner, with
//     P normalised before it is rounded (the TPU block, :196; the
//     forward's route 2). The block has that kernel's shape for the same
//     attention: 4 query warps, or 2 where a 64-position key band would
//     not fit one tile, and two groups of them where the work items fit
//     the SMs at once.
//  3. Output projection: a wo^T + bo as in phase 1, bo added in f32.
// What bounds it on the card (PERF.md): the
// projections run at ~130 TFLOP/s, each warp a chain of ldmatrix, mma
// and f32 adds with few warps beside it (the attention phase's three
// blocks of four warps an SM, 168 registers each); a wider or deeper
// ring, prefetch across tiles and 128-column tiles did not move them. The
// attention phase is bound by the chain of staged tiles per work item
// (local3d_fwd.cu), and at serving by its 48 work items, which leave most
// SMs idle at the second grid barrier.
//
// f32, other head sizes and widths (local3d_block_kernel): the CUDA
// cores, in blocks of 256 threads.
//  1. Projections: 64 x 64 tiles of [q | k | v], each a product whose
//     depth is staged through shared memory in 64-wide f32 chunks and
//     multiplied with flash_tile.cuh's 16 x 16 thread layout
//     (tile_dots_acc).
//  2. Attention: one warp per (row, head), with local3d_window.cuh's
//     window and warp layout (four groups of eight lanes, each group on its
//     own key). A first sweep over the window gives the softmax's max and
//     normaliser; a second recomputes each score, rounds P = exp(s - m) / l
//     to T, as the TPU kernel does before its product with V, and
//     accumulates P v in f32.
//  3. Output projection: 64 x 64 tiles of a wo^T + bo as in phase 1.
// Shared memory is two 64 x 65 f32 tiles (33,280 B, static).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_mma.cuh"
#include "flash_tile.cuh"
#include "launch_log.cuh"
#include "local3d_mma.cuh"
#include "local3d_window.cuh"
#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

using wmz::group_sum;
using wmz::kGroupLanes;
using wmz::kGroups;
using wmz::load4;
using wmz::store4;
using wmz::Window;
using wmz::window_of;
using wmz::window_pos;
using wmz::flash::from_float;
using wmz::flash::kCols;
using wmz::flash::kRows;
using wmz::flash::kThreads;
using wmz::flash::kTile;
using wmz::flash::kTx;
using wmz::flash::to_float;

constexpr int kChunk = 64;           // depth of one staged product chunk
constexpr int kLd = kChunk + 1;      // padded f32 row of a staged tile
constexpr int kWarps = kThreads / 32;

struct Args {
  const void *x, *q_in, *wk, *wv, *bv, *wq, *wo, *bo;
  void *out, *qkv, *attn;
  int B, S, H, W, heads, dh, dim, dim_q, out_dim, es, eh, ew;
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// rows [row0, row0 + 64) x columns [k0, k0 + 64) of the row-major (rows,
// cols) matrix `src` -> the f32 tile `dst` (64 x kLd), zero outside the
// matrix; cols % 4 == 0
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src,
                                           int rows, int cols, int row0,
                                           int k0) {
  constexpr int kVec = kChunk / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows && k0 + c < cols)
      v = load4(src + (long long)(row0 + r) * cols + k0 + c);
    float* p = dst + r * kLd + c;
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

// acc = rows [row0, row0 + 64) of a (rows, depth) times rows [col0, col0 +
// 64) of w (wrows, depth), transposed: thread (ty, tx) holds rows ty*4 + i
// and columns tx + 16 j of the 64 x 64 tile
template <typename T>
__device__ __forceinline__ void tile_product(const T* a, const T* w, int rows,
                                             int wrows, int depth, int row0,
                                             int col0, float* sa, float* sw,
                                             float acc[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < depth; k0 += kChunk) {
    __syncthreads();  // the previous chunk's (or tile's) readers are done
    load_chunk(sa, a, rows, depth, row0, k0);
    load_chunk(sw, w, wrows, depth, col0, k0);
    __syncthreads();
    wmz::flash::tile_dots_acc<kChunk>(sa, sw, acc);
  }
}

// E: elements of the head dimension per lane, dh = kGroupLanes * E
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
local3d_block_kernel(const Args a) {
  constexpr int dh = kGroupLanes * E;
  __shared__ float smem[2 * kTile * kLd];
  float* sa = smem;
  float* sw = smem + kTile * kLd;
  cg::grid_group grid = cg::this_grid();

  const T* x = static_cast<const T*>(a.x);
  const T* q_in = static_cast<const T*>(a.q_in);
  const T* bv = static_cast<const T*>(a.bv);
  const T* bo = static_cast<const T*>(a.bo);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* out = static_cast<T*>(a.out);
  const int rows = a.B * a.S * a.H * a.W;
  const int inner = a.heads * dh;
  const int ld3 = 3 * inner;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int row_tiles = (rows + kTile - 1) / kTile;

  // phase 1: [q | k | v], column tiles of each section apart
  const int sec_tiles = (inner + kTile - 1) / kTile;
  for (int t = blockIdx.x; t < row_tiles * 3 * sec_tiles; t += gridDim.x) {
    const int row0 = t / (3 * sec_tiles) * kTile;
    const int sec = t % (3 * sec_tiles) / sec_tiles;  // 0 q, 1 k, 2 v
    const int col0 = t % sec_tiles * kTile;
    const T* src = sec == 0 ? q_in : x;
    const T* w =
        static_cast<const T*>(sec == 0 ? a.wq : sec == 1 ? a.wk : a.wv);
    float acc[kRows][kCols];
    tile_product(src, w, rows, inner, sec == 0 ? a.dim_q : a.dim, row0, col0,
                 sa, sw, acc);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = row0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = col0 + tx + kTx * j;
        if (r < rows && c < inner) {
          float y = round_to<T>(acc[i][j]);
          if (sec == 2) y += to_float(bv[c]);
          qkv[(long long)r * ld3 + sec * inner + c] = from_float<T>(y);
        }
      }
    }
  }
  grid.sync();

  // phase 2: one warp per (row, head); q at column 0, k at inner, v at
  // 2 * inner of the row's qkv slice
  {
    const int lane = threadIdx.x & 31;
    const int group = lane / kGroupLanes;
    const int t = lane % kGroupLanes;
    const float scale = 1.0f / sqrtf((float)dh);
    const long long queries = (long long)rows * a.heads;
    for (long long query = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
         query < queries; query += (long long)gridDim.x * kWarps) {
      const Window c =
          window_of(query, a.S, a.H, a.W, a.heads, a.es, a.eh, a.ew);
      const long long head_off = (long long)c.head * dh + t * E;
      float qr[E];
      {
        const T* qp = qkv + wmz::centre_pos(c, a.S, a.H, a.W) * ld3 + head_off;
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 v = load4(qp + e);
          qr[e] = v.x;
          qr[e + 1] = v.y;
          qr[e + 2] = v.z;
          qr[e + 3] = v.w;
        }
      }
      // the scaled score of window key i (valid or not: all lanes shuffle)
      auto score = [&](int i) -> float {
        const T* kp =
            qkv + window_pos(c, i, a.S, a.H, a.W) * ld3 + inner + head_off;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 v = load4(kp + e);
          part = fmaf(qr[e], v.x, part);
          part = fmaf(qr[e + 1], v.y, part);
          part = fmaf(qr[e + 2], v.z, part);
          part = fmaf(qr[e + 3], v.w, part);
        }
        return group_sum(part) * scale;
      };

      // sweep 1: max and normaliser, per group, then merged
      float m = -INFINITY, l = 0.f;
      for (int i0 = 0; i0 < c.n; i0 += kGroups) {
        const int i = i0 + group;
        const bool valid = i < c.n;
        const float s = score(valid ? i : 0);
        if (valid) {
          const float m_new = fmaxf(m, s);
          l = l * expf(m - m_new) + expf(s - m_new);  // expf(-inf) = 0
          m = m_new;
        }
      }
#pragma unroll
      for (int off = kGroupLanes; off < 32; off <<= 1) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
        const float m_new = fmaxf(m, m_o);
        const float ca = m == -INFINITY ? 0.f : expf(m - m_new);
        const float cb = m_o == -INFINITY ? 0.f : expf(m_o - m_new);
        l = l * ca + l_o * cb;
        m = m_new;
      }

      // sweep 2: P rounded to T, times V, summed in f32
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
      for (int i0 = 0; i0 < c.n; i0 += kGroups) {
        const int i = i0 + group;
        const bool valid = i < c.n;
        const float s = score(valid ? i : 0);
        if (valid) {
          const float p = round_to<T>(expf(s - m) / l);
          const T* vp = qkv + window_pos(c, i, a.S, a.H, a.W) * ld3 +
                        2 * inner + head_off;
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 v = load4(vp + e);
            acc[e] = fmaf(p, v.x, acc[e]);
            acc[e + 1] = fmaf(p, v.y, acc[e + 1]);
            acc[e + 2] = fmaf(p, v.z, acc[e + 2]);
            acc[e + 3] = fmaf(p, v.w, acc[e + 3]);
          }
        }
      }
#pragma unroll
      for (int off = kGroupLanes; off < 32; off <<= 1)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
      if (group == 0) {
        T* op = attn + wmz::centre_pos(c, a.S, a.H, a.W) * inner + head_off;
#pragma unroll
        for (int e = 0; e < E; e += 4)
          store4(op + e,
                 make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]));
      }
    }
  }
  grid.sync();

  // phase 3: out = attn wo^T + bo, bo added in f32, rounded once
  const T* wo = static_cast<const T*>(a.wo);
  const int out_tiles = (a.out_dim + kTile - 1) / kTile;
  for (int t = blockIdx.x; t < row_tiles * out_tiles; t += gridDim.x) {
    const int row0 = t / out_tiles * kTile;
    const int col0 = t % out_tiles * kTile;
    float acc[kRows][kCols];
    tile_product(static_cast<const T*>(attn), wo, rows, a.out_dim, inner, row0,
                 col0, sa, sw, acc);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = row0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = col0 + tx + kTx * j;
        if (r < rows && c < a.out_dim)
          out[(long long)r * a.out_dim + c] =
              from_float<T>(acc[i][j] + to_float(bo[c]));
      }
    }
  }
}

// ---------------------------------------------------------------- bf16
// The tensor-core route.

namespace mma = wmz::mma;
using mma::bf16;

constexpr int kDepthChunk = 64;               // depth of a staged chunk
constexpr int kCL = kDepthChunk + mma::kPad;  // padded bf16 row of a chunk
constexpr int kProjCols = 64;                 // output columns of a tile
constexpr int kProjStages = 2;                // A chunks in the ring, >= 2

// The projection tiles of a block of NW warps: kRowsT rows by kProjCols
// columns, warp (wr, wc) owning rows 16 wr .. 16 wr + 15 and columns
// kColsW wc .. kColsW (wc + 1) - 1
template <int NW>
struct ProjTile {
  static constexpr int kWC = NW >= 8 ? 2 : 1;
  static constexpr int kRowsT = 16 * NW / kWC;
  static constexpr int kColsW = kProjCols / kWC;
  static constexpr int kStage = kRowsT * kCL;  // bf16 of an A chunk
};

// the row stride (bf16) of a resident weight slice of `depth`: whole
// chunks plus the pad, so that ldmatrix rows fall in distinct banks
__host__ __device__ inline int slice_ld(int depth) {
  return (depth + kDepthChunk - 1) / kDepthChunk * kDepthChunk + mma::kPad;
}

// shared memory of the projection phases: a weight slice of kProjCols rows
// of up to `depth` values, and the ring of A chunks
template <int NW>
size_t proj_smem_bytes(int depth) {
  return ((size_t)kProjCols * slice_ld(depth) + (size_t)kProjStages * ProjTile<NW>::kStage) *
         sizeof(bf16);
}

// rows [row0, row0 + Rows) x depth [k0, k0 + 64) of the row-major bf16
// (rows, depth) matrix `src` -> `dst` (row stride ld), asynchronously;
// zero outside the matrix (depth % 8 == 0, 16-byte aligned rows)
template <int Rows>
__device__ __forceinline__ void load_chunk_async(bf16* dst, int ld, const bf16* __restrict__ src,
                                                 int rows, int depth, int row0, int k0) {
  constexpr int kChunks = kDepthChunk / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < Rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool valid = row0 + r < rows && k0 + c < depth;
    mma::cp_async16(dst + r * ld + c,
                    src + (valid ? (long long)(row0 + r) * depth + k0 + c : 0), valid);
  }
}

// rows [col0, col0 + kProjCols) of the weight w (wrows, depth), all of its
// depth -> the resident slice `ws` (row stride slice_ld(depth)), as one
// cp.async group; the caller syncs the block first
__device__ __forceinline__ void load_slice_async(bf16* ws, const bf16* __restrict__ w,
                                                 int wrows, int depth, int col0) {
  const int ld = slice_ld(depth);
  for (int k0 = 0; k0 < depth; k0 += kDepthChunk)
    load_chunk_async<kProjCols>(ws + k0, ld, w, wrows, depth, col0, k0);
  mma::cp_async_commit();
}

// acc = this warp's part of rows [row0, row0 + kRowsT) of a (rows, depth)
// times the resident weight slice `ws` (kProjCols rows of depth values,
// loaded by load_slice_async), transposed: acc[j] holds the m16n8 tile of
// the slice's rows kColsW wc + 8 j .. + 7. A is staged in 64-deep chunks
// through the ring `ring`. Every thread of the block takes part.
template <int NW>
__device__ __forceinline__ void proj_tile(const bf16* __restrict__ a, int rows, int depth,
                                          int row0, const bf16* ws, bf16* ring,
                                          float acc[ProjTile<NW>::kColsW / 8][4]) {
  using P = ProjTile<NW>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / P::kWC, wc = warp % P::kWC;
  const int chunks = (depth + kDepthChunk - 1) / kDepthChunk;
  auto issue = [&](int c) {
    load_chunk_async<P::kRowsT>(ring + c % kProjStages * P::kStage, kCL, a, rows, depth, row0,
                                c * kDepthChunk);
  };
  mma::zero<P::kColsW / 8>(acc);
  __syncthreads();  // the ring's previous readers are done
  for (int c = 0; c < kProjStages - 1; ++c) {
    if (c < chunks) issue(c);
    mma::cp_async_commit();
  }
  // ldmatrix rows (flash_mma.cuh:warp_dots): A's four matrices are
  // (rows 0-7 | 8-15) x (depth 0-7 | 8-15), B's two n8 tiles x the halves
  const int a_off = (16 * wr + (lane & 15)) * kCL + (lane >> 4) * 8;
  const bf16* b_row = ws + (P::kColsW * wc + (lane & 7) + (lane >> 4) * 8) * slice_ld(depth) +
                      ((lane >> 3) & 1) * 8;
  for (int c = 0; c < chunks; ++c) {
    mma::cp_async_wait<kProjStages - 2>();  // chunk c (and the slice) landed
    __syncthreads();  // for every thread, and chunk c - 1 is read
    if (c + kProjStages - 1 < chunks) issue(c + kProjStages - 1);
    mma::cp_async_commit();
    const bf16* st = ring + c % kProjStages * P::kStage;
    // each 16-deep step's products summed apart, then added in f32: the
    // tensor cores' sum of a running total and 16 products rounds less
    // well than an f32 add, and q, k and v are rounded to bf16 next
#pragma unroll
    for (int kc = 0; kc < kDepthChunk / 16; ++kc) {
      uint32_t a_frag[4];
      mma::ldmatrix_x4(a_frag, st + a_off + kc * 16);
      float part[P::kColsW / 8][4];
      mma::zero<P::kColsW / 8>(part);
#pragma unroll
      for (int j = 0; j < P::kColsW / 16; ++j) {
        uint32_t b[4];
        mma::ldmatrix_x4(b, b_row + j * 16 * slice_ld(depth) + c * kDepthChunk + kc * 16);
        mma::mma_16816(part[2 * j], a_frag, b[0], b[1]);
        mma::mma_16816(part[2 * j + 1], a_frag, b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < P::kColsW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
  }
}

// The staging chunk of a tile's epilogue: the ring's stage that its last
// chunk does not use (its readers passed the last chunk's barrier)
template <int NW>
__device__ __forceinline__ bf16* staging(bf16* ring, int depth) {
  return ring + (depth + kDepthChunk - 1) / kDepthChunk % kProjStages * ProjTile<NW>::kStage;
}

// Two outputs of this lane (row gr + 8 i, columns 8 j + 2t, + 1 of its
// warp's part), rounded to bf16, into the staging chunk `st`
template <int NW>
__device__ __forceinline__ void stage_pair(bf16* st, int i, int j, float y0, float y1) {
  using P = ProjTile<NW>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * (warp / P::kWC) + (lane >> 2) + 8 * i;
  const int col = P::kColsW * (warp % P::kWC) + 8 * j + 2 * (lane & 3);
  *reinterpret_cast<uint32_t*>(st + row * kCL + col) = mma::pack_bf16(y0, y1);
}

// This warp's 16 x kColsW part of a tile, staged by stage_pair, -> rows
// row0 + 16 wr + r and columns col0 + kColsW wc + ... of dst (row stride
// ld) in 16-byte stores; rows at or past `rows` and columns at or past
// `cols` (a multiple of 8) are not written
template <int NW>
__device__ __forceinline__ void store_staged(const bf16* st, bf16* dst, long long ld, int rows,
                                             int cols, int row0, int col0) {
  using P = ProjTile<NW>;
  constexpr int kPerRow = P::kColsW / 8;  // 16-byte chunks of a warp's row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp / P::kWC), c0 = P::kColsW * (warp % P::kWC);
  __syncwarp();
#pragma unroll
  for (int q = lane; q < 16 * kPerRow; q += 32) {
    const int r = q / kPerRow, c = q % kPerRow * 8;
    if (row0 + r0 + r < rows && col0 + c0 + c < cols)
      *reinterpret_cast<uint4*>(dst + (row0 + r0 + r) * ld + col0 + c0 + c) =
          *reinterpret_cast<const uint4*>(st + (r0 + r) * kCL + c0 + c);
  }
}

// Args.dh = D; kWarps query warps in kGroups groups (fwd_block)
template <int D, int kWarps, int kGroups>
__global__ void __launch_bounds__(32 * kWarps * kGroups, kGroups == 1 ? 3 : 1)
local3d_block_mma_kernel(const Args a) {
  constexpr int NW = kWarps * kGroups;
  using P = ProjTile<NW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  cg::grid_group grid = cg::this_grid();

  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* bv = static_cast<const bf16*>(a.bv);
  const bf16* bo = static_cast<const bf16*>(a.bo);
  bf16* qkv = static_cast<bf16*>(a.qkv);
  bf16* attn = static_cast<bf16*>(a.attn);
  bf16* out = static_cast<bf16*>(a.out);
  const int rows = a.B * a.S * a.H * a.W;
  const int inner = a.heads * D;
  const int ld3 = 3 * inner;
  // this lane's first column of its warp's part of a tile
  const int col_w = P::kColsW * (threadIdx.x / 32 % P::kWC) + 2 * (threadIdx.x & 3);
  const int row_tiles = (rows + P::kRowsT - 1) / P::kRowsT;
  // the projections' weight slice, then their ring of A chunks
  bf16* ws = smem;
  bf16* ring = smem + kProjCols * slice_ld(max(max(a.dim, a.dim_q), inner));

  // phase 1: [q | k | v], column tiles of each section apart; a block
  // keeps its weight slice while its tiles' column stays (the grid walks
  // a row's column tiles side by side, so their A rows share the L2)
  const int sec_tiles = (inner + kProjCols - 1) / kProjCols;
  int resident = -1;
  for (int tile = blockIdx.x; tile < row_tiles * 3 * sec_tiles; tile += gridDim.x) {
    const int row0 = tile / (3 * sec_tiles) * P::kRowsT;
    const int slice = tile % (3 * sec_tiles);
    const int sec = slice / sec_tiles;  // 0 q, 1 k, 2 v
    const int col0 = slice % sec_tiles * kProjCols;
    const bf16* src = sec == 0 ? static_cast<const bf16*>(a.q_in) : x;
    const int depth = sec == 0 ? a.dim_q : a.dim;
    if (slice != resident) {
      __syncthreads();  // the previous slice's readers are done
      load_slice_async(ws, static_cast<const bf16*>(sec == 0 ? a.wq : sec == 1 ? a.wk : a.wv),
                       inner, depth, col0);
      resident = slice;
    }
    float acc[P::kColsW / 8][4];
    proj_tile<NW>(src, rows, depth, row0, ws, ring, acc);
    bf16* st = staging<NW>(ring, depth);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < P::kColsW / 8; ++j) {
        const int c = min(col0 + col_w + 8 * j, inner - 2);
        float y0 = acc[j][2 * i], y1 = acc[j][2 * i + 1];
        if (sec == 2) {  // v = T(T(x wv^T) + bv)
          y0 = round_to<bf16>(y0) + __bfloat162float(bv[c]);
          y1 = round_to<bf16>(y1) + __bfloat162float(bv[c + 1]);
        }
        stage_pair<NW>(st, i, j, y0, y1);
      }
    store_staged<NW>(st, qkv + sec * inner, ld3, rows, inner, row0, col0);
  }
  grid.sync();

  // phase 2: the bf16 forward's blocks over the scratch buffer's q, k, v
  {
    const int pblocks = (a.H * a.W + 16 * kWarps - 1) / (16 * kWarps);
    const int items = pblocks * a.S * a.B * a.heads;
    const float scale = 1.0f / sqrtf((float)D);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int pb = item % pblocks, fs = item / pblocks % a.S, bh = item / pblocks / a.S;
      wmz::l3d::fwd_block<D, kWarps, kGroups, false>(
          qkv, qkv + inner, qkv + 2 * inner, ld3, attn, inner, a.S, a.H, a.W, a.heads, a.es,
          a.eh, a.ew, scale, pb, fs, bh / a.heads, bh % a.heads, smem_raw);
      __syncthreads();  // group 0 may still read the shared P V sums
    }
  }
  grid.sync();

  // phase 3: out = attn wo^T + bo, bo added in f32, rounded once
  const int out_tiles = (a.out_dim + kProjCols - 1) / kProjCols;
  resident = -1;
  for (int tile = blockIdx.x; tile < row_tiles * out_tiles; tile += gridDim.x) {
    const int row0 = tile / out_tiles * P::kRowsT;
    const int col0 = tile % out_tiles * kProjCols;
    if (tile % out_tiles != resident) {
      __syncthreads();
      load_slice_async(ws, static_cast<const bf16*>(a.wo), a.out_dim, inner, col0);
      resident = tile % out_tiles;
    }
    float acc[P::kColsW / 8][4];
    proj_tile<NW>(attn, rows, inner, row0, ws, ring, acc);
    bf16* st = staging<NW>(ring, inner);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < P::kColsW / 8; ++j) {
        // columns past out_dim are staged (from its last bias) and not stored
        const int c = min(col0 + col_w + 8 * j, a.out_dim - 2);
        stage_pair<NW>(st, i, j, acc[j][2 * i] + __bfloat162float(bo[c]),
                       acc[j][2 * i + 1] + __bfloat162float(bo[c + 1]));
      }
    store_staged<NW>(st, out, a.out_dim, rows, a.out_dim, row0, col0);
  }
}

// ---------------------------------------------------------------- launch

// A cooperative launch: the kernel, its grid (no more blocks than fit at
// once, nor than the largest phase has work for), block and shared memory
struct Plan {
  const void* kernel;
  unsigned grid, threads;
  size_t smem;
};

// blocks of `kernel` that fit on the device at once with `smem` bytes of
// dynamic shared memory (0 on error), found once per instantiation, device
// and size: `cached` is the instantiation's own
struct Resident {
  size_t smem;
  int blocks;
};
int resident_blocks(const void* kernel, int threads, size_t smem, Resident cached[64]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev].blocks > 0 && cached[dev].smem == smem) return cached[dev].blocks;
  int sms = 0, per_sm = 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  const int n = sms * per_sm;
  if (dev < 64) cached[dev] = Resident{smem, n};
  return n;
}

template <typename T, int E>
cudaError_t plan_cores(const Args& a, Plan* p) {
  static Resident cached[64] = {};
  const void* kernel = (const void*)local3d_block_kernel<T, E>;
  const int resident = resident_blocks(kernel, kThreads, 0, cached);
  if (resident <= 0) return cudaErrorCooperativeLaunchTooLarge;
  const long long rows = (long long)a.B * a.S * a.H * a.W;
  const long long row_tiles = (rows + kTile - 1) / kTile;
  const long long inner = (long long)a.heads * a.dh;
  const long long work = std::max(
      std::max(row_tiles * 3 * ((inner + kTile - 1) / kTile),
               row_tiles * ((a.out_dim + kTile - 1) / kTile)),
      (rows * a.heads + kWarps - 1) / kWarps);
  *p = Plan{kernel, (unsigned)std::min((long long)resident, work), kThreads, 0};
  return cudaSuccess;
}

template <int D, int kWarpsQ, int kGroups>
cudaError_t plan_mma(const Args& a, Plan* p) {
  static Resident cached[64] = {};
  using P = ProjTile<kWarpsQ * kGroups>;
  const size_t smem =
      std::max(wmz::l3d::fwd_smem_bytes<D, kWarpsQ, kGroups>(),
               proj_smem_bytes<kWarpsQ * kGroups>(std::max(std::max(a.dim, a.dim_q), a.heads * D)));
  const int threads = 32 * kWarpsQ * kGroups;
  const void* kernel = (const void*)local3d_block_mma_kernel<D, kWarpsQ, kGroups>;
  const int resident = resident_blocks(kernel, threads, smem, cached);
  if (resident <= 0) return cudaErrorCooperativeLaunchTooLarge;
  const long long rows = (long long)a.B * a.S * a.H * a.W;
  const long long row_tiles = (rows + P::kRowsT - 1) / P::kRowsT;
  const long long items = (long long)(a.H * a.W + 16 * kWarpsQ - 1) / (16 * kWarpsQ) * a.S *
                          a.B * a.heads;
  const long long work =
      std::max(std::max(row_tiles * 3 * ((a.heads * D + kProjCols - 1) / kProjCols),
                        row_tiles * ((a.out_dim + kProjCols - 1) / kProjCols)),
               items);
  *p = Plan{kernel, (unsigned)std::min((long long)resident, work), (unsigned)threads, smem};
  return cudaSuccess;
}

// whether the tensor-core route takes the block: bf16 at dh 64 or 128,
// widths in whole 16-byte copies and every product's depth (dim, dim_q,
// and inner for the output projection) no deeper than kMaxWidth, so that
// a weight slice of 64 rows fits the shared memory beside the ring
constexpr int kMaxWidth = 1024;
bool tensor_cores(const Args& a, int dtype) {
  return dtype == 1 && (a.dh == 64 || a.dh == 128) && a.dim % 8 == 0 && a.dim_q % 8 == 0 &&
         a.out_dim % 8 == 0 && a.dim <= kMaxWidth && a.dim_q <= kMaxWidth &&
         a.heads * a.dh <= kMaxWidth;
}

template <int D>
cudaError_t plan_mma_shape(const Args& a, Plan* p) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const wmz::l3d::FwdShape shape = wmz::l3d::fwd_shape(a.B, a.S, a.H, a.W, a.heads, a.eh, sms);
  if (shape.warps == 4) return shape.groups == 2 ? plan_mma<D, 4, 2>(a, p) : plan_mma<D, 4, 1>(a, p);
  return shape.groups == 2 ? plan_mma<D, 2, 2>(a, p) : plan_mma<D, 2, 1>(a, p);
}

cudaError_t plan(const Args& a, int dtype, Plan* p) {
  if (tensor_cores(a, dtype)) return a.dh == 64 ? plan_mma_shape<64>(a, p) : plan_mma_shape<128>(a, p);
#define WMZ_BLOCK_CASE(EE)                                                     \
  case EE:                                                                     \
    return dtype == 0 ? plan_cores<float, EE>(a, p) : plan_cores<__nv_bfloat16, EE>(a, p);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  WMZ_L3D_E_SWITCH(a.dh, WMZ_BLOCK_CASE)
#undef WMZ_BLOCK_CASE
}

}  // namespace

// x, q_in, the six weights and biases, out, and the two scratch buffers
// qkv (R, 3 * inner) and attn (R, inner) of the operand type; dtype: 0 =
// float32, 1 = bfloat16. bfloat16 at dh 64 and 128 with dim, dim_q and
// out_dim multiples of 8 and dim, dim_q, heads * dh at most kMaxWidth
// takes the tensor-core kernel, the rest the CUDA-core one. Returns the launch's
// cudaError_t.
extern "C" int wmz_local3d_block(const void* x, const void* q_in,
                                 const void* wk, const void* wv,
                                 const void* bv, const void* wq,
                                 const void* wo, const void* bo, void* out,
                                 void* qkv, void* attn, int B, int S, int H,
                                 int W, int heads, int dh, int dim, int dim_q,
                                 int out_dim, int es, int eh, int ew,
                                 int dtype, void* stream) {
  if (wmz::bad_dh(dh) || dim % 4 || dim_q % 4 || out_dim % 4)
    return (int)cudaErrorInvalidValue;
  Args a{x, q_in, wk, wv, bv, wq, wo, bo, out, qkv, attn, B, S, H, W, heads, dh, dim, dim_q,
         out_dim, es, eh, ew};
  Plan p;
  cudaError_t err = plan(a, dtype, &p);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  wmz::note_launch(p.kernel);
  err = cudaLaunchCooperativeKernel(p.kernel, dim3(p.grid), dim3(p.threads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cooperative grid wmz_local3d_block launches for the shape: blocks
// (negative for a shape the kernel does not take), and their threads in
// *threads.
extern "C" int wmz_local3d_block_grid(int B, int S, int H, int W, int heads, int dh, int dim,
                                      int dim_q, int out_dim, int es, int eh, int ew, int dtype,
                                      int* threads) {
  if (wmz::bad_dh(dh) || dim % 4 || dim_q % 4 || out_dim % 4) return -1;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, B, S, H, W, heads, dh, dim, dim_q, out_dim, es, eh, ew};
  Plan p;
  if (plan(a, dtype, &p) != cudaSuccess) return -1;
  *threads = (int)p.threads;
  return (int)p.grid;
}

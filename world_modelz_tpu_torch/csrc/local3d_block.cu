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
// Design: simple and right first. One cooperative launch
// (cudaLaunchCooperativeKernel) of as many 256-thread blocks as can be
// resident at once, in three phases joined by grid-wide barriers
// (cooperative_groups::this_grid().sync()); blocks walk each phase's work
// with grid-stride loops.
//  1. Projections: 64 x 64 tiles of [q | k | v] (R, 3 * inner), each a
//     product whose depth is staged through shared memory in 64-wide f32
//     chunks and multiplied on the CUDA cores with flash_tile.cuh's 16 x 16
//     thread layout (tile_dots_acc). Rounded to T (v: + bv after the
//     rounding) into a scratch buffer the wrapper allocates; at the serving
//     and training shapes it is 2.4 and 18.9 MB, inside the 50 MB L2.
//  2. Attention: one warp per (row, head), with local3d_window.cuh's
//     window and warp layout (four groups of eight lanes, each group on its
//     own key). A first sweep over the window gives the softmax's max and
//     normaliser; a second recomputes each score, rounds P = exp(s - m) / l
//     to T, as the TPU kernel does before its product with V, and
//     accumulates P v in f32. The result, rounded to T, goes to a second
//     scratch buffer (R, inner).
//  3. Output projection: 64 x 64 tiles of a wo^T + bo as in phase 1.
// The attention is a phase of its own, not the prologue of the output
// tiles, so that every resident warp takes part in it: at the serving
// shape there are only 48 row tiles of 64 but 3,072 (row, head) pairs.
// Weights are read in place in their (out, in) layout: no transposed
// copies. Shared memory is two 64 x 65 f32 tiles (33,280 B, static). No
// atomics: every output element is written by one thread after a fixed
// sum, so two launches are bitwise equal. Tensor-core products
// (mma.sync/wgmma), TMA staging and keeping q/k/v in shared memory are
// later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_tile.cuh"
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

// blocks of the kernel that fit on the device at once (0 on error), found
// once per instantiation and device
template <typename T, int E>
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, local3d_block_kernel<T, E>, kThreads, 0) != cudaSuccess)
    return 0;
  const int n = sms * per_sm;
  if (dev < 64) cached[dev] = n;
  return n;
}

template <typename T, int E>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int resident = resident_blocks<T, E>();
  if (resident <= 0) return cudaErrorCooperativeLaunchTooLarge;
  // no more blocks than the largest phase has work for
  const long long rows = (long long)a.B * a.S * a.H * a.W;
  const long long row_tiles = (rows + kTile - 1) / kTile;
  const long long inner = (long long)a.heads * a.dh;
  const long long work = std::max(
      std::max(row_tiles * 3 * ((inner + kTile - 1) / kTile),
          row_tiles * ((a.out_dim + kTile - 1) / kTile)),
      (rows * a.heads + kWarps - 1) / kWarps);
  const unsigned grid = (unsigned)std::min((long long)resident, work);
  void* args[] = {const_cast<Args*>(&a)};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)local3d_block_kernel<T, E>, dim3(grid), dim3(kThreads),
      args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Args& a, cudaStream_t stream) {
#define WMZ_BLOCK_CASE(EE) \
  case EE:                 \
    return launch<T, EE>(a, stream);
  WMZ_L3D_E_SWITCH(a.dh, WMZ_BLOCK_CASE)
#undef WMZ_BLOCK_CASE
}

template <typename T>
cudaError_t resident_dtype(int dh, int* n) {
#define WMZ_BLOCK_CASE(EE)             \
  case EE:                             \
    *n = resident_blocks<T, EE>();     \
    return cudaSuccess;
  WMZ_L3D_E_SWITCH(dh, WMZ_BLOCK_CASE)
#undef WMZ_BLOCK_CASE
}

}  // namespace

// x, q_in, the six weights and biases, out, and the two scratch buffers
// qkv (R, 3 * inner) and attn (R, inner) of the operand type; dtype: 0 =
// float32, 1 = bfloat16. Returns the launch's cudaError_t.
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
  const Args a{x,  q_in, wk,  wv,    bv,    wq,  wo,    bo,
               out, qkv, attn, B,   S,     H,     W,   heads, dh,
               dim, dim_q, out_dim, es, eh, ew};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dtype<float>(a, st);
  } else if (dtype == 1) {
    err = launch_dtype<__nv_bfloat16>(a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The cooperative grid's cap on this device: the kernel's blocks that fit
// at once (negative for a dtype or head size the kernel does not take).
extern "C" int wmz_local3d_block_grid(int dh, int dtype) {
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  if (wmz::bad_dh(dh)) return -1;
  if (dtype == 0) err = resident_dtype<float>(dh, &n);
  if (dtype == 1) err = resident_dtype<__nv_bfloat16>(dh, &n);
  return err == cudaSuccess ? n : -1;
}

// VQ nearest-code search shared by the encode kernel (vq_encode.cu) and the
// training-statistics kernel (vq_train.cu), so that the codes used in
// training and the tokens seen at inference are the same for every row.
//
// What it computes. For each row x of (N, D), D <= 64: argmin_k (|e_k|^2 -
// 2 x.e_k) over the (K, D) f32 codebook; ties go to the lowest k, as
// jnp.argmin does, and a row whose distances are all NaN takes code 0.
// |x|^2 is constant per row and dropped, as the TPU kernels drop it.
//
// Arithmetic: split TF32 on Hopper's tensor cores (wgmma m64n64k8 .tf32,
// wgmma.cuh; the split of split_tf32.cuh). One TF32 product keeps ~10
// mantissa bits; its distance error (~3e-2 at unit-normal rows, D = 64,
// tests/test_torch_port_vq_split_tf32.py) would move rows whose two
// nearest codes differ by far more than the parity gate's 1e-3. So each f32
// product is three TF32 products, lo_x hi_e + hi_x lo_e + hi_x hi_e
// (lo_x lo_e, ~2^-22 relative, is dropped). The tensor cores add a product
// to the accumulator they are given less exactly than an f32 add, so each
// 8-deep step's three products go into zeroed registers
// and the step's sum is added to the dot product by one f32 add, in step
// order; two register sets take the steps in turn, so one step's products
// run while the last step's sum is added. A bf16 x is exact in TF32 (lo_x
// = 0): its lo_x product adds only zeros and is not taken, which leaves
// every distance bitwise the same.
//
// Sum order. A (row, code) distance is e_sq[k] - 2 s, where s adds the 8
// steps' sums in order and e_sq[k] is the prep kernel's |e_k|^2: the same
// instructions whatever N, the tile, the code split or the kernel that
// runs the search, so vq_train_stats's idx equals vq_encode's bitwise.
//
// Design.
// - Prep (one launch, one warp a code): the codebook split once into its
//   hi and lo planes, stored as each 64-code chunk's image in shared
//   memory (K-major 64 x 64 f32 tiles, 128-byte swizzle), and |e_k|^2 in
//   f32 from the unsplit codes (lane partial sums in d order, then a
//   shuffle tree). Codes past K (the last chunk's padding) get zero planes
//   and |e|^2 = +inf: their distance is +inf or NaN and never wins.
// - A CTA is two warpgroups, 128 rows: x is loaded (16-byte vectors when
//   the rows are 64 long and aligned), split once and stored as each
//   warpgroup's hi and lo tiles, A of the products. The chunks (32 KB each,
//   B) stream through two stages by 16-byte cp.async; each chunk read from
//   L2 feeds 128 rows. 171 KB of shared memory: one CTA an SM.
// - Epilogue in registers: a wgmma accumulator holds rows g and g + 8 of a
//   warp at codes 8 j + 2t and 8 j + 2t + 1 (lane 4 g + t); each lane keeps
//   its rows' first minimum over its codes, visited in increasing k with a
//   strict <; the quad's four candidates, then the code splits' in split
//   order, are merged by (distance, code), so a tie goes to the lower code.
// - Small N fills the card by splitting the codes: a tile's splits are the
//   CTAs of one cluster (blockIdx.y); each writes its candidates into the
//   shared memory of the cluster's first CTA, which merges them after a
//   cluster barrier in the same launch. The plan (make_plan) takes the
//   fewest waves x (chunks + 3) of a CTA, SMs / splits clusters a wave (one
//   CTA an SM, the count read from the device): at K = 512 on the H100's
//   132 SMs, N = 3,072 is 24 tiles x 4 splits of 2 chunks (96 CTAs), N =
//   6,144 48 x 2 of 4 (96), N = 24,576 192 x 2 of 4 (384, three waves) and
//   N = 65,536 512 x 1 of 8 (512, four waves).
//
// What bounds it on the H100: the three TF32 products, 3 x 2 N K D
// operations at 495 TFLOP/s (two for a bf16 x); the same search on the
// f32 CUDA cores would be bound by 2 N K D at 67 TFLOP/s.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include <cooperative_groups.h>

#include "flash_mma.cuh"
#include "launch_log.cuh"
#include "split_tf32.cuh"
#include "vec.cuh"
#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
namespace mma = wmz::mma;
namespace stf = wmz::split_tf32;
namespace wg = wmz::wg;

constexpr int kMaxD = 64;               // depth of the planes
constexpr int kSteps = kMaxD / 8;       // 8-deep steps of a product
constexpr int kGroups = 2;              // warpgroups of a search CTA
constexpr int kRows = 64 * kGroups;     // rows of a search CTA
constexpr int kThreads = 128 * kGroups;
constexpr int kChunk = 64;              // codes of a staged chunk
constexpr int kTileF = 64 * kMaxD;      // f32 of a swizzled 64-row tile (16 KB)
constexpr int kChunkF = 2 * kTileF;     // a chunk's hi tile, then its lo tile
constexpr int kMaxSplits = 8;           // a tile's splits form one cluster (portable size)
constexpr int kNoCode = 0x7fffffff;

// offset of (row r, depth d) in a K-major 64-row f32 tile with the 128-byte
// swizzle: two column blocks of 32 values (64 rows of 128 bytes each); the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8)
__host__ __device__ __forceinline__ int swz(int r, int d) {
  return (d >> 5) * 64 * 32 + r * 32 + ((((d & 31) >> 2) ^ (r & 7)) << 2) + (d & 3);
}

constexpr int kXStride = kMaxD + 1;     // f32 of a row of the staged x (no bank conflicts)

struct __align__(1024) SearchSmem {
  float e[2][kChunkF];         // two stages of a chunk's planes
  float xh[kGroups][kTileF];   // each warpgroup's rows: hi
  float xl[kGroups][kTileF];   // and lo (an f32 x)
  float x[kRows * kXStride];   // the rows in f32 (the training kernel's |x|^2)
  float cand_d[kMaxSplits][kRows];  // each split's minimum of each row (in the lead)
  int cand_k[kMaxSplits][kRows];
  float best_d[kRows];         // after merge_splits: each row's minimum
  int best_k[kRows];
};
// dynamic shared memory: SearchSmem and the slack to align it
constexpr size_t kSmemBytes = sizeof(SearchSmem) + 1024;

__device__ __forceinline__ SearchSmem& search_smem(unsigned char* raw) {
  const uint32_t base = mma::smem_addr(raw);
  return *reinterpret_cast<SearchSmem*>(raw + (((base + 1023) & ~1023u) - base));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The launch's shape: row tiles of kRows, codes in chunks of kChunk; a
// tile's codes in `splits` parts of `per_split` chunks, each part one CTA
// (blockIdx.y) of the tile's cluster (blockIdx.x); on `device`.
struct Plan {
  int tiles, chunks, per_split, splits, device;
};

inline int chunks_of(int K) { return (K + kChunk - 1) / kChunk; }

// A CTA costs about kCtaChunks chunks beyond its own (staging the rows, the
// first chunk's wait, the splits' merge); the plan takes the fewest waves x
// (chunks + kCtaChunks), SMs / splits clusters a wave (kSmemBytes leaves
// one search CTA an SM), ties to fewer splits. For the current device.
constexpr int kCtaChunks = 3;

inline cudaError_t make_plan(int N, int K, Plan& p) {
  int sms = 0;
  cudaError_t err = cudaGetDevice(&p.device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, p.device);
  if (err != cudaSuccess) return err;
  p.tiles = (N + kRows - 1) / kRows;
  p.chunks = chunks_of(K);
  long long best = -1;
  for (int per = p.chunks; per >= 1; --per) {
    const int splits = (p.chunks + per - 1) / per;
    if (splits > kMaxSplits) break;
    const int clusters = std::max(1, sms / splits);
    const long long cost = (long long)((p.tiles + clusters - 1) / clusters) * (per + kCtaChunks);
    if (best < 0 || cost < best) {
      best = cost;
      p.per_split = per;
      p.splits = splits;
    }
  }
  return cudaSuccess;
}

// The scratch of one search launch (and of the statistics, when `train`),
// carved from one device buffer; `bytes` is its size.
struct Scratch {
  float* planes;    // chunks x kChunkF: the codebook's hi and lo planes
  float* e_sq;      // chunks x kChunk: |e_k|^2, +inf past K
  float* err_row;   // N (train): max(min dist + |x|^2, 0)
  size_t bytes;
};

inline Scratch carve(char* base, int chunks, int N, bool train) {
  Scratch s{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = base ? base + off : nullptr;
    off += (bytes + 255) & ~size_t(255);
    return at;
  };
  s.planes = reinterpret_cast<float*>(take((size_t)chunks * kChunkF * sizeof(float)));
  s.e_sq = reinterpret_cast<float*>(take((size_t)chunks * kChunk * sizeof(float)));
  if (train) s.err_row = reinterpret_cast<float*>(take((size_t)N * sizeof(float)));
  s.bytes = off;
  return s;
}

// One warp per code of the padded codebook (K rounded up to kChunk): its
// hi and lo values in the swizzled tiles of its chunk and |e_k|^2.
__global__ void vq_prep_kernel(const float* __restrict__ codebook, float* __restrict__ planes,
                               float* __restrict__ e_sq, int K, int Kp, int D) {
  const int k = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= Kp) return;  // whole warps only
  float* hi = planes + (long long)(k / kChunk) * kChunkF;
  float* lo = hi + kTileF;
  const int r = k % kChunk;
  float sq = 0.f;
#pragma unroll
  for (int d = lane; d < kMaxD; d += 32) {
    const float e = k < K && d < D ? codebook[(long long)k * D + d] : 0.f;
    sq = fmaf(e, e, sq);
    uint32_t h, l;
    stf::split(e, h, l);
    hi[swz(r, d)] = __uint_as_float(h);
    lo[swz(r, d)] = __uint_as_float(l);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) e_sq[k] = k < K ? sq : INFINITY;
}

inline cudaError_t launch_prep(const float* codebook, const Scratch& s, const Plan& p, int K,
                               int D, cudaStream_t stream) {
  const int Kp = p.chunks * kChunk;
  wmz::note_launch(vq_prep_kernel);
  vq_prep_kernel<<<Kp / 8, 256, 0, stream>>>(codebook, s.planes, s.e_sq, K, Kp, D);
  return cudaGetLastError();
}

// (d, k) takes (od, ok) if it is smaller by distance, then by code
__device__ __forceinline__ void take_min(float& d, int& k, float od, int ok) {
  if (od < d || (od == d && ok < k)) {
    d = od;
    k = ok;
  }
}

// t (64 rows x 64 codes) = the 8-deep step kc of x e^T in split TF32 (small
// terms first: lo_x hi_e, hi_x lo_e, hi_x hi_e; lo_x hi_e only for an f32
// x), from the warpgroup's x tiles and a chunk's planes
template <bool kSplitX>
__device__ __forceinline__ void step_products(float t[8][4], const float* xh, const float* xl,
                                              const float* eh, const float* el, int kc) {
  using wg::bf16;  // desc_k counts in 2-byte units: an 8-deep f32 step is 16 of them
  auto desc = [&](const float* tile) {
    return wg::desc_k<64>(reinterpret_cast<const bf16*>(tile), kc);
  };
  wg::fence();
  if constexpr (kSplitX) {
    wg::mma_tf32_n64(t, desc(xl), desc(eh), 0);
    wg::mma_tf32_n64(t, desc(xh), desc(el), 1);
  } else {
    wg::mma_tf32_n64(t, desc(xh), desc(el), 0);
  }
  wg::mma_tf32_n64(t, desc(xh), desc(eh), 1);
  wg::commit();
  wg::fence_regs<8>(t);
}

// rows [row0, row0 + kRows) of x (zeros past N and D) -> v, every load
// issued before any is used: 4 values of a row a thread and step
constexpr int kQuads = kRows * (kMaxD / 4) / kThreads;

template <typename T>
__device__ __forceinline__ void load_rows(float v[kQuads][4], const T* __restrict__ x, int N,
                                          int D, long long row0, bool vec) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (kMaxD / 4), d0 = (i % (kMaxD / 4)) * 4;
    const long long row = row0 + r;
    if (vec) {  // D = kMaxD, aligned rows: one vector load
      const float4 f = row < N ? wmz::load4(x + row * kMaxD + d0) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[q][0] = f.x;
      v[q][1] = f.y;
      v[q][2] = f.z;
      v[q][3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[q][e] = row < N && d0 + e < D ? to_f32(x[row * D + d0 + e]) : 0.f;
    }
  }
}

// v (load_rows) -> the warpgroups' swizzled hi (and lo) tiles, split, and
// (kKeepX) the f32 rows
template <bool kSplitX, bool kKeepX>
__device__ __forceinline__ void stage_rows(const float v[kQuads][4], SearchSmem& sm) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (kMaxD / 4), d0 = (i % (kMaxD / 4)) * 4;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      stf::split(v[q][e], h[e], l[e]);
      if constexpr (kKeepX) sm.x[r * kXStride + d0 + e] = v[q][e];
    }
    const int at = swz(r & 63, d0);
    *reinterpret_cast<uint4*>(sm.xh[r >> 6] + at) = make_uint4(h[0], h[1], h[2], h[3]);
    if constexpr (kSplitX)
      *reinterpret_cast<uint4*>(sm.xl[r >> 6] + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// barrier.cluster in two halves: arrive (relaxed: no ordering, or
// release: this thread's writes, shared memory of other CTAs included, are
// visible to whoever waits) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The minimum of each row of the tile over all codes, in sm.best_d /
// sm.best_k (code 0 where no distance was below +inf), from each lane's
// candidates (bd, bk) for rows 16 w + g + 8 i over this CTA's codes. The
// tile's splits are one cluster: each CTA writes its quads' candidates
// into the shared memory of the cluster's first CTA (cand_d[split]) and
// arrives on the cluster barrier; the first waits and merges them in split
// order. Returns true in that CTA. Every thread of the cluster must call it,
// having arrived once on the cluster barrier when it started, so that
// every CTA of the cluster has started before any writes into another.
// With one split, the CTA's own minima are the result.
__device__ __forceinline__ bool merge_splits(float bd[2], int bk[2], SearchSmem& sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the quad's candidates
      const float od = __shfl_xor_sync(0xffffffffu, bd[i], off);
      const int ok = __shfl_xor_sync(0xffffffffu, bk[i], off);
      take_min(bd[i], bk[i], od, ok);
    }
  const int split = blockIdx.y, splits = gridDim.y;
  if (splits == 1) {
    if (t == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sm.best_d[16 * warp + g + 8 * i] = bd[i];
        sm.best_k[16 * warp + g + 8 * i] = bk[i] == kNoCode ? 0 : bk[i];
      }
    __syncthreads();
    return true;
  }
  SearchSmem* lead = cg::this_cluster().map_shared_rank(&sm, 0);
  cluster_wait();  // every CTA of the cluster has started
  if (t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lead->cand_d[split][16 * warp + g + 8 * i] = bd[i];
      lead->cand_k[split][16 * warp + g + 8 * i] = bk[i];
    }
  cluster_arrive();
  if (split != 0) return false;
  cluster_wait();
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float d = sm.cand_d[0][r];
    int k = sm.cand_k[0][r];
    for (int p = 1; p < splits; ++p) take_min(d, k, sm.cand_d[p][r], sm.cand_k[p][r]);
    sm.best_d[r] = d;
    sm.best_k[r] = k == kNoCode ? 0 : k;  // argmin of all-NaN distances
  }
  __syncthreads();
  return true;
}

// The search of row tile blockIdx.x over chunks [per_split y, per_split
// (y + 1)) of the codes, y = blockIdx.y: the chunks stream through a
// two-stage ring. Then the cluster's first CTA calls finish(row0) with
// the rows' minima in sm.best_d / sm.best_k (and, with kKeepX, the rows in
// sm.x). Every thread of the CTA must call it.
template <typename T, bool kKeepX, typename Finish>
__device__ __forceinline__ void search(const T* __restrict__ x, const float* __restrict__ planes,
                                       const float* __restrict__ e_sq, int N, int D, bool vec,
                                       int chunks, int per_split, SearchSmem& sm,
                                       Finish finish) {
  constexpr bool kSplitX = sizeof(T) == 4;  // a bf16 x has no lo plane
  if (gridDim.y > 1) cluster_arrive_relaxed();  // merge_splits waits for every CTA's
  const int group = threadIdx.x >> 7, t = threadIdx.x & 3;
  const int c_begin = blockIdx.y * per_split;
  const int c_end = min(chunks, c_begin + per_split);
  const long long row0 = (long long)blockIdx.x * kRows;
  auto issue = [&](int c) {
    const float4* src = reinterpret_cast<const float4*>(planes + (long long)c * kChunkF);
    float4* dst = reinterpret_cast<float4*>(sm.e[(c - c_begin) & 1]);
#pragma unroll 4
    for (int i = threadIdx.x; i < kChunkF / 4; i += kThreads) mma::cp_async16(dst + i, src + i, true);
  };
  issue(c_begin);
  mma::cp_async_commit();
  {
    float v[kQuads][4];
    load_rows<T>(v, x, N, D, row0, vec);
    stage_rows<kSplitX, kKeepX>(v, sm);
  }
  const float* xh = sm.xh[group];
  const float* xl = sm.xl[group];
  float bd[2] = {INFINITY, INFINITY};
  int bk[2] = {kNoCode, kNoCode};
  for (int c = c_begin; c < c_end; ++c) {
    if (c + 1 < c_end) issue(c + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    // the stage (cp.async) and the x tiles (stores) are written through the
    // generic proxy; wgmma reads them through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const float* eh = sm.e[(c - c_begin) & 1];
    const float* el = eh + kTileF;
    // s = x e^T, each step's three products taken into zeroed registers
    // (two sets in turn, so that one step runs while the last is added)
    // and added to s in f32, in step order
    float s[8][4], tp[2][8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    step_products<kSplitX>(tp[0], xh, xl, eh, el, 0);
#pragma unroll
    for (int kc = 1; kc <= kSteps; ++kc) {
      if (kc < kSteps) {
        step_products<kSplitX>(tp[kc & 1], xh, xl, eh, el, kc);
        wg::wait<1>();
      } else {
        wg::wait<0>();
      }
      float(*done)[4] = tp[(kc - 1) & 1];
      wg::fence_regs<8>(done);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += done[j][e];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = c * kChunk + 8 * j + 2 * t;
      const float2 sq = *reinterpret_cast<const float2*>(e_sq + code);
      const float dist[4] = {sq.x - 2.f * s[j][0], sq.y - 2.f * s[j][1], sq.x - 2.f * s[j][2],
                             sq.y - 2.f * s[j][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (dist[e] < bd[e >> 1]) {  // strict: the lowest k keeps a tie
          bd[e >> 1] = dist[e];
          bk[e >> 1] = code + (e & 1);
        }
      }
    }
    __syncthreads();  // every warpgroup is done with this stage before its refill
  }
  if (merge_splits(bd, bk, sm)) finish(row0);
}

// x's rows are read as vectors of 4 (wmz::load4) when they are kMaxD long
// and aligned
template <typename T>
inline bool vector_rows(const void* x, int D) {
  return D == kMaxD && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
}

// Launches a search kernel: grid (tiles, splits), a tile's splits one
// cluster, kSmemBytes of dynamic shared memory (allowed once a device)
template <auto kernel, typename... Args>
inline cudaError_t launch_search(const Plan& p, cudaStream_t stream, Args... args) {
  static uint64_t allowed = 0;  // bit d: device d (from 64 on, every launch)
  const uint64_t bit = p.device < 64 ? uint64_t(1) << p.device : 0;
  if (!(allowed & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    allowed |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.tiles, (unsigned)p.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = (unsigned)p.splits;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  wmz::note_launch(kernel);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

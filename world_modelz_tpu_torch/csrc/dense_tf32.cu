// Dense layers in f32 on Hopper's tensor cores (sm_90a): Y = epi(X W^T + b)
// in split TF32, with the bias, a tanh GELU or a residual add in the
// epilogue.
//
// Replaces no TPU kernel: the JAX package leaves its dense layers to XLA
// (flax's nn.Dense). It takes the place of cuBLAS's f32 GEMM (TF32 off, on
// the CUDA cores) for every dense layer of an f32 forward run without
// autograd on the card (ops/dense.py:tf32_route): the served denoiser's
// projections and MLPs, the sparse denoiser's and its logits.
//
// What it computes. X (M, K) f32 row-major, W (N, K) f32 (nn.Linear's
// layout), b (N,) f32 or none: Y = X W^T + b, then per `epi` nothing, the
// tanh GELU (flax's nn.gelu, PyTorch's GELU(approximate="tanh")) or + R
// for a residual R of Y's shape, in f32 and in that order. A launch takes
// up to three such problems that share M and K (each its own X, W, b and
// N): the attention's q over x, k and v over LN(x).
//
// Arithmetic: split TF32 (split_tf32.cuh). Each operand value is split as
// it arrives into hi = tf32(x) and lo = tf32(x - hi), rounded as cvt.rna
// rounds (split_int), and each f32 product is three TF32 products, lo_x
// hi_w + hi_x lo_w + hi_x hi_w (lo_x lo_w, ~2^-22 relative, is dropped).
// One TF32 product keeps ~10 mantissa bits: its error (~1e-3 of |Y| at K =
// 384) breaks the served sampler's f32 gate. The tensor cores add a product
// to the accumulator they are given less exactly than an f32 add: with the
// whole depth summed in their accumulators the error against float64 was
// ~1.2e-5 of max(1, |Y|) at the served shapes, against ~1.1e-6 with
// vq_search.cuh's discipline (each 8-deep step's three products summed
// apart, added to the running sum in f32). Each 32-deep chunk's twelve
// products summed apart and added in f32, in chunk order, read ~1.3e-6,
// the same within a fifth, at a quarter of the waits and adds; that is
// the order this kernel keeps (PERF.md).
//
// Design: a CTA is one 192 x 64 output tile of one problem and four
// warpgroups, specialised.
// - The producer warpgroup streams the depth in 32-deep chunks through a
//   ring of three stages, each handed over and back on a pair of mbarriers
//   (full, empty): its threads copy the chunk's 192 X rows by cp.async into
//   the stage as they are (f32 rows padded to 36), and its 64 W rows, whose
//   pieces each thread then splits into the stage's hi and lo tiles (K-major
//   64 x 32, 128-byte swizzle, wgmma.cuh); two chunks' copies are in
//   flight while one is split. Rows past M or N and depth past K are zeros.
// - Three consumer warpgroups, 64 rows each, take a stage's four steps on
//   wgmma m64n64k8 .tf32 with A from registers: each thread reads its A
//   fragment from the padded X rows (32 banks, no conflict), splits it, and
//   issues lo_x hi_w, hi_x lo_w, hi_x hi_w against the shared W tiles. While
//   one consumer adds its chunk's sum, the others' products run; the
//   producer fills the next stages meanwhile. X is never split into shared
//   memory, which keeps the shared-memory traffic near the products' rate.
// - The epilogue's bias and residual tile are staged in shared memory by
//   the producer while the consumers finish the last chunks (read from
//   device memory after the products, their latency showed in every
//   launch); it stores pairs of columns.
// - Small M fills the card by splitting the depth: a tile's splits are the
//   CTAs of one cluster (blockIdx.y); each adds its partial sums into the
//   shared memory of the cluster's first CTA, which sums them in split
//   order after a cluster barrier and writes the tile. The plan
//   (make_plan) takes the fewest waves x (chunks + kCtaChunks) of a CTA,
//   with the clusters resident at once read from the device (one CTA an
//   SM; a cluster's CTAs share a GPC).
//
// What bounds it on the H100: the three TF32 products, 3 x 2 M N K
// operations at 495 TFLOP/s (the same products on the f32 CUDA cores are
// bound by 2 M N K at 67 TFLOP/s); at small M, the bytes, (M K + N K + M N)
// x 4 at 3.35 TB/s, and the launch. Its costs beyond the products: the
// splits (W again in every CTA of a column, X again in every CTA of a row:
// the split is made as tiles arrive, with no prep launch and no cached
// split copy of the weights), overlapped with the products by the warp
// roles, and the 192-row tiles' wave shape at the served sizes. Measured
// (PERF.md): at 3,072 rows 28-52 TFLOP/s of f32 products, 17-32% of the
// three products' ceiling; at 384-768 rows a launch takes 10-15 us
// whatever its size, its first chunk's copies, the handoffs and the
// merge, not its bytes, setting the time.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "flash_mma.cuh"
#include "launch_log.cuh"
#include "split_tf32.cuh"
#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
namespace mma = wmz::mma;
namespace stf = wmz::split_tf32;
namespace wg = wmz::wg;

constexpr int kConsumers = 3;                       // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);    // the producer, then the consumers
constexpr int kTileM = 64 * kConsumers;             // rows of an output tile
constexpr int kTileN = 64;                          // columns of an output tile
constexpr int kChunk = 32;                          // depth of a chunk (128 bytes a row)
constexpr int kChunkSteps = kChunk / 8;             // 8-deep steps of a chunk
constexpr int kTileF = kTileN * kChunk;             // f32 of a W chunk tile (8 KB)
constexpr int kXStride = kChunk + 4;                // f32 of a staged X row
constexpr int kXPieces = kTileM * kChunk / 4 / 128;  // 16-byte pieces a producer thread
constexpr int kWPieces = kTileN * kChunk / 4 / 128;  // copies of X and W a chunk
constexpr int kStages = 3;                          // the ring
constexpr int kResStride = kTileN + 8;              // f32 of a staged residual row
constexpr int kMaxProblems = 3;
constexpr int kMaxSplits = 4;                       // a tile's depth splits form one cluster
constexpr int kCtaChunks = 4;                       // a CTA's cost beyond its own chunks (plan)

enum Epilogue { kNone = 0, kGelu = 1, kResidual = 2 };

struct Problem {
  const float* x;  // (M, K)
  const float* w;  // (n, K)
  const float* b;  // (n,) or null
  float* y;        // (M, n)
  int n, n_tiles;
};

struct Params {
  Problem p[kMaxProblems];
  const float* r;  // (M, p[0].n): the residual (kResidual)
  int count, M, K, m_tiles, chunks, per_split, epi;
};

struct Stage {  // one chunk: W split (1,024-byte aligned tiles), X and W as copied
  float wh[kTileF];
  float wl[kTileF];
  float x[kTileM * kXStride];
  float rw[kTileF];  // each producer thread's W pieces at 4 p
};
struct __align__(1024) Smem {
  Stage st[kStages];
  float res[kTileM * kResStride];  // the epilogue's residual tile and bias,
  float bias[kTileN];              // staged while the last chunks run
  uint64_t full[kStages], empty[kStages], epi;
};
static_assert(sizeof(Stage) % 1024 == 0, "stage alignment");
// the ring is free once a CTA's products are done: the cluster's first CTA
// takes the other splits' partial sums there
constexpr int kPartialF = kConsumers * 128 * 32;  // f32 of one CTA's partial sums
static_assert((kMaxSplits - 1) * kPartialF * sizeof(float) <= sizeof(Stage) * kStages,
              "merge space");
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;

__device__ __forceinline__ Smem& dense_smem(unsigned char* raw) {
  const uint32_t base = mma::smem_addr(raw);
  return *reinterpret_cast<Smem*>(raw + (((base + 1023) & ~1023u) - base));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mma::smem_addr(bar))
               : "memory");
}

// flax's nn.gelu (approximate=True) in f32, as PyTorch's CUDA GELU(tanh)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float cube = x * x * x;
  return 0.5f * x * (1.f + tanhf(kBeta * (x + kKappa * cube)));
}

// producer thread t's pieces of chunk c into stage st: X rows [row0, row0
// + 192) and W rows [col0, col0 + 64), depth [32 c, 32 c + 32)
__device__ __forceinline__ void issue_chunk(const Params& P, const Problem& pr, Stage& st,
                                            int t, int c, int row0, int col0) {
#pragma unroll
  for (int q = 0; q < kXPieces; ++q) {
    const int p = t + 128 * q, r = p >> 3, k = c * kChunk + 4 * (p & 7);
    const bool v = k < P.K && row0 + r < P.M;
    mma::cp_async16(st.x + r * kXStride + 4 * (p & 7),
                    pr.x + (v ? (long long)(row0 + r) * P.K + k : 0), v);
  }
#pragma unroll
  for (int q = 0; q < kWPieces; ++q) {
    const int p = t + 128 * q, r = p >> 3, k = c * kChunk + 4 * (p & 7);
    const bool v = k < P.K && col0 + r < pr.n;
    mma::cp_async16(st.rw + 4 * p, pr.w + (v ? (long long)(col0 + r) * P.K + k : 0), v);
  }
}

// producer thread t's W pieces of stage st, as copied -> its swizzled hi
// and lo tiles (row r's 16-byte piece c sits at piece c ^ (r % 8))
__device__ __forceinline__ void split_w(Stage& st, int t) {
#pragma unroll
  for (int q = 0; q < kWPieces; ++q) {
    const int p = t + 128 * q, r = p >> 3;
    const int at = r * kChunk + (((p & 7) ^ (r & 7)) << 2);
    const float4 v = *reinterpret_cast<const float4*>(st.rw + 4 * p);
    uint32_t h[4], l[4];
    stf::split_int(v.x, h[0], l[0]);
    stf::split_int(v.y, h[1], l[1]);
    stf::split_int(v.z, h[2], l[2]);
    stf::split_int(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(st.wh + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(st.wl + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// barrier.cluster in two halves: arrive (release: this thread's writes,
// shared memory of other CTAs included, are visible to whoever waits) and
// wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the producer: chunk d is split and handed over as soon as its pieces
// land, then chunk d + kAhead's copies are issued once its stage is free
// (the consumers are done with chunk d - 1), so kAhead chunks' copies are
// in flight behind the one split
constexpr int kAhead = kStages - 1;

__device__ __forceinline__ void produce(const Params& P, const Problem& pr, Smem& sm, int t,
                                        int c_begin, int n_chunks, int row0, int col0) {
  for (int ci = 0; ci < kAhead; ++ci) {
    if (ci < n_chunks) issue_chunk(P, pr, sm.st[ci], t, c_begin + ci, row0, col0);
    mma::cp_async_commit();  // one group a chunk, empty past the last
  }
  for (int d = 0; d < n_chunks; ++d) {
    mma::cp_async_wait<kAhead - 1>();  // chunk d's pieces of this thread
    const int slot = d % kStages;
    split_w(sm.st[slot], t);
    // the split tiles are written through the generic proxy; wgmma reads
    // them through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&sm.full[slot]);
    const int ci = d + kAhead;
    if (ci < n_chunks) {
      const int next = ci % kStages;
      if (ci >= kStages) wg::mbar_wait(&sm.empty[next], ((ci / kStages) - 1) & 1);
      issue_chunk(P, pr, sm.st[next], t, c_begin + ci, row0, col0);
    }
    mma::cp_async_commit();
  }
}

// producer thread t's share of the epilogue's operands (the residual tile,
// 16-byte pieces where its rows allow, and the bias), staged while the
// consumers finish the last chunks, then handed over on sm.epi
__device__ __forceinline__ void stage_epilogue(const Params& P, const Problem& pr, Smem& sm,
                                               int t, int row0, int col0) {
  if (P.epi == kResidual) {
    if ((pr.n & 3) == 0) {
      for (int p = t; p < kTileM * kTileN / 4; p += 128) {
        const int r = p / (kTileN / 4), c = 4 * (p % (kTileN / 4));
        const bool v = row0 + r < P.M && col0 + c < pr.n;
        mma::cp_async16(sm.res + r * kResStride + c,
                        P.r + (v ? (long long)(row0 + r) * pr.n + col0 + c : 0), v);
      }
    } else {
      for (int p = t; p < kTileM * kTileN; p += 128) {
        const int r = p / kTileN, c = p % kTileN;
        const bool v = row0 + r < P.M && col0 + c < pr.n;
        mma::cp_async4(sm.res + r * kResStride + c,
                       P.r + (v ? (long long)(row0 + r) * pr.n + col0 + c : 0), v);
      }
    }
  }
  if (pr.b != nullptr && t < kTileN)
    mma::cp_async4(sm.bias + t, pr.b + (col0 + t < pr.n ? col0 + t : 0), col0 + t < pr.n);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  mbar_arrive(&sm.epi);
}

// consumer warpgroup g: s += its 64 rows of X W^T over the CTA's chunks,
// each chunk's twelve products summed apart (zeroed registers) and added
// in f32
__device__ __forceinline__ void consume(const Params& P, Smem& sm, int g, int c_begin,
                                        int n_chunks, float s[8][4]) {
  using wg::bf16;  // desc_k counts in 2-byte units: an 8-deep f32 step is 16 of them
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row = 64 * g + 16 * warp + (lane >> 2), t4 = lane & 3;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int slot = ci % kStages;
    const int steps = min(kChunkSteps, (P.K - (c_begin + ci) * kChunk) / 8);
    wg::mbar_wait(&sm.full[slot], (ci / kStages) & 1);
    const Stage& st = sm.st[slot];
    const float* xa = st.x + row * kXStride + t4;
    float t[8][4];
    uint32_t ah[kChunkSteps][4], al[kChunkSteps][4];
    // every step's A fragment (rows g, g + 8 at k-slots t, t + 4), split,
    // then one fence and the chunk's twelve products
#pragma unroll
    for (int kc = 0; kc < kChunkSteps; ++kc) {
      if (kc < steps) {
        const float* a = xa + 8 * kc;
        stf::split_int(a[0], ah[kc][0], al[kc][0]);
        stf::split_int(a[8 * kXStride], ah[kc][1], al[kc][1]);
        stf::split_int(a[4], ah[kc][2], al[kc][2]);
        stf::split_int(a[8 * kXStride + 4], ah[kc][3], al[kc][3]);
      }
    }
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < kChunkSteps; ++kc) {
      if (kc < steps) {
        const uint64_t dh = wg::desc_k<64>(reinterpret_cast<const bf16*>(st.wh), kc);
        const uint64_t dl = wg::desc_k<64>(reinterpret_cast<const bf16*>(st.wl), kc);
        wg::mma_tf32_rs_n64(t, al[kc], dh, kc > 0);
        wg::mma_tf32_rs_n64(t, ah[kc], dl, 1);
        wg::mma_tf32_rs_n64(t, ah[kc], dh, 1);
      }
    }
    wg::commit();
    wg::fence_frags<kChunkSteps>(ah);
    wg::fence_frags<kChunkSteps>(al);
    wg::fence_regs<8>(t);
    wg::wait<0>();
    wg::fence_frags<kChunkSteps>(ah);
    wg::fence_frags<kChunkSteps>(al);
    wg::fence_regs<8>(t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += t[j][e];
    mbar_arrive(&sm.empty[slot]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dense_tf32_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = dense_smem(smem_raw);
  // the tile: row tiles vary fastest, then the problems' column tiles
  int nt = blockIdx.x / P.m_tiles, pi = 0;
  while (pi + 1 < P.count && nt >= P.p[pi].n_tiles) nt -= P.p[pi++].n_tiles;
  const Problem& pr = P.p[pi];
  const int row0 = (blockIdx.x % P.m_tiles) * kTileM, col0 = nt * kTileN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int c_begin = split * P.per_split;
  const int n_chunks = min(P.chunks, c_begin + P.per_split) - c_begin;
  const int group = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(&sm.full[i], 128);
      wg::mbar_init(&sm.empty[i], 128 * kConsumers);
    }
    wg::mbar_init(&sm.epi, 128);
    wg::mbar_init_fence();
  }
  __syncthreads();

  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if (group == 0) {
    produce(P, pr, sm, threadIdx.x, c_begin, n_chunks, row0, col0);
    if (split == 0) stage_epilogue(P, pr, sm, threadIdx.x, row0, col0);
  } else {
    consume(P, sm, group - 1, c_begin, n_chunks, s);
  }

  const int ct = threadIdx.x - 128;  // a consumer thread's index among the consumers
  if (splits > 1) {
    // every CTA of the cluster is done with its products and splits (so
    // with the first CTA's ring, where the partial sums go)
    cluster_arrive();
    cluster_wait();
    float* merge = &sm.st[0].wh[0];
    if (split != 0) {
      if (group > 0) {
        float4* lead = reinterpret_cast<float4*>(
            cg::this_cluster().map_shared_rank(merge, 0) + (split - 1) * kPartialF);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          lead[j * 128 * kConsumers + ct] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      }
      cluster_arrive();
      return;
    }
    cluster_arrive();
    cluster_wait();
    if (group > 0)
      for (int sp = 1; sp < splits; ++sp)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 v = reinterpret_cast<const float4*>(
              merge + (sp - 1) * kPartialF)[j * 128 * kConsumers + ct];
          s[j][0] += v.x;
          s[j][1] += v.y;
          s[j][2] += v.z;
          s[j][3] += v.w;
        }
  }
  if (group == 0) return;

  // accumulator (warp w of consumer g): d[j][0..1] row 64 g + 16 w + g8,
  // columns 8 j + 2 t4, +1; d[j][2..3] 8 rows further (lane = 4 g8 + t4);
  // the bias and the residual from their staged tiles
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rt = 64 * (group - 1) + 16 * warp + g8;  // the row within the tile
  const bool has_bias = pr.b != nullptr, has_res = P.epi == kResidual;
  wg::mbar_wait(&sm.epi, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + rt + 8 * h;
    if (row >= P.M) continue;
    float* yrow = pr.y + (long long)row * pr.n;
    const float* rrow = sm.res + (rt + 8 * h) * kResStride;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t4, col = col0 + c;
      const float2 bias = *reinterpret_cast<const float2*>(sm.bias + c);
      const float2 res = *reinterpret_cast<const float2*>(rrow + c);
      float v[2] = {s[j][2 * h], s[j][2 * h + 1]};
      if (has_bias) {
        v[0] += bias.x;
        v[1] += bias.y;
      }
      if (P.epi == kGelu) {
        v[0] = gelu_tanh(v[0]);
        v[1] = gelu_tanh(v[1]);
      }
      if (has_res) {
        v[0] += res.x;
        v[1] += res.y;
      }
      if ((pr.n & 1) == 0 && col < pr.n) {
        *reinterpret_cast<float2*>(yrow + col) = make_float2(v[0], v[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < pr.n) yrow[col + e] = v[e];
      }
    }
  }
}

// The launch's shape: the output's row tiles and the problems' column
// tiles; the depth in chunks, `splits` parts of `per_split` chunks, a
// tile's parts one cluster; on `device`, with `slots` clusters of `splits`
// CTAs resident at once.
struct Plan {
  int m_tiles, n_tiles, chunks, per_split, splits, slots, device;
};

// The dynamic shared memory the kernel takes (allowed once a device) and,
// for each cluster size 1 .. kMaxSplits, the clusters resident at once on
// the current device (a cluster's CTAs share a GPC, so the SMs do not
// divide evenly).
inline cudaError_t device_slots(int& device, const int*& slots) {
  static uint64_t allowed = 0;  // bit d: device d (from 64 on, every call)
  static int resident[64][kMaxSplits + 1] = {};
  static int scratch[kMaxSplits + 1];
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t(1) << device : 0;
  int* out = device < 64 ? resident[device] : scratch;
  slots = out;
  if (allowed & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(dense_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  for (int c = 1; c <= kMaxSplits && err == cudaSuccess; ++c) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1024, (unsigned)c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = (unsigned)c;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&out[c], dense_tf32_kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  allowed |= bit;
  return cudaSuccess;
}

// The fewest waves x (per_split + kCtaChunks), a wave being the clusters of
// `splits` CTAs resident at once, ties to fewer splits.
inline cudaError_t make_plan(int M, int K, int n_tiles, Plan& p) {
  const int* slots = nullptr;
  const cudaError_t err = device_slots(p.device, slots);
  if (err != cudaSuccess) return err;
  p.m_tiles = (M + kTileM - 1) / kTileM;
  p.n_tiles = n_tiles;
  p.chunks = (K + kChunk - 1) / kChunk;
  const long long tiles = (long long)p.m_tiles * n_tiles;
  long long best = -1;
  for (int per = p.chunks; per >= 1; --per) {
    const int parts = (p.chunks + per - 1) / per;
    if (parts > kMaxSplits) break;
    const long long wave = slots[parts] > 0 ? slots[parts] : 1;
    const long long cost = ((tiles + wave - 1) / wave) * (per + kCtaChunks);
    if (best < 0 || cost < best) {
      best = cost;
      p.per_split = per;
      p.splits = parts;
      p.slots = (int)wave;
    }
  }
  return cudaSuccess;
}

}  // namespace

// The plan of a launch of `n_tiles` column tiles (64 columns each, summed
// over the problems) over M rows of depth K: out[0..5] = row tiles (192
// rows each), chunks, chunks a split, splits, CTAs, clusters of that many
// splits resident at once.
extern "C" int wmz_dense_tf32_plan(int M, int K, int n_tiles, int* out) {
  Plan p;
  const cudaError_t err = make_plan(M, K, n_tiles, p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.m_tiles;
  out[1] = p.chunks;
  out[2] = p.per_split;
  out[3] = p.splits;
  out[4] = p.m_tiles * p.n_tiles * p.splits;
  out[5] = p.slots;
  return 0;
}

// count problems (1 to 3) of M rows and depth K: xs, ws, bs (null: no
// bias), ys are arrays of `count` device pointers, ns their widths. epi: 0
// none, 1 tanh GELU, 2 + r (one problem; r of y's shape, not y). K % 8 ==
// 0, every X and W row base 16-byte aligned (the wrapper checks). Returns
// the cudaError_t of the launch.
extern "C" int wmz_dense_tf32(void* const* xs, void* const* ws, void* const* bs, void* const* ys,
                              const int* ns, int count, int M, int K, int epi, const void* r,
                              void* stream) {
  if (count < 1 || count > kMaxProblems || M <= 0 || K <= 0 || K % 8 != 0 || epi < 0 ||
      epi > kResidual || (epi == kResidual && (r == nullptr || count != 1)))
    return (int)cudaErrorInvalidValue;
  Params P = {};
  int n_tiles = 0;
  for (int i = 0; i < count; ++i) {
    if (ns[i] <= 0) return (int)cudaErrorInvalidValue;
    P.p[i] = Problem{static_cast<const float*>(xs[i]), static_cast<const float*>(ws[i]),
                     static_cast<const float*>(bs[i]), static_cast<float*>(ys[i]), ns[i],
                     (ns[i] + kTileN - 1) / kTileN};
    n_tiles += P.p[i].n_tiles;
  }
  Plan p;
  cudaError_t err = make_plan(M, K, n_tiles, p);
  if (err != cudaSuccess) return (int)err;
  P.r = static_cast<const float*>(r);
  P.count = count;
  P.M = M;
  P.K = K;
  P.m_tiles = p.m_tiles;
  P.chunks = p.chunks;
  P.per_split = p.per_split;
  P.epi = epi;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.m_tiles * n_tiles), (unsigned)p.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = (unsigned)p.splits;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  wmz::note_launch(dense_tf32_kernel);
  return (int)cudaLaunchKernelEx(&cfg, dense_tf32_kernel, P);
}

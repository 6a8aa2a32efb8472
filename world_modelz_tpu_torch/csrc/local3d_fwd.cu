// Local-3D windowed attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU forward kernels of world_modelz_tpu/kernels/local3d.py
// that `local3d_attention_pallas` (:1493) routes to through `_route_fwd`
// (:1510): `_attn_kernel_allframes` (:490), `_attn_kernel` (:177) and
// `_attn_kernel_tiled` (:881). The three are one computation cut three ways
// to fit the TPU's VMEM; on the GPU one kernel covers them.
//
// What it computes. q, k, v, out are (B, S, H, W, heads * dh), contiguous.
// Query (b, s, h, w) of head n attends to the keys with |ds| <= es inside
// the clip and |dh| <= eh, |dw| <= ew inside the frame; scores are scaled
// by dh^-1/2 and softmaxed over those keys only, then multiplied by V. In
// bf16 P = exp(s - m), m the max over the query's whole window, is rounded
// where the TPU kernel for the shape rounds it: unnormalised, with P V
// divided by the sum l after the product (`_attn_kernel_allframes`,
// :531-539; route 1), or normalised first (`_attn_kernel` :207-211,
// `_attn_kernel_tiled` :924-928; route 2). The caller says which
// (kernels/local3d.py:divides_after_product); which kernel runs follows
// dtype and head size here alone.
//
// What bounds it on the H100. At the serving shape (B=8, S=6, 8x8 grid,
// dh=128, extents (3,1,1)) one launch moves ~3.1 MB in bf16 (q, k, v read
// once, out written once), ~0.94 us at 3.35 TB/s, and does ~59 MFLOP,
// ~0.06 us at the bf16 tensor-core peak: memory-bound, and at that size
// bound in practice by latency and by the launch itself. In f32 it moves
// 6.29 MB, 1.878 us, against 0.89 us for the 59 MFLOP at the CUDA cores'
// 67 TFLOP/s: memory-bound too. On the card the bf16
// tensor-core kernel is bound by each SM's intake of staged tiles and by
// the chain of steps of a block, not by its (dense) products.
//
// Design, bf16 at dh = 64 and 128 (routes 1, 2): tensor cores on
// flash_mma.cuh's tiles and local3d_mma.cuh's window. A block owns 16
// kWarps consecutive query positions of one (b, head, frame s), 16 per
// warp, with Q held as mma A fragments in registers: kWarps = 4, or 2
// where 64 positions' key band would not fit one tile. It visits only the
// frames of the clip inside s +- es (`_valid_offsets`, :481) and, of each,
// the rows within eh of its queries' rows (`key_band`), staged as
// 64-position tiles with cp.async, the next step's tiles in flight while
// the current ones are used. Each warp takes S = Q K^T (mma.sync
// m16n8k16) over a whole tile, or over the 32 keys of it that hold its
// own band where they fit (every 8 x 8 frame), and masks the keys
// outside each query's window with bits worked out once where the band is
// one tile. The max runs over the whole window before P is rounded, so
// the block walks its tiles twice: sweep 1 for the row max (route 2: and
// the online sum), sweep 2 for P, rounded into the A fragments of P V
// (`to_a_frags`), and its sum (route 1); a division by the sum is a
// multiplication by its correctly rounded reciprocal (within an f32 ulp
// of the TPU kernel's quotient before the bf16 rounding). Where the grid
// leaves SMs to spare (the serving shape: 48 blocks) two groups of warps
// split the window's tiles and merge their maxima, sums and P V sums in
// group order; their window's K tiles (at most 8) are all staged up front
// and stay for sweep 2, which then stages V alone. Otherwise one group,
// with Q passing through the second stage, holds 70 KB at dh = 128 and
// three blocks fit on an SM. Each warp sums in a fixed order: no atomics,
// two launches are bitwise equal.
//
// Design, f32 at dh = 64 and 128 (`local3d_fwd_cluster_kernel`): a thread
// block cluster per query tile, K and V staged in shared memory, the
// products in f32 FMAs on the CUDA cores. In f32, P is never
// rounded, so one online sweep (running max m, sum l, acc rescaled as m
// moves) serves and the window's frames can be taken apart and merged.
// The one-warp-a-query kernel below reads every key and value row of a
// query's window from L2 for that query alone: at the rollout's shape
// (B=8) 116,160 window pairs x 1 KB of K and V, ~19x its tensors' 6.29
// MB, in a chain of ~10 dependent steps a warp. Here a query tile (64
// positions of one (b, head, frame)) is one cluster of C CTAs, and rank r
// takes the frames fa + r, fa + r + C, ... of the window inside the clip
// (the ranks left without a frame leave at once). Per frame the CTA stages
// its tile's key band (`key_band`) in steps of 64 keys (96 with two
// stages) of K and V with
// cp.async: each is read from L2 once per tile and frame. 8 lanes serve two
// neighbouring queries of the tile: lane t holds elements 32 c + 4 t .. 32
// c + 4 t + 3 of both q in registers, and of the key and value rows (128
// contiguous bytes a group: no bank conflicts, no padding) and of both f32
// accumulators. The pair walks the box of its two windows 4 keys at a time
// and reads each key row once for both (a row's neighbours share two of
// their three columns): f32 FMAs, a 3-step shuffle sum a query, then each
// query folds the keys of its own window into its online softmax and
// accumulator. Both queries take q k and P V for every key of the box (P
// is 0 outside a query's window), and a warp's four pairs walk as many
// batches as the one with the most keys: ~1.36x the window's products at
// a 3 x 3 spatial window (12-key boxes for 9-key windows;
// chip_smoke.py:local3d_cluster_executed_ops counts them). After the steps each CTA leaves its rows' (m, l, acc) in
// its shared memory; after a cluster barrier CTA r merges its share of the
// rows of every CTA, in rank order, through distributed shared memory, and
// writes them; a second barrier keeps every CTA alive until the others
// have read it. The C entry picks C (1 to 8, the portable size) and the
// stages: where the CTAs fit one an SM, the largest C that keeps them so,
// with two stages of K and V (the next step's copies in flight while a
// step is taken); otherwise one stage and the C of the fewest waves x the
// longest CTA's chain. No atomics: two launches are bitwise equal. Split
// TF32 on the tensor cores (split_tf32.cuh) was measured first, in the
// same cluster: at a 3 x 3 spatial window a warp's m16n8k8 tiles compute
// ~4.2x the window's products, three TF32 products each, and splitting the
// operands costs more instructions than the f32 FMAs here (PERF.md).
//
// Design, f32 at the other head sizes and bf16 at them (route 0): CUDA
// cores. In f32, P stays in f32 and the window is walked once; in bf16 it
// is walked twice (`local3d_fwd_round_kernel`): once for the max and the
// sum, once to round P (route 1's way or route 2's, as the caller says)
// before P V. The TPU kernels multiply dense 7-frame blocks and mask the
// scores (with a max over valid keys only, local3d.py:520-530, to avoid NaN
// rows). Here the window is walked directly, so a query never visits an
// invalid key and always visits itself: the normaliser is never 0. One
// warp per query, split into four groups of eight lanes; each group scores
// its own key of the window (keys g, g+4, g+8, ... of the window in
// row-major order), so four keys' loads are in flight per warp. Lane t of
// a group holds elements [t*E, t*E+E) of q (pre-scaled), of the key and
// value rows (vector loads) and of its f32 accumulator, E = dh / 8; a
// three-step shuffle sums the dot product within the group. Each group
// keeps an online softmax (running max, running sum); the four partial
// states are merged by two shuffles at the end. q, k and v are read in
// place in their (B, S, H, W, heads * dh) layout: no transposes and no
// zero-padded frames. The window and the warp layout are defined once, for
// this kernel and the backward pair, in local3d_window.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include <cooperative_groups.h>

#include "flash_mma.cuh"
#include "launch_log.cuh"
#include "local3d_mma.cuh"
#include "local3d_window.cuh"
#include "vec.cuh"

namespace {

using wmz::group_sum;
using wmz::kGroupLanes;
using wmz::kGroups;
using wmz::kWarpsPerBlock;
using wmz::load4;
using wmz::store4;
using wmz::Window;
using wmz::window_of;
using wmz::window_row;

// E: elements of the head dimension per lane, dh = kGroupLanes * E, E % 4 == 0
template <typename T, int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
local3d_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, int B, int S,
                   int H, int W, int heads, int es, int eh, int ew,
                   float scale) {
  constexpr int dh = kGroupLanes * E;
  const int lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes;
  const int t = lane % kGroupLanes;
  const long long query =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (query >= (long long)B * S * H * W * heads) return;  // whole warps
  const Window c = window_of(query, S, H, W, heads, es, eh, ew);
  // element offset of a row's lane slice
  auto elems = [&](long long row) -> long long { return row * dh + t * E; };

  float qr[E], acc[E];
  {
    const T* qp = q + elems(query);
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(qp + e);
      qr[e] = x.x * scale;
      qr[e + 1] = x.y * scale;
      qr[e + 2] = x.z * scale;
      qr[e + 3] = x.w * scale;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = -INFINITY, l = 0.f;

#pragma unroll 2
  for (int i0 = 0; i0 < c.n; i0 += kGroups) {
    const int i = i0 + group;
    const bool valid = i < c.n;
    const long long o = elems(window_row(c, valid ? i : 0, S, H, W, heads));
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(k + o + e);
      part = fmaf(qr[e], x.x, part);
      part = fmaf(qr[e + 1], x.y, part);
      part = fmaf(qr[e + 2], x.z, part);
      part = fmaf(qr[e + 3], x.w, part);
    }
    part = group_sum(part);
    if (valid) {
      const float m_new = fmaxf(m, part);
      const float corr = expf(m - m_new);  // 0 on the first key (m = -inf)
      const float p = expf(part - m_new);
      l = l * corr + p;
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 x = load4(v + o + e);
        acc[e] = fmaf(p, x.x, acc[e] * corr);
        acc[e + 1] = fmaf(p, x.y, acc[e + 1] * corr);
        acc[e + 2] = fmaf(p, x.z, acc[e + 2] * corr);
        acc[e + 3] = fmaf(p, x.w, acc[e + 3] * corr);
      }
      m = m_new;
    }
  }

  // merge the groups' (m, l, acc): lanes t, t+8, t+16, t+24 hold the same
  // elements. A group that saw no key has m = -inf and weighs 0.
#pragma unroll
  for (int off = kGroupLanes; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    const float ca = m == -INFINITY ? 0.f : expf(m - m_new);
    const float cb = m_o == -INFINITY ? 0.f : expf(m_o - m_new);
    l = l * ca + l_o * cb;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * ca + acc_o * cb;
    }
    m = m_new;
  }

  if (group == 0) {
    const float inv = 1.f / l;
    T* op = out + elems(query);
#pragma unroll
    for (int e = 0; e < E; e += 4)
      store4(op + e, make_float4(acc[e] * inv, acc[e + 1] * inv,
                                 acc[e + 2] * inv, acc[e + 3] * inv));
  }
}

// bf16 at the other head sizes: the same walk twice, P rounded where the
// TPU kernel rounds it (kDivideAfter: P = exp(s - m), P V divided by the
// sum after the product; else P / l).
template <int E, bool kDivideAfter>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
local3d_fwd_round_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int B, int S, int H, int W,
                         int heads, int es, int eh, int ew, float scale) {
  constexpr int dh = kGroupLanes * E;
  const int lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes;
  const int t = lane % kGroupLanes;
  const long long query = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (query >= (long long)B * S * H * W * heads) return;  // whole warps
  const Window c = window_of(query, S, H, W, heads, es, eh, ew);
  auto elems = [&](long long row) -> long long { return row * dh + t * E; };

  float qr[E], acc[E];
  {
    const long long o = elems(query);
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(q + o + e);
      qr[e] = x.x, qr[e + 1] = x.y, qr[e + 2] = x.z, qr[e + 3] = x.w;
    }
  }
  // the scaled score of window row i (all lanes); o: the row's offset
  auto score = [&](int i, long long& o) {
    o = elems(window_row(c, i, S, H, W, heads));
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(k + o + e);
      part = fmaf(qr[e], x.x, part);
      part = fmaf(qr[e + 1], x.y, part);
      part = fmaf(qr[e + 2], x.z, part);
      part = fmaf(qr[e + 3], x.w, part);
    }
    return __fmul_rn(group_sum(part), scale);
  };
  // walk 1: the max and the online sum per group, merged
  float m = -INFINITY, l = 0.f;
  for (int i0 = 0; i0 < c.n; i0 += kGroups) {
    const int i = i0 + group;
    const bool valid = i < c.n;
    long long o;
    const float sc = score(valid ? i : 0, o);
    if (valid) {
      const float m_new = fmaxf(m, sc);
      l = l * expf(m - m_new) + expf(sc - m_new);  // expf(-inf) = 0 first
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
  const float inv = __frcp_rn(l);
  // walk 2: P rounded into P V (kDivideAfter: and its sum)
  float l2 = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int i0 = 0; i0 < c.n; i0 += kGroups) {
    const int i = i0 + group;
    const bool valid = i < c.n;
    long long o;
    const float sc = score(valid ? i : 0, o);
    if (valid) {
      const float p = expf(sc - m);
      l2 += p;
      const float pr =
          __bfloat162float(__float2bfloat16_rn(kDivideAfter ? p : __fmul_rn(p, inv)));
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 x = load4(v + o + e);
        acc[e] = fmaf(pr, x.x, acc[e]);
        acc[e + 1] = fmaf(pr, x.y, acc[e + 1]);
        acc[e + 2] = fmaf(pr, x.z, acc[e + 2]);
        acc[e + 3] = fmaf(pr, x.w, acc[e + 3]);
      }
    }
  }
#pragma unroll
  for (int off = kGroupLanes; off < 32; off <<= 1) {
    l2 += __shfl_xor_sync(0xffffffffu, l2, off);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (group == 0) {
    const float f = kDivideAfter ? __frcp_rn(l2) : 1.f;
    __nv_bfloat16* op = out + elems(query);
#pragma unroll
    for (int e = 0; e < E; e += 4)
      store4(op + e, make_float4(acc[e] * f, acc[e + 1] * f, acc[e + 2] * f, acc[e + 3] * f));
  }
}

// ---------------------------------------------------------------- bf16
// The tensor-core forward (routes 1 and 2).

namespace mma = wmz::mma;
using mma::bf16;

// kGroups groups of kWarps warps split the window's tiles (fwd_block,
// local3d_mma.cuh, which the fused block's attention phase runs too).
template <int D, int kWarps, int kGroups, bool kDivideAfter>
__global__ void __launch_bounds__(32 * kWarps * kGroups, kGroups == 1 ? 3 : 1)
local3d_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                       int H, int W, int heads, int es, int eh, int ew, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long ld = (long long)heads * D;  // elements between positions
  wmz::l3d::fwd_block<D, kWarps, kGroups, kDivideAfter>(
      q, k, v, ld, out, ld, S, H, W, heads, es, eh, ew, scale, blockIdx.x, blockIdx.y,
      blockIdx.z / heads, blockIdx.z % heads, smem_raw);
}

// ---------------------------------------------------------------- f32
// The f32 forward at dh = 64 and 128 (local3d_fwd_cluster_kernel): a
// thread block cluster per query tile, each CTA a share of the window's
// frames, staged in shared memory; merged through distributed shared
// memory.

namespace cg = cooperative_groups;

constexpr int kClusterMax = 8;  // the portable cluster size
constexpr int kTileQ = 64;      // query positions of a tile
// key positions of a staged step: 64, and 96 with two stages (a CTA to an
// SM has the room), which takes a 64-query tile's band of 16-wide frames
// (6 rows) in one step
template <int kStages>
__host__ __device__ constexpr int step_keys() {
  return kStages == 2 ? 96 : 64;
}
constexpr int kLanesQ = 8;      // lanes that share a pair of queries
constexpr int kBatch = 4;       // keys a pair scores at once

// shared-memory bytes: kStages stages of one step of K and one of V, f32
// rows of D (the merge then holds the CTA's rows of P V where stage 0's K
// was, and their running max, sum and weights where its V was)
template <int D, int kStages>
constexpr size_t cluster_smem_bytes() {
  return (size_t)2 * kStages * step_keys<kStages>() * D * sizeof(float);
}

// sum over the kLanesQ lanes of a group; all 32 lanes take part
__device__ __forceinline__ float group_sum8(float x) {
#pragma unroll
  for (int off = 1; off < kLanesQ; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The kTileQ query positions from pb * kTileQ of frame s of (b, head), item
// blockIdx.x / C, against the frames of their window that cluster rank r =
// blockIdx.x % C takes: fa + r, fa + r + C, ... (fa the window's first frame
// in the clip), each frame's key band in steps of kKeys keys. kLanesQ
// lanes serve two neighbouring queries (positions 2 g and 2 g + 1 of the
// tile): lane t holds elements 32 c + 4 t .. 32 c + 4 t + 3 of both q
// (in registers), of the key and value rows (from shared memory, 128
// contiguous bytes a group) and of both f32 accumulators. The pair walks
// the keys of the box that holds both windows in each step, kBatch at a
// time in row-major order: each key row is read once for both queries,
// and scored for each query whose window holds it (a row's neighbours
// share two of their three columns), with an online softmax per query in
// f32 (running max m, sum l, acc rescaled as m moves). With two stages the
// next step's K and V are in flight while a step is taken. Then the cluster's
// CTAs merge their (m, l, acc) in rank order, each CTA the rows [r kTileQ /
// A, (r + 1) kTileQ / A) of the A ranks with a frame, and write out.
template <int D, int kStages>
__global__ void __launch_bounds__(kTileQ / 2 * kLanesQ, 3 - kStages)
local3d_fwd_cluster_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int S, int H,
                           int W, int heads, int es, int eh, int ew, float scale, int C) {
  constexpr int L = D, kChunks = D / (4 * kLanesQ), kKeys = step_keys<kStages>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kKeys * L;
  const int HW = H * W, per_frame = (HW + kTileQ - 1) / kTileQ;
  const int rank = blockIdx.x % C;
  long long item = blockIdx.x / C;
  const int pb = (int)(item % per_frame);
  item /= per_frame;
  const int s = (int)(item % S);
  item /= S;
  const int head = (int)(item % heads), b = (int)(item / heads);
  const long long ld = (long long)heads * D;  // elements between positions
  // element offset of head `head` of frame f's first position
  auto frame = [&](int f) { return ((long long)b * S + f) * HW * ld + head * D; };
  const int p0 = pb * kTileQ, p1 = min(p0 + kTileQ, HW);
  const wmz::l3d::Band band = wmz::l3d::key_band(p0, p1, H, W, eh);
  const int tiles = (band.hi - band.lo + kKeys - 1) / kKeys;
  const int fa = max(s - es, 0), fb = min(s + es, S - 1);
  // the ranks with a frame: the others leave at once, which frees their
  // place on the card (a cluster barrier waits for the threads that have
  // not exited), and nothing reads their shared memory
  const int active = min(C, fb - fa + 1);
  if (rank >= active) return;
  const int steps = ((fb - fa - rank) / C + 1) * tiles;

  // this group's queries (a query past the frame takes the frame's last
  // position and is not written) and its slices of q
  const int g = threadIdx.x / kLanesQ, t = threadIdx.x % kLanesQ;
  int pq[2], hq[2], wq[2];
  float4 qv[2][kChunks], acc[2][kChunks];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    pq[i] = min(p0 + 2 * g + i, p1 - 1);
    hq[i] = pq[i] / W;
    wq[i] = pq[i] - hq[i] * W;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      qv[i][c] = __ldg(reinterpret_cast<const float4*>(q + frame(s) + pq[i] * ld + 32 * c + 4 * t));
      acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // the box of both windows in a frame: rows h0 .. h1, columns w0 .. w1
  const int h0 = max(min(hq[0], hq[1]) - eh, 0), h1 = min(max(hq[0], hq[1]) + eh, H - 1);
  const int w0 = max(min(wq[0], wq[1]) - ew, 0), w1 = min(max(wq[0], wq[1]) + ew, W - 1);
  const int nc = w1 - w0 + 1;

  // step i's K and V rows (those of the band) into stage i % kStages, one
  // group of copies
  auto issue = [&](int i) {
    if (i < steps) {
      const int f = fa + rank + C * (i / tiles), t0 = band.lo + i % tiles * kKeys;
      const int n = min(kKeys, band.hi - t0) * (D / 4);  // 16-byte chunks
      float* stage = Ks + (i % kStages) * 2 * kKeys * L;
      const float* kf = k + frame(f) + t0 * ld;
      const float* vf = v + frame(f) + t0 * ld;
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int r = j / (D / 4), c = j % (D / 4) * 4;
        mma::cp_async16(stage + r * L + c, kf + r * ld + c, true);
        mma::cp_async16(stage + (kKeys + r) * L + c, vf + r * ld + c, true);
      }
    }
    mma::cp_async_commit();
  };
  if (kStages == 2) issue(0);
  for (int it = 0; it < steps; ++it) {
    const int t0 = band.lo + it % tiles * kKeys, t1 = min(t0 + kKeys, band.hi);
    issue(kStages == 2 ? it + 1 : it);
    mma::cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* Kt = Ks + (it % kStages) * 2 * kKeys * L;
    const float* Vt = Kt + kKeys * L;
    // the box's keys in [t0, t1) are its keys ia .. ib - 1 in row-major
    // order: positions rise with the index
    int ia = 0, ib = 0;
    for (int hk = h0; hk <= h1; ++hk) {
      ia += min(max(t0 - hk * W - w0, 0), nc);
      ib += min(max(t1 - hk * W - w0, 0), nc);
    }
    int ch = h0 + ia / nc, cw = w0 + ia % nc;  // key ia's row and column
    // the warp walks its groups' keys together (the sums shuffle across
    // the warp): as many batches as its group with the most keys, the
    // others' surplus keys masked
    const int n = __reduce_max_sync(0xffffffffu, ib - ia);
    for (int i = 0; i < n; i += kBatch) {
      const int i0 = ia + i;
      int row[kBatch];
      float sc[2][kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool key = i0 + u < ib;
        row[u] = key ? ch * W + cw - t0 : 0;
        bool in[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) in[j] = key && abs(ch - hq[j]) <= eh && abs(cw - wq[j]) <= ew;
        if (++cw > w1) cw = w0, ++ch;
        const float* kp = Kt + row[u] * L + 4 * t;
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 kk = *reinterpret_cast<const float4*>(kp + 32 * c);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            part[j] = fmaf(qv[j][c].x, kk.x, part[j]);
            part[j] = fmaf(qv[j][c].y, kk.y, part[j]);
            part[j] = fmaf(qv[j][c].z, kk.z, part[j]);
            part[j] = fmaf(qv[j][c].w, kk.w, part[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float dot = group_sum8(part[j]);  // every lane: the shuffles span the warp
          sc[j][u] = in[j] ? __fmul_rn(dot, scale) : -INFINITY;
        }
      }
      // a query may have no key yet (a batch past its keys, or its keys in
      // another step): its max stays -inf and exp is taken against 0
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mb = m[j];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) mb = fmaxf(mb, sc[j][u]);
        const float base = mb == -INFINITY ? 0.f : mb;
        const float corr = __expf(m[j] - base);  // 0 while m = -inf
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          sc[j][u] = __expf(__fsub_rn(sc[j][u], base));  // 0 outside the window
          ps += sc[j][u];
        }
        l[j] = l[j] * corr + ps;
        m[j] = mb;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          acc[j][c].x *= corr;
          acc[j][c].y *= corr;
          acc[j][c].z *= corr;
          acc[j][c].w *= corr;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i0 + u >= ib) continue;
        const float* vp = Vt + row[u] * L + 4 * t;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vp + 32 * c);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[j][c].x = fmaf(sc[j][u], vv.x, acc[j][c].x);
            acc[j][c].y = fmaf(sc[j][u], vv.y, acc[j][c].y);
            acc[j][c].z = fmaf(sc[j][u], vv.z, acc[j][c].z);
            acc[j][c].w = fmaf(sc[j][u], vv.w, acc[j][c].w);
          }
        }
      }
    }
    __syncthreads();  // every group is done with the stage before it is refilled
  }

  if (active == 1) {  // the CTA saw the whole window: out = acc / l
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (p0 + 2 * g + j >= p1) continue;
      const float inv = __frcp_rn(l[j]);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        *reinterpret_cast<float4*>(out + frame(s) + pq[j] * ld + 32 * c + 4 * t) =
            make_float4(__fmul_rn(acc[j][c].x, inv), __fmul_rn(acc[j][c].y, inv),
                        __fmul_rn(acc[j][c].z, inv), __fmul_rn(acc[j][c].w, inv));
    }
    return;
  }
  // the merge: this CTA's rows of P V where K was, their (m, l) where V was
  float* part = Ks;
  float* stat_m = Vs;
  float* stat_l = stat_m + kTileQ;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      *reinterpret_cast<float4*>(part + (2 * g + j) * L + 32 * c + 4 * t) = acc[j][c];
    if (t == 0) {
      stat_m[2 * g + j] = m[j];
      stat_l[2 * g + j] = l[j];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's partials are in its shared memory
  // this CTA's rows [r0, r1) of the tile. First each row's weights: the
  // CTAs' w_j = exp(m_j - m) in rank order, m the max of their m_j, and
  // 1 / l, l = sum_j l_j w_j (a CTA that saw none of the row's keys has
  // m_j = -inf and weighs 0; every row in the frame has its own key in
  // frame s); then out = (sum_j acc_j w_j) / l, 4 columns a thread, every
  // CTA's values loaded at once
  const int r0 = rank * kTileQ / active, r1 = min((rank + 1) * kTileQ / active, p1 - p0);
  constexpr int kW = kClusterMax + 1;  // a row's weights and 1 / l
  float* wts = stat_l + kTileQ;
  for (int row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    float mj[kClusterMax], lj[kClusterMax];
#pragma unroll
    for (int j = 0; j < kClusterMax; ++j) {
      mj[j] = j < active ? *cluster.map_shared_rank(stat_m + row, j) : -INFINITY;
      lj[j] = j < active ? *cluster.map_shared_rank(stat_l + row, j) : 0.f;
    }
    float mx = -INFINITY, lx = 0.f;
#pragma unroll
    for (int j = 0; j < kClusterMax; ++j) mx = fmaxf(mx, mj[j]);
#pragma unroll
    for (int j = 0; j < kClusterMax; ++j) {
      const float w = __expf(mj[j] - mx);  // 0 where m_j = -inf
      wts[row * kW + j] = w;
      lx = fmaf(lj[j], w, lx);
    }
    wts[row * kW + kClusterMax] = __frcp_rn(lx);
  }
  __syncthreads();
  const float* parts[kClusterMax];
#pragma unroll
  for (int j = 0; j < kClusterMax; ++j) parts[j] = cluster.map_shared_rank(part, j < active ? j : 0);
  constexpr int kQuads = D / 4;
  for (int i = threadIdx.x; i < (r1 - r0) * kQuads; i += blockDim.x) {
    const int row = r0 + i / kQuads, c4 = i % kQuads * 4;
    float4 x[kClusterMax];
#pragma unroll
    for (int j = 0; j < kClusterMax; ++j)
      if (j < active) x[j] = *reinterpret_cast<const float4*>(parts[j] + row * L + c4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kClusterMax; ++j) {
      if (j >= active) continue;
      const float w = wts[row * kW + j];
      a.x = fmaf(x[j].x, w, a.x);
      a.y = fmaf(x[j].y, w, a.y);
      a.z = fmaf(x[j].z, w, a.z);
      a.w = fmaf(x[j].w, w, a.w);
    }
    const float inv = wts[row * kW + kClusterMax];
    *reinterpret_cast<float4*>(out + frame(s) + (long long)(p0 + row) * ld + c4) =
        make_float4(__fmul_rn(a.x, inv), __fmul_rn(a.y, inv), __fmul_rn(a.z, inv),
                    __fmul_rn(a.w, inv));
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B, int S,
                       int H, int W, int heads, int dh, int es, int eh, int ew,
                       cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)dh);
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(out);
  const dim3 grid(wmz::blocks_for(B, S, H, W, heads));
  const dim3 block(kWarpsPerBlock * 32);
#define WMZ_L3D_CASE(EE)                                                   \
  case EE:                                                                 \
    wmz::note_launch(local3d_fwd_kernel<float, EE>);                       \
    local3d_fwd_kernel<float, EE><<<grid, block, 0, stream>>>(             \
        qq, kk, vv, oo, B, S, H, W, heads, es, eh, ew, scale);             \
    break;
  WMZ_L3D_E_SWITCH(dh, WMZ_L3D_CASE)
#undef WMZ_L3D_CASE
  return cudaGetLastError();
}

template <bool kDivideAfter>
cudaError_t launch_round(const void* q, const void* k, const void* v, void* out, int B,
                         int S, int H, int W, int heads, int dh, int es, int eh, int ew,
                         cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)dh);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const dim3 grid(wmz::blocks_for(B, S, H, W, heads));
  const dim3 block(kWarpsPerBlock * 32);
#define WMZ_L3D_CASE(EE)                                                   \
  case EE:                                                                 \
    wmz::note_launch(local3d_fwd_round_kernel<EE, kDivideAfter>);           \
    local3d_fwd_round_kernel<EE, kDivideAfter><<<grid, block, 0, stream>>>( \
        qq, kk, vv, oo, B, S, H, W, heads, es, eh, ew, scale);             \
    break;
  WMZ_L3D_E_SWITCH(dh, WMZ_L3D_CASE)
#undef WMZ_L3D_CASE
  return cudaGetLastError();
}

template <int D, int kWarps, int kGroups, bool kDivideAfter>
cudaError_t launch_groups(const void* q, const void* k, const void* v, void* out, int B,
                          int S, int H, int W, int heads, int es, int eh, int ew,
                          cudaStream_t stream) {
  const size_t bytes = wmz::l3d::fwd_smem_bytes<D, kWarps, kGroups>();
  auto kernel = local3d_fwd_mma_kernel<D, kWarps, kGroups, kDivideAfter>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((H * W + 16 * kWarps - 1) / (16 * kWarps)), (unsigned)S,
                  (unsigned)(B * heads));
  wmz::note_launch(kernel);
  kernel<<<grid, 32 * kWarps * kGroups, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, W, heads, es, eh, ew,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// The places of a launch of local3d_fwd_cluster_kernel<D, kStages>: the
// clusters of c that fit on the card at once, c = 1 .. kClusterMax (0
// where none does), asked of the occupancy API once a device.
template <int D, int kStages>
cudaError_t cluster_fits(int device, const int*& fits) {
  static int table[64][kClusterMax + 1];
  static uint64_t asked = 0;  // bit d: device d's row is filled
  if (device >= 64) return cudaErrorInvalidDevice;
  fits = table[device];
  if (asked & (uint64_t(1) << device)) return cudaSuccess;
  auto kernel = local3d_fwd_cluster_kernel<D, kStages>;
  constexpr size_t bytes = cluster_smem_bytes<D, kStages>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kTileQ / 2 * kLanesQ);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  for (int c = 1; c <= kClusterMax && err == cudaSuccess; ++c) {
    cfg.gridDim = dim3((unsigned)c);
    cluster.val.clusterDim.x = (unsigned)c;
    err = cudaOccupancyMaxActiveClusters(&table[device][c], kernel, &cfg);
  }
  if (err == cudaSuccess) asked |= uint64_t(1) << device;
  return err;
}

template <int D, int kStages>
cudaError_t launch_cluster_stages(const void* q, const void* k, const void* v, void* out,
                                  long long ctas, int C, int S, int H, int W, int heads, int es,
                                  int eh, int ew, cudaStream_t stream) {
  auto kernel = local3d_fwd_cluster_kernel<D, kStages>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(kTileQ / 2 * kLanesQ);
  cfg.dynamicSmemBytes = cluster_smem_bytes<D, kStages>();
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)C;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  wmz::note_launch(kernel);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(q),
                            static_cast<const float*>(k), static_cast<const float*>(v),
                            static_cast<float*>(out), S, H, W, heads, es, eh, ew,
                            1.0f / sqrtf((float)D), C);
}

// The plan of a launch of local3d_fwd_cluster_kernel: cluster size C and
// stages. Where the CTAs that have a frame fit one an SM at C = 1, C is the
// largest (1 .. min(frames of a window, 8)) at which they still do, with
// two stages: each CTA has its SM, and the next step's K and V land while
// a step is taken. Otherwise one stage, and C takes the fewest waves (those
// CTAs over the places of the clusters of C that the card holds at once)
// times the longest CTA's chain: ceil(frames / C) frames of `tiles` steps,
// and the merge, counted as one step where C > 1; the larger C where two
// tie.
struct ClusterPlan {
  int key[9];  // device, B, S, H, W, heads, es, eh, ew
  int C, stages;
};

template <int D>
cudaError_t plan_cluster(ClusterPlan& plan) {
  const int device = plan.key[0], B = plan.key[1], S = plan.key[2], H = plan.key[3],
            W = plan.key[4], heads = plan.key[5], es = plan.key[6], eh = plan.key[7];
  const int *fits1 = nullptr, *fits2 = nullptr;
  cudaError_t err = cluster_fits<D, 1>(device, fits1);
  if (err == cudaSuccess) err = cluster_fits<D, 2>(device, fits2);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long per_s = (long long)B * heads * ((H * W + kTileQ - 1) / kTileQ);  // tiles a frame
  const int rows = std::min((kTileQ + W - 1) / W + 1 + 2 * std::min(eh, H), H);
  const int tiles = (rows * W + step_keys<1>() - 1) / step_keys<1>();
  const int nf = std::min(2 * std::min(es, S) + 1, S);
  // the CTAs with a frame at cluster size c (the others leave at once), and
  // the most frames one takes
  auto busy = [&](int c, int* chain) {
    long long n = 0;
    *chain = 0;
    for (int s = 0; s < S; ++s) {
      const int f = std::min(s + es, S - 1) - std::max(s - es, 0) + 1;
      n += std::min(c, f) * per_s;
      *chain = std::max(*chain, (f + c - 1) / c);
    }
    return n;
  };
  int C = 1, chain = 0, stages = 1;
  if (busy(1, &chain) <= sms && fits2[1] >= sms) {
    stages = 2;
    for (int c = 2; c <= std::min(nf, kClusterMax); ++c) {
      int ch = 0;
      if (fits2[c] > 0 && busy(c, &ch) <= (long long)fits2[c] * c && busy(c, &ch) <= sms) C = c;
    }
  } else {
    long long best = -1;
    for (int c = 1; c <= std::min(nf, kClusterMax); ++c) {
      if (fits1[c] == 0) continue;  // a cluster of c does not fit
      int ch = 0;
      const long long n = busy(c, &ch);
      const long long waves = (n + (long long)fits1[c] * c - 1) / ((long long)fits1[c] * c);
      const long long cost = waves * (ch * tiles + (c > 1));
      if (best < 0 || cost <= best) best = cost, C = c;
    }
  }
  plan.C = C;
  plan.stages = stages;
  return cudaSuccess;
}

// Launches local3d_fwd_cluster_kernel<D, stages> as plan_cluster plans it.
// Each host thread keeps the plans of the last kPlans shapes it launched,
// so a shape launched again (4,800 times a rollout batch) is planned once.
template <int D>
cudaError_t launch_cluster(const void* q, const void* k, const void* v, void* out, int B, int S,
                           int H, int W, int heads, int es, int eh, int ew, cudaStream_t stream) {
  constexpr int kPlans = 8;
  thread_local ClusterPlan plans[kPlans];
  thread_local int filled = 0, next = 0;
  ClusterPlan want = {{0, B, S, H, W, heads, es, eh, ew}, 0, 0};
  cudaError_t err = cudaGetDevice(&want.key[0]);
  if (err != cudaSuccess) return err;
  const ClusterPlan* plan = nullptr;
  for (int i = 0; i < filled && !plan; ++i)
    if (std::equal(want.key, want.key + 9, plans[i].key)) plan = &plans[i];
  if (!plan) {
    err = plan_cluster<D>(want);
    if (err != cudaSuccess) return err;
    plans[next] = want;
    plan = &plans[next];
    next = (next + 1) % kPlans;
    filled = std::min(filled + 1, kPlans);
  }
  const long long ctas = (long long)B * heads * ((H * W + kTileQ - 1) / kTileQ) * S * plan->C;
  if (plan->stages == 2)
    return launch_cluster_stages<D, 2>(q, k, v, out, ctas, plan->C, S, H, W, heads, es, eh, ew,
                                       stream);
  return launch_cluster_stages<D, 1>(q, k, v, out, ctas, plan->C, S, H, W, heads, es, eh, ew,
                                     stream);
}

// The block's shape: wmz::l3d::fwd_shape.
template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S,
                       int H, int W, int heads, int es, int eh, int ew, int divide_after,
                       cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const wmz::l3d::FwdShape shape = wmz::l3d::fwd_shape(B, S, H, W, heads, eh, sms);
#define WMZ_L3D_SHAPE(QW, G)                                                           \
  return divide_after ? launch_groups<D, QW, G, true>(q, k, v, out, B, S, H, W, heads, es, \
                                                      eh, ew, stream)                  \
                      : launch_groups<D, QW, G, false>(q, k, v, out, B, S, H, W, heads, es, \
                                                       eh, ew, stream)
  if (shape.warps == 4) {
    if (shape.groups == 2) WMZ_L3D_SHAPE(4, 2);
    WMZ_L3D_SHAPE(4, 1);
  }
  if (shape.groups == 2) WMZ_L3D_SHAPE(2, 2);
  WMZ_L3D_SHAPE(2, 1);
#undef WMZ_L3D_SHAPE
}

}  // namespace

// The kernel follows dtype and dh: float32 takes the cluster kernel at dh
// = 64 and 128 and the one-warp-a-query kernel at the other head sizes,
// both with P in f32; bfloat16 the tensor-core kernel at dh = 64 and 128 and the
// rounding CUDA-core kernel at the other head sizes, both rounding P
// before P V and dividing by the sum after it (divide_after = 1) or
// rounding P / l (0). dtype: 0 = float32, 1 = bfloat16. Returns the
// launch's cudaError_t.
extern "C" int wmz_local3d_fwd(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int W,
                               int heads, int dh, int es, int eh, int ew,
                               int divide_after, int dtype, void* stream) {
  if (wmz::bad_dh(dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (dh == 64) return (int)launch_cluster<64>(q, k, v, out, B, S, H, W, heads, es, eh, ew, st);
    if (dh == 128) return (int)launch_cluster<128>(q, k, v, out, B, S, H, W, heads, es, eh, ew, st);
    return (int)launch_f32(q, k, v, out, B, S, H, W, heads, dh, es, eh, ew, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)launch_mma<64>(q, k, v, out, B, S, H, W, heads, es, eh, ew, divide_after, st);
  if (dh == 128)
    return (int)launch_mma<128>(q, k, v, out, B, S, H, W, heads, es, eh, ew, divide_after, st);
  if (divide_after)
    return (int)launch_round<true>(q, k, v, out, B, S, H, W, heads, dh, es, eh, ew, st);
  return (int)launch_round<false>(q, k, v, out, B, S, H, W, heads, dh, es, eh, ew, st);
}

// Local-3D windowed attention, backward, for Hopper (sm_90a): a split pair
// of kernels, a query-centric dQ pass and a key-centric dK/dV pass.
//
// Replaces the TPU backward kernels of world_modelz_tpu/kernels/local3d.py
// that `_route_bwd` (:1535) picks among under the custom_vjp of
// `local3d_attention_pallas`: `_bwd_kernel_allframes` (:665), `_bwd_kernel`
// (:1565), the split pair `_bwd_kernel_dq` (:1183) and `_bwd_kernel_dkv`
// (:1261) of `_bwd_impl_split` (:1377), and `_bwd_kernel_tiled` (:999).
// The five exist to fit the TPU's VMEM; on the GPU one split pair covers
// every shape, needs no atomics and no partial slabs in device memory, and
// so is deterministic.
//
// What it computes. q, k, v, g (the output's cotangent), dq, dk, dv are
// (B, S, H, W, heads * dh), contiguous; lse and delta are (B, S, H, W,
// heads) f32. The window is the forward's (local3d_window.cuh): query i
// sees the keys j with |ds| <= es inside the clip, |dh| <= eh and |dw| <=
// ew inside the frame. It is symmetric, so the queries that see key j are
// exactly the window of j. With s_ij = scale * q_i . k_j, P_ij the softmax
// of s_i. over i's window, dP_ij = g_i . v_j:
//   pass 1, per query i: lse_i = m_i + log l_i, delta_i = sum_j P_ij dP_ij,
//     dS_ij = P_ij (dP_ij - delta_i), dq_i = scale * sum_j dS_ij k_j;
//   pass 2, per key j, over the queries i of its window: P_ij = e^{s_ij -
//     lse_i}, dv_j = sum_i P_ij g_i, dk_j = scale * sum_i dS_ij q_i.
//
// Where bf16 rounds. Every TPU backward rounds the normalised P and dS to
// the operand dtype before their products (`_bwd_kernel_allframes`
// :709-710, `_bwd_kernel` :1610-1611, `_bwd_kernel_tiled` :1053-1054,
// `_bwd_kernel_dq` :1225, `_bwd_kernel_dkv` :1301-1308, which rebuilds P as
// e^{s - lse}) and applies the scale after the product; so do these
// kernels. dK and dV are one f32 sum per key, rounded once, on the
// all-frames and split routes; the per-frame kernel stores each query
// frame's partial at the operand dtype (`_part_dtype` :49) and its fold
// (:1688) adds them in f32, the H-tiled kernel each query frame's and H
// tile's (fold :1131). Pass 2 takes that as `partial_rows` (0: one sum;
// else the query rows of a frame per rounded partial), which the caller
// gets from kernels/local3d.py:bwd_route. f32 rounds nowhere.
//
// What bounds it on the H100. At the training shape (B=64, S=6, 8x8 grid,
// dh=128, extents (3,1,1)) in bf16 one (B, S, H, W, 128) tensor is 6.29 MB:
// pass 1 reads q, k, v, g and writes dq, lse, delta (~31 MB, 9.449 us at
// 3.35 TB/s), pass 2 reads q, k, v, g, lse, delta and writes dk, dv (~38
// MB, 11.327 us). The window holds ~0.93 M (query, key) pairs per launch,
// 6-8 dh-long products each: ~1 GFLOP, ~1 us at the bf16 tensor-core peak.
// Both are bound by bytes. What the tensor-core kernels execute is dense
// 64 x 64 tiles: each 64-row block against each 64-position tile of the
// other side's band in each frame of its window (pass 1: 5 products a
// tile over its two sweeps, ~10.1 GFLOP; pass 2: 4, ~8.1 GFLOP), and what
// bounds them on the card is each step's chain: waiting for its staged
// tiles, the products, the exponentials between them.
//
// Design, bf16 at dh = 64 and 128: warpgroup products (wgmma.cuh:
// wgmma.mma_async on 128-byte swizzled tiles, tiles staged by the tensor
// memory accelerator onto an mbarrier a stage) over local3d_mma.cuh's
// window (`key_band`, `in_window`). A block is one warpgroup of 64 rows:
// 64 positions of one frame, or 32 positions of two consecutive frames
// where 64 positions' band would not fit one 64-position tile (16 x 16
// frames), so that a frame's band is one tile; warp w holds rows 16 w ..
// 16 w + 15 in mma.sync's fragment layout, and P and dS, rounded pairwise
// to bf16, are the register A operand of the next product (to_a_frags).
// The window bits are worked out once where the band is one tile; a row's
// frame outside a tile's frame window masks the whole row.
//   Pass 1 walks the window twice: sweep 1 takes S = Q K^T and dP = G V^T
//   and keeps an online max m, sum l and D = sum e^{s - m} dP per query
//   (rescaled as m moves; delta = D / l, within f32 ulps of the TPU's sum
//   of P dP), sweep 2 takes them again, forms P = e^{s - m} / l and dS = P
//   (dP - delta) and adds dS K. Q and G are shared tiles; K and V tiles
//   pass through three stages at dh 64, two at dh 128 (two blocks an SM).
//   Pass 2, per query tile: S^T = K Q^T, P^T = e^{S^T - lse} under the
//   window, dP^T = V G^T, dS^T = P^T (dP^T - delta); dV += P^T G and dK +=
//   dS^T Q, with G and Q read transposed (MN-major) from the same tiles.
//   Two stages; 8-column groups that no row of a warp sees skip their
//   exponentials (half of them at 8 x 8 frames). Where partials are
//   rounded (kPartial), a segment's tiles start at its first query row,
//   and at its end each thread adds its rounded partial to an f32 total
//   in shared memory that only it touches.
// Design, bf16 at the other head sizes: CUDA cores, one warp per query
// (pass 1) or key (pass 2), four groups of eight lanes each taking every
// fourth row of the window (local3d_window.cuh). Pass 1 walks the window
// twice as above (the online algebra of the f32 kernel never forms dS);
// pass 2 rounds P and dS per row and, with partials, merges the groups and
// rounds at each segment's end.
// Design, f32: the same CUDA-core layout in one walk each. Pass 1 keeps
// an online softmax per group: running max m, l = sum e^{s-m}, D = sum
// e^{s-m} dp, A = sum e^{s-m} dp k and Bk = sum e^{s-m} k, merged across
// groups by shuffles at the end; then delta = D / l and dq = scale * (A -
// delta * Bk) / l. Pass 2 rebuilds p from the saved lse.
// Every kernel sums in a fixed order: two launches are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"
#include "launch_log.cuh"
#include "local3d_mma.cuh"
#include "local3d_window.cuh"
#include "vec.cuh"
#include "wgmma.cuh"

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

// ----------------------------------------------------------------- f32
// Pass 1: dq, lse, delta. E: elements per lane, dh = kGroupLanes * E.
template <int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
local3d_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      float* __restrict__ dq, float* __restrict__ lse,
                      float* __restrict__ delta, int B, int S, int H, int W,
                      int heads, int es, int eh, int ew, float scale) {
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

  float qr[E], gr[E], a[E], bk[E];
  {
    const long long o = elems(query);
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(q + o + e);
      const float4 y = load4(g + o + e);
      qr[e] = x.x * scale;
      qr[e + 1] = x.y * scale;
      qr[e + 2] = x.z * scale;
      qr[e + 3] = x.w * scale;
      gr[e] = y.x;
      gr[e + 1] = y.y;
      gr[e + 2] = y.z;
      gr[e + 3] = y.w;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = bk[e] = 0.f;
  float m = -INFINITY, l = 0.f, d = 0.f;

  for (int i0 = 0; i0 < c.n; i0 += kGroups) {
    const int i = i0 + group;
    const bool valid = i < c.n;
    const long long o = elems(window_row(c, valid ? i : 0, S, H, W, heads));
    float kr[E];
    float sc = 0.f, dp = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(k + o + e);
      const float4 y = load4(v + o + e);
      kr[e] = x.x;
      kr[e + 1] = x.y;
      kr[e + 2] = x.z;
      kr[e + 3] = x.w;
      sc = fmaf(qr[e], x.x, sc);
      sc = fmaf(qr[e + 1], x.y, sc);
      sc = fmaf(qr[e + 2], x.z, sc);
      sc = fmaf(qr[e + 3], x.w, sc);
      dp = fmaf(gr[e], y.x, dp);
      dp = fmaf(gr[e + 1], y.y, dp);
      dp = fmaf(gr[e + 2], y.z, dp);
      dp = fmaf(gr[e + 3], y.w, dp);
    }
    sc = group_sum(sc);
    dp = group_sum(dp);
    if (valid) {
      const float m_new = fmaxf(m, sc);
      const float corr = expf(m - m_new);  // 0 on the first row (m = -inf)
      const float p = expf(sc - m_new);
      const float pd = p * dp;
      l = fmaf(l, corr, p);
      d = fmaf(d, corr, pd);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        a[e] = fmaf(pd, kr[e], a[e] * corr);
        bk[e] = fmaf(p, kr[e], bk[e] * corr);
      }
      m = m_new;
    }
  }

  // merge the groups' states: lanes t, t+8, t+16, t+24 hold the same
  // elements. A group that saw no row has m = -inf and weighs 0.
#pragma unroll
  for (int off = kGroupLanes; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float d_o = __shfl_xor_sync(0xffffffffu, d, off);
    const float m_new = fmaxf(m, m_o);
    const float ca = m == -INFINITY ? 0.f : expf(m - m_new);
    const float cb = m_o == -INFINITY ? 0.f : expf(m_o - m_new);
    l = l * ca + l_o * cb;
    d = d * ca + d_o * cb;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float a_o = __shfl_xor_sync(0xffffffffu, a[e], off);
      const float b_o = __shfl_xor_sync(0xffffffffu, bk[e], off);
      a[e] = a[e] * ca + a_o * cb;
      bk[e] = bk[e] * ca + b_o * cb;
    }
    m = m_new;
  }

  if (group == 0) {
    const float inv = 1.f / l;
    const float dl = d * inv;  // delta = sum_j p_j dp_j
    const float f = scale * inv;
    float* op = dq + elems(query);
#pragma unroll
    for (int e = 0; e < E; e += 4)
      store4(op + e, make_float4(f * fmaf(-dl, bk[e], a[e]),
                                 f * fmaf(-dl, bk[e + 1], a[e + 1]),
                                 f * fmaf(-dl, bk[e + 2], a[e + 2]),
                                 f * fmaf(-dl, bk[e + 3], a[e + 3])));
    if (t == 0) {
      lse[query] = m + logf(l);
      delta[query] = dl;
    }
  }
}

// Pass 2: dk, dv from the saved lse and delta.
template <int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
local3d_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dk,
                       float* __restrict__ dv, int B, int S, int H, int W,
                       int heads, int es, int eh, int ew, float scale) {
  constexpr int dh = kGroupLanes * E;
  const int lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes;
  const int t = lane % kGroupLanes;
  const long long key =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (key >= (long long)B * S * H * W * heads) return;  // whole warps
  const Window c = window_of(key, S, H, W, heads, es, eh, ew);
  // element offset of a row's lane slice
  auto elems = [&](long long row) -> long long { return row * dh + t * E; };

  float kr[E], vr[E], dka[E], dva[E];
  {
    const long long o = elems(key);
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(k + o + e);
      const float4 y = load4(v + o + e);
      kr[e] = x.x * scale;
      kr[e + 1] = x.y * scale;
      kr[e + 2] = x.z * scale;
      kr[e + 3] = x.w * scale;
      vr[e] = y.x;
      vr[e + 1] = y.y;
      vr[e + 2] = y.z;
      vr[e + 3] = y.w;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) dka[e] = dva[e] = 0.f;

  for (int i0 = 0; i0 < c.n; i0 += kGroups) {
    const int i = i0 + group;
    const bool valid = i < c.n;
    const long long row = window_row(c, valid ? i : 0, S, H, W, heads);
    const long long o = elems(row);
    const float row_lse = lse[row];
    const float row_delta = delta[row];
    float qr[E], gr[E];
    float sc = 0.f, dp = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(q + o + e);
      const float4 y = load4(g + o + e);
      qr[e] = x.x;
      qr[e + 1] = x.y;
      qr[e + 2] = x.z;
      qr[e + 3] = x.w;
      gr[e] = y.x;
      gr[e + 1] = y.y;
      gr[e + 2] = y.z;
      gr[e + 3] = y.w;
      sc = fmaf(kr[e], x.x, sc);
      sc = fmaf(kr[e + 1], x.y, sc);
      sc = fmaf(kr[e + 2], x.z, sc);
      sc = fmaf(kr[e + 3], x.w, sc);
      dp = fmaf(vr[e], y.x, dp);
      dp = fmaf(vr[e + 1], y.y, dp);
      dp = fmaf(vr[e + 2], y.z, dp);
      dp = fmaf(vr[e + 3], y.w, dp);
    }
    sc = group_sum(sc);
    dp = group_sum(dp);
    if (valid) {
      const float p = expf(sc - row_lse);
      const float ds = p * (dp - row_delta);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dva[e] = fmaf(p, gr[e], dva[e]);
        dka[e] = fmaf(ds, qr[e], dka[e]);
      }
    }
  }

  // sum the four groups' partials (same elements on lanes t + 8j)
#pragma unroll
  for (int off = kGroupLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dka[e] += __shfl_xor_sync(0xffffffffu, dka[e], off);
      dva[e] += __shfl_xor_sync(0xffffffffu, dva[e], off);
    }
  }

  if (group == 0) {
    const long long o = elems(key);
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      store4(dk + o + e, make_float4(dka[e] * scale, dka[e + 1] * scale,
                                     dka[e + 2] * scale, dka[e + 3] * scale));
      store4(dv + o + e,
             make_float4(dva[e], dva[e + 1], dva[e + 2], dva[e + 3]));
    }
  }
}


// ------------------------------------------------------- bf16, CUDA cores
// The other head sizes: P and dS rounded to bf16 before their products.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// sum over the kGroups groups of a warp (lanes t, t+8, t+16, t+24 hold the
// same elements); every group gets the sum
template <int E>
__device__ __forceinline__ void groups_sum(float x[E]) {
#pragma unroll
  for (int off = kGroupLanes; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] += __shfl_xor_sync(0xffffffffu, x[e], off);
}

// Pass 1: two walks of the window. E: elements per lane, dh = 8 E.
template <int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
local3d_bwd_dq_round_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ g,
                            bf16* __restrict__ dq, float* __restrict__ lse,
                            float* __restrict__ delta, int B, int S, int H, int W,
                            int heads, int es, int eh, int ew, float scale) {
  constexpr int dh = kGroupLanes * E;
  const int lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes;
  const int t = lane % kGroupLanes;
  const long long query = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (query >= (long long)B * S * H * W * heads) return;  // whole warps
  const Window c = window_of(query, S, H, W, heads, es, eh, ew);
  auto elems = [&](long long row) -> long long { return row * dh + t * E; };

  float qr[E], gr[E], a[E];
  {
    const long long o = elems(query);
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(q + o + e);
      const float4 y = load4(g + o + e);
      qr[e] = x.x, qr[e + 1] = x.y, qr[e + 2] = x.z, qr[e + 3] = x.w;
      gr[e] = y.x, gr[e + 1] = y.y, gr[e + 2] = y.z, gr[e + 3] = y.w;
    }
  }
  // the scaled score and dP of window row i (all lanes), and its k row
  auto row = [&](int i, float kr[E], float& sc, float& dp) {
    const long long o = elems(window_row(c, i, S, H, W, heads));
    sc = 0.f, dp = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(k + o + e);
      const float4 y = load4(v + o + e);
      kr[e] = x.x, kr[e + 1] = x.y, kr[e + 2] = x.z, kr[e + 3] = x.w;
      sc = fmaf(qr[e], x.x, sc);
      sc = fmaf(qr[e + 1], x.y, sc);
      sc = fmaf(qr[e + 2], x.z, sc);
      sc = fmaf(qr[e + 3], x.w, sc);
      dp = fmaf(gr[e], y.x, dp);
      dp = fmaf(gr[e + 1], y.y, dp);
      dp = fmaf(gr[e + 2], y.z, dp);
      dp = fmaf(gr[e + 3], y.w, dp);
    }
    sc = __fmul_rn(group_sum(sc), scale);
    dp = group_sum(dp);
  };

  // walk 1: online max m, l = sum e^{s-m}, D = sum e^{s-m} dP per group
  float m = -INFINITY, l = 0.f, d = 0.f;
  for (int i0 = 0; i0 < c.n; i0 += kGroups) {
    const int i = i0 + group;
    const bool valid = i < c.n;
    float kr[E], sc, dp;
    row(valid ? i : 0, kr, sc, dp);
    if (valid) {
      const float m_new = fmaxf(m, sc);
      const float corr = expf(m - m_new);  // 0 on the first row (m = -inf)
      const float p = expf(sc - m_new);
      l = fmaf(l, corr, p);
      d = fmaf(d, corr, p * dp);
      m = m_new;
    }
  }
#pragma unroll
  for (int off = kGroupLanes; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float d_o = __shfl_xor_sync(0xffffffffu, d, off);
    const float m_new = fmaxf(m, m_o);
    const float ca = m == -INFINITY ? 0.f : expf(m - m_new);
    const float cb = m_o == -INFINITY ? 0.f : expf(m_o - m_new);
    l = l * ca + l_o * cb;
    d = d * ca + d_o * cb;
    m = m_new;
  }
  const float inv = __frcp_rn(l), dl = d * inv;

  // walk 2: dS = P (dP - delta), rounded, into dq
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = 0.f;
  for (int i0 = 0; i0 < c.n; i0 += kGroups) {
    const int i = i0 + group;
    const bool valid = i < c.n;
    float kr[E], sc, dp;
    row(valid ? i : 0, kr, sc, dp);
    if (valid) {
      const float p = __fmul_rn(expf(sc - m), inv);
      const float ds = round_bf16(__fmul_rn(p, dp - dl));
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] = fmaf(ds, kr[e], a[e]);
    }
  }
  groups_sum<E>(a);
  if (group == 0) {
    bf16* op = dq + elems(query);
#pragma unroll
    for (int e = 0; e < E; e += 4)
      store4(op + e, make_float4(a[e] * scale, a[e + 1] * scale, a[e + 2] * scale,
                                 a[e + 3] * scale));
    if (t == 0) {
      lse[query] = m + logf(l);
      delta[query] = dl;
    }
  }
}

// Pass 2: P and dS rounded per row; with partial_rows > 0, the window's
// queries of each frame's tiles of partial_rows rows form a partial that
// is rounded before it joins the f32 total.
template <int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
local3d_bwd_dkv_round_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int B, int S, int H, int W, int heads,
                             int es, int eh, int ew, int partial_rows, float scale) {
  constexpr int dh = kGroupLanes * E;
  const int lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes;
  const int t = lane % kGroupLanes;
  const long long key = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (key >= (long long)B * S * H * W * heads) return;  // whole warps
  const Window c = window_of(key, S, H, W, heads, es, eh, ew);
  auto elems = [&](long long row) -> long long { return row * dh + t * E; };

  float kr[E], vr[E], dkp[E], dvp[E], dkt[E], dvt[E];
  {
    const long long o = elems(key);
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = load4(k + o + e);
      const float4 y = load4(v + o + e);
      kr[e] = x.x, kr[e + 1] = x.y, kr[e + 2] = x.z, kr[e + 3] = x.w;
      vr[e] = y.x, vr[e + 1] = y.y, vr[e + 2] = y.z, vr[e + 3] = y.w;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) dkp[e] = dvp[e] = dkt[e] = dvt[e] = 0.f;

  // window rows [ib, ie) into the partial sums
  auto walk = [&](int ib, int ie) {
    for (int i0 = ib; i0 < ie; i0 += kGroups) {
      const int i = i0 + group;
      const bool valid = i < ie;
      const long long row = window_row(c, valid ? i : ib, S, H, W, heads);
      const long long o = elems(row);
      float qr[E], gr[E];
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 x = load4(q + o + e);
        const float4 y = load4(g + o + e);
        qr[e] = x.x, qr[e + 1] = x.y, qr[e + 2] = x.z, qr[e + 3] = x.w;
        gr[e] = y.x, gr[e + 1] = y.y, gr[e + 2] = y.z, gr[e + 3] = y.w;
        sc = fmaf(kr[e], x.x, sc);
        sc = fmaf(kr[e + 1], x.y, sc);
        sc = fmaf(kr[e + 2], x.z, sc);
        sc = fmaf(kr[e + 3], x.w, sc);
        dp = fmaf(vr[e], y.x, dp);
        dp = fmaf(vr[e + 1], y.y, dp);
        dp = fmaf(vr[e + 2], y.z, dp);
        dp = fmaf(vr[e + 3], y.w, dp);
      }
      sc = __fmul_rn(group_sum(sc), scale);
      dp = group_sum(dp);
      if (valid) {
        const float p = expf(sc - lse[row]);
        const float ds = round_bf16(__fmul_rn(p, dp - delta[row]));
        const float pr = round_bf16(p);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dvp[e] = fmaf(pr, gr[e], dvp[e]);
          dkp[e] = fmaf(ds, qr[e], dkp[e]);
        }
      }
    }
  };

  if (partial_rows <= 0) {
    walk(0, c.n);
    groups_sum<E>(dkp);
    groups_sum<E>(dvp);
#pragma unroll
    for (int e = 0; e < E; ++e) dkt[e] = dkp[e] * scale, dvt[e] = dvp[e];
  } else {
    const int h1 = c.h0 + c.nhw / c.nw - 1, frames = c.n / c.nhw;
    for (int fs = 0; fs < frames; ++fs)
      for (int ht = c.h0 / partial_rows; ht <= h1 / partial_rows; ++ht) {
        const int ha = max(c.h0, ht * partial_rows);
        const int hb = min(h1, ht * partial_rows + partial_rows - 1);
        walk(fs * c.nhw + (ha - c.h0) * c.nw, fs * c.nhw + (hb - c.h0 + 1) * c.nw);
        groups_sum<E>(dkp);
        groups_sum<E>(dvp);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dkt[e] += round_bf16(dkp[e] * scale);
          dvt[e] += round_bf16(dvp[e]);
          dkp[e] = dvp[e] = 0.f;
        }
      }
  }
  if (group == 0) {
    const long long o = elems(key);
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      store4(dk + o + e, make_float4(dkt[e], dkt[e + 1], dkt[e + 2], dkt[e + 3]));
      store4(dv + o + e, make_float4(dvt[e], dvt[e + 1], dvt[e + 2], dvt[e + 3]));
    }
  }
}

// --------------------------------------------------- bf16, tensor cores
// dh = 64 and 128: warpgroup products and TMA staging (wgmma.cuh) over the
// window (local3d_mma.cuh).

namespace mma = wmz::mma;
namespace wg = wmz::wg;
using wmz::l3d::Band;
using wmz::l3d::kTileKeys;
constexpr int kRows = 64;  // a block's rows: one warpgroup's product
constexpr float kLn2 = 0.6931471805599453f;

// which of this lane's 16 x 64 scores lie in the window: bit 4 j + 2 i + c
// for rows gr + 8 i (positions (hr[i], wr[i])) and columns 8 j + 2 t + c
// from position c0; columns at or past c1 are out
__device__ __forceinline__ uint32_t window_bits(int c0, int c1, const int hr[2], const int wr[2],
                                                int W, int eh, int ew) {
  const int t = threadIdx.x & 3;
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kTileKeys / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int pk = c0 + 8 * j + 2 * t + c;
      if (pk >= c1) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (wmz::l3d::in_window(pk, hr[i], wr[i], W, eh, ew)) bits |= 1u << (4 * j + 2 * i + c);
    }
  return bits;
}

// strided f32 stats (lse, delta) of positions p0 .. p0 + kTileKeys - 1 ->
// dst; zero at or past p1
__device__ __forceinline__ void load_stats_async(float* dst, const float* __restrict__ src,
                                                 int stride, int p0, int p1) {
  for (int i = threadIdx.x; i < kTileKeys; i += blockDim.x) {
    const bool valid = p0 + i < p1;
    mma::cp_async4(dst + i, src + (valid ? (long long)(p0 + i) * stride : 0), valid);
  }
}

// the staged tiles have landed and, after the barrier, every warp's
// products may read them (cp.async writes through the generic proxy,
// wgmma reads through the async proxy)
__device__ __forceinline__ void tiles_landed() {
  mma::cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// 2^x (ex2.approx: __expf's own instruction, with the log2 e scaling
// folded into the caller's FMA)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// whether any lane of the warp has a score of 8-column group j in the
// window: groups that none has (half of them at 8 x 8 frames) skip their
// exponentials
__device__ __forceinline__ bool group_live(uint32_t bits, int j) {
  return __any_sync(0xffffffffu, bits >> (4 * j) & 0xFu);
}

// d (64 x D) += A B for 16-deep step kk of an MN-major tile of 64 rows
template <int D>
__device__ __forceinline__ void mma_rs_mn(float d[D / 8][4], const uint32_t a[4],
                                          const bf16* tile, int kk) {
  if constexpr (D == 128)
    wg::mma_rs_n128<1>(d, a, wg::desc_mn<kRows>(tile, kk), 1);
  else
    wg::mma_rs_n64<1>(d, a, wg::desc_mn<kRows>(tile, kk), 1);
}

// d (64 x 64) = A B^T over the depth D: A, B K-major tiles of 64 rows
template <int D>
__device__ __forceinline__ void mma_ss_rows(float d[kTileKeys / 8][4], const bf16* a,
                                            const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg::mma_ss_n64<0>(d, wg::desc_k<kRows>(a, kk), wg::desc_k<kTileKeys>(b, kk), kk > 0);
}

// The block's frames: one (64 positions of a frame), or two (32 positions
// of two consecutive frames) where 64 positions' band would not fit one
// 64-position tile (16 x 16 frames), so that a frame's band is one tile.
inline int block_frames(int H, int W, int eh) {
  const int rows64 = min((min(64, H * W) - 1) / W + 1 + 2 * eh, H);
  return rows64 * W <= kTileKeys ? 1 : 2;
}

// pass 1's stages of K and V tiles: as many as leave two blocks an SM
__host__ __device__ constexpr int dq_stages(int D) { return D == 128 ? 2 : 3; }

// 1,024-byte aligned start of the dynamic shared memory (the swizzle
// repeats every 1,024 bytes)
__device__ __forceinline__ bf16* aligned_smem(unsigned char* raw) {
  const uint32_t base = mma::smem_addr(raw);
  return reinterpret_cast<bf16*>(raw + (((base + 1023) & ~1023u) - base));
}

// Pass 1 on the tensor cores: dq, lse and delta of 64 / kFrames query
// positions of kFrames consecutive frames of one (b, head), one warpgroup:
// warp w holds rows 16 w .. 16 w + 15 (frame w * 16 / kOwn). Q and G stay
// in shared memory for every product; K and V tiles pass through a ring of
// stages, each step's tiles requested a step or two ahead: three stages at
// D = 64, two at D = 128 (96 KB, two blocks an SM). No register operand of
// a product outlives its step: ptxas 12.9 gave the registers of Q and G
// fragments held across the loop to sweep 2's exponentials and dS (the
// SASS of that form at D = 64), which made every tile after the first one
// of sweep 2 wrong.
template <int D, int kFrames>
__global__ void __launch_bounds__(128, 2)
local3d_bwd_dq_mma_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ g,
                          bf16* __restrict__ dq, float* __restrict__ lse,
                          float* __restrict__ delta, int S, int H, int W, int heads, int es,
                          int eh, int ew, float scale) {
  constexpr int kOwn = kRows / kFrames, kTile = kTileKeys * D;
  constexpr int kStages = dq_stages(D);
  extern __shared__ unsigned char smem_raw[];
  bf16* KV = aligned_smem(smem_raw);  // kStages stages of (K, V) tiles, swizzled
  bf16* Qs = KV + 2 * kStages * kTile;  // Q and G after the stages
  bf16* Gs = Qs + kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Gs + kTile);  // one a stage
  const int HW = H * W;
  const int s0 = blockIdx.y * kFrames, head = blockIdx.z % heads, b = blockIdx.z / heads;
  const int p0 = blockIdx.x * kOwn, p1 = min(p0 + kOwn, HW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int s = s0 + 16 * warp / kOwn, pw = p0 + 16 * warp % kOwn;  // this warp's frame, rows
  const bool mine = s < S;  // a frame past the clip only stages
  const long long ld = (long long)heads * D;  // elements between positions
  auto frame = [&](int f) { return ((long long)b * S + f) * HW * ld + head * D; };
  const Band band = wmz::l3d::key_band(p0, p1, H, W, eh);
  const int tiles = (band.hi - band.lo + kTileKeys - 1) / kTileKeys;
  const int f0 = max(s0 - es, 0);
  const int frames = min(min(s0 + kFrames - 1, S - 1) + es, S - 1) - f0 + 1;
  // the windows' tiles kt = 0 .. n - 1, frame by frame, each swept twice
  const int n = frames * tiles, steps = 2 * n;
  // thread 0 stages step i's K and V tiles (TMA); rows of a tile past the
  // band hold the next positions' keys, which the window masks
  auto issue = [&](int i) {
    bf16* stage = KV + i % kStages * 2 * kTile;
    uint64_t* bar = &bars[i % kStages];
    const int kt = i % n;
    const int row = ((b * S + f0 + kt / tiles) * HW) + band.lo + kt % tiles * kTileKeys;
    wg::mbar_expect_bytes(bar, 2 * kTile * sizeof(bf16));
    wg::tma_rows<D>(stage, &kmap, head * D, row, bar);
    wg::tma_rows<D>(stage + kTile, &vmap, head * D, row, bar);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) wg::mbar_init(&bars[i], 1);
    wg::mbar_init_fence();
  }
  for (int f = 0; f < kFrames; ++f) {  // a frame past the clip: zeros
    const int sf = min(s0 + f, S - 1), end = s0 + f < S ? p1 : p0;
    wg::load_rows_async<D, kRows>(Qs, q + frame(sf), ld, p0, end, f * kOwn, kOwn);
    wg::load_rows_async<D, kRows>(Gs, g + frame(sf), ld, p0, end, f * kOwn, kOwn);
  }
  mma::cp_async_commit();
  __syncthreads();  // the barriers are ready
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages - 1 && i < steps; ++i) issue(i);
  }
  tiles_landed();  // Q and G

  // this lane's query rows gr and gr + 8 of the warp's 16
  int hq[2], wq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pq = pw + gr + 8 * i;
    hq[i] = pq / W;
    wq[i] = pq - hq[i] * W;
  }
  // one tile's bits serve every frame where the band is one tile
  const uint32_t bits0 = tiles == 1 ? window_bits(band.lo, band.hi, hq, wq, W, eh, ew) : 0u;
  const float scale_log2 = scale * mma::kLog2e;
  float acc[D / 8][4];
  mma::zero<D / 8>(acc);
  // per row: the max m of the scaled scores times log2 e, l = sum e^{s - m},
  // D = sum e^{s - m} dP (sweep 2: m, 1 / l, delta)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};

  for (int it = 0; it < steps; ++it) {
    // every warp is done with step it - 1: refill its stage while this
    // step runs
    __syncthreads();
    if (threadIdx.x == 0 && it + kStages - 1 < steps) issue(it + kStages - 1);
    wg::mbar_wait(&bars[it % kStages], it / kStages & 1);
    const bf16* Ks = KV + it % kStages * 2 * kTile;
    const bf16* Vs = Ks + kTile;
    const int kt = it % n;
    const bool sweep2 = it >= n;
    // S = Q K^T and dP = G V^T for the block's 64 rows
    float sc[kTileKeys / 8][4], dp[kTileKeys / 8][4];
    wg::fence();
    mma_ss_rows<D>(sc, Qs, Ks);
    mma_ss_rows<D>(dp, Gs, Vs);
    wg::commit();
    wg::fence_regs<kTileKeys / 8>(sc);
    wg::fence_regs<kTileKeys / 8>(dp);
    wg::wait<0>();
    wg::fence_regs<kTileKeys / 8>(sc);
    wg::fence_regs<kTileKeys / 8>(dp);
    uint32_t bits = 0;
    if (mine && abs(f0 + kt / tiles - s) <= es)
      bits = tiles == 1 ? bits0
                        : window_bits(band.lo + kt % tiles * kTileKeys, band.hi, hq, wq, W, eh, ew);
    // scaled scores times log2 e, -inf outside the window
#pragma unroll
    for (int j = 0; j < kTileKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = bits >> (4 * j + e) & 1u ? sc[j][e] * scale_log2 : -INFINITY;
    if (!sweep2) {
      // fold into m, l and D in pairwise trees; every lane shuffles, a row
      // with no key yet keeps m = -inf, l = 0
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x[kTileKeys / 8], ps[kTileKeys / 8], pd[kTileKeys / 8];
#pragma unroll
        for (int j = 0; j < kTileKeys / 8; ++j) x[j] = fmaxf(sc[j][2 * i], sc[j][2 * i + 1]);
#pragma unroll
        for (int w = kTileKeys / 16; w > 0; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) x[j] = fmaxf(x[j], x[j + w]);
        const float m_new = fmaxf(m[i], mma::quad_max(x[0]));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
#pragma unroll
        for (int j = 0; j < kTileKeys / 8; ++j) {
          const float pa = exp2_approx(sc[j][2 * i] - m_use);
          const float pb = exp2_approx(sc[j][2 * i + 1] - m_use);
          ps[j] = pa + pb;
          pd[j] = fmaf(pa, dp[j][2 * i], pb * dp[j][2 * i + 1]);
        }
#pragma unroll
        for (int w = kTileKeys / 16; w > 0; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) {
            ps[j] += ps[j + w];
            pd[j] += pd[j + w];
          }
        const float corr = m[i] == -INFINITY ? 0.f : exp2_approx(m[i] - m_use);
        l[i] = l[i] * corr + mma::quad_sum(ps[0]);
        dsum[i] = dsum[i] * corr + mma::quad_sum(pd[0]);
        m[i] = m_new;
      }
      if (it == n - 1) {  // sweep 1 done: lse, delta; m, 1 / l, delta for sweep 2
        const long long st = ((long long)b * S + s) * HW * heads + head;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pq = pw + gr + 8 * i;
          if (m[i] == -INFINITY) m[i] = 0.f, l[i] = 1.f;  // a row past the frame
          const float dl = __fdiv_rn(dsum[i], l[i]);
          if (mine && t == 0 && pq < p1) {
            lse[st + (long long)pq * heads] = fmaf(m[i], kLn2, logf(l[i]));
            delta[st + (long long)pq * heads] = dl;
          }
          dsum[i] = dl;
          l[i] = __frcp_rn(l[i]);
        }
      }
      continue;
    }
    // sweep 2: dS = P (dP - delta), P = e^{s - m} / l, rounded to bf16
    // (local3d.py:710, :1225) into the A fragments of dq += dS K
#pragma unroll
    for (int j = 0; j < kTileKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = __fmul_rn(exp2_approx(sc[j][e] - m[i]), l[i]);
        sc[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], dsum[i]));
      }
    uint32_t dsa[kTileKeys / 16][4];
    mma::to_a_frags<kTileKeys>(sc, dsa);
    wg::fence_regs<D / 8>(acc);
    wg::fence_frags<kTileKeys / 16>(dsa);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk) mma_rs_mn<D>(acc, dsa[kk], Ks, kk);
    wg::commit();
    wg::fence_regs<D / 8>(acc);
    wg::wait<0>();
    wg::fence_regs<D / 8>(acc);
    wg::fence_frags<kTileKeys / 16>(dsa);
  }
  wg::fence_regs<D / 8>(acc);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fmul_rn(acc[j][e], scale);
  if (mine) mma::store_rows<D>(acc, dq + frame(s), ld, pw, p1);
}

// Pass 2 on the tensor cores: dk and dv of 64 / kFrames key positions of
// kFrames consecutive frames of one (b, head), one warpgroup, over the
// query band of each frame of their windows. kPartial: each segment of
// partial_rows query rows of a frame ends in a rounded partial added to
// an f32 total (the per-frame and H-tiled routes).
template <int D, int kFrames, bool kPartial>
__global__ void __launch_bounds__(128, kPartial ? 1 : 2)
local3d_bwd_dkv_mma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const __grid_constant__ CUtensorMap gmap,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int W,
                           int heads, int es, int eh, int ew, int partial_rows, float scale) {
  constexpr int kOwn = kRows / kFrames, kTile = kTileKeys * D;
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = aligned_smem(smem_raw);  // 64 rows each, swizzled
  bf16* Vs = Ks + kTile;
  bf16* QG = Vs + kTile;  // two stages of (Q, G) tiles
  float* stats = reinterpret_cast<float*>(QG + 4 * kTile);  // two of (lse, delta)
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 4 * kTileKeys);  // one a stage
  float* total = reinterpret_cast<float*>(bars + 2);  // kPartial: each thread's dK, dV
  const int HW = H * W;
  const int s0 = blockIdx.y * kFrames, head = blockIdx.z % heads, b = blockIdx.z / heads;
  const int k0 = blockIdx.x * kOwn, k1 = min(k0 + kOwn, HW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int s = s0 + 16 * warp / kOwn, pw = k0 + 16 * warp % kOwn;  // this warp's frame, rows
  const bool mine = s < S;  // a frame past the clip only stages
  const long long ld = (long long)heads * D;
  auto frame = [&](int f) { return ((long long)b * S + f) * HW * ld + head * D; };
  auto stat = [&](int f) { return ((long long)b * S + f) * HW * heads + head; };
  // the query positions that see these keys (the window is symmetric)
  const Band band = wmz::l3d::key_band(k0, k1, H, W, eh);
  // a frame's query tiles: kTileKeys-position runs from the start of each
  // segment (seg positions: partial_rows rows, else the frame) in the band
  const int seg = kPartial ? partial_rows * W : HW;
  const int seg_first = band.lo / seg * seg;
  auto seg_tiles = [&](int c) {
    const int a = max(band.lo, c), e = min(band.hi, c + seg);
    return (e - a + kTileKeys - 1) / kTileKeys;
  };
  int tiles = 0;
  for (int c = seg_first; c < band.hi; c += seg) tiles += seg_tiles(c);
  // tile idx of a frame: its first position, its end, whether it ends a
  // segment
  auto tile_at = [&](int idx, int& t0, int& t1, bool& last) {
    for (int c = seg_first;; c += seg) {
      const int nt = seg_tiles(c);
      if (idx < nt) {
        const int e = min(band.hi, c + seg);
        t0 = max(band.lo, c) + idx * kTileKeys;
        t1 = min(t0 + kTileKeys, e);
        last = idx == nt - 1;
        return;
      }
      idx -= nt;
    }
  };
  const int f0 = max(s0 - es, 0);
  const int frames = min(min(s0 + kFrames - 1, S - 1) + es, S - 1) - f0 + 1;
  const int steps = frames * tiles;
  // step i's Q and G tiles (thread 0, TMA: rows of a tile past its end
  // hold the next positions' queries, which the window masks) and their
  // stats (cp.async, zero past the end)
  auto issue = [&](int i) {
    const int f = f0 + i / tiles;
    int t0, t1;
    bool last;
    tile_at(i % tiles, t0, t1, last);
    if (threadIdx.x == 0) {
      bf16* stage = QG + (i & 1) * 2 * kTile;
      const int row = (b * S + f) * HW + t0;
      wg::mbar_expect_bytes(&bars[i & 1], 2 * kTile * sizeof(bf16));
      wg::tma_rows<D>(stage, &qmap, head * D, row, &bars[i & 1]);
      wg::tma_rows<D>(stage + kTile, &gmap, head * D, row, &bars[i & 1]);
    }
    float* st = stats + (i & 1) * 2 * kTileKeys;
    load_stats_async(st, lse + stat(f), heads, t0, t1);
    load_stats_async(st + kTileKeys, delta + stat(f), heads, t0, t1);
    mma::cp_async_commit();
  };
  if (threadIdx.x == 0) {
    wg::mbar_init(&bars[0], 1);
    wg::mbar_init(&bars[1], 1);
    wg::mbar_init_fence();
  }
  for (int f = 0; f < kFrames; ++f) {  // a frame past the clip: zeros
    const int sf = min(s0 + f, S - 1), end = s0 + f < S ? k1 : k0;
    wg::load_rows_async<D, kRows>(Ks, k + frame(sf), ld, k0, end, f * kOwn, kOwn);
    wg::load_rows_async<D, kRows>(Vs, v + frame(sf), ld, k0, end, f * kOwn, kOwn);
  }
  mma::cp_async_commit();
  __syncthreads();  // the barriers are ready
  issue(0);

  // this lane's key rows gr and gr + 8 of the warp's 16
  int hk[2], wk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pk = pw + gr + 8 * i;
    hk[i] = pk / W;
    wk[i] = pk - hk[i] * W;
  }
  const uint32_t bits0 = tiles == 1 ? window_bits(band.lo, band.hi, hk, wk, W, eh, ew) : 0u;
  float dka[D / 8][4], dva[D / 8][4];
  mma::zero<D / 8>(dka);
  mma::zero<D / 8>(dva);
  if (kPartial) {
    for (int i = threadIdx.x; i < 128 * D; i += blockDim.x) total[i] = 0.f;
  }

  for (int it = 0; it < steps; ++it) {
    // this step's stats (and at the start K, V) have landed and every
    // warp is done with the other stage: refill it while this step runs,
    // then wait for this step's tiles
    tiles_landed();
    if (it + 1 < steps) issue(it + 1);
    wg::mbar_wait(&bars[it & 1], (it >> 1) & 1);
    const bf16* Qt = QG + (it & 1) * 2 * kTile;
    const bf16* Gt = Qt + kTile;
    const float* Lt = stats + (it & 1) * 2 * kTileKeys;
    const float* Dt = Lt + kTileKeys;
    int t0, t1;
    bool last;
    tile_at(it % tiles, t0, t1, last);
    // S^T = K Q^T and dP^T = V G^T (rows: the block's keys)
    float sc[kTileKeys / 8][4], dp[kTileKeys / 8][4];
    wg::fence();
    mma_ss_rows<D>(sc, Ks, Qt);
    mma_ss_rows<D>(dp, Vs, Gt);
    wg::commit();
    wg::fence_regs<kTileKeys / 8>(sc);
    wg::fence_regs<kTileKeys / 8>(dp);
    wg::wait<0>();
    wg::fence_regs<kTileKeys / 8>(sc);
    wg::fence_regs<kTileKeys / 8>(dp);
    const bool active = mine && abs(f0 + it / tiles - s) <= es;
    uint32_t bits = 0;
    if (active) bits = tiles == 1 ? bits0 : window_bits(t0, t1, hk, wk, W, eh, ew);
    const float scale_log2 = scale * mma::kLog2e;
#pragma unroll
    for (int j = 0; j < kTileKeys / 8; ++j) {
      const bool live = group_live(bits, j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const float p = live && bits >> (4 * j + e) & 1u
                            ? exp2_approx(fmaf(sc[j][e], scale_log2, -Lt[col] * mma::kLog2e))
                            : 0.f;
        sc[j][e] = p;
        dp[j][e] = live ? __fmul_rn(p, __fsub_rn(dp[j][e], Dt[col])) : 0.f;
      }
    }
    // P^T and dS^T to bf16 (local3d.py:709-710, :1301-1308), into the A
    // fragments of dV += P^T G and dK += dS^T Q
    uint32_t pa[kTileKeys / 16][4], dsa[kTileKeys / 16][4];
    mma::to_a_frags<kTileKeys>(sc, pa);
    mma::to_a_frags<kTileKeys>(dp, dsa);
    wg::fence_regs<D / 8>(dka);
    wg::fence_regs<D / 8>(dva);
    wg::fence_frags<kTileKeys / 16>(pa);
    wg::fence_frags<kTileKeys / 16>(dsa);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk) {
      mma_rs_mn<D>(dva, pa[kk], Gt, kk);
      mma_rs_mn<D>(dka, dsa[kk], Qt, kk);
    }
    wg::commit();
    wg::fence_regs<D / 8>(dka);
    wg::fence_regs<D / 8>(dva);
    wg::wait<0>();
    wg::fence_regs<D / 8>(dka);
    wg::fence_regs<D / 8>(dva);
    wg::fence_frags<kTileKeys / 16>(pa);
    wg::fence_frags<kTileKeys / 16>(dsa);
    if (kPartial && active && last) {  // a segment's partial, rounded, into the total
      wg::fence_regs<D / 8>(dka);
      wg::fence_regs<D / 8>(dva);
      float* sums = total + threadIdx.x;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = (j * 4 + e) * 2 * 128;
          sums[x] += round_bf16(__fmul_rn(dka[j][e], scale));
          sums[x + 128] += round_bf16(dva[j][e]);
          dka[j][e] = dva[j][e] = 0.f;
        }
    }
  }
  wg::fence_regs<D / 8>(dka);
  wg::fence_regs<D / 8>(dva);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kPartial) {
        const int x = (j * 4 + e) * 2 * 128 + threadIdx.x;
        dka[j][e] = total[x];
        dva[j][e] = total[x + 128];
      } else {
        dka[j][e] = __fmul_rn(dka[j][e], scale);
      }
    }
  if (!mine) return;
  mma::store_rows<D>(dka, dk + frame(s), ld, pw, k1);
  mma::store_rows<D>(dva, dv + frame(s), ld, pw, k1);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, void* dq, float* lse, float* delta,
                      int B, int S, int H, int W, int heads, int dh, int es,
                      int eh, int ew, cudaStream_t stream) {
  const dim3 grid(wmz::blocks_for(B, S, H, W, heads));
  const dim3 block(kWarpsPerBlock * 32);
  const float scale = 1.0f / sqrtf((float)dh);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(g);
  T* out = static_cast<T*>(dq);
  if constexpr (std::is_same<T, float>::value) {
#define WMZ_DQ_CASE(EE)                                                    \
  case EE:                                                                 \
    wmz::note_launch(local3d_bwd_dq_kernel<EE>);                        \
    local3d_bwd_dq_kernel<EE><<<grid, block, 0, stream>>>(              \
        qq, kk, vv, gg, out, lse, delta, B, S, H, W, heads, es, eh, ew,    \
        scale);                                                            \
    break;
    WMZ_L3D_E_SWITCH(dh, WMZ_DQ_CASE)
#undef WMZ_DQ_CASE
  } else {
#define WMZ_DQ_CASE(EE)                                                    \
  case EE:                                                                 \
    wmz::note_launch(local3d_bwd_dq_round_kernel<EE>);                     \
    local3d_bwd_dq_round_kernel<EE><<<grid, block, 0, stream>>>(           \
        qq, kk, vv, gg, out, lse, delta, B, S, H, W, heads, es, eh, ew,    \
        scale);                                                            \
    break;
    WMZ_L3D_E_SWITCH(dh, WMZ_DQ_CASE)
#undef WMZ_DQ_CASE
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int H, int W,
                       int heads, int dh, int es, int eh, int ew,
                       int partial_rows, cudaStream_t stream) {
  const dim3 grid(wmz::blocks_for(B, S, H, W, heads));
  const dim3 block(kWarpsPerBlock * 32);
  const float scale = 1.0f / sqrtf((float)dh);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(g);
  T* dko = static_cast<T*>(dk);
  T* dvo = static_cast<T*>(dv);
  if constexpr (std::is_same<T, float>::value) {
#define WMZ_DKV_CASE(EE)                                                   \
  case EE:                                                                 \
    wmz::note_launch(local3d_bwd_dkv_kernel<EE>);                       \
    local3d_bwd_dkv_kernel<EE><<<grid, block, 0, stream>>>(             \
        qq, kk, vv, gg, lse, delta, dko, dvo, B, S, H, W, heads, es, eh,   \
        ew, scale);                                                        \
    break;
    WMZ_L3D_E_SWITCH(dh, WMZ_DKV_CASE)
#undef WMZ_DKV_CASE
  } else {
#define WMZ_DKV_CASE(EE)                                                   \
  case EE:                                                                 \
    wmz::note_launch(local3d_bwd_dkv_round_kernel<EE>);                    \
    local3d_bwd_dkv_round_kernel<EE><<<grid, block, 0, stream>>>(          \
        qq, kk, vv, gg, lse, delta, dko, dvo, B, S, H, W, heads, es, eh,   \
        ew, partial_rows, scale);                                          \
    break;
    WMZ_L3D_E_SWITCH(dh, WMZ_DKV_CASE)
#undef WMZ_DKV_CASE
  }
  return cudaGetLastError();
}

// the dynamic shared memory of a kernel, set before each launch: above 48
// KB a kernel must opt in
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// 1,024 bytes of slack for aligned_smem
template <int D>
constexpr size_t tiles_bytes(int tiles) {
  return 1024 + (size_t)tiles * kTileKeys * D * sizeof(bf16);
}

template <int D, int kFrames>
cudaError_t launch_dq_shape(const void* q, const void* k, const void* v, const void* g,
                            void* dq, float* lse, float* delta, int B, int S, int H, int W,
                            int heads, int es, int eh, int ew, cudaStream_t stream) {
  // the stages of K, V; Q and G; the barriers
  constexpr int stages = dq_stages(D);
  const size_t bytes = tiles_bytes<D>(2 * stages + 2) + stages * sizeof(uint64_t);
  auto kernel = local3d_bwd_dq_mma_kernel<D, kFrames>;
  CUtensorMap kmap, vmap;
  const long long inner = (long long)heads * D, rows = (long long)B * S * H * W;
  cudaError_t err = wg::encode_rows_map(&kmap, k, inner, rows, inner);
  if (err == cudaSuccess) err = wg::encode_rows_map(&vmap, v, inner, rows, inner);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  constexpr int own = kRows / kFrames;
  const dim3 grid((unsigned)((H * W + own - 1) / own), (unsigned)((S + kFrames - 1) / kFrames),
                  (unsigned)(B * heads));
  wmz::note_launch(kernel);
  kernel<<<grid, 128, bytes, stream>>>(static_cast<const bf16*>(q), kmap, vmap,
                                       static_cast<const bf16*>(g), static_cast<bf16*>(dq), lse,
                                       delta, S, H, W, heads, es, eh, ew,
                                       1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D, int kFrames, bool kPartial>
cudaError_t launch_dkv_shape(const void* q, const void* k, const void* v, const void* g,
                             const float* lse, const float* delta, void* dk, void* dv, int B,
                             int S, int H, int W, int heads, int es, int eh, int ew,
                             int partial_rows, cudaStream_t stream) {
  // K, V, two stages of Q, G; their stats; with partials each thread's sums
  const size_t bytes = tiles_bytes<D>(6) + 4 * kTileKeys * sizeof(float) +
                       2 * sizeof(uint64_t) + (kPartial ? (size_t)128 * D * sizeof(float) : 0);
  auto kernel = local3d_bwd_dkv_mma_kernel<D, kFrames, kPartial>;
  CUtensorMap qmap, gmap;
  const long long inner = (long long)heads * D, rows = (long long)B * S * H * W;
  cudaError_t err = wg::encode_rows_map(&qmap, q, inner, rows, inner);
  if (err == cudaSuccess) err = wg::encode_rows_map(&gmap, g, inner, rows, inner);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  constexpr int own = kRows / kFrames;
  const dim3 grid((unsigned)((H * W + own - 1) / own), (unsigned)((S + kFrames - 1) / kFrames),
                  (unsigned)(B * heads));
  wmz::note_launch(kernel);
  kernel<<<grid, 128, bytes, stream>>>(qmap, static_cast<const bf16*>(k),
                                       static_cast<const bf16*>(v), gmap, lse, delta,
                                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, W,
                                       heads, es, eh, ew, partial_rows, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* g,
                          void* dq, float* lse, float* delta, int B, int S, int H, int W,
                          int heads, int es, int eh, int ew, cudaStream_t stream) {
  if (block_frames(H, W, eh) == 1)
    return launch_dq_shape<D, 1>(q, k, v, g, dq, lse, delta, B, S, H, W, heads, es, eh, ew,
                                 stream);
  return launch_dq_shape<D, 2>(q, k, v, g, dq, lse, delta, B, S, H, W, heads, es, eh, ew,
                               stream);
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* g,
                           const float* lse, const float* delta, void* dk, void* dv, int B,
                           int S, int H, int W, int heads, int es, int eh, int ew,
                           int partial_rows, cudaStream_t stream) {
#define WMZ_DKV_SHAPE(F, P)                                                                 \
  return launch_dkv_shape<D, F, P>(q, k, v, g, lse, delta, dk, dv, B, S, H, W, heads, es, \
                                   eh, ew, partial_rows, stream)
  if (block_frames(H, W, eh) == 1) {
    if (partial_rows > 0) WMZ_DKV_SHAPE(1, true);
    WMZ_DKV_SHAPE(1, false);
  }
  if (partial_rows > 0) WMZ_DKV_SHAPE(2, true);
  WMZ_DKV_SHAPE(2, false);
#undef WMZ_DKV_SHAPE
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels, P and dS in f32), 1 = bfloat16
// (the tensor-core kernels at dh = 64 and 128, the rounding CUDA-core
// kernels at the other head sizes). Each returns its launch's cudaError_t.
extern "C" int wmz_local3d_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* g, void* dq, void* lse,
                                  void* delta, int B, int S, int H, int W,
                                  int heads, int dh, int es, int eh, int ew,
                                  int dtype, void* stream) {
  if (wmz::bad_dh(dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)launch_dq<float>(q, k, v, g, dq, ls, dl, B, S, H, W, heads,
                                 dh, es, eh, ew, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)launch_dq_mma<64>(q, k, v, g, dq, ls, dl, B, S, H, W, heads, es, eh, ew, st);
  if (dh == 128)
    return (int)launch_dq_mma<128>(q, k, v, g, dq, ls, dl, B, S, H, W, heads, es, eh, ew, st);
  return (int)launch_dq<bf16>(q, k, v, g, dq, ls, dl, B, S, H, W, heads, dh, es, eh, ew, st);
}

// partial_rows: 0 = dK and dV one f32 sum each; > 0 (bfloat16 only; it
// divides H) = a rounded partial per frame's partial_rows query rows,
// summed in f32 (kernels/local3d.py:bwd_route).
extern "C" int wmz_local3d_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int S, int H, int W, int heads,
                                   int dh, int es, int eh, int ew, int partial_rows,
                                   int dtype, void* stream) {
  if (wmz::bad_dh(dh) || partial_rows < 0 || (partial_rows > 0 && H % partial_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, g, ls, dl, dk, dv, B, S, H, W,
                                  heads, dh, es, eh, ew, 0, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)launch_dkv_mma<64>(q, k, v, g, ls, dl, dk, dv, B, S, H, W, heads, es, eh, ew,
                                   partial_rows, st);
  if (dh == 128)
    return (int)launch_dkv_mma<128>(q, k, v, g, ls, dl, dk, dv, B, S, H, W, heads, es, eh,
                                    ew, partial_rows, st);
  return (int)launch_dkv<bf16>(q, k, v, g, ls, dl, dk, dv, B, S, H, W, heads, dh, es, eh, ew,
                               partial_rows, st);
}

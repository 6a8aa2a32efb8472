// Local-3D windowed attention, backward, for Hopper (sm_90a): a split pair
// of kernels, a query-centric dQ pass and a key-centric dK/dV pass.
//
// Replaces the TPU backward kernels of world_modelz_tpu/kernels/local3d.py
// that `_route_bwd` (:1535) picks among under the custom_vjp of
// `local3d_attention_pallas`: the split pair `_bwd_kernel_dq` (:1183) and
// `_bwd_kernel_dkv` (:1261) of `_bwd_impl_split` (:1377), and the
// slab-and-fold variants `_bwd_kernel_allframes` (:665), `_bwd_kernel`
// (:1565) and `_bwd_kernel_tiled` (:999). The five exist to fit the TPU's
// VMEM; on the GPU the split pair alone covers every shape, needs no
// atomics and no partial slabs, and so is deterministic.
//
// What it computes. q, k, v, g (the output's cotangent), dq, dk, dv are
// (B, S, H, W, heads * dh), contiguous; lse and delta are (B, S, H, W,
// heads) f32. The window is the forward's, defined once for both files in
// local3d_window.cuh: query i sees the keys j with |ds| <= es inside the
// clip, |dh| <= eh and |dw| <= ew inside the frame. It is symmetric, so
// the queries that see key j are exactly the window of j. With s_ij = scale * q_i . k_j and
// p_ij the softmax of s_i. over i's window:
//   pass 1, per query i: lse_i = log sum_j e^{s_ij}, dp_ij = g_i . v_j,
//     delta_i = sum_j p_ij dp_ij, dq_i = scale * sum_j p_ij (dp_ij -
//     delta_i) k_j;
//   pass 2, per key j, over the queries i of its window: p_ij =
//     e^{s_ij - lse_i}, dv_j = sum_i p_ij g_i, dk_j = scale * sum_i p_ij
//     (g_i . v_j - delta_i) q_i.
//
// What bounds it on the H100. At the training shape (B=64, S=6, 8x8 grid,
// dh=128, extents (3,1,1)) in bf16 one (B, S, H, W, 128) tensor is 6.29 MB:
// pass 1 reads q, k, v, g and writes dq (~31 MB, ~9.4 us at 3.35 TB/s),
// pass 2 reads q, k, v, g, lse, delta and writes dk, dv (~38 MB, ~11.3 us).
// Each does 6-8 dh-long dot products per valid (query, key) pair, ~0.93 M
// pairs per launch: ~1 GFLOP, ~1 us at the bf16 tensor-core peak. Both
// are bound by bytes; as in the forward, what limits these simple kernels
// in practice is the latency of walking a window row by row from L2.
//
// Design. As local3d_fwd.cu: one warp per query (pass 1) or per key
// (pass 2), split into four groups of eight lanes; each group takes every
// fourth row of the window, so four rows' loads are in flight per warp.
// Lane t of a group holds elements [t*E, t*E+E) of each row, E = dh / 8,
// in f32 registers; three shuffles sum a dot product within the group.
// Pass 1 keeps an online softmax per group: running max m, l = sum
// e^{s-m}, D = sum e^{s-m} dp, A = sum e^{s-m} dp k and Bk = sum e^{s-m} k,
// merged across groups by shuffles at the end; then delta = D / l and
// dq = scale * (A - delta * Bk) / l, one pass over the window. Pass 2
// rebuilds p from the saved lse and needs no softmax state: the four
// groups' partial dk, dv are summed by shuffles. q, k, v, g are read in
// place in their layout; no padding, no masks, no empty rows (a window
// always holds its own centre). Shared-memory tiles and tensor-core
// products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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

// Pass 1: dq, lse, delta. E: elements per lane, dh = kGroupLanes * E.
template <typename T, int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
local3d_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      T* __restrict__ dq, float* __restrict__ lse,
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
    T* op = dq + elems(query);
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
template <typename T, int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
local3d_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, int B, int S, int H, int W,
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
#define WMZ_DQ_CASE(EE)                                                    \
  case EE:                                                                 \
    local3d_bwd_dq_kernel<T, EE><<<grid, block, 0, stream>>>(              \
        qq, kk, vv, gg, out, lse, delta, B, S, H, W, heads, es, eh, ew,    \
        scale);                                                            \
    break;
  WMZ_L3D_E_SWITCH(dh, WMZ_DQ_CASE)
#undef WMZ_DQ_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int H, int W,
                       int heads, int dh, int es, int eh, int ew,
                       cudaStream_t stream) {
  const dim3 grid(wmz::blocks_for(B, S, H, W, heads));
  const dim3 block(kWarpsPerBlock * 32);
  const float scale = 1.0f / sqrtf((float)dh);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(g);
  T* dko = static_cast<T*>(dk);
  T* dvo = static_cast<T*>(dv);
#define WMZ_DKV_CASE(EE)                                                   \
  case EE:                                                                 \
    local3d_bwd_dkv_kernel<T, EE><<<grid, block, 0, stream>>>(             \
        qq, kk, vv, gg, lse, delta, dko, dvo, B, S, H, W, heads, es, eh,   \
        ew, scale);                                                        \
    break;
  WMZ_L3D_E_SWITCH(dh, WMZ_DKV_CASE)
#undef WMZ_DKV_CASE
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns its launch's cudaError_t.
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
  if (dtype == 1)
    return (int)launch_dq<__nv_bfloat16>(q, k, v, g, dq, ls, dl, B, S, H, W,
                                         heads, dh, es, eh, ew, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int wmz_local3d_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int S, int H, int W, int heads,
                                   int dh, int es, int eh, int ew, int dtype,
                                   void* stream) {
  if (wmz::bad_dh(dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, g, ls, dl, dk, dv, B, S, H, W,
                                  heads, dh, es, eh, ew, st);
  if (dtype == 1)
    return (int)launch_dkv<__nv_bfloat16>(q, k, v, g, ls, dl, dk, dv, B, S, H,
                                          W, heads, dh, es, eh, ew, st);
  return (int)cudaErrorInvalidValue;
}

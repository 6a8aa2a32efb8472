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
// by dh^-1/2 and softmaxed over those keys only, then multiplied by V.
//
// What bounds it on the H100. At the serving shape (B=8, S=6, 8x8 grid,
// dh=128, extents (3,1,1)) one launch moves ~3.1 MB in bf16 (q, k, v read
// once, out written once), ~0.94 us at 3.35 TB/s, and does ~59 MFLOP,
// ~0.06 us at the bf16 tensor-core peak: memory-bound, and at that size
// bound in practice by latency and by the launch itself.
//
// Design. The TPU kernels multiply dense 7-frame blocks and mask the
// scores (with a max over valid keys only, local3d.py:520-530, to avoid
// NaN rows). Here the window is walked directly, so a query never visits
// an invalid key and always visits itself: the normaliser is never 0.
// One warp per query, split into four groups of eight lanes; each group
// scores its own key of the window (keys g, g+4, g+8, ... of the window in
// row-major order), so four keys' loads are in flight per warp. Lane t of
// a group holds elements [t*E, t*E+E) of q (pre-scaled), of the key and
// value rows (vector loads) and of its f32 accumulator, E = dh / 8; a
// three-step shuffle sums the dot product within the group. Each group
// keeps an online softmax (running max, running sum); the four partial
// states are merged by two shuffles at the end. q, k and v are read in
// place in their (B, S, H, W, heads * dh) layout: no transposes and no
// zero-padded frames. The window's k/v rows are re-read from L2 by every
// query that sees them; shared-memory K/V tiles and tensor-core products
// are later work. The window and the warp layout are defined once, for
// this kernel and the backward pair, in local3d_window.cuh.

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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int W, int heads, int dh, int es,
                   int eh, int ew, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)dh);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  const dim3 grid(wmz::blocks_for(B, S, H, W, heads));
  const dim3 block(kWarpsPerBlock * 32);
#define WMZ_L3D_CASE(EE)                                                   \
  case EE:                                                                 \
    local3d_fwd_kernel<T, EE><<<grid, block, 0, stream>>>(                 \
        qq, kk, vv, oo, B, S, H, W, heads, es, eh, ew, scale);             \
    break;
  WMZ_L3D_E_SWITCH(dh, WMZ_L3D_CASE)
#undef WMZ_L3D_CASE
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int wmz_local3d_fwd(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int W,
                               int heads, int dh, int es, int eh, int ew,
                               int dtype, void* stream) {
  if (wmz::bad_dh(dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, out, B, S, H, W, heads, dh, es, eh, ew, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, out, B, S, H, W, heads, dh, es, eh,
                                ew, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

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
// bound in practice by latency and by the launch itself. On the card the
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
// Design, f32 and the other head sizes (route 0): CUDA cores. In f32, P
// stays in f32 and the window is walked once; in bf16 it is walked twice
// (`local3d_fwd_round_kernel`): once for the max and the sum, once to
// round P (route 1's way or route 2's, as the caller says) before P V.
// The TPU kernels multiply dense 7-frame blocks and mask the scores (with
// a max over valid keys only, local3d.py:520-530, to avoid NaN rows). Here
// the window is walked directly, so a query never visits an invalid key
// and always visits itself: the normaliser is never 0. One warp per query,
// split into four groups of eight lanes; each group scores its own key of
// the window (keys g, g+4, g+8, ... of the window in row-major order), so
// four keys' loads are in flight per warp. Lane t of a group holds
// elements [t*E, t*E+E) of q (pre-scaled), of the key and value rows
// (vector loads) and of its f32 accumulator, E = dh / 8; a three-step
// shuffle sums the dot product within the group. Each group keeps an
// online softmax (running max, running sum); the four partial states are
// merged by two shuffles at the end. q, k and v are read in place in their
// (B, S, H, W, heads * dh) layout: no transposes and no zero-padded
// frames. The window's k/v rows are re-read from L2 by every query that
// sees them. The window and the warp layout are defined once, for this
// kernel and the backward pair, in local3d_window.cuh.

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

// The kernel follows dtype and dh: float32 takes the CUDA-core kernel with
// P in f32; bfloat16 the tensor-core kernel at dh = 64 and 128 and the
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
  if (dtype == 0)
    return (int)launch_f32(q, k, v, out, B, S, H, W, heads, dh, es, eh, ew, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)launch_mma<64>(q, k, v, out, B, S, H, W, heads, es, eh, ew, divide_after, st);
  if (dh == 128)
    return (int)launch_mma<128>(q, k, v, out, B, S, H, W, heads, es, eh, ew, divide_after, st);
  if (divide_after)
    return (int)launch_round<true>(q, k, v, out, B, S, H, W, heads, dh, es, eh, ew, st);
  return (int)launch_round<false>(q, k, v, out, B, S, H, W, heads, dh, es, eh, ew, st);
}

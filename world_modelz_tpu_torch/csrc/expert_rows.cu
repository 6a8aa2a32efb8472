// The row moves of the dropless held-expert layer (parallel/moe.py:
// HeldExperts) around the grouped GEMMs of expert_gemm.cu, on Hopper
// (sm_90a): the gather of each routed row, the weighted sum of a token's
// rows back into the token, and the backward's split of a token's
// gradient into its rows.
//
// Replaces no TPU kernel: added with the grouped GEMMs for SDAR's expert
// layer. The grouped buffer has a static size (the worst routing: every
// assignment of every token to a held expert), eight times the rows an
// even routing uses; these kernels read the rows in use from `offsets[E]`
// on the device and leave the rest untouched, where plain index_add /
// gather calls would sweep the whole buffer (and pile every padding row's
// zeros onto one token by atomics). Bound: bytes (each row read and
// written once, ~2 x 16,384 x 2,048 bf16 per call at the SDAR cell's
// shape, ~40 us at 3.35 TB/s). No atomics: the sum of a token's rows runs
// over its k slots in slot order, so two launches are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "launch_log.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256, kBlocks = 132 * 8;

__device__ __forceinline__ void unpack(const uint4& v, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float f[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// rows r < offsets[E]: out[r] = x[token[r]], zeros for a padding row
// (token[r] == T)
__global__ void __launch_bounds__(kThreads)
expert_rows_gather_kernel(const bf16* __restrict__ x, const long long* __restrict__ token,
                          const int* __restrict__ offsets, int E, int T, int D,
                          bf16* __restrict__ out) {
  const int chunks = D / 8;
  const long long n = (long long)offsets[E] * chunks;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / chunks, c = i % chunks;
    const long long t = token[r];
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < T) v = reinterpret_cast<const uint4*>(x + t * D)[c];
    reinterpret_cast<uint4*>(out + r * D)[c] = v;
  }
}

// out[t] = sum over the slots s of token t whose row row_of[t, s] >= 0 of
// w[t, s] y[row] (w null: 1), in f32 in slot order, rounded to bf16
__global__ void __launch_bounds__(kThreads)
expert_rows_combine_kernel(const bf16* __restrict__ y, const long long* __restrict__ row_of,
                           const float* __restrict__ w, int T, int k, int D,
                           bf16* __restrict__ out) {
  const int chunks = D / 8;
  const long long n = (long long)T * chunks;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long t = i / chunks, c = i % chunks;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < k; ++s) {
      const long long r = row_of[t * k + s];
      if (r < 0) continue;
      const float ws = w ? w[t * k + s] : 1.f;
      float f[8];
      unpack(reinterpret_cast<const uint4*>(y + r * D)[c], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += ws * f[e];
    }
    reinterpret_cast<uint4*>(out + t * D)[c] = pack(acc);
  }
}

// rows r < offsets[E], one warp a row: dy[r] = bf16(dout[t] w_row[r]) and
// dw_row[r] = dout[t] . y[r] in f32, t = token[r]; zeros for a padding row
__global__ void __launch_bounds__(kThreads)
expert_rows_scatter_bwd_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ y,
                               const long long* __restrict__ token,
                               const float* __restrict__ w_row, const int* __restrict__ offsets,
                               int E, int T, int D, bf16* __restrict__ dy,
                               float* __restrict__ dw_row) {
  const int lane = threadIdx.x & 31, chunks = D / 8;
  const long long rows = offsets[E];
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long r = blockIdx.x * (long long)(blockDim.x / 32) + (threadIdx.x >> 5); r < rows;
       r += warps) {
    const long long t = token[r];
    float dot = 0.f;
    if (t < T) {
      const float wr = w_row[r];
      for (int c = lane; c < chunks; c += 32) {
        float g[8], f[8], d[8];
        unpack(reinterpret_cast<const uint4*>(dout + t * D)[c], g);
        unpack(reinterpret_cast<const uint4*>(y + r * D)[c], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dot += g[e] * f[e];
          d[e] = g[e] * wr;
        }
        reinterpret_cast<uint4*>(dy + r * D)[c] = pack(d);
      }
    } else {
      for (int c = lane; c < chunks; c += 32)
        reinterpret_cast<uint4*>(dy + r * D)[c] = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) dw_row[r] = dot;
  }
}

}  // namespace

// mode 0: gather (a = x (T, D), b = token, out (rows, D));
// mode 1: combine (a = y (rows, D), b = row_of (T, k), w (T, k) f32 or
// null, out (T, D)); mode 2: the backward's split (a = dout (T, D), y,
// b = token, w = w_row, out = dy (rows, D), dw = dw_row (rows,) f32).
// D % 8 == 0, 16-byte aligned rows. Returns the launch's cudaError_t.
extern "C" int wmz_expert_rows(const void* a, const void* y, const void* b, const void* w,
                               const void* offsets, void* out, void* dw, int E, int T, int k,
                               int D, int mode, void* stream) {
  if (D % 8 || T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* idx = static_cast<const long long*>(b);
  const int* off = static_cast<const int*>(offsets);
  if (mode == 0) {
    wmz::note_launch(expert_rows_gather_kernel);
    expert_rows_gather_kernel<<<kBlocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(a), idx, off, E, T, D, static_cast<bf16*>(out));
  } else if (mode == 1) {
    wmz::note_launch(expert_rows_combine_kernel);
    expert_rows_combine_kernel<<<kBlocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(a), idx, static_cast<const float*>(w), T, k, D,
        static_cast<bf16*>(out));
  } else if (mode == 2) {
    wmz::note_launch(expert_rows_scatter_bwd_kernel);
    expert_rows_scatter_bwd_kernel<<<kBlocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(y), idx,
        static_cast<const float*>(w), off, E, T, D, static_cast<bf16*>(out),
        static_cast<float*>(dw));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

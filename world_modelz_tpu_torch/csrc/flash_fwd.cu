// Dense flash attention, forward, for Hopper (sm_90a).
//
// Replaces the stock Pallas TPU kernel `_flash_attention_kernel`
// (jax/experimental/pallas/ops/tpu/flash_attention.py:331, pallas_call :758)
// that world_modelz_tpu/models/attention.py:_flash_dense_attention (:124)
// calls for the sparse-diffusion transformer's DenseAttention.
//
// What it computes. Non-causal out = softmax(scale * q k^T) v over (B, H, N,
// D) operands, D = 64 or 128, and lse = m + log l per query (the TPU kernel
// writes l and m; the backward here takes their log-sum-exp). The TPU
// wrapper pads N to a multiple of 128 and fences the padding off with
// segment ids; here the key loop masks the columns at or past N, so every
// real query sees the real keys only, which is what the segment ids give
// for real rows. Softmax statistics and sums in f32; out in the input
// dtype, written (B, N, H, D)-contiguous so the heads merge without a copy.
//
// What bounds it on the H100. At the sparse trainer's shape (B=16, H=8,
// N=1024, D=64, bf16) it reads q, k, v (25 MB) and writes out and lse: ~8 us
// at 3.35 TB/s, against 4 B H N^2 D = 34.4 GFLOP of products, ~35 us at the
// bf16 tensor-core peak: bound by operations.
//
// Design (simple and right first; tensor cores are later work). One block
// of 256 threads per (64-query tile, h, b), the tiling of flash_tile.cuh:
// the query tile stays in shared memory, 64-key tiles of K and V are staged
// through it in order, the 4 x 4 scores per thread are CUDA-core f32 FMAs,
// the softmax is online (running max and sum per row, the accumulator
// rescaled per key tile), and the weights go through shared memory into
// the P v product. Each block sums in a fixed order: two launches are
// bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "flash_tile.cuh"

namespace {

using namespace wmz::flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 int H, int N, float scale) {
  constexpr int kC = D / kTx;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ps = Vs + kTile * (D + 1);  // 64 x kSLd weights
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;

  load_tile<T, D>(Qs, q, sq, b, h, q0, N);
  float acc[kRows][kC], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k, sk, b, h, k0, N);
    load_tile<T, D>(Vs, v, sv, b, h, k0, N);
    __syncthreads();
    float s[kRows][kCols];
    tile_dots<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = k0 + tx + kTx * j < N ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      // every key tile holds a real key, so m_new is finite
      const float m_new = fmaxf(m[i], row_max(mt));
      const float corr = expf(m[i] - m_new);  // 0 on the first tile
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * kRows + i) * kSLd + tx + kTx * j] = p;
        ps += p;
      }
      l[i] = fmaf(l[i], corr, row_sum(ps));
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();
    tile_product<D>(Ps, Vs, acc);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int n = q0 + ty * kRows + i;
    if (n >= N) continue;
    const float inv = 1.f / l[i];
    T* orow = out + (((long long)b * N + n) * H + h) * D + tx;
#pragma unroll
    for (int c = 0; c < kC; ++c) orow[c * kTx] = from_float<T>(acc[i][c] * inv);
    if (tx == 0) lse[((long long)b * H + h) * N + n] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const long long* st, int B, int H, int N,
                   float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(3, 1, 0);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(B, H, N), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, H, N, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, const long long* st, int B, int H, int N,
                     int D, float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, out, lse, st, B, H, N, scale, stream);
  return launch<T, 128>(q, k, v, out, lse, st, B, H, N, scale, stream);
}

}  // namespace

// strides: int64 [9], the b, h, n element strides of q, k, v. dtype: 0 =
// float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int wmz_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int B, int H, int N, int D, float scale,
                             int dtype, void* stream) {
  if (wmz::flash::bad_head_size(D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, out, ls, strides, B, H, N, D, scale,
                                st);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(q, k, v, out, ls, strides, B, H, N, D,
                                        scale, st);
  return (int)cudaErrorInvalidValue;
}
